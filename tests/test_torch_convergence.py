"""The convergence gate on the port (slow): the JAX package's
``tests/test_convergence.py`` setup and its four tests, on the CPU, through
`spev_tpu_torch.diag.convergence.gate_failures`.

The formant setup (`build_quality_setup`: 120 utterances, hidden 96,
``vp_output_norm=False``, B=16, a 90/10 split) trained 45 epochs with the
dashboard read every epoch, then every held-out utterance run free.  The
bars are the code's (``tests/test_convergence.py:88-131``): the last 3
epochs' median duration error under 10 %; the last 5 epochs' median MCD
under 0.29x epoch 0's and under 40 dB; the median free-running frame error
under 9 %; MCD, duration error and val loss lower in the last third of the
epochs than in the first.
"""

import numpy as np
import pytest

from spev_tpu_torch.diag import convergence as cv

EPOCHS = 45


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    s = cv.build_quality_setup(EPOCHS, device="cpu", work=str(tmp_path_factory.mktemp("gate")))
    hist = cv.run_dashboard(s, EPOCHS)
    errors = cv.freerun_frame_errors(s.trainer, s.ds, s.vocab, s.cfg, s.va_idx, device="cpu")
    summary = cv.gate_summary(hist, errors, EPOCHS, 1.0)
    return hist, errors, summary


def _broken(summary, bar):
    return [f for f in cv.gate_failures(summary) if f.split(":")[0] == bar]


@pytest.mark.slow
def test_duration_error_reaches_reference_target(gate):
    hist, _, summary = gate
    assert not _broken(summary, "durerr"), [h["durerr"] for h in hist]


@pytest.mark.slow
def test_mcd_converges_toward_target(gate):
    hist, _, summary = gate
    mcds = np.array([h["mcd"] for h in hist])
    assert np.all(np.isfinite(mcds))
    assert not (_broken(summary, "mcd_ratio") + _broken(summary, "mcd")), list(mcds)


@pytest.mark.slow
def test_freerun_frame_count_generalizes(gate):
    _, errors, summary = gate
    assert np.isfinite(summary["freerun_frame_err_pct_median"])
    assert not _broken(summary, "freerun"), errors


@pytest.mark.slow
def test_dashboard_trend_is_convergent(gate):
    _, _, summary = gate
    assert not _broken(summary, "trend"), summary["trend"]
