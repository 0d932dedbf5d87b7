"""The convergence gate's trajectory, JAX's trainer beside the port's, on
the CPU (the quick form of the paired runs in ``tests/_torch_gate_pair.py``):
the formant setup at 12 utterances, narrowed to hidden 32 and one FFT block
each side (JAX's trainer set-up and its compile of the two train steps
bound the test's time), JAX's seeded weights carried into the port, both
dropout rates 0, 'highest' in both, one feature cache, 4 epochs (the two
duration-only epochs and two full ones).

Every epoch's batches are equal array for array, and its train loss, val
loss and val MCD agree within 1e-4 relative.  The paired 45-epoch runs at
120 utterances (PERF.md, section 6) read at most 4.9e-5 (train loss),
1.4e-5 (val loss) and 1.3e-5 (val MCD) over their first four epochs; from
there Adam's normalisation carries rounding differences of near-zero
gradient elements into every reading, as it carries a one-ulp nudge of the
port's own weights, and no reading stays within 1e-3 past epoch 6.  At this
test's size the gaps read at most 4.5e-6.
"""

import math

import pytest
import torch

from tests._torch_gate_pair import build_pair, run_pair

N = 12
EPOCHS = 4
TOL = 1e-4


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the six-worker run shares the machine's cores
    try:
        ref, port = build_pair(N, EPOCHS, str(tmp_path_factory.mktemp("pair")), cache_by="port",
                               hidden=32, n_encoder_layers=1, n_decoder_layers=1)
        assert port.bt.indices == ref.bt.indices and port.va_idx == ref.va_idx
        for e in range(EPOCHS):
            assert [len(b["ids"]) for b in port.bt.epoch(e)] == [16]
        return run_pair(ref, port, EPOCHS)
    finally:
        torch.set_num_threads(n)


def test_both_phases_run(rows):
    assert len(rows) == EPOCHS
    # duration-only epochs 0-1 (no variance losses), then the full loss
    assert all(math.isfinite(r[side]["loss"]) for r in rows for side in ("jax", "port"))
    assert rows[1]["jax"]["loss"] < rows[0]["jax"]["loss"]


@pytest.mark.parametrize("key", ["loss", "val", "mcd"])
def test_readings_agree_every_epoch(rows, key):
    gaps = [r["gap"][key] for r in rows]
    assert max(gaps) <= TOL, [(r["jax"][key], r["port"][key]) for r in rows]
