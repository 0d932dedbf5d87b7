"""The port's formant-corpus quality gate (`spev_tpu_torch.diag.convergence`)
against the JAX package's ``tools/demo_common.py``,
``tools/gate_calibration.py`` and ``tools/make_demo.py``, on the CPU at 12
utterances:

- the setup: `build_quality_setup(..., n_utterances=12)` against the JAX
  pieces assembled as ``demo_common`` assembles them: the corpus's files
  byte-equal, the vocab, the split and the configs' fields equal, the
  caches equal (phonemes and durations exact, mel within 2e-4, the
  per-phoneme targets within 1e-3, stats within 1e-4 relative, the bars of
  ``tests/test_torch_dataset_build.py``);
- the free-running errors: a JAX `Trainer` at hidden 32 (one encoder and
  one decoder block) trained one epoch, its duration bias then set to the
  corpus's mean frames, its parameters carried into the port's `Trainer`; the port's
  `freerun_frame_errors` equals ``gate_calibration.freerun_frame_errors``
  on every utterance exactly (frame counts are integers);
- the bars: ``gate_calibration.main`` runs unchanged on a canned dashboard
  and prints the same JSON as `run_dashboard` → `gate_summary` on it;
  `gate_failures` names each bar a summary breaks, and none of a summary
  that breaks none;
- the demo: `write_demo` after one epoch writes every file, with a seeded
  V3 generator as the GAN vocoder; each ``val{j}_gt.wav`` is byte-equal
  to the corpus wav of its cache file.
"""

import dataclasses
import json
import math
import os
import re
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spev_tpu.config import ModelConfig as JaxModelConfig
from spev_tpu.config import SpevConfig as JaxSpevConfig
from spev_tpu.config import TrainConfig as JaxTrainConfig
from spev_tpu.data.batching import BucketBatcher as JaxBatcher
from spev_tpu.data.batching import train_val_split as jax_split
from spev_tpu.data.dataset import SpevDataset as JaxDataset
from spev_tpu.data.synthetic import generate_formant_corpus as jax_corpus
from spev_tpu.text.vocab import Vocab as JaxVocab
from spev_tpu.train.trainer import Trainer as JaxTrainer
from spev_tpu_torch.diag import convergence as cv
from spev_tpu_torch.diag import plots
from spev_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from spev_tpu_torch.train.trainer import Trainer
from spev_tpu_torch.train.vocoder_trainer import save_generator
from spev_tpu_torch.utils.params import fastspeech2_state_dict_from_tree
from spev_tpu_torch.utils.wavio import read_wav

N = 12
H = 32
TARGETS = ("pitch", "energy", "breath", "rough", "bright", "nasal")
# the JAX package's TPU-only switches, which the port leaves out (ROADMAP.md, section 4)
LEFT_OUT = {"model": {"use_pallas_lr", "fused_predictors", "max_phonemes"},
            "train": {"dropout_rng_impl", "metrics_window"}}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    # the six-worker run shares the machine's cores (module scope: the
    # module's fixtures build datasets too)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_tools():
    """``tools.gate_calibration`` imported with the process's environment
    kept (the tool sets JAX_PLATFORMS and XLA_FLAGS for its own process)."""
    saved = dict(os.environ)
    try:
        from tools import gate_calibration
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return gate_calibration


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    """The port's setup and the JAX pieces of ``tools/demo_common.py`` at
    ``N`` utterances, each in its own directory."""
    port = cv.build_quality_setup(1, device="cpu", n_utterances=N,
                                  work=str(tmp_path_factory.mktemp("port")))
    work = str(tmp_path_factory.mktemp("jax"))
    root = os.path.join(work, "corpus")
    tg = jax_corpus(root, n_utterances=N, seed=0)
    ds = JaxDataset(root, textgrid_dir=tg, cache_dir=os.path.join(work, "cache"),
                    g2p_backend="rules", stats_sample=60)
    vocab = JaxVocab(ds.vocab)
    cfg = JaxSpevConfig(
        model=JaxModelConfig(vocab_size=len(vocab), embed_dim=96, hidden_dim=96, n_mels=80,
                             max_phonemes=32, max_frames=256, vp_output_norm=False),
        train=JaxTrainConfig(batch_size=16, warmup_steps=50, epochs=1, warmup_epochs=2,
                             learning_rate=2e-3))
    tr_idx, va_idx = jax_split(len(ds), 0.1, seed=0)
    ref = SimpleNamespace(work=work, corpus_root=root, ds=ds, vocab=vocab, cfg=cfg,
                          tr_idx=tr_idx, va_idx=va_idx)
    return port, ref


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_setup_corpus_matches_jax(setups):
    port, ref = setups
    names = _files(port.corpus_root)
    assert names == _files(ref.corpus_root)
    assert sum(n.endswith(".wav") for n in names) == N
    assert sum(n.endswith(".TextGrid") for n in names) == N
    for n in names:
        with open(os.path.join(port.corpus_root, n), "rb") as a, \
                open(os.path.join(ref.corpus_root, n), "rb") as b:
            assert a.read() == b.read(), n


def test_setup_vocab_split_and_config_match_jax(setups):
    port, ref = setups
    assert list(port.vocab.symbols) == list(ref.vocab.symbols)
    assert port.va_idx == ref.va_idx and port.bt.indices == ref.tr_idx
    assert port.bv.indices == ref.va_idx
    for section in ("model", "train"):
        ours = dataclasses.asdict(getattr(port.cfg, section))
        theirs = dataclasses.asdict(getattr(ref.cfg, section))
        assert set(theirs) - set(ours) == LEFT_OUT[section]
        assert ours == {k: theirs[k] for k in ours}, section
    assert port.cfg.model.hidden_dim == 96 and port.cfg.train.learning_rate == 2e-3
    for b in (port.bt, port.bv):
        assert b.phoneme_buckets == (32,) and b.frame_buckets == (256,) and b.batch_size == 16


def test_setup_cache_matches_jax(setups):
    port, ref = setups
    ours, theirs = port.ds, ref.ds
    assert ours.files == theirs.files and ours.vocab == theirs.vocab
    assert sorted(ours.stats) == sorted(theirs.stats)
    for k, v in theirs.stats.items():
        assert abs(ours.stats[k] - v) <= 1e-4 * abs(v), k
    for i in range(N):
        a, b = ours.load_utterance(i), theirs.load_utterance(i)
        assert sorted(a) == sorted(b)
        assert list(a["phs"]) == list(b["phs"])
        np.testing.assert_array_equal(a["durs"], b["durs"])
        np.testing.assert_allclose(a["mel"], b["mel"], atol=2e-4)
        for k in TARGETS:
            np.testing.assert_allclose(a[k], b[k], atol=1e-3, err_msg=k)


def test_freerun_frame_errors_match_jax(setups, tmp_path):
    """Both packages' free-running frame errors from one set of weights (JAX's
    trainer after one epoch, hidden 32, 1 + 1 blocks), on every utterance of
    the corpus."""
    port, ref = setups
    narrow = dict(embed_dim=H, hidden_dim=H, n_encoder_layers=1, n_decoder_layers=1)
    jcfg = dataclasses.replace(ref.cfg, model=dataclasses.replace(ref.cfg.model, **narrow))
    jt = JaxTrainer(jcfg, ref.vocab, ref.ds.stats, ckpt_dir=str(tmp_path / "jax_ck"),
                    log_dir=str(tmp_path / "jax_logs"))
    jt.train_epoch(JaxBatcher(ref.ds, ref.vocab, batch_size=16, phoneme_buckets=(32,),
                              frame_buckets=(256,), indices=ref.tr_idx).epoch(0))
    assert int(jt.state.step) == 1
    # one step leaves the duration head near its zero init (~0 frames a
    # phoneme); its bias set to the corpus's mean frames makes every
    # phoneme's rounding count, in both packages alike
    params = jax.tree.map(np.asarray, jt.state.params)
    params["duration_predictor"]["proj"]["bias"] = np.asarray(
        [np.log1p(ref.ds.stats["frames_per_phoneme"])], np.float32)
    jt.state = jt.state._replace(params=jax.tree.map(jnp.asarray, params))
    cfg = dataclasses.replace(port.cfg, model=dataclasses.replace(port.cfg.model, **narrow))
    tr = Trainer(cfg, port.vocab, ref.ds.stats, ckpt_dir=str(tmp_path / "ck"),
                 log_dir=str(tmp_path / "logs"), device="cpu")
    tr.model.load_state_dict(fastspeech2_state_dict_from_tree(params))
    every = list(range(N))
    ours = cv.freerun_frame_errors(tr, port.ds, port.vocab, cfg, every, device="cpu")
    theirs = _jax_tools().freerun_frame_errors(jt, ref.ds, ref.vocab, jcfg, every)
    assert ours == theirs
    assert len(set(ours)) > 1 and all(0 <= e < 50 for e in ours), ours


# -- the bars ---------------------------------------------------------------------

CANNED = [  # (train loss, val loss, val MCD or None, duration error or None)
    (5.6, 5.5, 137.5, None), (4.1, 4.0, 130.0, 28.9), (3.5, 3.4, 124.6, 10.1),
    (2.0, 1.9, 90.0, 8.0), (1.3, 1.26, 35.0, 6.3), (1.0, 1.1, 30.0, 6.0),
    (0.8, 0.9, 28.0, 5.1), (0.6, 0.7, 26.4, 3.9), (0.5, 0.53, 24.9, 4.2),
]
CANNED_ERRORS = [1.5, 12.0, 3.25, 0.0, 7.5]


class _CannedTrainer:
    """A trainer whose epochs replay `CANNED` (an absent dashboard entry
    leaves ``last_quality`` without its key)."""

    def __init__(self):
        self.epoch, self.last_quality = 0, {}

    def train_epoch(self, batches):
        return {"train_loss": CANNED[self.epoch][0]}

    def validate(self, batches):
        loss, val, mcd, dur = CANNED[self.epoch]
        self.last_quality = {k: v for k, v in (("val_mcd_db", mcd), ("val_dur_err_pct", dur))
                             if v is not None}
        self.epoch += 1
        return val


def _canned_setup():
    batches = SimpleNamespace(epoch=lambda e: iter(()))
    return SimpleNamespace(trainer=_CannedTrainer(), bt=batches, bv=batches, ds=None,
                           vocab=None, cfg=None, va_idx=[])


def _same(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    return a == b or (math.isnan(a) and math.isnan(b))


def test_gate_summary_matches_jax(monkeypatch, capsys):
    jax_gate = _jax_tools()
    from tools import demo_common

    monkeypatch.setattr(demo_common, "build_quality_setup", lambda epochs, lr_mult: _canned_setup())
    monkeypatch.setattr(jax_gate, "freerun_frame_errors", lambda *a: list(CANNED_ERRORS))
    monkeypatch.setattr(sys, "argv", ["gate_calibration.py", "--epochs", str(len(CANNED)),
                                      "--lr_mult", "1.1"])
    jax_gate.main()
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    hist = cv.run_dashboard(_canned_setup(), len(CANNED))
    ours = cv.gate_summary(hist, CANNED_ERRORS, len(CANNED), 1.1)
    assert list(ours) == list(theirs) and _same(ours, theirs), (ours, theirs)
    assert math.isnan(hist[0]["durerr"]) and math.isnan(ours["trend"]["durerr"][0])
    # the NaN first third breaks the duration trend; every other bar holds
    assert [f.split(":")[0] for f in cv.gate_failures(ours)] == ["trend"]
    assert "durerr did not fall" in cv.gate_failures(ours)[0]


PASSING = {"epochs": 45, "lr_mult": 1.0, "mcd0": 137.5, "mcd_final_med5": 26.4,
           "mcd_ratio": 26.4 / 137.5, "durerr_final_med3": 3.8,
           "freerun_frame_err_pct_median": 2.7, "freerun_frame_err_pct_max": 8.0,
           "trend": {"mcd": [124.6, 30.0], "durerr": [10.1, 3.9], "val": [3.4, 0.6]}}
BROKEN = {
    "durerr": {"durerr_final_med3": 10.0},
    "mcd_ratio": {"mcd_final_med5": 39.9},  # 0.29 x 137.5 = 39.875
    "mcd": {"mcd0": 200.0, "mcd_final_med5": 40.0},
    "freerun": {"freerun_frame_err_pct_median": 9.0},
    "trend": {"trend": {"mcd": [124.6, 30.0], "durerr": [10.1, 3.9], "val": [0.6, 0.6]}},
}


def test_gate_failures_none_when_every_bar_holds():
    assert cv.gate_failures(PASSING) == []
    assert set(BROKEN) == set(cv.BARS)


@pytest.mark.parametrize("bar", sorted(BROKEN))
def test_gate_failures_names_the_bar_broken(bar):
    failures = cv.gate_failures({**PASSING, **BROKEN[bar]})
    assert len(failures) == 1 and failures[0].startswith(bar + ":"), failures
    nan = {**PASSING, **{k: (float("nan") if not isinstance(v, dict) else v)
                         for k, v in BROKEN[bar].items()}}
    if bar != "trend":
        assert any(f.startswith(bar + ":") for f in cv.gate_failures(nan))


# -- the demo page ----------------------------------------------------------------


def test_write_demo_writes_every_file(setups, tmp_path):
    port, _ = setups
    cv.run_dashboard(port, 1)
    gcfg = HiFiGANConfig.v3()
    gen = str(tmp_path / "gen_00000000.spev")
    torch.manual_seed(0)
    save_generator(gen, SimpleNamespace(generator=HiFiGANGenerator(gcfg), step=0), gcfg)
    out = tmp_path / "demo"
    metrics = cv.write_demo(port, str(out), gan_checkpoint=gen, gan_config="v3")
    n = len(port.va_idx[:3])
    assert n >= 1 and sorted(metrics["utterances"]) == [f"val{j}" for j in range(n)]
    assert metrics["epochs"] == 1 and set(metrics["final_quality"]) == {"val_mcd_db",
                                                                         "val_dur_err_pct"}
    kinds = ["gt.wav", "synth.wav", "synth_gan.wav"] + (["mels.png"] if plots.available() else [])
    assert sorted(os.listdir(out)) == sorted(["demo_metrics.json"] + [
        f"val{j}_{k}" for j in range(n) for k in kinds])
    assert json.loads((out / "demo_metrics.json").read_text()) == metrics
    wavs = sorted(f for f in os.listdir(port.corpus_root) if f.endswith(".wav"))
    for j, idx in enumerate(port.va_idx[:3]):
        k = int(re.match(r"u_(\d+)\.npz$", port.ds.files[idx]).group(1))
        src = os.path.join(port.corpus_root, wavs[k])
        assert (out / f"val{j}_gt.wav").read_bytes() == open(src, "rb").read()
        # the pairing holds in the audio: the cached mel has that wav's frames
        y, _ = read_wav(src)
        u = port.ds.load_utterance(idx)
        assert u["mel"].shape[0] == 1 + len(y) // 256
        row = metrics["utterances"][f"val{j}"]
        assert row["frames_gt"] == u["mel"].shape[0] and row["phonemes"] == len(u["phs"])
        synth, _ = read_wav(str(out / f"val{j}_synth.wav"))
        gan, _ = read_wav(str(out / f"val{j}_synth_gan.wav"))
        assert len(synth) == len(gan) == row["frames_pred"] * 256
        assert np.isfinite(synth).all() and np.isfinite(gan).all()
        assert math.isfinite(row["mcd_db_vs_gt"])
