"""The port's mel PNGs and in-training probes (``spev_tpu_torch.diag``)
against the JAX package's, on the CPU.

- `mel_statistics` equals JAX's on the same mels (flatline and range
  warnings included).
- `test_inference_probe` on a tiny trainer whose weights are JAX's gives
  each probe's stats within 1e-4 of JAX's probe (in eval mode, whatever
  mode the model was left in), and its PNGs; after it (inference mode) a
  train step still takes a backward.
- `Trainer.validate(save_plot_epoch=...)` writes ``val_<epoch>.png`` and
  `write_output` a ``_mel.png`` beside the wav.
- Without matplotlib (``sys.modules["matplotlib"] = None``) the plot
  functions raise `UserError` naming the ``plots`` extra, and
  ``cli.train`` runs 10 epochs (probes included) with one "skipped" line
  and no PNG.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spev_tpu_torch.config as port_config
from spev_tpu.config import ModelConfig as JModelConfig
from spev_tpu.config import SpevConfig as JSpevConfig
from spev_tpu.config import TrainConfig as JTrainConfig
from spev_tpu.diag import probes as jax_probes
from spev_tpu.text.lexicon import LEXICON
from spev_tpu.text.vocab import Vocab as JaxVocab
from spev_tpu.train.trainer import Trainer as JaxTrainer
from spev_tpu_torch.cli.common import PNGS_SKIPPED, write_output
from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
from spev_tpu_torch.diag import plots, probes
from spev_tpu_torch.errors import UserError
from spev_tpu_torch.train.trainer import Trainer
from spev_tpu_torch.utils.params import fastspeech2_state_dict_from_tree

from _torch_cache import write_cache

H = 32
SMALL = dict(embed_dim=H, hidden_dim=H, n_mels=80, n_encoder_layers=1, n_decoder_layers=1,
             max_frames=512)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A JAX trainer and the port's on the same weights (durations near 6
    frames a phoneme, so every probe has frames)."""
    tmp = tmp_path_factory.mktemp("probe")
    vocab = JaxVocab.build(set("".join(LEXICON.values())))
    jt = JaxTrainer(JSpevConfig(model=JModelConfig(vocab_size=len(vocab), **SMALL),
                                train=JTrainConfig(batch_size=2)),
                    vocab, {}, ckpt_dir=str(tmp / "jc"), log_dir=str(tmp / "jl"))
    params = jax.tree.map(np.asarray, jt.state.params)
    params["duration_predictor"]["output_norm"]["bias"] = np.asarray([np.log(7.0)], np.float32)
    jt.state = jt.state._replace(params=jax.tree.map(jnp.asarray, params))
    tt = Trainer(SpevConfig(model=ModelConfig(vocab_size=len(vocab), **SMALL),
                            train=TrainConfig(batch_size=2, warmup_steps=2)),
                 vocab, {}, ckpt_dir=str(tmp / "tc"), log_dir=str(tmp / "tl"), device="cpu")
    tt.model.load_state_dict(fastspeech2_state_dict_from_tree(params))
    return jt, tt, tmp


def test_mel_statistics_match_jax():
    rng = np.random.default_rng(0)
    mels = [rng.standard_normal((40, 80)) - 4.0, np.full((5, 80), -3.0),
            rng.standard_normal((7, 80)) + 2.0, rng.standard_normal((9, 80)) - 9.0]
    for mel in mels:
        assert probes.mel_statistics(mel) == jax_probes.mel_statistics(mel)
    assert probes.mel_statistics(mels[1])["flatline_warning"]
    assert probes.mel_statistics(mels[2])["range_warning"]
    assert probes.mel_statistics(mels[3])["range_warning"]


def test_probe_matches_jax_then_training_continues(pair, capsys):
    jt, tt, tmp = pair
    ref = jax_probes.test_inference_probe(jt, str(tmp / "jax_png"), epoch=9)
    tt.model.train()  # as a train step leaves it
    ours = probes.test_inference_probe(tt, str(tmp / "port_png"), epoch=9)
    assert not tt.model.training
    out = capsys.readouterr().out
    assert "failed" not in out and out.count("Probe ") >= 6
    assert len(ours) == len(ref) == len(probes.TEST_TEXTS)
    for a, b in zip(ours, ref):
        for k in ("mean", "std", "min", "max"):
            assert abs(a[k] - b[k]) <= 1e-4, (k, a[k], b[k])
        assert a["flatline_warning"] == b["flatline_warning"]
    for i in range(1, 4):
        assert (tmp / "port_png" / f"test_e10_t{i}.png").stat().st_size > 0
    # the probe ran under inference mode; a train step still takes a backward
    rng = np.random.default_rng(1)
    n, T = 6, 30
    batch = {"ids": np.tile(np.arange(4, 4 + n), (2, 1)).astype(np.int32),
             "lens": np.full((2,), n, np.int32),
             "durs": np.full((2, n), 5.0, np.float32),
             "log_durs": np.full((2, n), np.log(6.0), np.float32),
             "mel": (rng.standard_normal((2, T, 80)) - 4.0).astype(np.float32),
             "mel_lens": np.full((2,), T, np.int32)}
    for k in ("pitch", "energy", "breath", "rough", "bright"):
        batch[k] = rng.uniform(0, 0.5, (2, n)).astype(np.float32)
    m = tt.train_step(tt.to_device(batch))
    assert m["skipped"] == 0.0 and np.isfinite(m["loss"]) and tt.step == 1


def test_validate_and_write_output_save_pngs(pair, tmp_path):
    _, tt, _ = pair
    rng = np.random.default_rng(2)
    batch = {"ids": np.tile(np.arange(4, 10), (2, 1)).astype(np.int32),
             "lens": np.full((2,), 6, np.int32), "durs": np.full((2, 6), 4.0, np.float32),
             "log_durs": np.full((2, 6), np.log(5.0), np.float32),
             "mel": (rng.standard_normal((2, 24, 80)) - 4.0).astype(np.float32),
             "mel_lens": np.asarray([24, 20], np.int32)}
    for k in ("pitch", "energy", "breath", "rough", "bright"):
        batch[k] = np.zeros((2, 6), np.float32)
    val = tt.validate([batch], save_plot_epoch=3)
    assert np.isfinite(val)
    assert os.path.getsize(os.path.join(tt.log_dir, "val_3.png")) > 0
    out = str(tmp_path / "o.wav")
    write_output(np.zeros(512, np.float32), out, mel=batch["mel"][0])
    assert (tmp_path / "o_mel.png").stat().st_size > 0 and (tmp_path / "o.wav").exists()


@dataclasses.dataclass(frozen=True)
class TinyModelConfig(port_config.ModelConfig):
    embed_dim: int = 32
    hidden_dim: int = 32
    n_encoder_layers: int = 1
    n_decoder_layers: int = 1
    max_frames: int = 512


@pytest.fixture
def one_thread():
    """One torch thread: the hidden-32 model's ops are too small to share, and
    the six-worker run oversubscribes the cores with the default count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_without_matplotlib(tmp_path, monkeypatch, capsys, one_thread):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not plots.available()
    with pytest.raises(UserError, match=r"plots"):
        plots.save_mel_plot(np.zeros((80, 4)), str(tmp_path / "a.png"))
    with pytest.raises(UserError, match=r"plots"):
        plots.save_comparison_plot(np.zeros((80, 4)), np.zeros((80, 4)), str(tmp_path / "b.png"))
    write_output(np.zeros(256, np.float32), str(tmp_path / "w.wav"), mel=np.zeros((4, 80)))
    assert capsys.readouterr().out.count(PNGS_SKIPPED) == 1

    from spev_tpu_torch.cli.train import main

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(port_config, "ModelConfig", TinyModelConfig)
    write_cache(str(tmp_path / "cache"), n_utts=10, seed=1, n_mels=80, max_ph=20, max_dur=4)
    argv = ["--cache_dir", "cache", "--name", "nomp", "--epochs", "10", "--batch_size", "4",
            "--warmup_epochs", "1", "--warmup_steps", "5", "--save_every", "5",
            "--device", "cpu"]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert out.count(PNGS_SKIPPED) == 1
    assert out.count("Probe ") == 3 and "failed" not in out
    logs = tmp_path / "logs" / "nomp"
    rows = [json.loads(line) for line in (logs / "metrics.jsonl").open()]
    assert len(rows) == 10 and all(np.isfinite(r["val_mel"]) for r in rows)
    assert not list(logs.glob("*.png"))
    assert (tmp_path / "checkpoints" / "nomp" / "ckpt_10.pt").exists()
