"""End to end on the CPU: ``python -m spev_tpu_torch.cli.train`` at a tiny
config trains from a numpy-written feature cache for 2 epochs, writes
``last.pt``, ``best.pt`` and ``metrics.jsonl``, resumes from ``last.pt``,
and the port's `Synthesizer` serves ``best.pt`` with the architecture the
checkpoint carries.  With ``--data_dir`` it first builds the cache from a
corpus of wavs (the JAX package's layout), and a second call reuses it."""

import dataclasses
import json

import numpy as np
import pytest

import spev_tpu_torch.config as port_config
from spev_tpu_torch.cli.train import main
from spev_tpu_torch.infer.synthesis import Synthesizer

from _torch_cache import write_cache
from test_data import _make_corpus



@dataclasses.dataclass(frozen=True)
class TinyModelConfig(port_config.ModelConfig):
    """The default config narrowed to what the CPU trains in seconds."""

    embed_dim: int = 32
    hidden_dim: int = 32
    n_encoder_layers: int = 2
    n_decoder_layers: int = 2


@pytest.fixture
def trained(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(port_config, "ModelConfig", TinyModelConfig)
    # 80 mel channels, lengths inside the (64, 256) bucket
    write_cache(str(tmp_path / "cache"), n_utts=24, seed=1, n_mels=80, max_ph=40, max_dur=5)
    argv = ["--cache_dir", "cache", "--name", "tiny", "--epochs", "2", "--batch_size", "4",
            "--warmup_epochs", "1", "--warmup_steps", "5", "--device", "cpu"]
    assert main(argv) == 0
    return tmp_path, argv


def test_cli_trains_and_synthesizer_serves_best(trained):
    root, _ = trained
    ck = root / "checkpoints" / "tiny"
    assert (ck / "last.pt").exists() and (ck / "best.pt").exists()
    rows = [json.loads(line) for line in (root / "logs" / "tiny" / "metrics.jsonl").open()]
    assert [r["step"] for r in rows] == [0, 1]
    for r in rows:
        assert np.isfinite(r["train_loss"]) and np.isfinite(r["val_mel"]) and r["skipped"] == 0
    synth = Synthesizer(str(ck / "best.pt"), hifigan_dir=None, g2p_backend="rules", device="cpu")
    assert synth.model_cfg.hidden_dim == 32 and synth.model_cfg.vp_output_norm is False
    wav, mel = synth.synthesize("Hello there.")
    assert mel.shape[1] == 80 and len(wav) == mel.shape[0] * 256
    assert np.isfinite(wav).all() and np.isfinite(mel).all()


def test_cli_resumes_from_last(trained):
    root, argv = trained
    last = str(root / "checkpoints" / "tiny" / "last.pt")
    argv = [a if a != "2" else "3" for a in argv] + ["--resume", last]
    assert main(argv) == 0
    rows = [json.loads(line) for line in (root / "logs" / "tiny" / "metrics.jsonl").open()]
    assert [r["step"] for r in rows] == [0, 1, 2]


def test_cli_without_cache_exits_2(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert main(["--cache_dir", "nowhere", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error: no wavs under data/training_data") and err.count("\n") == 1


def test_cli_builds_cache_from_data_dir_then_reuses_it(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(port_config, "ModelConfig", TinyModelConfig)
    _make_corpus(str(tmp_path / "wavs"), n=6)
    argv = ["--data_dir", "wavs", "--textgrid_dir", "none", "--cache_dir", "cache",
            "--name", "built", "--epochs", "1", "--batch_size", "4", "--warmup_epochs", "0",
            "--device", "cpu"]
    assert main(argv) == 0
    meta = json.loads((tmp_path / "cache" / "metadata.json").read_text())
    assert meta["files"] == [f"u_{i:05d}.npz" for i in range(6)]
    assert {"p_mean", "c_std", "frames_per_phoneme"} <= set(meta["stats"])
    for name, (n_ph, n_fr) in zip(meta["files"], meta["lengths"]):
        with np.load(tmp_path / "cache" / name, allow_pickle=True) as u:
            assert u["mel"].shape == (n_fr, 80) and len(u["phs"]) == n_ph == len(u["pitch"])
    assert (tmp_path / "checkpoints" / "built" / "best.pt").exists()
    stamp = (tmp_path / "cache" / "u_00000.npz").stat().st_mtime_ns
    capsys.readouterr()
    assert main([a if a != "built" else "again" for a in argv]) == 0
    assert (tmp_path / "cache" / "u_00000.npz").stat().st_mtime_ns == stamp
    assert "Dataset: 6 utterances" in capsys.readouterr().out
