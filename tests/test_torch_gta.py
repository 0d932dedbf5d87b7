"""GTA (ground-truth-aligned) mels and the crop batcher in the port against
the JAX package, on the CPU.

The corpus and the acoustic checkpoint are built as ``tests/test_gta.py``
builds them (JAX's dataset build and ``Trainer.save``, hidden 32), with
four utterances of 0.5-1.1 s so that a 64-frame bucket skips two of them.
- ``compute_gta_mels`` of both packages on the same dataset and ``.spev``:
  the same keys, each mel the ground truth's frame count, mel MAE < 1e-4;
  the same skipped set and message with a too-small bucket.
- ``make_crop_batcher`` of both packages draws the same crops, and with
  ``gta_by_path`` crops the teacher-forced mels, not the ground truth.
- ``cli.vocoder --gta_checkpoint`` in process on the CPU.
"""

import glob
import os

import numpy as np
import pytest

from spev_tpu.cli.vocoder import make_crop_batcher as jax_make_crop_batcher
from spev_tpu.config import AudioConfig as JAudioConfig
from spev_tpu.config import ModelConfig as JModelConfig
from spev_tpu.config import SpevConfig as JSpevConfig
from spev_tpu.config import TrainConfig as JTrainConfig
from spev_tpu.data.dataset import SpevDataset as JaxDataset
from spev_tpu.infer.gta import compute_gta_mels as jax_compute_gta_mels
from spev_tpu.text.vocab import Vocab
from spev_tpu.train.trainer import Trainer as JaxTrainer
from spev_tpu.utils.wavio import write_wav
from spev_tpu_torch.cli import vocoder as cli
from spev_tpu_torch.config import AudioConfig
from spev_tpu_torch.data.dataset import SpevDataset
from spev_tpu_torch.infer.gta import compute_gta_mels

TEXTS = ["hello there", "speech test", "one two", "tiny voice"]
SECONDS = (0.5, 0.7, 0.9, 1.1)


@pytest.fixture(scope="module")
def corpus_ckpt(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    cache = str(tmp_path_factory.mktemp("cache"))
    work = str(tmp_path_factory.mktemp("work"))
    rng = np.random.default_rng(0)
    sr = 22050
    for i, sec in enumerate(SECONDS):
        t = np.arange(int(sec * sr)) / sr
        y = 0.4 * np.sin(2 * np.pi * (150 + 30 * i) * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
        y += 0.02 * rng.standard_normal(len(t))
        write_wav(os.path.join(root, f"utt{i}.wav"), y.astype(np.float32), sr)
        with open(os.path.join(root, f"utt{i}.txt"), "w") as f:
            f.write(TEXTS[i])
    ds = JaxDataset(root, cache_dir=cache, g2p_backend="rules", stats_sample=4)
    vocab = Vocab(ds.vocab)
    cfg = JSpevConfig(
        model=JModelConfig(vocab_size=len(vocab), embed_dim=32, hidden_dim=32, n_mels=80,
                           max_phonemes=64, max_frames=128),
        train=JTrainConfig(batch_size=2, warmup_steps=5, epochs=1))
    trainer = JaxTrainer(cfg, vocab, ds.stats, ckpt_dir=os.path.join(work, "ck"),
                         log_dir=os.path.join(work, "logs"))
    ckpt = trainer.save("gta_test")
    return root, cache, ds, ckpt


def test_gta_mels_match_jax(corpus_ckpt):
    root, cache, ds, ckpt = corpus_ckpt
    kw = dict(batch_size=3, phoneme_buckets=(64,), frame_buckets=(64, 128))
    ref = jax_compute_gta_mels(ckpt, ds, **kw)
    # the port reads the same cache without a device
    ours = compute_gta_mels(ckpt, SpevDataset(None, cache_dir=cache), device="cpu", **kw)
    assert set(ours) == set(ref) == set(range(len(ds))) == {0, 1, 2, 3}
    for i in range(len(ds)):
        gt = ds.load_utterance(i)["mel"]
        assert ours[i].shape == ref[i].shape == gt.shape  # frame for frame
        assert ours[i].dtype == np.float32 and np.isfinite(ours[i]).all()
        assert np.abs(ours[i] - ref[i]).mean() < 1e-4
        assert ours[i].min() >= -10.0 and ours[i].max() <= 2.0


def test_gta_skips_the_same_utterances(corpus_ckpt, capsys):
    root, cache, ds, ckpt = corpus_ckpt
    kw = dict(batch_size=2, phoneme_buckets=(64,), frame_buckets=(64,))
    ref = jax_compute_gta_mels(ckpt, ds, **kw)
    jax_out = capsys.readouterr().out
    ours = compute_gta_mels(ckpt, ds, device="cpu", **kw)
    assert set(ours) == set(ref) == {0, 1}  # 0.9 and 1.1 s exceed 64 frames
    assert capsys.readouterr().out == jax_out == (
        "gta: 2 utterances exceed the largest bucket — skipped\n")
    for i in ours:
        assert np.abs(ours[i] - ref[i]).mean() < 1e-4
    assert compute_gta_mels(ckpt, ds, device="cpu", phoneme_buckets=(64,),
                            frame_buckets=(8,)) == {}


def test_crop_batcher_matches_jax_and_uses_gta_mels(corpus_ckpt):
    root, cache, ds, ckpt = corpus_ckpt
    wavs = sorted(glob.glob(os.path.join(root, "*.wav")))
    # teacher-forced stand-ins, clearly distinct from extracted mels
    gta_by_path = {p: np.full((ds.load_utterance(w)["mel"].shape[0], 80), w - 50.0, np.float32)
                   for w, p in enumerate(wavs)}
    ours = cli.make_crop_batcher(wavs, AudioConfig(), 8, 4, gta_by_path=gta_by_path,
                                 device="cpu")
    ref = jax_make_crop_batcher(wavs, JAudioConfig(), 8, 4, gta_by_path=gta_by_path)
    for _ in range(3):
        (mels, wav_crops), (mels_j, wav_j) = ours(), ref()
        assert mels.shape == (4, 8, 80) and wav_crops.shape == (4, 8 * 256)
        np.testing.assert_array_equal(wav_crops, wav_j)  # the same crops
        np.testing.assert_array_equal(mels, mels_j)
        for row in mels:
            assert row.std() == 0.0 and row[0, 0] <= -46.0

    # without gta_by_path: crops of the extracted log-mel (K2's plain version here)
    ours = cli.make_crop_batcher(wavs, AudioConfig(), 8, 4, device="cpu")
    ref = jax_make_crop_batcher(wavs, JAudioConfig(), 8, 4)
    (mels, wav_crops), (mels_j, wav_j) = ours(), ref()
    np.testing.assert_array_equal(wav_crops, wav_j)
    assert all(row.std() > 0.0 for row in mels)
    np.testing.assert_allclose(mels, mels_j, atol=2e-4, rtol=0)


def test_cli_gta_end_to_end(corpus_ckpt, tmp_path, monkeypatch, capsys):
    root, cache, ds, ckpt = corpus_ckpt
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--data_dir", root, "--cache_dir", cache, "--gta_checkpoint", ckpt,
                     "--steps", "2", "--batch_size", "2", "--segment_frames", "8",
                     "--config", "tiny", "--periods", "2", "--scales", "1", "--log_every", "1",
                     "--save_every", "2", "--name", "gta_run", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"GTA conditioning from {ckpt}: 4 utterances" in out
    assert os.path.exists(tmp_path / "checkpoints" / "gta_run" / "gen_00000002.spev")
