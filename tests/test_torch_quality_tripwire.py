"""The quick quality tripwire on the port: the JAX package's
``tests/test_quality_tripwire.py`` recipe and bars, on the CPU.

The real pipeline end to end at toy scale: a 16-utterance formant corpus
(2-4 syllables, seed 0) → `SpevDataset` (pyin and log-mel extraction) →
bucketed batches → the port's `Trainer` (hidden 32, B=8, lr 2e-3, 4 warmup
steps, 10 epochs), validating every epoch.  JAX's bars:

- the train loss falls by at least 15 % from the first epoch;
- the teacher-forced duration error ends under 60 % and below the first
  epoch's.
"""

import os

import numpy as np
import torch

from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
from spev_tpu_torch.data.batching import BucketBatcher
from spev_tpu_torch.data.dataset import SpevDataset
from spev_tpu_torch.data.synthetic import generate_formant_corpus
from spev_tpu_torch.text.vocab import Vocab
from spev_tpu_torch.train.trainer import Trainer


def test_training_moves_quality_signals(tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # the six-worker run shares the machine's cores
    try:
        root = str(tmp_path / "corpus")
        tg = generate_formant_corpus(root, n_utterances=16, seed=0, syllable_range=(2, 4))
        ds = SpevDataset(root, textgrid_dir=tg, cache_dir=str(tmp_path / "cache"),
                         g2p_backend="rules", stats_sample=16, device="cpu")
        vocab = Vocab(ds.vocab)
        cfg = SpevConfig(
            model=ModelConfig(vocab_size=len(vocab), embed_dim=32, hidden_dim=32, n_mels=80,
                              max_frames=256, vp_output_norm=False),
            train=TrainConfig(batch_size=8, warmup_steps=4, epochs=10, warmup_epochs=0,
                              learning_rate=2e-3),
        )
        trainer = Trainer(cfg, vocab, ds.stats, ckpt_dir=str(tmp_path / "ck"),
                          log_dir=str(tmp_path / "logs"), device="cpu")
        bt = BucketBatcher(ds, vocab, batch_size=8, phoneme_buckets=(32,), frame_buckets=(256,))
        losses, dur_errs = [], []
        for epoch in range(cfg.train.epochs):
            m = trainer.train_epoch(bt.epoch(epoch))
            trainer.validate(bt.epoch(0))
            losses.append(float(m["train_loss"]))
            q = trainer.last_quality
            if "val_dur_err_pct" in q:
                dur_errs.append(float(q["val_dur_err_pct"]))
    finally:
        torch.set_num_threads(n)

    assert np.isfinite(losses).all(), losses
    drop = (losses[0] - losses[-1]) / losses[0]
    assert drop >= 0.15, (
        f"train loss fell only {drop:.0%} over {len(losses)} epochs "
        f"({losses[0]:.3f} -> {losses[-1]:.3f}): training numerics regression")
    assert dur_errs, "duration-error signal missing from val quality"
    assert dur_errs[-1] < 60.0, (
        f"duration error {dur_errs[-1]:.0f}% after {len(losses)} epochs "
        f"(random-init is ~100%): duration pathway regression")
    assert dur_errs[-1] < dur_errs[0], (dur_errs[0], dur_errs[-1])
