"""Acoustic training on the card (or the CPU), from a corpus of wavs or an
existing feature cache:

    python -m spev_tpu_torch.cli.train --data_dir WAVS [--textgrid_dir TG] \
        --cache_dir cache_spev [--force_rebuild] --name run1 \
        [--epochs 100] [--batch_size 16] [--lr 1e-3] [--warmup_epochs 10] \
        [--warmup_steps N] [--save_every 10] [--resume checkpoints/run1/last.pt] \
        [--reference_predictors] [--device cuda]

Counterpart of ``spev-train`` (``spev_tpu.cli.spev_tts`` in train mode,
through ``spev_tpu.cli.common.run_training``): dataset build (when
``--cache_dir`` holds no cache, or with ``--force_rebuild``; feature
extraction with kernel K2 on ``--device``) → 95/5 split → bucketed batches
→ epochs of train steps with validation.  Checkpoints go to
``checkpoints/<name>/{last,best}.pt`` and the per-epoch log to
``logs/<name>/metrics.jsonl``, under the working directory.  As in
``spev-train``, the variance predictors are per-phoneme
(``vp_output_norm=False``) unless ``--reference_predictors`` keeps the
reference's constant ones.  Plots, inference probes, the numbered
``ckpt_*`` snapshots and ``--multi_speaker`` are not ported.  Errors caused
by the input exit with status 2 and one ``error:`` line.
"""

from __future__ import annotations

import argparse
import os
import sys
from spev_tpu_torch.errors import UserError


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m spev_tpu_torch.cli.train")
    p.add_argument("--data_dir", type=str, default="data/training_data",
                   help="corpus of wavs (+ .txt transcripts) the cache is built from")
    p.add_argument("--textgrid_dir", type=str, default="data/textgrid_data",
                   help="forced-alignment TextGrids (phones tier) for the durations")
    p.add_argument("--cache_dir", type=str, default="cache_spev",
                   help="feature-cache directory (npz + metadata.json)")
    p.add_argument("--force_rebuild", action="store_true",
                   help="delete and rebuild the feature cache (the reference's default "
                        "behavior)")
    p.add_argument("--name", type=str, default="spev_tts")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup_epochs", type=int, default=10,
                   help="duration-only epochs before full training")
    p.add_argument("--warmup_steps", type=int, default=None,
                   help="LR warmup steps (default: TrainConfig's 4000)")
    p.add_argument("--save_every", type=int, default=10,
                   help="epochs between resumable `last` checkpoints (the final epoch "
                        "always saves; `best` saves on every improvement)")
    p.add_argument("--resume", type=str, help="checkpoint to continue from")
    p.add_argument("--reference_predictors", action="store_true",
                   help="keep the reference's LayerNorm(1) constant-output variance "
                        "predictors")
    p.add_argument("--device", type=str, default="cuda")
    return p


def run_training(args):
    """dataset (built on ``args.device`` when the cache is missing) → split
    → batches → Trainer epochs with validation and last/best checkpoints.
    Returns the Trainer."""
    from spev_tpu_torch.config import ModelConfig, SpevConfig, TrainConfig
    from spev_tpu_torch.data.batching import BucketBatcher, train_val_split
    from spev_tpu_torch.data.dataset import SpevDataset
    from spev_tpu_torch.diag.metrics import log_metrics
    from spev_tpu_torch.text.vocab import Vocab
    from spev_tpu_torch.train.trainer import Trainer

    ds = SpevDataset(args.data_dir, textgrid_dir=args.textgrid_dir, cache_dir=args.cache_dir,
                     force_rebuild=args.force_rebuild, device=args.device)
    vocab = Vocab(ds.vocab)
    print(f"Dataset: {len(ds)} utterances, vocab {len(vocab)}")
    overrides = {} if args.reference_predictors else {"vp_output_norm": False}
    train_kw = {} if args.warmup_steps is None else {"warmup_steps": int(args.warmup_steps)}
    cfg = SpevConfig(
        model=ModelConfig(vocab_size=len(vocab), **overrides),
        train=TrainConfig(learning_rate=args.lr, batch_size=args.batch_size,
                          epochs=args.epochs, warmup_epochs=args.warmup_epochs, **train_kw),
    )
    tr_idx, va_idx = train_val_split(len(ds), cfg.train.val_fraction, seed=cfg.train.seed)
    print(f"Dataset: {len(tr_idx)} Train, {len(va_idx)} Val")
    n_mels = cfg.model.n_mels
    train_b = BucketBatcher(ds, vocab, batch_size=cfg.train.batch_size, n_mels=n_mels,
                            indices=tr_idx)
    val_b = BucketBatcher(ds, vocab, batch_size=cfg.train.batch_size, n_mels=n_mels,
                          indices=va_idx)
    trainer = Trainer(cfg, vocab, ds.stats, ckpt_dir=os.path.join("checkpoints", args.name),
                      log_dir=os.path.join("logs", args.name), device=args.device)
    if args.resume:
        print(f"Resuming from {args.resume}")
        trainer.restore(args.resume)

    save_every = max(1, int(args.save_every or 10))
    for epoch in range(trainer.epoch, cfg.train.epochs):
        metrics = trainer.train_epoch(train_b.epoch(epoch))
        val_loss = trainer.validate(val_b.epoch(0))
        quality = trainer.last_quality
        log_metrics(trainer.log_dir, epoch, {**metrics, "val_mel": val_loss, **quality})
        qstr = ""
        if "val_mcd_db" in quality:
            qstr = f" | MCD {quality['val_mcd_db']:.2f} dB"
            if "val_dur_err_pct" in quality:
                qstr += f" | dur err {quality['val_dur_err_pct']:.1f}%"
        print(f"Epoch {epoch + 1}: train {metrics['train_loss']:.4f} | "
              f"val mel {val_loss:.4f}{qstr}")
        if (epoch + 1) % save_every == 0 or epoch + 1 == cfg.train.epochs:
            trainer.save("last")
        if trainer.maybe_save_best(val_loss):
            print(f"New best model saved (val {val_loss:.4f})")
    return trainer


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        run_training(args)
    except (UserError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
