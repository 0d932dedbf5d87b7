"""Acoustic training on the card (or the CPU), from a corpus of wavs or an
existing feature cache:

    python -m spev_tpu_torch.cli.train --data_dir WAVS [--textgrid_dir TG] \
        --cache_dir cache_spev [--force_rebuild] --name run1 \
        [--epochs 100] [--batch_size 16] [--lr 1e-3] [--warmup_epochs 10] \
        [--warmup_steps N] [--save_every 10] [--resume checkpoints/run1/last.pt] \
        [--reference_predictors] [--model_axis 1] [--device cuda]

The port's own training command, the train mode of ``cli.spev_tts`` under
another name and without ``--multi_speaker``, through
`spev_tpu_torch.cli.common.run_training`: dataset build (when
``--cache_dir`` holds no cache, or with ``--force_rebuild``; feature
extraction with kernel K2 on ``--device``) → 95/5 split → bucketed batches
→ epochs of train steps with validation.  Checkpoints go to
``checkpoints/<name>/{last,best}.{spev,pt}`` (and ``ckpt_<n>`` every 10
epochs) and the per-epoch log to ``logs/<name>/metrics.jsonl``, under the
working directory.  As in ``spev-train``, the variance predictors are
per-phoneme (``vp_output_norm=False``) unless ``--reference_predictors``
keeps the reference's constant ones.  The synthesis probes run every 10
epochs and ``logs/<name>/val_<epoch>.png`` is written every
``--save_every`` epochs (skipped with one line without matplotlib).  Under
``python -m torch.distributed.run --nproc_per_node N`` it trains
data-parallel over N ranks (``--batch_size`` must divide by N), and with
``--model_axis S`` over a (N/S, S) data×model mesh whose model groups
share the FFT blocks (``--batch_size`` must divide by N/S).  Errors
caused by the input exit with status 2 and one ``error:`` line.
"""

from __future__ import annotations

import argparse
import sys

from spev_tpu_torch.cli.common import add_cache_flags, cli_guard, run_training


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m spev_tpu_torch.cli.train")
    p.add_argument("--data_dir", type=str, default="data/training_data",
                   help="corpus of wavs (+ .txt transcripts) the cache is built from")
    p.add_argument("--textgrid_dir", type=str, default="data/textgrid_data",
                   help="forced-alignment TextGrids (phones tier) for the durations")
    add_cache_flags(p)
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
    p.add_argument("--model_axis", type=int, default=1,
                   help="ranks that share each FFT block (tensor parallelism; must divide the "
                        "process group and n_heads)")
    p.add_argument("--device", type=str, default="cuda")
    return p


@cli_guard
def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    run_training(args, warmup_epochs=args.warmup_epochs,
                 model_overrides=None if args.reference_predictors else {"vp_output_norm": False})
    return 0


if __name__ == "__main__":
    sys.exit(main())
