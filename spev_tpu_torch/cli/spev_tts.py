"""The core TTS command (counterpart of ``spev_tpu.cli.spev_tts``, the
``spev-train`` and ``spev-infer`` console scripts): two-phase training
(``--warmup_epochs`` train duration only) and inference with duration and
pitch scales.

    python -m spev_tpu_torch.cli.spev_tts --mode train --data_dir WAVS \
        [--multi_speaker] [--name spev_tts --epochs 100 ...] [--device cuda]
    python -m spev_tpu_torch.cli.spev_tts --mode infer \
        --checkpoint checkpoints/spev_tts/best.spev --text "Hello." \
        [--hifigan_dir DIR] [--device cuda] --output out.wav

The JAX package's flags, plus ``--device``.  Training goes through
`spev_tpu_torch.cli.common.run_training` and writes
``checkpoints/<name>/{last,best}.spev`` (and ``.pt`` beside them for a
model without the advanced groups); inference writes the waveform and
``<output>_mel.png`` beside it (skipped without matplotlib).  Errors caused
by the input exit with status 2 and one ``error:`` line.
"""

from __future__ import annotations

import argparse
import sys

from spev_tpu_torch.cli.common import add_cache_flags, cli_guard, run_training, write_output


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m spev_tpu_torch.cli.spev_tts")
    p.add_argument("--mode", type=str, default="train", choices=["train", "infer"])
    p.add_argument("--data_dir", type=str, default="data/training_data")
    p.add_argument("--textgrid_dir", type=str, default="data/textgrid_data")
    p.add_argument("--hifigan_dir", type=str, default="hifi-gan")
    p.add_argument("--name", type=str, default="spev_tts")
    p.add_argument("--resume", type=str, help="checkpoint to continue from")
    add_cache_flags(p)
    p.add_argument("--save_every", type=int, default=10,
                   help="epochs between resumable `last` checkpoints (the final epoch "
                        "always saves; `best` saves on every improvement)")
    p.add_argument("--warmup_epochs", type=int, default=10,
                   help="duration-only epochs before full training")
    p.add_argument("--multi_speaker", action="store_true",
                   help="speaker labels from file-name prefixes ({speaker}_*.wav) and a "
                        "speaker embedding")
    p.add_argument("--reference_predictors", action="store_true",
                   help="keep the reference's LayerNorm(1) constant-output variance "
                        "predictors; by default they are per-phoneme")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--warmup_steps", type=int, default=None,
                   help="LR warmup steps (default: TrainConfig's 4000)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--checkpoint", type=str, default="checkpoints/spev_tts/best.spev")
    p.add_argument("--text", type=str, default="Hello from SPEV.")
    p.add_argument("--duration_scale", type=float, default=1.0)
    p.add_argument("--pitch_scale", type=float, default=1.0)
    p.add_argument("--output", type=str, default="output.wav")
    p.add_argument("--device", type=str, default="cuda")
    return p


@cli_guard
def main(argv=None) -> int:
    """``spev-train``; ``--mode infer`` serves as ``spev-infer`` does."""
    args = build_parser().parse_args(argv)
    if args.mode == "train":
        run_training(args, warmup_epochs=args.warmup_epochs,
                     model_overrides=None if args.reference_predictors
                     else {"vp_output_norm": False})
    else:
        _infer(args)
    return 0


@cli_guard
def inference_mode(argv=None) -> int:
    """``spev-infer``."""
    _infer(build_parser().parse_args(argv))
    return 0


def _infer(args) -> None:
    from spev_tpu_torch.infer.synthesis import infer_tts

    wav, mel = infer_tts(args.checkpoint, args.text, duration_scale=args.duration_scale,
                       pitch_scale=args.pitch_scale, hifigan_dir=args.hifigan_dir,
                       device=args.device)
    write_output(wav, args.output, mel)


if __name__ == "__main__":
    sys.exit(main())
