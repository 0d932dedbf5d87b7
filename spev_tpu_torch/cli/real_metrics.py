"""The reference engine's command line (counterpart of
``spev_tpu.cli.real_metrics``), with its flag surface plus ``--device``:

    python -m spev_tpu_torch.cli.real_metrics --mode train --data_dir WAVS \
        [--name run_stable --epochs 100 --grad_accum 1 ...] [--device cuda]
    python -m spev_tpu_torch.cli.real_metrics --mode infer \
        --checkpoint checkpoints/run_stable/best.spev --text "Hello." \
        [--breathiness 0.1 --roughness 0.05 --brightness 0.0] \
        [--hifigan_dir DIR] [--device cuda] --output out.wav

Training goes through `spev_tpu_torch.cli.common.run_training` (the
reference's constant variance predictors, no duration-only epochs) and
writes ``checkpoints/<name>/{last,best}.{spev,pt}``; inference writes the
waveform and ``<output>_mel.png`` beside it (skipped without matplotlib).
Errors caused by the input exit with status 2 and one ``error:`` line.
"""

from __future__ import annotations

import argparse
import sys

from spev_tpu_torch.cli.common import add_cache_flags, cli_guard, run_training, write_output


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m spev_tpu_torch.cli.real_metrics")
    p.add_argument("--mode", type=str, required=True, choices=["train", "infer"])
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--textgrid_dir", type=str, help="Path to MFA .TextGrid files")
    p.add_argument("--name", type=str, default="run_stable")
    add_cache_flags(p)
    p.add_argument("--save_every", type=int, default=10,
                   help="epochs between resumable `last` checkpoints (the final epoch "
                        "always saves; `best` saves on every improvement)")
    p.add_argument("--resume", type=str)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--hifigan_dir", type=str, default="vocoder_checkpoints/LJ_FT_T2_V3")
    p.add_argument("--text", type=str,
                   default="You are using the SPEV text-to-speech synthesis system.")
    p.add_argument("--output", type=str, default="output.wav")
    p.add_argument("--checkpoint", type=str, default="checkpoints/run_stable/best.spev")
    p.add_argument("--breathiness", type=float, default=0.1, help="Breathiness control 0-0.8")
    p.add_argument("--roughness", type=float, default=0.05, help="Roughness control 0-1.5")
    p.add_argument("--brightness", type=float, default=0.0,
                   help="Brightness control -2.5 to 2.5")
    p.add_argument("--pitch_scale", type=float, default=1.0)
    p.add_argument("--duration_scale", type=float, default=1.0)
    p.add_argument("--energy_scale", type=float, default=1.0)
    p.add_argument("--device", type=str, default="cuda")
    return p


@cli_guard
def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode == "train":
        run_training(args)
        return 0
    from spev_tpu_torch.infer.synthesis import infer_tts

    print(f"Generating speech for: '{args.text}'")
    wav, mel = infer_tts(args.checkpoint, args.text, breathiness=args.breathiness,
                       roughness=args.roughness, brightness=args.brightness,
                       pitch_scale=args.pitch_scale, duration_scale=args.duration_scale,
                       energy_scale=args.energy_scale, hifigan_dir=args.hifigan_dir,
                       device=args.device)
    write_output(wav, args.output, mel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
