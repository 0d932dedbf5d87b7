"""Text → wav on the card (or the CPU):

    python -m spev_tpu_torch.cli.infer --checkpoint model.pt|model.spev --text "Hello." \
        [--hifigan_dir DIR] [--duration_scale 1.0] [--pitch_scale 1.0] \
        [--device cuda] --output out.wav

Counterpart of ``spev-infer`` (``spev_tpu.cli.spev_tts.inference_mode``); it
writes the waveform only.  HiFi-GAN is used when ``--hifigan_dir`` holds a
``config.json`` and a ``g_*`` checkpoint, Griffin-Lim otherwise.  Errors
caused by the input exit with status 2 and one ``error:`` line.
"""

from __future__ import annotations

import argparse
import sys

from spev_tpu_torch.errors import UserError


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m spev_tpu_torch.cli.infer")
    p.add_argument("--checkpoint", type=str, required=True, help=".pt or .spev checkpoint")
    p.add_argument("--text", type=str, default="Hello from SPEV.")
    p.add_argument("--hifigan_dir", type=str, default="hifi-gan")
    p.add_argument("--duration_scale", type=float, default=1.0)
    p.add_argument("--pitch_scale", type=float, default=1.0)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--output", type=str, default="output.wav")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from spev_tpu_torch.config import AudioConfig
    from spev_tpu_torch.infer.synthesis import infer_tts
    from spev_tpu_torch.utils.wavio import write_wav

    try:
        wav, _ = infer_tts(args.checkpoint, args.text, duration_scale=args.duration_scale,
                           pitch_scale=args.pitch_scale, hifigan_dir=args.hifigan_dir,
                           device=args.device)
    except (UserError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    write_wav(args.output, wav, AudioConfig().sample_rate)
    print(f"wrote {args.output} ({len(wav)} samples)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
