"""The embodied agent's commands (counterpart of ``spev_tpu.cli.embodied``):
``main`` is ``spev-embodied`` (static knobs), ``temporal_main`` is
``spev-temporal`` (per-phoneme curves).

    python -m spev_tpu_torch.cli.embodied --text "I made it [sigh] but I am tired" \
        --emotion exhausted --checkpoint best.spev [--hifigan_dir DIR] \
        [--device cuda] [--output embodied_output.wav]

A ``--hifigan_dir`` without a HiFi-GAN checkpoint gives the Griffin-Lim
vocoder.  Errors caused by the input exit with status 2 and one ``error:``
line.
"""

from __future__ import annotations

import argparse
import sys

from spev_tpu_torch.cli.common import cli_guard

STATIC_EMOTIONS = ["neutral", "exhausted", "excited", "secretive", "angry"]
TEMPORAL_EMOTIONS = ["neutral", "exhausted", "relief", "anxious", "angry"]


def build_parser(temporal: bool) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="spev-temporal" if temporal else "spev-embodied")
    p.add_argument("--text", type=str, required=True,
                   help="Text with events, e.g. 'Hi [sigh] bye'")
    p.add_argument("--emotion", type=str, default="neutral",
                   choices=TEMPORAL_EMOTIONS if temporal else STATIC_EMOTIONS)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--hifigan_dir", type=str, default="./hifi-gan")
    p.add_argument("--output", type=str,
                   default="temporal_output.wav" if temporal else "embodied_output.wav")
    p.add_argument("--device", type=str, default="cuda")
    return p


def _run(temporal: bool, argv=None) -> int:
    from spev_tpu_torch.agents.embodied import EmbodiedAgent
    from spev_tpu_torch.utils.wavio import write_wav

    args = build_parser(temporal).parse_args(argv)
    agent = EmbodiedAgent(args.checkpoint, hifigan_dir=args.hifigan_dir, temporal=temporal,
                          device=args.device)
    audio = agent.synthesize(args.text, args.emotion)
    write_wav(args.output, audio, agent.sr)
    print(f"Output saved to {args.output}")
    return 0


@cli_guard
def main(argv=None) -> int:
    """``spev-embodied``."""
    return _run(temporal=False, argv=argv)


@cli_guard
def temporal_main(argv=None) -> int:
    """``spev-temporal``."""
    return _run(temporal=True, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
