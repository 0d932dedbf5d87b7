"""Measured effects of the advanced controls on a trained checkpoint, on
the card.  The port's counterpart of ``tools/advanced_controls_demo.py``
(`spev_tpu_torch.diag.evidence.control_sweeps`), through
`synthesize_advanced_controls` with Griffin-Lim, phoneme bucket 64 and
frame buckets 256 and 512:

- age 10 / 25 / 45 / 70 → the median voiced F0 of the audio (pyin), beside
  the rule's multiplier ``1 + (25 - age)·0.008``;
- word emphasis "1,1,2.0,1" against none on "alpha bravo charlie delta" →
  frames;
- nasality 0 / 0.5 / 1 → the output mel's spectral tilt;
- lung capacity 1.0 / 0.6 / 0.3 → speech frames, samples and the breaths
  the planner inserts.

Writes ``advanced_controls.json`` and the sweep wavs to ``--out``.

    python tools/torch_advanced_controls_demo.py --checkpoint best.spev \\
        [--out .scratch/demo] [--text "..."] [--device cuda]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    from spev_tpu_torch.diag.evidence import CONTROL_TEXT, control_sweeps

    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--out", default=".scratch/demo")
    ap.add_argument("--text", default=CONTROL_TEXT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return control_sweeps(args.checkpoint, args.out, text=args.text, device=args.device)


if __name__ == "__main__":
    main()
