#!/usr/bin/env python3
"""Loss-trajectory probe of the bf16-discriminator mode on one card: the
port's counterpart of ``tools/disc_bf16_probe.py``
(`spev_tpu_torch.diag.disc_bf16_probe`).

Runs the fused V3 GAN step for ``--steps`` steps with fp32 discriminators and
again with bf16 ones, from one init (``--seed``) over one synthetic batch
stream, at ``--precision`` ('default': cuDNN TF32, as the JAX tool's).

    python3 tools/torch_disc_bf16_probe.py [--steps 200] [--batch_size 16]
        [--segment_frames 32] [--precision default|high] [--seed 0]
        [--device cuda] [--out probe.jsonl]

Prints each mode's line (the trajectory at steps 1, s/4, s/2 and s, steps per
second, the last step's skip flag), the JAX tool's summary line, then the
card's name and power limit; ``--out`` appends the same three records to a
JSONL file.  Nothing is written under ``docs/``.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--segment_frames", type=int, default=32)
    ap.add_argument("--precision", default="default")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also append the lines to this JSONL file")
    return ap


def main(argv=None) -> int:
    from spev_tpu_torch.diag.disc_bf16_probe import MODES, bf16_probe

    a = parser().parse_args(argv)
    res = bf16_probe(a.steps, a.batch_size, a.segment_frames, a.precision, a.seed,
                     device=a.device)
    records = [{m: res[m]} for m in MODES] + [res["summary"], {"card": res["card"]}]
    for r in records:
        print(json.dumps(r), flush=True)
    if a.out:
        with open(a.out, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in records)
    return 0


if __name__ == "__main__":
    sys.exit(main())
