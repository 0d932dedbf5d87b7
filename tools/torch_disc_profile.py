#!/usr/bin/env python3
"""Per-sub-discriminator cost profile on one card: the port's counterpart
of ``tools/tpu_disc_profile.py``, with its flags and JSON rows
(`spev_tpu_torch.diag.disc_profile`).

Times each MPD period and MSD scale alone, forward and forward+backward
(parameter gradients), at the given precision and dtype: each graph runs
twice, then ``--n_iter`` calls between CUDA events.

    python3 tools/torch_disc_profile.py [--batch_size 16] [--segment 8192]
        [--n_iter 30] [--precision default|high] [--dtype f32|bf16]
        [--device cuda] [--out rows.jsonl]

Prints one JSON line per sub-discriminator, then the totals line with the
card's name and power limit; ``--out`` writes the same lines to a JSONL
file, which ``tools/torch_disc_roofline.py`` reads.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--segment", type=int, default=8192)
    ap.add_argument("--n_iter", type=int, default=30)
    ap.add_argument("--precision", default="default")
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                    help="bf16 casts the wav and the discriminators' weights (the "
                         "--disc_dtype trainer mode)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the rows to this JSONL file")
    return ap


def main(argv=None) -> int:
    from spev_tpu_torch.diag.disc_profile import time_sub_discriminators

    a = parser().parse_args(argv)
    rows = time_sub_discriminators(a.batch_size, a.segment, a.n_iter, a.precision, a.dtype,
                                   device=a.device)
    for r in rows:
        print(json.dumps(r), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
