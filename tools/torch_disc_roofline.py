#!/usr/bin/env python3
"""Per-sub-discriminator roofline table: the port's counterpart of
``tools/disc_roofline.py`` (`spev_tpu_torch.diag.disc_roofline`).

Reads the rows of ``tools/torch_disc_profile.py`` (one or more JSONL files,
each row tagged with its precision and dtype), sets each sub-discriminator's
analytic FLOPs and bytes at ``--batch`` × ``--segment`` against its forward
time and prints a markdown table: achieved TF/s and GB/s and which limit
binds, with its share of the H100's published peak for that row's precision
and dtype (``--peak_tflops`` / ``--hbm_gbs`` override them for every row).
No device is used.

    python3 tools/torch_disc_roofline.py rows.jsonl [more.jsonl ...] [--batch 16]
        [--segment 8192] [--peak_tflops T] [--hbm_gbs G] [--out roofline.jsonl]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("jsonl", nargs="+")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--segment", type=int, default=8192)
    # the JAX tool's defaults are a TPU's peaks; None takes the H100's per row
    ap.add_argument("--peak_tflops", type=float, default=None)
    ap.add_argument("--hbm_gbs", type=float, default=None)
    ap.add_argument("--out", default=None, help="also write each row's roofline to this JSONL")
    return ap


def main(argv=None) -> int:
    from spev_tpu_torch.diag.disc_roofline import roofline, roofline_table

    a = parser().parse_args(argv)
    rows = []
    for path in a.jsonl:
        with open(path) as f:
            rows += [json.loads(line) for line in f if line.strip()]
    print(roofline_table(rows, a.batch, a.segment, a.peak_tflops, a.hbm_gbs))
    cards = sorted({r["card"] for r in rows if r.get("card")})
    if cards:
        print("card: " + "; ".join(cards))
    if a.out:
        with open(a.out, "w") as f:
            f.writelines(json.dumps(e) + "\n"
                         for e in roofline(rows, a.batch, a.segment, a.peak_tflops, a.hbm_gbs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
