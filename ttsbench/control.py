"""Readings that the limits of ``correct`` are set from, for one cell, in one
process (the import and the CUDA context paid once):

- the program's: full runs of the cell (`runner.execute`, untraced) on
  ``--seeds`` seeds, each a window of ``--seconds``;
- the control's: the plain reference put in the program's place at the
  precision below the configuration's (bfloat16 under autocast), on
  ``--control-seeds`` seeds, over the rows a run would check;
- a training cell's faults (``--faults half_batch``), planted in the
  reference put in the program's place.

    python3 ttsbench/control.py --workload v1-batch --seeds 12 --control-seeds 3 \\
        --seconds 3 --out readings/v1-batch.jsonl

Each reading is a JSON line; the summary (the program's largest and the
control's smallest reading of each number) is the last line.  The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=2_500_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    from ttsbench.lib.cells import Cell, benchmark
    from ttsbench.lib.runner import execute

    cell = Cell(args.workload)
    run_seconds = benchmark()["run_seconds"]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    lines = []

    def put(row):
        lines.append(row)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)

    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        r = execute(args.workload, seed, args.seconds, False, args.device, time.perf_counter(),
                    cell)
        put({"who": "program", "seed": seed, "correct": r["correct"],
             "numbers": {k: v["value"] for k, v in r["checks"].items()},
             "metrics": {k: v["value"] for k, v in r["metrics"].items()}})
    for variant, n in [("bf16", args.control_seeds)] + [(f, args.control_seeds) for f in args.faults]:
        for i in range(n):
            seed = args.first_seed + 104729 * (i + 1)
            numbers = cell.kind.control(cell, seed, args.device, variant, run_seconds)
            put({"who": variant, "seed": seed, "numbers": numbers})
    summary = {}
    for row in lines:
        for k, v in row["numbers"].items():
            s = summary.setdefault(k, {})
            key = "program_max" if row["who"] == "program" else f"{row['who']}_min"
            s[key] = max(s.get(key, v), v) if row["who"] == "program" else min(s.get(key, v), v)
    put({"who": "summary", "numbers": {}, "summary": summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
