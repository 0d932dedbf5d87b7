"""Find the knee of an open-loop cell: the highest offered rate at which the
completed rate keeps up with the offered one and no backlog grows.

One process builds and warms the cell's program once, then offers each rate
of ``--rates`` for ``--seconds`` (the cell's traffic: Poisson arrivals of
LJSpeech-length texts through `CoalescingBatcher.submit`) and prints a line
per rate: offered and completed requests a second, median and 95th
percentile latency, and the growth of the median from the window's first
quarter of requests to its last.

    python3 ttsbench/sweep.py --workload v1-open --rates 20 30 40 50 --seconds 10

Run once when a cell is defined; the cell's file then states its rate as a
number.  The benchmark's own runs never run this.
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
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1_234_567_891)
    args = ap.parse_args(argv)

    import numpy as np

    from spev_tpu_torch.infer.batching import CoalescingBatcher
    from spev_tpu_torch.ops.cuda.build import build_all
    from ttsbench.lib import program
    from ttsbench.lib.cells import Cell
    from ttsbench.traffic.texts import TextGenerator

    cell = Cell(args.workload)
    kind, p = cell.kind, dict(cell.spec["params"])
    build_all()
    synth, *_ = program.synthesizer(cell.config, args.seed, "cuda")
    texts = TextGenerator(args.seed, p["phonemes_per_audio_s"], p["audio_s"], p["beta"])
    kind.warm_up(synth, texts, p)
    batcher = CoalescingBatcher(synth, max_batch=p["max_batch"], window_ms=p["window_ms"])
    for rate in args.rates:
        p["rate_per_s"] = rate
        due, requests, _ = kind.plan(texts, args.seed, p, args.seconds)
        s0 = batcher.stats()
        t0 = time.perf_counter()
        out = kind.drive(batcher, requests, due, p, args.seconds, set(), t0)
        lat = out["latency"]
        done = np.isfinite(lat)
        span = float(np.nanmax(due + lat) if done.any() else args.seconds)
        q = len(lat) // 4
        row = {"offered_per_s": rate, "requests": len(lat), "completed": int(done.sum()),
               "completed_per_s": float(done.sum() / span),
               "p50_ms": float(np.percentile(out["waited"], 50) * 1e3),
               "p95_ms": float(np.percentile(out["waited"], 95) * 1e3),
               "median_growth": float(np.nanmedian(lat[-q:]) / np.nanmedian(lat[:q])),
               "late_p95_ms": float(np.percentile(out["late"], 95) * 1e3),
               "rows_mean": kind.mean_rows(s0, batcher.stats())}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
