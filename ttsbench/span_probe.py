"""Run one cell traced, as ``run.py --trace 1`` does, with the profiler
recording every thread, and read the program's own spans (`lib/spans.py`).

    python3 ttsbench/span_probe.py --workload <cell> --seed <n> --seconds <s>

The last line of standard output is one JSON object: the harness's result
line (its ``metrics``, ``breakdown`` and ``checks`` as ``run.py`` gives them
from the benchmark's own ranges, here on every thread), and beside it
``traced_end_to_end`` (the cell's end-to-end numbers in this traced window),
``span_metrics`` (`spans.READERS` that found something to read) and
``spans`` (`spans.reduce_spans`: host, self, device and idle seconds and
calls of each ``spev.*`` span, and ``idle_gaps_by_span``, the ten largest
idle shares).

The harness reads none of this yet: its window records the starting thread
only and keeps no batcher counter.  The probe sets three things for its own
process before the cell runs: every profiler it starts records every
thread, the run's trace reduction also reduces the program's spans, and
each ``CoalescingBatcher.stats()`` reading is kept (the first and last are
the window's before and after).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".ttsbench_cache")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def instrument(patch=setattr) -> dict:
    """Set the probe's three hooks with ``patch(owner, name, value)``;
    returns where they put what they read."""
    import torch.profiler

    from spev_tpu_torch.infer.batching import CoalescingBatcher
    from ttsbench.lib import runner, spans

    seen = {"ctx": None, "stats": []}
    patch(torch.profiler, "profile", functools.partial(
        torch.profiler.profile, experimental_config=spans.every_thread_config()))
    reduce_trace, stats = runner.Run.reduce_trace, CoalescingBatcher.stats

    def reduce_both(run, window, names):
        run.layer_ctx["spans"] = spans.reduce_spans(window.prof.profiler.kineto_results.events())
        seen["ctx"], seen["e2e"] = run.layer_ctx, run.e2e
        reduce_trace(run, window, names)

    def kept_stats(batcher):
        out = stats(batcher)
        seen["stats"].append(out)
        return out

    patch(runner.Run, "reduce_trace", reduce_both)
    patch(CoalescingBatcher, "stats", kept_stats)
    return seen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from ttsbench.lib.cells import Cell
    from ttsbench.lib.runner import emit, execute

    if not torch.cuda.is_available():
        print("no result: the probe needs a CUDA device", file=sys.stderr)
        return 2
    seen = instrument()
    result = execute(args.workload, args.seed, args.seconds, True, "cuda", T_START,
                     Cell(args.workload))
    return emit(probed(result, seen))


def probed(result: dict, seen: dict) -> dict:
    """The harness's result with the probe's readings beside it."""
    from ttsbench.lib import spans

    ctx = seen["ctx"] or {}
    if seen["stats"]:
        ctx["batcher_stats"] = (seen["stats"][0], seen["stats"][-1])
    read = {name: fn(ctx) for name, fn in spans.READERS.items()}
    sp = dict(ctx.get("spans") or {})
    sp["idle_gaps_by_span"] = spans.largest(sp.get("span_idle_s", {}))
    for key in ("batcher_stats", "steps", "audio_s", "texts"):
        if ctx.get(key):
            sp[key] = ctx[key]
    result.update(traced_end_to_end=dict(seen.get("e2e") or {}), spans=sp,
                  span_metrics={k: v for k, v in read.items() if v is not None})
    return result


if __name__ == "__main__":
    sys.exit(main())
