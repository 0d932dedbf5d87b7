"""Run one cell of the benchmark of ``spev_tpu_torch`` once, on the card.

    python3 ttsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json`` and ``ttsbench/workloads/``;
its configuration, traffic kind and metric readers by the names there.  The
last line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks``, each compared number with its limit); the checks are also the
last lines of standard error.  Without a card, or with fewer cards than the
cell asks for, the run exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".ttsbench_cache")
# every build and kernel cache at a fixed place inside the checkout
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from ttsbench.lib.cells import Cell
    from ttsbench.lib.runner import emit, execute

    cell = Cell(args.workload)
    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"no result: the cell needs {need} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                     T_START, cell)
    return emit(result)


if __name__ == "__main__":
    sys.exit(main())
