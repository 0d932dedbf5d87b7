"""One run of one cell: the state a traffic kind fills in, and the result line.

A kind's ``run(run)`` builds the program, warms it up, calls
`Run.setup_done` at its first timed request or step, drives the window,
calls `Run.window_closed` (the memory peak is read there, before anything
of the reference runs), frees the program's state, and hands the compared
numbers to `Run.judge`.  `execute` assembles the result line; `emit` prints it.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import time

import torch

from ttsbench.lib.cells import Cell
from ttsbench.lib.trace import Spans, reduce

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "spev_tpu"}


class Run:
    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 t_start: float):
        self.cell, self.seed, self.seconds, self.device = cell, int(seed), float(seconds), device
        self.t_start = t_start
        self.spans = Spans(trace)
        self.e2e: dict = {}
        self.layer_ctx: dict = {}
        self.checks: dict = {}
        self.correct = False
        self.attempted = self.failed = 0
        self.setup_s = None
        self.memory_peak = 0
        self.trace = None

    @property
    def cuda(self) -> bool:
        return torch.device(self.device).type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def log(self, what: str) -> None:
        """A set-up phase's end, on standard error with the seconds since start."""
        print(f"[ttsbench] {time.perf_counter() - self.t_start:.2f} s {what}", file=sys.stderr,
              flush=True)

    def setup_done(self) -> None:
        """Set-up ends here: process start to the first timed request or step."""
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start
        self.log("set-up done")

    @staticmethod
    def elapsed(window) -> float:
        return time.perf_counter() - window.t0

    def window_closed(self, window) -> None:
        window.close()
        self.layer_ctx["window_s"] = window.seconds
        if self.cuda:
            self.memory_peak = int(torch.cuda.max_memory_allocated())

    def reduce_trace(self, window, names) -> None:
        self.trace = reduce(window, set(names))
        self.layer_ctx["trace"] = self.trace
        window.prof = None

    def free(self) -> None:
        """Drop the program's cached blocks before the reference runs."""
        self.spans.close()
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    @contextlib.contextmanager
    def fp32(self):
        """Products in full fp32 (TF32 off for cuBLAS and cuDNN) inside."""
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def judge(self, numbers: dict, missing: int = 0) -> None:
        """``correct``: every answer came, and every compared number is at or
        under its limit (a NaN fails)."""
        limits = self.cell.spec["limits"]
        for name, value in numbers.items():
            self.checks[name] = {"value": float(value), "limit": float(limits[name])}
        self.checks["missing"] = {"value": float(missing), "limit": 0.0}
        self.correct = all(c["value"] <= c["limit"] for c in self.checks.values())


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def execute(cell_name: str, seed: int, seconds: float, trace: bool, device="cuda",
            t_start: float = None, cell: Cell = None) -> dict:
    """Run the cell once and return the result line's object."""
    cell = cell or Cell(cell_name)
    run = Run(cell, seed, seconds, trace, device, t_start or time.perf_counter())
    if run.cuda:
        from spev_tpu_torch.ops.cuda.build import build_all

        build_all()  # the first run in a checkout compiles; later ones find the libraries
        torch.cuda.reset_peak_memory_stats()
        run.log("kernels built or found")
    cell.kind.run(run)
    run.e2e["setup_s"] = run.setup_s
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.reader(m["name"])(run.layer_ctx)
            if _finite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": run.e2e[m["name"]], "unit": units[m["name"]]}
    dev = {"platform": "gpu" if run.cuda else "cpu",
           "kind": torch.cuda.get_device_name() if run.cuda else "cpu",
           "count": 1, "memory_peak_bytes": run.memory_peak}
    if run.cuda:
        dev["power_limit"] = _power_limit()
    result = {"correct": bool(run.correct), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = run.checks
    return result


def loaded_forbidden() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & FORBIDDEN)


def emit(result: dict) -> int:
    """Print the result line last on stdout and the checks last on stderr;
    refuse to print a result when JAX or the JAX package is loaded."""
    bad = loaded_forbidden()
    if bad:
        print(f"refused: the process holds {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
