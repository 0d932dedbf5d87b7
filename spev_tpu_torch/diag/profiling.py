"""Profiling, the program's spans and step timing.  Counterpart of
``spev_tpu.diag.profiling``.

- ``span(name)``: the program's span at a layer boundary.  While a profiler
  records, a ``torch.profiler.record_function`` range, on the profiler's
  clock beside the device operations the thread launches inside it; with
  none recording, one shared no-op context (no range, no allocation).
  ``spanned(name)`` puts every call of a function inside one.
- ``trace(log_dir)``: a context manager around ``torch.profiler`` (host and,
  when a GPU is present, device activity) on every thread of the process,
  so a serving trace shows the batcher's worker, that writes a Chrome
  trace, ``<log_dir>/trace.json`` (open it in Perfetto or
  ``chrome://tracing``).
- ``StepTimer`` / ``timed_steps``: per-step wall times that end in
  ``torch.cuda.synchronize()`` when the step returned a CUDA tensor, with
  warm-up steps discarded.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Callable, Iterable, List

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records
    (on any thread: the flag is the process's), else the shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def trace(log_dir: str = "spev_trace"):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=activities, experimental_config=every_thread) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _on_card(out) -> bool:
    """Whether a step's result holds a CUDA tensor (in a tuple, list or dict)."""
    if torch.is_tensor(out):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_on_card(v) for v in out.values())
    if isinstance(out, (tuple, list)):
        return any(_on_card(v) for v in out)
    return False


class StepTimer:
    """Accumulates per-step wall times."""

    def __init__(self):
        self.times: List[float] = []

    def record(self, fn: Callable, *args, **kw):
        """Time ``fn(*args, **kw)`` to the end of its device work."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if _on_card(out):
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)
        return out

    def summary(self, warmup: int = 1) -> dict:
        t = self.times[warmup:] if len(self.times) > warmup else self.times
        if not t:
            return {"steps": 0}
        return {"steps": len(t), "mean_s": sum(t) / len(t), "min_s": min(t), "max_s": max(t)}


def timed_steps(fn: Callable, args_iter: Iterable, warmup: int = 1) -> dict:
    timer = StepTimer()
    for args in args_iter:
        timer.record(fn, *args)
    return timer.summary(warmup)
