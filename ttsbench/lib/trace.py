"""The benchmark's spans and the reduction of a device trace to numbers.

`Spans` wraps calls into the program's layers in ``record_function`` ranges
(the benchmark's own spans: the program carries none) and, while a window is
traced, records each call of the length-regulator kernels with its shapes.
`reduce` reads the profiler's raw events once the window has closed:

- device operations are the CUDA events that are not annotations (kernels,
  copies, sets), cut to the traced window;
- each is attributed to the innermost benchmark range open on the host
  thread that launched it (the launch is the runtime call with the same
  correlation id), so a layer's device time is the union of its operations'
  intervals;
- busy time is the union of all of them (``chip_smoke._profile_stats``'s
  interval union, taken over the traced window itself);
- idle gaps are named by the innermost range open on any host thread when
  the gap began.

Nothing is written to disk: the trace stays in memory.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import time
import torch

WINDOW = "ttsbench.window"
K1_NAME = "lr_fused_kernel"
K1B_NAME = "lr_fused_bwd_kernel"


class Spans:
    """Benchmark ranges around the program's layers; inert when ``on`` is
    False, so an untraced run pays nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.k1_calls: list = []
        self.k1b_calls: list = []
        self.recording = False
        self._undo: list = []

    def range(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def wrap(self, obj, attr: str, name: str) -> None:
        """Put ``obj.attr`` (a bound method) inside a range named ``name``."""
        if not self.on:
            return
        inner = getattr(obj, attr)

        @functools.wraps(inner)
        def spanned(*a, **k):
            with torch.profiler.record_function(name):
                return inner(*a, **k)

        setattr(obj, attr, spanned)

    def record_kernels(self) -> None:
        """Record the shapes of every K1 and K1b call while ``recording``
        (the kernels' entry points, as the length regulator calls them)."""
        if not self.on:
            return
        from spev_tpu_torch.ops import length_regulator as lr

        fwd, bwd = lr.lr_fused, lr.lr_fused_bwd

        def k1(x, fpad, ends, max_frames):
            if self.recording and x.is_cuda:
                self.k1_calls.append((tuple(x.shape), int(fpad.shape[-1]), int(max_frames), ends))
            return fwd(x, fpad, ends, max_frames)

        def k1b(gx, gf, ends, T):
            if self.recording and gx.is_cuda:
                self.k1b_calls.append((tuple(gx.shape), int(gf.shape[-1]), int(T), ends))
            return bwd(gx, gf, ends, T)

        lr.lr_fused, lr.lr_fused_bwd = k1, k1b
        self._undo.append(lambda: (setattr(lr, "lr_fused", fwd), setattr(lr, "lr_fused_bwd", bwd)))

    def close(self) -> None:
        for undo in self._undo:
            undo()
        self._undo.clear()


class Window:
    """The measured window: host-clock bounds, and under ``trace`` the
    profiler around it."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None
        self.t0 = self.t1 = None
        self._range = None

    def __enter__(self):
        if self.spans.on:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if torch.cuda.is_available() else [])
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self._range = torch.profiler.record_function(WINDOW)
            self._range.__enter__()
            self.spans.recording = True
        self.t0 = time.perf_counter()
        return self

    def close(self):
        """End the window (after the caller's last synchronisation)."""
        if self.t1 is not None:
            return
        self.t1 = time.perf_counter()
        if self.prof is not None:
            self.spans.recording = False
            self._range.__exit__(None, None, None)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def _union(intervals) -> tuple:
    """(covered ns, merged intervals) of sorted (start, end) pairs."""
    merged = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


class _Ranges:
    """Benchmark ranges per host thread, for innermost-range lookups (ranges
    on one thread nest)."""

    def __init__(self, ranges):
        self.rows: dict = {}
        for tid, a, b, name in ranges:
            self.rows.setdefault(tid, []).append((a, -b, name))
        self.starts, self.parent = {}, {}
        for tid, rows in self.rows.items():
            rows.sort()
            parent, stack = [], []
            for i, (a, nb, _) in enumerate(rows):
                while stack and -rows[stack[-1]][1] < a:
                    stack.pop()
                parent.append(stack[-1] if stack else -1)
                stack.append(i)
            self.starts[tid] = [r[0] for r in rows]
            self.parent[tid] = parent

    def innermost(self, tid, t):
        """(start, name) of the innermost range open on ``tid`` at ``t``."""
        rows = self.rows.get(tid)
        if not rows:
            return None
        i = bisect.bisect_right(self.starts[tid], t) - 1
        while i >= 0 and -rows[i][1] < t:
            i = self.parent[tid][i]
        return (rows[i][0], rows[i][2]) if i >= 0 else None

    def name(self, tid, t):
        found = self.innermost(tid, t)
        return found[1] if found else None

    def any_thread(self, t) -> str:
        """The innermost range below the window open on any thread at ``t``."""
        best = None
        for tid in self.rows:
            found = self.innermost(tid, t)
            if found and found[1] != WINDOW and (best is None or found[0] > best[0]):
                best = found
        return best[1] if best else "outside any range"


def reduce(window: Window, names: set) -> dict:
    """The traced window's numbers: ``window_s``, ``busy_s``, device seconds
    per range (``device_s``), host seconds and calls per range (``host_s``,
    ``host_calls``), K1 and K1b device seconds per call in time order,
    ``device_ops`` and ``idle_gaps`` (each the ten largest, in seconds)."""
    events = window.prof.profiler.kineto_results.events()
    w0 = w1 = None
    launches, ranges, ops = {}, [], []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((e.start_ns(), e.end_ns(), name, e.correlation_id()))
        elif e.is_user_annotation():
            if name == WINDOW:
                w0, w1 = e.start_ns(), e.end_ns()
            if name in names or name == WINDOW:
                ranges.append((e.start_thread_id(), e.start_ns(), e.end_ns(), name))
        elif name.startswith("cu"):
            launches[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
    if w0 is None:
        raise RuntimeError("the trace holds no window range")
    ops = sorted((max(a, w0), min(b, w1), n, c) for a, b, n, c in ops if b > w0 and a < w1)
    lookup = _Ranges(ranges)
    per_range: dict = {}
    by_name: dict = {}
    k1, k1b = [], []
    for a, b, n, c in ops:
        launch = launches.get(c)
        owner = lookup.name(*launch) if launch else None
        per_range.setdefault(owner, []).append((a, b))
        by_name[n] = by_name.get(n, 0) + (b - a)
        if K1B_NAME in n:
            k1b.append((b - a) / 1e9)
        elif K1_NAME in n:
            k1.append((b - a) / 1e9)
    busy, merged = _union((a, b) for a, b, _, _ in ops)
    gaps: dict = {}
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for gs, ge in zip(edges[0::2], edges[1::2]):
        if ge > gs:
            key = lookup.any_thread(gs)
            gaps[key] = gaps.get(key, 0) + (ge - gs)
    host_s, host_calls = {}, {}
    for tid, a, b, n in ranges:
        if n != WINDOW and b > w0 and a < w1:
            host_s[n] = host_s.get(n, 0.0) + (min(b, w1) - max(a, w0)) / 1e9
            host_calls[n] = host_calls.get(n, 0) + 1
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "device_s": {k: _union(sorted(v))[0] / 1e9 for k, v in per_range.items()
                     if k is not None},
        "host_s": host_s,
        "host_calls": host_calls,
        "k1_s": k1,
        "k1b_s": k1b,
        "device_ops": [[n, t / 1e9] for n, t in sorted(by_name.items(),
                                                        key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[n, t / 1e9] for n, t in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    }
