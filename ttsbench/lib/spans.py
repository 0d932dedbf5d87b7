"""The program's own spans in a traced window, and the numbers they give.

``spev_tpu_torch`` opens a ``record_function`` range at each layer boundary
while a profiler records (`spev_tpu_torch.diag.profiling.span`, names
``spev.*``), on whichever thread runs the layer: the caller, the
``CoalescingBatcher`` worker, the prefetch consumer.  `torch.profiler`
records host ranges only on the thread that started it unless it is asked
for every thread (`every_thread_config`), so a window that reads these spans is
profiled with that setting.  `trace.reduce` reads the benchmark's own
ranges; `reduce_spans` reads the program's, from the same events:

- ``span_host_s``, ``span_calls``: each span's host seconds and calls, cut
  to the window; ``span_self_s``: the part of those seconds in which no
  child span was open on its thread (so it is at most ``span_host_s``);
- ``span_device_s``: the device seconds of the operations whose launch came
  while the span was the innermost open on the launching thread.  A launch
  from a thread with no program span open (autograd's device thread, which
  runs a backward on CUDA) goes to the innermost span most recently opened
  on any thread, and is counted again in ``adopted_device_s``;
  ``owned_device_s`` is the union of every attributed operation;
- ``span_idle_s``: every instant of the window with no device operation,
  named by the innermost span open at that instant on the thread that
  launched the last operation before the gap (chosen as launches are when
  that thread has no span open at the gap's start; when no thread has one,
  the thread that launches the operation after it), else ``OUTSIDE``.  The
  values add up to the window's idle seconds.

The readers at the end turn them into per-layer numbers; each returns None
when the context holds nothing to read (an untraced run, a program without
the spans, a batcher without the counter).
"""

from __future__ import annotations

import bisect

import torch

from ttsbench.lib.trace import WINDOW

PREFIX = "spev."
OUTSIDE = "outside any span"
BATCHER_WAIT = "spev.batcher.wait"


def every_thread_config():
    """The profiler's setting that records host ranges on every thread."""
    return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)


def _timeline(rows) -> list:
    """(start, end, name, span start) segments of one thread's nested spans,
    each naming the innermost span open over it; instants with no span open
    have no segment.  A child that outlasts its parent (clock rounding) is
    cut at the parent's end."""
    segs, stack, t = [], [], None
    for a, b, name in sorted(rows, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= a:
            end, nm, st = stack.pop()
            if end > t:
                segs.append((t, end, nm, st))
                t = end
        if stack:
            if a > t:
                segs.append((t, a, stack[-1][1], stack[-1][2]))
            b = min(b, stack[-1][0])
        stack.append((b, name, a))
        t = a
    while stack:
        end, nm, st = stack.pop()
        if end > t:
            segs.append((t, end, nm, st))
            t = end
    return segs


class _Threads:
    """Every thread's timeline of innermost spans, for lookups by time."""

    def __init__(self, spans):
        rows: dict = {}
        for tid, a, b, name in spans:
            rows.setdefault(tid, []).append((a, b, name))
        self.segs = {tid: _timeline(r) for tid, r in rows.items()}
        self.starts = {tid: [s[0] for s in segs] for tid, segs in self.segs.items()}

    def at(self, tid, t):
        """The segment of ``tid`` open at ``t``, or None."""
        segs = self.segs.get(tid)
        if not segs:
            return None
        i = bisect.bisect_right(self.starts[tid], t) - 1
        return segs[i] if i >= 0 and t < segs[i][1] else None

    def owner(self, tid, t):
        """(thread, segment) that owns an event of ``tid`` at ``t``: its own
        innermost span, else the innermost span most recently opened on any
        thread; (None, None) when no span is open anywhere."""
        seg = self.at(tid, t)
        if seg is not None:
            return tid, seg
        best = (None, None)
        for other in self.segs:
            s = self.at(other, t)
            if s is not None and (best[1] is None or s[3] > best[1][3]):
                best = (other, s)
        return best

    def sweep(self, tid, a, b, into: dict) -> None:
        """Add to ``into`` the seconds of [a, b) under each innermost span of
        ``tid``, the rest under `OUTSIDE`."""
        covered = 0
        segs = self.segs.get(tid)
        if segs:
            i = max(bisect.bisect_right(self.starts[tid], a) - 1, 0)
            while i < len(segs) and segs[i][0] < b:
                lo, hi = max(segs[i][0], a), min(segs[i][1], b)
                if hi > lo:
                    into[segs[i][2]] = into.get(segs[i][2], 0.0) + (hi - lo) / 1e9
                    covered += hi - lo
                i += 1
        if b - a > covered:
            into[OUTSIDE] = into.get(OUTSIDE, 0.0) + (b - a - covered) / 1e9


def _union(intervals) -> tuple:
    """(covered ns, merged [start, end, index of the pair that starts it,
    index of the pair that ends it]) of (start, end) pairs sorted by start."""
    merged = []
    for k, (a, b) in enumerate(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1], merged[-1][3] = b, k
        else:
            merged.append([a, b, k, k])
    return sum(m[1] - m[0] for m in merged), merged


def reduce_spans(events) -> dict:
    """The program's spans in the traced window of ``events`` (a profile's
    ``kineto_results.events()``, its window the benchmark's `WINDOW`
    range); the keys are the module's."""
    w0 = w1 = None
    spans, ops, launches = [], [], {}
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((e.start_ns(), e.end_ns(), e.correlation_id()))
        elif e.is_user_annotation():
            if name == WINDOW:
                w0, w1 = e.start_ns(), e.end_ns()
            elif name.startswith(PREFIX):
                spans.append((e.start_thread_id(), e.start_ns(), e.end_ns(), name))
        elif name.startswith("cu"):
            launches[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
    if w0 is None:
        raise RuntimeError("the trace holds no window range")
    spans = [(tid, max(a, w0), min(b, w1), n) for tid, a, b, n in spans if b > w0 and a < w1]
    threads = _Threads(spans)
    host, calls, own = {}, {}, {}
    for _, a, b, n in spans:
        host[n] = host.get(n, 0.0) + (b - a) / 1e9
        calls[n] = calls.get(n, 0) + 1
    for segs in threads.segs.values():
        for a, b, n, _ in segs:
            own[n] = own.get(n, 0.0) + (b - a) / 1e9

    ops = sorted((max(a, w0), min(b, w1), c) for a, b, c in ops if b > w0 and a < w1)
    per_span, adopted, owned, op_thread = {}, [], [], []
    for a, b, c in ops:
        launch = launches.get(c)
        tid, seg = threads.owner(*launch) if launch else (None, None)
        op_thread.append(launch[0] if launch else None)
        if seg is None:
            continue
        per_span.setdefault(seg[2], []).append((a, b))
        owned.append((a, b))
        if tid != launch[0]:
            adopted.append((a, b))

    busy, merged = _union((a, b) for a, b, _ in ops)
    idle: dict = {}
    gap_start, last_tid = w0, None
    for a, b, first, last in merged + [[w1, w1, None, None]]:
        if a > gap_start:
            tid = threads.owner(last_tid, gap_start)[0]
            if tid is None and first is not None:
                tid = op_thread[first]
            threads.sweep(tid, gap_start, a, idle)
        gap_start = b
        last_tid = op_thread[last] if last is not None else None
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "span_host_s": host,
        "span_self_s": own,
        "span_calls": calls,
        "span_device_s": {n: _union(sorted(v))[0] / 1e9 for n, v in per_span.items()},
        "span_idle_s": idle,
        "adopted_device_s": _union(sorted(adopted))[0] / 1e9,
        "owned_device_s": _union(sorted(owned))[0] / 1e9,
    }


def largest(values: dict, n: int = 10) -> list:
    """The ``n`` largest entries of a {name: seconds} map, as [name, seconds]."""
    return [[k, v] for k, v in sorted(values.items(), key=lambda kv: -kv[1])[:n]]


# -- readers: ctx is a run's layer context with ``spans`` (`reduce_spans`)
# and, for an open-loop run, ``batcher_stats`` (before and after the window)


def idle_ms_per(ctx, names, per: str):
    """Idle milliseconds named by any span of ``names`` per unit of ``per``."""
    sp = ctx.get("spans")
    if not sp or not ctx.get(per) or not any(n in sp["span_host_s"] for n in names):
        return None
    return 1e3 * sum(sp["span_idle_s"].get(n, 0.0) for n in names) / ctx[per]


def host_ms_per(ctx, name: str, per: str):
    """Host milliseconds inside ``name`` per unit of ``per``."""
    sp = ctx.get("spans")
    if not sp or name not in sp["span_host_s"] or not ctx.get(per):
        return None
    return 1e3 * sp["span_host_s"][name] / ctx[per]


def device_ms_per(ctx, name: str, per: str):
    """Device milliseconds attributed to ``name`` per unit of ``per``."""
    sp = ctx.get("spans")
    if not sp or name not in sp["span_device_s"] or not ctx.get(per):
        return None
    return 1e3 * sp["span_device_s"][name] / ctx[per]


def queue_wait_ms(ctx):
    """Mean milliseconds from `submit` to the close of the batch that took
    the request, over the window's requests (`CoalescingBatcher.stats()`)."""
    before, after = ctx.get("batcher_stats") or (None, None)
    if not after or "requests" not in after:
        return None
    n = after["requests"] - before["requests"]
    return 1e3 * (after["queue_wait_s"] - before["queue_wait_s"]) / n if n else None


def queued_idle(ctx):
    """Per cent of the window with no device operation while the batcher's
    worker was in a span other than its wait for a first request."""
    sp = ctx.get("spans")
    if not sp or not any(k.startswith("spev.batcher.") for k in sp["span_host_s"]):
        return None
    held = sum(v for k, v in sp["span_idle_s"].items() if k not in (BATCHER_WAIT, OUTSIDE))
    return 100.0 * held / sp["window_s"]


ACOUSTIC = ("spev.synth.acoustic", "spev.fs2.encoder", "spev.fs2.variance", "spev.fs2.decoder")
UPDATE = ("spev.train.update", "spev.train.host_read")

READERS = {
    "queue_wait_ms.open": queue_wait_ms,
    "queued_idle.open": queued_idle,
    "acoustic_idle_ms_per_audio_s.batch": lambda ctx: idle_ms_per(ctx, ACOUSTIC, "audio_s"),
    "data_wait_ms_per_step.train": lambda ctx: host_ms_per(ctx, "spev.train.data_wait",
                                                           "steps"),
    "update_idle_ms_per_step.train": lambda ctx: idle_ms_per(ctx, UPDATE, "steps"),
    "backward_device_ms_per_step.train": lambda ctx: device_ms_per(ctx, "spev.train.backward",
                                                                   "steps"),
}
