"""Shared arithmetic of the per-layer metric readers in ``ttsbench/metrics/``.

A reader gets the run's context (``trace``: `trace.reduce`'s numbers, absent
in an untraced run, and what the traffic kind counted) and returns a number,
or None when it finds nothing to read: the harness then leaves the metric
out of the line.  A share of a roofline or of a peak is never 0 for want of
data: it is None.
"""

from __future__ import annotations

from ttsbench.counts.peaks import FLOPS, HBM_BYTES_PER_S


def device_idle(ctx):
    """Per cent of the traced window in which no device operation ran."""
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def device_ms_per(ctx, span: str, per: str, scale: float = 1e3):
    """Device milliseconds of the operations launched inside ``span``, per
    unit of the kind's count ``per``."""
    tr = ctx.get("trace")
    if not tr or span not in tr["device_s"] or not ctx.get(per):
        return None
    return scale * tr["device_s"][span] / ctx[per]


def host_ms_per(ctx, span: str, per: str):
    """Host milliseconds inside ``span`` per unit of ``per``."""
    tr = ctx.get("trace")
    if not tr or span not in tr["host_s"] or not ctx.get(per):
        return None
    return 1e3 * tr["host_s"][span] / ctx[per]


def roofline(ctx, bytes_key: str, seconds_key: str):
    """Per cent: the least time of the kernel's calls (their bytes at the
    HBM rate) over their device time, calls paired in launch order."""
    tr = ctx.get("trace")
    moved = ctx.get(bytes_key) or []
    times = (tr or {}).get(seconds_key) or []
    if not tr or not times or len(times) != len(moved):
        return None
    return 100.0 * (sum(moved) / HBM_BYTES_PER_S) / sum(times)


def mfu(ctx, precision: str = "tf32"):
    """Per cent of the peak of the precision the configuration states: the
    useful operations counted from shapes over the traced window."""
    tr = ctx.get("trace")
    if not tr or not ctx.get("flops"):
        return None
    return 100.0 * ctx["flops"] / (tr["window_s"] * FLOPS[precision])
