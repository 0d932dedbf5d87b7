"""The whole request: the median, over every request due in the window, of
the time from its due time to the return of `submit`."""


def read(ctx):
    return ctx.get("latency_p50_ms")
