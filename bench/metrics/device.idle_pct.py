"""device.idle_pct: share of the traced window in which no kernel, copy or
set ran on the card (the union of the profiler's device intervals)."""


def read(ctx):
    w = ctx.trace["window_s"]
    if w <= 0 or not ctx.trace["device_s"]:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / w)
