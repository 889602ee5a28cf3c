"""topk_distance_roofline: the least time of the traced window's
exact top-k calls (``peaks.topk_distance_bound`` of each call's shape, the
published HBM and float32 peaks) over the profiler's device time of the
``topk_distance`` kernels."""


def read(ctx):
    t = sum(s for name, s in ctx.trace["device_s"].items()
            if name.startswith("topk_distance"))
    if t <= 0 or not ctx.spans:
        return None
    data = ctx.cell.config["data"]
    k = int(ctx.cell.traffic["k"])
    bound = sum(ctx.peaks.topk_distance_bound(int(data["rows"]),
                                              int(data["dim"]), rows, k,
                                              False)
                for _, _, rows in ctx.spans)
    return 100.0 * bound / t
