"""ivf_adc_roofline: the least time of the traced window's ADC
work over the profiler's device time of every ``ivf_adc*`` grid. The least
time is the larger of the bytes at the published 3.35 TB/s and the lookups
at the derived shared-memory rate (``peaks.lookup_rate``, not a published
peak), for the work the inputs need whatever grid runs it
(``peaks.ivf_adc_work``): the codes of each probed list read once a call,
one lookup a probed row and subspace a query. The probes are those of the
program's centroids for the window's queries."""
import torch


def read(ctx):
    t = sum(s for name, s in ctx.trace["device_s"].items()
            if name.startswith("ivf_adc"))
    if t <= 0 or ctx.state is None or not ctx.rec.calls:
        return None
    args = ctx.cell.config["engine_args"]
    m, ksub = int(args["m"]), int(args["ksub"])
    nprobe, R = int(args["nprobe"]), max(int(args["refine"]),
                                         int(ctx.cell.traffic["k"]))
    cent = ctx.state["centroids"].float()
    list_rows = (ctx.state["buckets"] >= 0).sum(dim=1)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        probes = torch.topk(ctx.pool @ cent.T, nprobe, dim=1).indices
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    rate = ctx.peaks.lookup_rate(ctx.card["sms"], ctx.card["mhz"])
    bound = 0.0
    block = int(ctx.cell.traffic["block"])
    for a in ctx.rec.calls:
        n_bytes, lookups = ctx.peaks.ivf_adc_work(
            probes[a:a + block], list_rows, m=m, ksub=ksub, R=R)
        bound += ctx.peaks.adc_bound(n_bytes, lookups, rate)
    return 100.0 * bound / t
