"""engine.adc_sharing: the IVF-PQ dispatch's sharing factor (visit pairs
over distinct blocks), its mean over the window's batches, from the
engine's ``adc_stats`` counters before and after the window."""


def read(ctx):
    before, after = ctx.stats
    batches = after.get("batches", 0) - before.get("batches", 0)
    if batches <= 0:
        return None
    return (after["sharing_sum"] - before["sharing_sum"]) / batches
