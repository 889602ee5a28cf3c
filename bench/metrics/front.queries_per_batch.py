"""front.queries_per_batch: queries the serving front put into each
``VectorDB.query`` call, before padding to the plan bucket: the window's
attempted queries over the calls the front made in it (a span each)."""


def read(ctx):
    if not ctx.spans:
        return None
    return ctx.rec.attempted / len(ctx.spans)
