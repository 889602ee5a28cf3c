"""db.query_host_ms: mean host milliseconds of a ``VectorDB.query`` call in
the window, from the call to its return, with no synchronize of its own
(a span each)."""


def read(ctx):
    if not ctx.spans:
        return None
    return 1e3 * sum(b - a for a, b, _ in ctx.spans) / len(ctx.spans)
