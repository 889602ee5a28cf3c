"""setup_s: seconds from the process's start (``run.py``'s first line) to
the window's start: imports, the card's start, the collection, the
system's load and the warm-up."""


def read(ctx):
    return ctx.rec.t_start - ctx.t_process
