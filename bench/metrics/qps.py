"""qps: queries whose results reached the host inside the window, over the
window's seconds."""


def read(ctx):
    return ctx.rec.completed_in_window / ctx.seconds
