"""Rebuild segments of the window that were not a CUDA graph replay: the
captures and the first sights run eagerly."""


def read(ctx):
    return ctx.counters["captures"] + ctx.counters["eager_segments"]
