"""The window's steps over the neighbour-grid builds made in the window."""


def read(ctx):
    builds = ctx.counters["builds"]
    return ctx.steps / builds if builds > 0 else None
