"""Host ms a step in the writers' fires over the window (the harness's
spans around each writer's ``write``)."""


def read(ctx):
    fires = [(a, b) for n, a, b in ctx.spans.spans
             if n.startswith("write.") and ctx.window_t0 <= a <= ctx.window_t1]
    if not fires:
        return None
    return 1e3 * sum(b - a for a, b in fires) / ctx.steps
