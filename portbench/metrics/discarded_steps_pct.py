"""Steps the program ran and threw away in the window (a chunk replayed
after a drift violation or a cell overflow: the tracer's
``discarded_steps``), over the window's steps, in %."""


def read(ctx):
    counters = getattr(ctx, "program_counters", None)
    if counters is None or not ctx.steps:
        return None
    return 100.0 * sum(counters.get("discarded_steps", {}).values()) / ctx.steps
