"""Device operations (kernels, copies, fills) a step in the traced stretches."""


def read(ctx):
    n, _ = ctx.device_ops()
    return n / ctx.traced_steps if n else None
