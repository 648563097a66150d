"""Device ms a step of every operation in the traced stretches that is not
one of the program's own kernels (a ``__global__`` of its ``csrc/*.cu``):
PyTorch's kernels, copies and fills."""


def read(ctx):
    n, seconds = ctx.device_ops(program=False)
    return 1e3 * seconds / ctx.traced_steps if n else None
