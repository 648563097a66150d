"""Device ms a step, in the marked stretches, of the operations in the
``integrate_step2`` phase that are not the program's own kernels (the flow
field before K8; ``phases.py``)."""

from portbench import phases


def read(ctx):
    return phases.phase_ms_per_step(ctx, lambda p: p == "integrate_step2", program=False)
