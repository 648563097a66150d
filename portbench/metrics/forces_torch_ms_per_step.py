"""Device ms a step, in the marked stretches, of the operations in the
``force.*`` phases that are not the program's own kernels (the barrier,
the wall, the net-force sums; ``phases.py``)."""

from portbench import phases


def read(ctx):
    return phases.phase_ms_per_step(ctx, lambda p: p.startswith("force."), program=False)
