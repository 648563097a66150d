"""Device ms a step, in the marked stretches, of the operations in the
``updater.*`` phases that are not the program's own kernels (the masked
pick around K4; ``phases.py``)."""

from portbench import phases


def read(ctx):
    return phases.phase_ms_per_step(ctx, lambda p: p.startswith("updater."), program=False)
