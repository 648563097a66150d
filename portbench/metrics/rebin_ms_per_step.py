"""Device ms a step of the grid rebuild in the marked stretches: every
operation between a ``rebin`` phase mark and the next mark, the marks
left out (``phases.py``)."""

from portbench import phases


def read(ctx):
    return phases.phase_ms_per_step(ctx, lambda p: p == "rebin")
