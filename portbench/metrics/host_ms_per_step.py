"""Host ms a step of the program's own work in the window's unprofiled
calls with its spans on: the ``az.run`` spans less their ``az.chunk.read``
spans (the chunks' waits on the card), over those calls' steps
(``ctx.program_calls``, ``phases.py``)."""

from portbench import phases


def read(ctx):
    calls = phases.unprofiled(ctx)
    steps = sum(c["steps"] for c in calls)
    if not steps:
        return None
    return (phases.span_ms(calls, ("az.run",)) - phases.span_ms(calls, ("az.chunk.read",))) / steps
