"""Host ms a step of the segment graph cache's churn in the window's
unprofiled calls with the program's spans on: its spans
``az.segment.first`` (a segment shape's eager first sight),
``az.segment.capture`` and ``az.runner.build``, over those calls' steps
(``ctx.program_calls``, ``phases.py``)."""

from portbench import phases


def read(ctx):
    calls = phases.unprofiled(ctx)
    steps = sum(c["steps"] for c in calls)
    return phases.span_ms(calls, phases.CHURN) / steps if steps else None
