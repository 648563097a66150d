"""The integrator's share of its roofline, in %: the summed least times of
the K7+K6 (``drift_kernel``) and K8 (``step2_kernel``) calls in the traced
stretches (``roofline/integrator.py``, each from the slot layout of its own
stretch) over their summed device time."""

import re

DRIFT = re.compile(r"(?<![A-Za-z0-9_])drift_kernel(?![A-Za-z0-9_])")
STEP2 = re.compile(r"(?<![A-Za-z0-9_])step2_kernel(?![A-Za-z0-9_])")


def read(ctx):
    roof = ctx.roofline("integrator")
    flow = ctx.params["method"].get("flow") is not None
    bound, seconds = 0.0, 0.0
    for st in ctx.stretches:
        n1, s1 = ctx.device_ops(DRIFT, stretches=[st])
        n2, s2 = ctx.device_ops(STEP2, stretches=[st])
        if not n1 or not n2:
            continue
        bound += (n1 * roof.step1_drift_s(st.n_slots, st.n_occupied)
                  + n2 * roof.step2_s(st.n_slots, st.n_occupied, flow))
        seconds += s1 + s2
    return 100.0 * bound / seconds if seconds else None
