"""K1's share of its roofline, in %: the least time of its calls
(``roofline/pair.py``, each from the pairs inside the cutoff and the slot
layout of its own traced stretch) over K1's device time in the traced
stretches."""

import re

K1 = re.compile(r"(?<![A-Za-z0-9_])cell_pair_force_kernel(?![A-Za-z0-9_])")


def read(ctx):
    roof, bound, seconds = ctx.roofline("pair"), 0.0, 0.0
    for st in ctx.stretches:
        n, s = ctx.device_ops(K1, stretches=[st])
        if not n or not st.pairs:
            continue
        bound += n * roof.bound_s(ctx.params["pair"]["potential"], st.n_occupied, st.n_slots,
                                  ctx.n_types, st.pairs)
        seconds += s
    return 100.0 * bound / seconds if seconds else None
