"""The device's idle share of the traced stretches: 100 (1 - the union of
the device operations' intervals / the stretches' wall time), in %."""


def read(ctx):
    wall, busy = ctx.traced_wall_s(), ctx.busy_s()
    if wall <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / wall)
