"""Device: the share of the traced frames' wall time in which no kernel,
copy or set runs on the card, from the union of the device intervals of
the profiler's trace."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
