"""device_idle_share (%): the share of the profiled stretch in which no
kernel, copy or set ran on the card: 100 · (1 − union of their intervals /
the stretch's host seconds between its two synchronisations)."""


def read(ctx):
    t = ctx.trace
    if not t.kernels or t.stretch_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.stretch_s)
