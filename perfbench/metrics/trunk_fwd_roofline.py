"""trunk_fwd_roofline (%): the least time of every trunk forward call in
the profiled stretch (trace.trunk_bound_ms on the shapes the profiler
recorded for ``lgzt::siren_trunk_fwd``), over the card time of the kernels
named ``trunk_fwd*``. Nothing to read where no trunk kernel ran."""
from perfbench.trace import trunk_roofline


def read(ctx):
    return trunk_roofline(ctx.trace, "siren_trunk_fwd", "trunk_fwd", False)
