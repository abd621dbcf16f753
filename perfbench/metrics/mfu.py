"""mfu (%): model FLOP/s utilisation of the whole superstep: the plain
reference's count of a superstep's matmul and convolution operations
(forward, backward, the R1 penalty's double backward; no elementwise work,
no recomputation) times the supersteps of the traced run's window outside
the profiled stretch, over their seconds (the profiler's start, stop and
trace flush left out), over the card's bf16 dense peak."""
from perfbench.trace import PEAK_BF16_FLOPS


def read(ctx):
    if not ctx.flops_per_superstep or ctx.untraced_s <= 0 \
            or ctx.untraced_supersteps <= 0:
        return None
    rate = ctx.flops_per_superstep * ctx.untraced_supersteps / ctx.untraced_s
    return 100.0 * rate / PEAK_BF16_FLOPS
