"""elementwise_ms_per_step (ms): card time per superstep in kernels that the
kernel-class table (trace.KINDS) classes as elementwise."""


def read(ctx):
    t = ctx.trace
    if not t.kernels or t.supersteps <= 0:
        return None
    return t.ms_by_kind().get("elementwise", 0.0) / t.supersteps
