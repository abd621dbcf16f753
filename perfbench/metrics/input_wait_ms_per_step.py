"""input_wait_ms_per_step (ms): the training thread's time in the
Trainer's input per superstep of the profiled stretch: the host ms of its
``zoo.loader_wait`` spans (blocked on the loader's next stack) and
``zoo.to_device`` spans (the stack's copy to the card and its permute)
over the stretch's supersteps. Nothing to read where the program records
neither span."""
from perfbench.metrics.input_idle_share import INPUT_SPANS


def read(ctx):
    t = ctx.trace
    spans = [e - s for name, s, e, _ in t.host_ops if name in INPUT_SPANS]
    if not spans or t.supersteps <= 0:
        return None
    return sum(spans) / 1e3 / t.supersteps
