"""superstep_host_ms (ms): the mean host ms of the program's
``zoo.superstep`` spans in the profiled stretch: the training thread's
time to enqueue one superstep (runtime/steps.py::superstep), to hold
against the card's busy time per superstep. Nothing to read where the
program records no such span."""


def read(ctx):
    spans = [e - s for name, s, e, _ in ctx.trace.host_ops
             if name == "zoo.superstep"]
    if not spans:
        return None
    return sum(spans) / len(spans) / 1e3
