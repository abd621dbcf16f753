"""input_idle_share (%): as launch_idle_share, for the gaps that open while
the Trainer waits for the loader's next stack (``zoo.loader_wait``) or
copies it to the card (``zoo.to_device``)."""
from perfbench.metrics.launch_idle_share import idle_share_opening_in

INPUT_SPANS = ("zoo.loader_wait", "zoo.to_device")


def read(ctx):
    return idle_share_opening_in(ctx.trace, INPUT_SPANS)
