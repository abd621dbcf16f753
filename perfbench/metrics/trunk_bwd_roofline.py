"""trunk_bwd_roofline (%): as trunk_fwd_roofline, for the backward calls
(``lgzt::siren_trunk_bwd``, which recompute the forward, pass the cotangent
down and form the weight gradients) over the card time of the kernels named
``trunk_bwd*`` (the chain, split-K and reduction kernels)."""
from perfbench.trace import trunk_roofline


def read(ctx):
    return trunk_roofline(ctx.trace, "siren_trunk_bwd", "trunk_bwd", True)
