"""CUDA graphs over a pure piece of a training loss.

``GraphedCalls`` runs ``fn(module, *inputs)``, a function of tensors that
returns a tuple of tensors and depends on nothing but its inputs, the
parameters of the module it calls and Python values fixed by the caller's
key: it draws no random number, synchronises nothing with the host, runs no
collective and updates no buffer. π-GAN's and ANIGAN's discriminator side
of each loss is such a function (tasks/nerf_gan.py). Where the call may
replay (``replayable``), the first call with a key warms ``fn`` up on a side
stream, then captures its forward and its backward (``torch.autograd.grad``
of the outputs that need a gradient, with respect to the inputs and
parameters that take one) as two CUDA graphs in one private memory pool;
that call and every later one with the key copy the inputs into the
graphs' own, replay the forward, and the backward replays when autograd
reaches it, as ``torch.cuda.make_graphed_callables`` does. Elsewhere ``fn``
runs as it is. The key joins the caller's to what the call can observe:
the autocast state, each input's shape, strides, dtype and
``requires_grad``, and which parameters take a gradient.

What keeps a replay equal to the eager call, bit for bit:

  * The graphs read the parameters' storage. The capture calls the module
    with a detached alias of each parameter, so that the captured backward
    ends in gradient accumulators of its own, on the capture stream,
    whatever autograd graph of the parameters is still alive. A call that
    finds a parameter moved captures anew. Under fsdp the parameters are
    freed and gathered again every superstep, so it runs eagerly, and so
    does tensor parallelism, whose hooks inside the module run collectives.
  * Autocast's cache of weight casts is cleared before and after each
    capture, so every cast the function makes is a kernel of the graph,
    made from the weights of the moment at each replay, and casts that
    ``fn`` shares between its passes stay shared, as they are eagerly. A
    cast cached before the capture would otherwise be read, stale, by
    every replay.
  * The backward is captured outside autocast, where the superstep runs
    it: a double backward (R1's) calls convolutions that autocast would
    otherwise cast to bf16.
  * The outputs and the gradients are copied out of the graphs' static
    buffers (one foreach copy each), so nothing a caller keeps, a metric
    or a parameter's ``.grad``, is overwritten by the next replay.

``name + ".replay"`` spans each replayed call and ``name + ".eager"`` each
eager one (utils/profiling.py::span); a capture runs in neither.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from ..parallel import dist
from ..utils.profiling import span

#: eager calls before a capture (make_graphed_callables's default)
WARMUP = 3


class GraphedCalls:
    """Replays of one module's pure functions on one device, by key."""

    def __init__(self, name: str, device, fsdp: bool = False):
        self.device = torch.device(device)
        self.fsdp = bool(fsdp)
        self.graphs: Dict[tuple, _Graphed] = {}
        self._replay, self._eager = name + ".replay", name + ".eager"
        self._stream: Optional[torch.cuda.Stream] = None

    def replayable(self) -> bool:
        """Whether a call may replay: on a CUDA device, with gradients on,
        at tp 1 and without fsdp."""
        return (self.device.type == "cuda" and not self.fsdp
                and dist.tp_size() == 1 and torch.is_grad_enabled())

    def __call__(self, fn, key, module: torch.nn.Module, *inputs):
        """``fn(module, *inputs)``, replayed where it may be."""
        if not self.replayable():
            with span(self._eager):
                return fn(module, *inputs)
        params = tuple(module.parameters())
        kind = self.device.type
        key = (key, torch.is_autocast_enabled(kind),
               torch.get_autocast_dtype(kind),
               tuple((x.shape, x.stride(), x.dtype, x.requires_grad)
                     for x in inputs),
               tuple(p.requires_grad for p in params))
        g = self.graphs.get(key)
        if g is None or not g.holds(params):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            g = self.graphs[key] = _Graphed(fn, module, inputs,
                                            self._stream)
        with span(self._replay):
            return _Replay.apply(g, *inputs, *g.trained)


class _Graphed:
    """One key's forward and backward graphs and their static tensors."""

    def __init__(self, fn, module: torch.nn.Module,
                 inputs: Sequence[torch.Tensor], stream: torch.cuda.Stream):
        with torch.no_grad():
            self.static = [torch.empty_strided(
                x.shape, x.stride(), dtype=x.dtype, device=x.device
            ).copy_(x).requires_grad_(x.requires_grad) for x in inputs]
        named = dict(module.named_parameters())
        self.ptrs = [p.data_ptr() for p in named.values()]
        self.trained = [p for p in named.values() if p.requires_grad]
        aliases = {n: p.detach().requires_grad_(p.requires_grad)
                   for n, p in named.items()}

        def aliased(*args):
            return torch.func.functional_call(module, aliases, args)

        targets = [s for s in self.static if s.requires_grad] + [
            a for a in aliases.values() if a.requires_grad]
        # where each of the Function's tensor inputs finds its gradient
        k = iter(range(len(targets)))
        self.slots = [next(k) if s.requires_grad else None
                      for s in self.static] + [next(k) for _ in self.trained]

        eager_backward = torch.autocast(stream.device.type, enabled=False)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for _ in range(WARMUP):
                outs = fn(aliased, *self.static)
                diff = [o for o in outs if o.requires_grad]
                if diff:
                    with eager_backward:
                        torch.autograd.grad(
                            diff, targets, [torch.ones_like(o) for o in diff],
                            allow_unused=True)
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        torch.clear_autocast_cache()
        with torch.cuda.graph(self.fwd, pool=pool, stream=stream):
            outs = fn(aliased, *self.static)
        torch.clear_autocast_cache()
        self.needs = [o.requires_grad for o in outs]
        diff = [o for o in outs if o.requires_grad]
        self.grad_outs = [torch.empty_like(o) for o in diff]
        self.grads: tuple = ()
        if diff:
            with eager_backward, torch.cuda.graph(self.bwd, pool=pool,
                                                  stream=stream):
                self.grads = torch.autograd.grad(diff, targets,
                                                 self.grad_outs,
                                                 allow_unused=True)
        self.outs = [o.detach() for o in outs]
        torch.cuda.current_stream().wait_stream(stream)

    def holds(self, params: Sequence[torch.nn.Parameter]) -> bool:
        """Whether the parameters are where the graphs read them."""
        return [p.data_ptr() for p in params] == self.ptrs

    def input_grads(self) -> List[Optional[torch.Tensor]]:
        """Copies of the backward's gradients, one for each tensor input
        of the Function (None where it takes none)."""
        have = [g for g in self.grads if g is not None]
        fresh = iter(torch._foreach_mul(have, 1.0) if have else ())
        grads = [None if g is None else next(fresh) for g in self.grads]
        return [None if i is None else grads[i] for i in self.slots]


class _Replay(torch.autograd.Function):
    """A replay of ``g``'s forward; its backward replays ``g``'s backward.
    Its tensor inputs are the call's inputs and the parameters that take a
    gradient, so that autograd carries their gradients as it would the
    eager call's."""

    @staticmethod
    def forward(ctx, g: _Graphed, *args):
        for s, x in zip(g.static, args):
            s.copy_(x)
        g.fwd.replay()
        outs = torch._foreach_mul(g.outs, 1.0)
        ctx.g = g
        ctx.mark_non_differentiable(*(o for o, need in zip(outs, g.needs)
                                      if not need))
        return tuple(outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        g = ctx.g
        for s, d in zip(g.grad_outs, (d for d, need in zip(grads, g.needs)
                                      if need)):
            s.copy_(d)
        g.bwd.replay()
        return (None, *g.input_grads())
