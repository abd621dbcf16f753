"""Tensor parallelism over the tp group (``num_tp``): the collectives and
the column-parallel layers that GSPMD places in the JAX package
(lightning_gan_zoo_tpu/parallel/mesh.py's 'tp' axis).

Under ``num_tp`` = T each rank of a tp group holds its block of every
tp-sharded parameter: 1/T of the leaf along flax's trailing (output) axis,
which parallel/sharding.py cuts and puts into the module in place of the
whole parameter, marked with the dim it was cut along (``tp_dim``). Every
activation outside a layer is whole and the same on every rank of the group
("replicated"). A layer uses its blocks in one of two ways:

  * column-parallel: a convolution, transposed convolution or dense
    (``nn.Conv*d``, ``nn.ConvTranspose*d``, ``nn.Linear`` and the port's
    ``Siren`` and ``SpectralNormConv``) whose weight is a block computes
    its block of output channels from the whole input, and ``gather``
    makes the whole output over the group along the channel dim;
  * whole at use: every other block (norm scales and shifts, HoloGAN's
    constant volume, the spectral norm's weight, of which σ needs all,
    the LSTM's gates, the SIREN trunk's kernels when the fused kernel runs)
    is gathered whole where it is read (``whole``).

The backward rule. Every activation that is replicated over the group must
get a replicated cotangent, the same whole gradient on every rank, to any
order of differentiation; a block gets its block of the gradient.
The four operations below keep that rule, and each one's backward is
another of the four, applied through autograd, so a gradient of a gradient
(R1, WGAN-GP) passes them with the same rule:

  * ``copy_in`` (identity forward, all-reduce backward): a replicated
    tensor entering a block computation. The block's backward gives each
    rank its share of the input's gradient (its output channels' terms),
    and their sum over the group is the gradient: the all-reduce makes it
    whole and the same everywhere.
  * ``reduce_out`` (all-reduce forward, identity backward): the sum of the
    ranks' terms. Its output is replicated, so its cotangent is the same
    whole tensor on every rank, which is each term's cotangent.
  * ``gather`` (all-gather forward, ``split`` backward): blocks into the
    replicated whole. The whole's cotangent is replicated, so the block's
    is its slice, with no communication.
  * ``split`` (this rank's block forward, ``gather`` backward): a
    replicated tensor cut to the block. The block's cotangent is the
    rank's own; the whole's is every rank's blocks put together, which is
    an all-gather, not the zero-padded slice that autograd's own narrow
    would give (that would leave a cotangent that is the whole gradient
    only when summed over the group, and break the rule at second order).

``dist.all_reduce_sum`` is not reused: its backward is itself, which is the
data axis's rule, where each rank's loss is its own term.

A replicated tensor read inside a block computation other than through the
layer's input (the spectral norm's σ) enters it through ``copy_in`` too.
The tp gradient reduction (``dist.average_grads``) then has nothing to fix:
a block's gradient is the rank's, a whole leaf's is the same on every rank
(summed over the group and divided by T only so that the copies cannot
drift where a kernel's summation order is not fixed).

Outside a training step (rank 0's validation, figures, FID, export) the
modules hold the whole parameters (parallel/sharding.py's ``full()``), no
leaf is a block, and every layer here runs the one-device forward with no
collective.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as tdist
from torch import nn

from . import dist
from .dist import is_tp_block as is_block


def _gather_parts(x: torch.Tensor) -> List[torch.Tensor]:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.tp_size())]
    tdist.all_gather(parts, x, group=dist.tp_group())
    return parts


class _Copy(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' cotangents
    (``_Reduce``)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _Reduce.apply(grad)


class _Reduce(torch.autograd.Function):
    """The sum over the tp group; the backward hands the replicated
    cotangent to every term (``_Copy``)."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(x, group=dist.tp_group())
        return x

    @staticmethod
    def backward(ctx, grad):
        return _Copy.apply(grad)


class _Gather(torch.autograd.Function):
    """Every rank's block along ``dim``, in tp order; the backward cuts
    this rank's block of the replicated cotangent (``_Split``)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return torch.cat(_gather_parts(x), dim)

    @staticmethod
    def backward(ctx, grad):
        return _Split.apply(grad, ctx.dim), None


class _Split(torch.autograd.Function):
    """This rank's block along ``dim``; the backward puts every rank's
    cotangent block together (``_Gather``)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        n = x.shape[dim] // dist.tp_size()
        return x.narrow(dim, dist.tp_rank() * n, n).clone()

    @staticmethod
    def backward(ctx, grad):
        return _Gather.apply(grad, ctx.dim), None


def copy_in(x: torch.Tensor) -> torch.Tensor:
    """A replicated ``x`` entering a block computation (``x`` at tp 1)."""
    return _Copy.apply(x) if dist.tp_size() > 1 else x


def reduce_out(x: torch.Tensor) -> torch.Tensor:
    """The sum of the ranks' ``x`` over the tp group (``x`` at tp 1)."""
    return _Reduce.apply(x) if dist.tp_size() > 1 else x


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole tensor from every rank's block ``x`` along ``dim``."""
    return _Gather.apply(x, dim % x.dim()) if dist.tp_size() > 1 else x


def split(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block of a replicated ``x`` along ``dim``."""
    return _Split.apply(x, dim % x.dim()) if dist.tp_size() > 1 else x


def whole(p: torch.Tensor) -> torch.Tensor:
    """A parameter whole where it is read: gathered if it is a block."""
    return gather(p, p.tp_dim) if is_block(p) else p


def column_in(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The input of a layer whose ``weight`` may be a block."""
    return copy_in(x) if is_block(weight) else x


def column_out(y: torch.Tensor, weight: torch.Tensor, dim: int
               ) -> torch.Tensor:
    """The output of a layer whose ``weight`` may be a block: gathered
    whole along its channel ``dim``."""
    return gather(y, dim) if is_block(weight) else y


def call_whole(module: nn.Module, *args):
    """``module(*args)`` with its blocks gathered whole (a torch module
    whose forward cannot read them itself: the LSTM cell)."""
    params = {n: whole(p) for n, p in module.named_parameters()
              if is_block(p)}
    if not params:
        return module(*args)
    return torch.func.functional_call(module, params, args)


@torch.no_grad()
def gather_whole(blocks: Sequence[torch.Tensor], dims: Sequence[int]
                 ) -> List[torch.Tensor]:
    """Whole tensors (new storage) from every rank's ``blocks``, cut along
    ``dims``, in one flat all-gather over the tp group (one dtype). Not
    differentiable: the state's gathers (checkpoints, ``full()``)."""
    if not blocks:
        return []
    dtypes = {b.dtype for b in blocks}
    if len(dtypes) != 1:
        raise TypeError(f"one all-gather takes one dtype, not {dtypes}")
    flat = torch.cat([b.detach().reshape(-1) for b in blocks])
    rows = _gather_parts(flat)
    out, off = [], 0
    for b, d in zip(blocks, dims):
        n = b.numel()
        out.append(torch.cat([r[off:off + n].view(b.shape) for r in rows], d))
        off += n
    return out


# ------------------------------------------------------ the layer hooks
#: the torch layers that run column-parallel through hooks, and the dim of
#: their output's channels
COLUMN_DIM = {nn.Linear: -1, nn.Conv1d: 1, nn.Conv2d: 1, nn.Conv3d: 1,
              nn.ConvTranspose1d: 1, nn.ConvTranspose2d: 1,
              nn.ConvTranspose3d: 1}


def column_dim(module: nn.Module):
    """The output channel dim of a torch layer that runs column-parallel
    through hooks, else None."""
    for cls, d in COLUMN_DIM.items():
        if isinstance(module, cls):
            return d
    return None


def _column_pre(module, args):
    if is_block(module.weight):
        return (copy_in(args[0]),) + tuple(args[1:])
    return None


def _column_post(module, args, out):
    if is_block(module.weight):
        return gather(out, column_dim(module))
    return None


def make_column_parallel(module: nn.Module):
    """Hooks that run ``module`` column-parallel while its weight is a
    block (``copy_in`` on its input, ``gather`` on its output); with the
    whole weight in place they do nothing."""
    if getattr(module, "_tp_hooks", None) is None:
        module._tp_hooks = (module.register_forward_pre_hook(_column_pre),
                            module.register_forward_hook(_column_post))


def reads_blocks(module: nn.Module) -> bool:
    """Whether ``module`` knows what to do with its blocks: a torch layer
    run column-parallel through hooks, a port layer that reads its
    parameters through this module (``tp_aware``), or the LSTM cell, which
    its deformer calls through ``call_whole``."""
    return (column_dim(module) is not None
            or getattr(module, "tp_aware", False)
            or isinstance(module, nn.LSTMCell))
