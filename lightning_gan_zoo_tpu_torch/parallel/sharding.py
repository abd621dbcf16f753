"""State sharding over the data ranks: ZeRO-1 (``zero_opt``) and FSDP /
ZeRO-3 (``fsdp``), the counterpart of lightning_gan_zoo_tpu/parallel/
mesh.py's ``_zero_leaf_spec``, ``opt_shardings``, ``state_shardings`` and
``gather_tree``.

The leaf rule is the JAX package's. A parameter leaf is sharded over the
data ranks iff its flax trailing extent divides by their number; a 0-d
leaf stays whole, and there is no floor on the data factor (mesh.py:
"unlike params there is no lane floor"). Data rank d holds the d-th of
those equal contiguous blocks of that axis. ``zero_opt`` applies the rule
to the optimizer's state (Adam's moments, SGD's trace, RMSprop's ν and
trace); ``fsdp`` also to the parameters and the EMA twin, and implies
``zero_opt``. Buffers (BatchNorm statistics, the spectral norm's u), counters and the
task's extra state stay whole on every rank, as the JAX package replicates
them.

The flax trailing axis is where convert.py puts it in the torch layout
(``trailing_dim``): dim 0 for Conv and Linear weights and for biases and
norm parameters, dim 1 for ConvTranspose weights, the last dim for the SIREN
kernels kept in flax's (in, out) layout, dim 1 for HoloGAN's constant
volume (NDHWC → NCDHW).

The update follows the JAX superstep's collectives: under ``zero_opt`` the
gradients are all-reduced whole (``dist.average_grads``) and each rank
slices its blocks; under ``fsdp`` the sharded leaves' gradients are
reduce-scattered and the whole ones all-reduced. Each rank's optimizer
steps its blocks (and the whole leaves), and one all-gather puts the
updated blocks back into the full parameters the next micro-step reads.
Under ``fsdp`` the full parameters exist only while they are in use: their
storage is freed between supersteps (``release``) and gathered again into
the same tensors (``materialize``), so the modules' references stay valid.

On a data × sp grid (``num_sp``) the rule shards over the data axis
alone, as the JAX rule does (``opt_shardings`` takes ``mesh.shape['data']``):
the sp ranks of a data group hold the same blocks, the gathers and
reduce-scatters run in the data group, and a generator whose gradient is a
partial sum over each sp rank's rays has it summed over the sp group
before the reduce-scatter (as every gradient is: ``dist.average_grads``).
At one data rank nothing is sharded (the JAX rule's ``data > 1``).

Every function here that gathers is a collective: every rank calls it at
the same point. A checkpoint holds the full state in the one-device
optimizer's format (``full_state_dict``, ``full_optimizer_state``), so it
is the same file whatever the world size and the switches, and a restore
slices it on each rank without a collective (``load_optimizer_state``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional, Sequence

import torch
from torch import nn

from . import dist


def trailing_dim(module: nn.Module, name: str, param: torch.Tensor) -> int:
    """The torch dim of ``module``'s parameter ``name`` that holds flax's
    trailing axis, where convert.py's layout rules put it."""
    if param.dim() <= 1:
        return 0                    # biases, norm scales and shifts
    if isinstance(module, nn.modules.conv._ConvTransposeNd):
        return 1                    # (in, out, k...): _conv_transpose
    if name in ("weight", "weight_ih", "weight_hh"):
        return 0                    # OIHW, (out, in), stacked gates: _conv,
        #                             _dense, the LSTM's gate denses
    if name == "kernel":
        return param.dim() - 1      # SIREN, flax's (in, out): _siren
    if name == "const":
        return 1                    # HoloGAN's NDHWC volume as NCDHW
    raise ValueError(f"no flax layout known for {type(module).__name__}."
                     f"{name} {tuple(param.shape)}")


def flax_extent(module: nn.Module, param: torch.Tensor, dim: int) -> int:
    """The extent of flax's trailing axis. An LSTMCell stacks flax's four
    gate denses along dim 0, each with the trailing extent H."""
    n = param.shape[dim]
    return n // 4 if isinstance(module, nn.LSTMCell) else n


def sharded(extent: int, ndim: int, world: int, tp: int = 1) -> bool:
    """The leaf rule of ``_zero_leaf_spec``: the trailing axis is split over
    the ``world`` data ranks iff it divides by data × tp; a 0-d leaf stays
    whole. Tensor parallelism (``num_tp``) is not ported: tp is 1."""
    if tp != 1:
        raise NotImplementedError("num_tp > 1 is not ported")
    return ndim > 0 and world > 1 and extent % (world * tp) == 0


class Leaf:
    """One parameter of a net: its name, the tensor, and for a sharded
    leaf the dim it is split along and this rank's block (own storage)."""

    def __init__(self, name: str, param: nn.Parameter, dim: Optional[int],
                 world: int, rank: int):
        self.name, self.param, self.dim = name, param, dim
        self.shard: Optional[torch.Tensor] = None
        if dim is not None:
            self.size = param.shape[dim] // world
            self.shard = self.block(param, rank).detach().clone()

    def block(self, full: torch.Tensor, r: int) -> torch.Tensor:
        """Rank r's block of a full-shaped tensor (a view)."""
        return full.narrow(self.dim, r * self.size, self.size)


class NetShards:
    """One net's parameters under the leaf rule on this rank."""

    def __init__(self, net: nn.Module, fsdp: bool,
                 world: Optional[int] = None, rank: Optional[int] = None):
        """``world`` and ``rank`` default to the group's data ranks and
        this rank's data index (given, the blocks of that rank are cut
        without a group; nothing gathers then)."""
        self.net, self.fsdp = net, fsdp
        self.world = dist.data_size() if world is None else world
        self.rank = dist.data_rank() if rank is None else rank
        owner = {}
        for mod_name, m in net.named_modules():
            for pn, p in m.named_parameters(recurse=False):
                owner[id(p)] = (m, pn)
        self.leaves: List[Leaf] = []
        for name, p in net.named_parameters():
            m, pn = owner[id(p)]
            dim = trailing_dim(m, pn, p)
            dim = dim if sharded(flax_extent(m, p, dim), p.dim(),
                                 self.world) else None
            self.leaves.append(Leaf(name, p, dim, self.world, self.rank))
        self.sharded = [lf for lf in self.leaves if lf.shard is not None]
        self._by_shard = {id(lf.shard): lf for lf in self.sharded}
        self.materialized = True

    # ---------------------------------------------------------- state
    def shard_optimizer(self, opt: torch.optim.Optimizer):
        """The optimizer steps each sharded leaf's block in place of the
        leaf; its param groups keep their order, so its state_dict indexes
        the parameters as the one-device optimizer does."""
        by_param = {id(lf.param): lf for lf in self.sharded}
        for group in opt.param_groups:
            group["params"] = [by_param[id(p)].shard if id(p) in by_param
                               else p for p in group["params"]]

    def local(self) -> Dict[str, torch.Tensor]:
        """The tensors this rank holds, by parameter name: the block of a
        sharded leaf, the whole parameter otherwise."""
        return {lf.name: lf.param if lf.shard is None else lf.shard
                for lf in self.leaves}

    def shard_tensors(self, full: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """This rank's blocks (copies) of full-shaped tensors named like the
        parameters (the EMA twin)."""
        out = dict(full)
        for lf in self.sharded:
            out[lf.name] = lf.block(full[lf.name], self.rank).clone()
        return out

    # ---------------------------------------------------------- update
    def reduce_grads(self, ray_partial: bool = False):
        """Each gradient reduced by ``dist.average_grads``'s rule (summed
        over the sp group, averaged over the data group; ``ray_partial``:
        each sp rank holds its rays' partial sum), a sharded leaf's into
        its block's ``grad``: under zero_opt the flat all-reduces of every
        gradient there is, then this rank's blocks; under fsdp the sharded
        leaves' gradients summed over the sp group and reduce-scattered
        over the data group, and the whole ones all-reduced. The full
        gradients of sharded leaves are dropped."""
        if not self.fsdp:
            dist.average_grads((lf.param for lf in self.leaves), ray_partial)
            for lf in self.sharded:
                if lf.param.grad is not None:
                    lf.shard.grad = lf.block(lf.param.grad,
                                             self.rank).contiguous()
                    lf.param.grad = None
            return
        dist.average_grads((lf.param for lf in self.leaves
                            if lf.shard is None), ray_partial)
        have = [lf for lf in self.sharded if lf.param.grad is not None]
        if not have:
            return
        mine = dist.reduce_scatter_flat(dist.sum_over_sp(torch.cat(
            [lf.block(lf.param.grad, r).reshape(-1)
             for r in range(self.world) for lf in have])))
        mine.div_(dist.grad_divisor(ray_partial))
        for lf, g in zip(have, mine.split([lf.shard.numel() for lf in have])):
            lf.shard.grad = g.view_as(lf.shard)
            lf.param.grad = None

    def fill_missing_grads(self):
        """runtime/steps.py::fill_missing_grads on what the optimizer
        steps: a zero gradient for every block and whole leaf without
        one."""
        for t in self.local().values():
            if t.grad is None:
                t.grad = torch.zeros_like(t)

    @torch.no_grad()
    def pull(self):
        """Each block takes its values from the full parameter: what the
        superstep did to the full tensors in place (WGAN's clip) reaches
        the state the optimizer steps."""
        for lf in self.sharded:
            lf.shard.copy_(lf.block(lf.param, self.rank))

    @torch.no_grad()
    def gather_params(self):
        """Every rank's blocks into the full parameters (one all-gather);
        the blocks' gradients are dropped."""
        for lf in self.sharded:
            lf.shard.grad = None
        if not self.sharded:
            return
        parts = gather_blocks([lf.shard for lf in self.sharded])
        for lf, per_rank in zip(self.sharded, parts):
            for r, blk in enumerate(per_rank):
                lf.block(lf.param, r).copy_(blk)

    # ------------------------------------------------------------ fsdp
    def release(self):
        """fsdp: the blocks take the full parameters' values, whose storage
        is then freed (the tensors stay, empty, in the modules)."""
        if not self.fsdp or not self.materialized:
            return
        self.pull()
        for lf in self.sharded:
            lf.param.untyped_storage().resize_(0)
        self.materialized = False

    def materialize(self, gather: bool = True):
        """fsdp: the full parameters' storage back, filled from every rank's
        blocks (``gather``, a collective) or left for the caller to fill."""
        if self.materialized:
            return
        for lf in self.sharded:
            p = lf.param
            p.untyped_storage().resize_(p.numel() * p.element_size())
        self.materialized = True
        if gather:
            self.gather_params()

    # ----------------------------------------------------- checkpoints
    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The net's state_dict with full tensors; under fsdp the sharded
        leaves are gathered from the blocks into new tensors (a
        collective), whether or not the parameters are materialized."""
        sd = self.net.state_dict()
        if self.fsdp:
            sd.update(self.gather_full({lf.name: lf.shard
                                        for lf in self.sharded}))
        return sd

    def gather_full(self, blocks: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Full tensors (new storage) from every rank's blocks of the
        sharded leaves named in ``blocks``; other entries as they are."""
        names = [lf.name for lf in self.sharded if lf.name in blocks]
        out = dict(blocks)
        if not names:
            return out
        by_name = {lf.name: lf for lf in self.sharded}
        parts = gather_blocks([blocks[n] for n in names])
        for n, per_rank in zip(names, parts):
            out[n] = torch.cat(per_rank, dim=by_name[n].dim)
        return out

    def _optimizer_leaves(self, opt) -> List[Optional[Leaf]]:
        return [self._by_shard.get(id(p)) for g in opt.param_groups
                for p in g["params"]]

    def full_optimizer_state(self, opt: torch.optim.Optimizer) -> dict:
        """``opt.state_dict()`` as the one-device optimizer gives it: every
        state tensor of a sharded leaf gathered to the parameter's shape
        (one all-gather), the 0-d counts as they are."""
        sd = opt.state_dict()
        leaves = self._optimizer_leaves(opt)
        state = {i: dict(s) for i, s in sd["state"].items()}
        todo = [(i, k) for i, s in state.items() if leaves[i] is not None
                for k, v in s.items()
                if torch.is_tensor(v) and v.shape == leaves[i].shard.shape]
        if todo:
            parts = gather_blocks([state[i][k] for i, k in todo])
            for (i, k), per_rank in zip(todo, parts):
                state[i][k] = torch.cat(per_rank, dim=leaves[i].dim)
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_optimizer_state(self, opt: torch.optim.Optimizer, sd: dict):
        """Load a one-device optimizer state_dict: each full state tensor of
        a sharded leaf cut to this rank's block (no collective)."""
        leaves = self._optimizer_leaves(opt)
        state = {}
        for i, s in sd["state"].items():
            lf = leaves[int(i)]
            if lf is not None:
                s = {k: lf.block(v, self.rank).clone()
                     if torch.is_tensor(v) and v.shape == lf.param.shape
                     else v for k, v in s.items()}
            state[i] = s
        opt.load_state_dict({"state": state,
                             "param_groups": sd["param_groups"]})


def gather_blocks(blocks: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Every data rank's version of each of ``blocks`` (the same shapes on
    every rank), in one flat all-gather in the data group: for each block,
    the list over data ranks."""
    dtypes = {b.dtype for b in blocks}
    if len(dtypes) != 1:
        raise TypeError(f"one all-gather takes one dtype, not {dtypes}")
    flat = torch.cat([b.reshape(-1) for b in blocks])
    per_rank = dist.all_gather_flat(flat).view(dist.data_size(), -1)
    out, off = [], 0
    for b in blocks:
        n = b.numel()
        out.append([row[off:off + n].view(b.shape) for row in per_rank])
        off += n
    return out


class StateSharding:
    """A TrainState's sharding: G's and D's ``NetShards``, their optimizers
    stepping the blocks, and under fsdp the EMA twin held as blocks."""

    def __init__(self, task, state, fsdp: bool):
        self.fsdp = fsdp
        self.g = NetShards(task.generator, fsdp)
        self.d = NetShards(task.discriminator, fsdp)
        self.g.shard_optimizer(state.g_opt)
        self.d.shard_optimizer(state.d_opt)
        self.state = state
        if fsdp and state.g_ema is not None:
            state.g_ema = self.g.shard_tensors(state.g_ema)
        #: the gathered EMA twin inside ``full()`` under fsdp
        self.ema_full: Optional[Dict[str, torch.Tensor]] = None
        self._depth = 0
        self.release()

    def nets(self) -> Iterable[NetShards]:
        return (self.g, self.d)

    def materialize(self):
        for n in self.nets():
            n.materialize()

    def release(self):
        for n in self.nets():
            n.release()

    @contextlib.contextmanager
    def full(self):
        """Within the block every rank's modules hold the full parameters
        and ``TrainState.eval_g_params`` returns the full EMA twin (a
        collective under fsdp: every rank enters it at the same point).
        Re-entrant; nothing to do under zero_opt."""
        if not self.fsdp:
            yield
            return
        self._depth += 1
        was = [n.materialized for n in self.nets()]
        try:
            if self._depth == 1:
                self.materialize()
                if self.state.g_ema is not None:
                    self.ema_full = self.g.gather_full(self.state.g_ema)
            yield
        finally:
            self._depth -= 1
            if self._depth == 0:
                self.ema_full = None
                for n, m in zip(self.nets(), was):
                    if not m:
                        n.release()

    @contextlib.contextmanager
    def restoring(self):
        """Around a restore into the modules: the parameters' storage is
        there to be written (not gathered), and the blocks take the
        restored values afterwards. No collective."""
        was = [n.materialized for n in self.nets()]
        for n in self.nets():
            n.materialize(gather=False)
        try:
            yield
        finally:
            for n, m in zip(self.nets(), was):
                n.pull()
                if not m:
                    n.release()

    def full_ema(self) -> Optional[Dict[str, torch.Tensor]]:
        """The full EMA twin, new tensors (a collective under fsdp)."""
        ema = self.state.g_ema
        if ema is None or not self.fsdp:
            return ema
        return self.g.gather_full(ema)

    def load_ema(self, full: Dict[str, torch.Tensor]):
        """Restore the EMA twin from full tensors (this rank's blocks under
        fsdp; no collective)."""
        mine = self.g.shard_tensors(full) if self.fsdp else full
        with torch.no_grad():
            for k, v in self.state.g_ema.items():
                v.copy_(mine[k])


def held_bytes(task, state) -> Dict[str, int]:
    """The bytes of state this rank holds now, sharded or not: parameters
    (every parameter's storage, none for a freed one, and the blocks the
    optimizers step), the optimizers' state tensors and the EMA twin."""
    def storage(ts):
        return sum(t.untyped_storage().nbytes() for t in ts)
    opts = (state.g_opt, state.d_opt)
    params = {id(p): p for net in (task.generator, task.discriminator)
              for p in net.parameters()}
    params.update({id(p): p for o in opts for g in o.param_groups
                   for p in g["params"]})
    return {"params": storage(params.values()),
            "optimizer": storage(v for o in opts for s in o.state.values()
                                 for v in s.values() if torch.is_tensor(v)),
            "ema": storage((state.g_ema or {}).values())}
