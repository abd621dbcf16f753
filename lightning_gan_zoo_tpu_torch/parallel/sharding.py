"""State sharding: tensor parallelism's blocks over the tp ranks
(``num_tp``), and ZeRO-1 (``zero_opt``) and FSDP / ZeRO-3 (``fsdp``) over
the data ranks, the counterpart of lightning_gan_zoo_tpu/parallel/mesh.py's
``_tp_leaf_spec``, ``params_shardings``, ``_zero_leaf_spec``,
``opt_shardings``, ``state_shardings`` and ``gather_tree``.

The leaf rule is the JAX package's, read on flax's trailing extent E of
each parameter leaf (a 0-d leaf stays whole everywhere):

  * tp (``tp_sharded``): the leaf is cut into T blocks along that axis iff
    T divides E and E/T ≥ ``tp_min_shard`` (default 8; the floor applies
    to the tp factor alone). Tp rank t holds block t, in the module in
    place of the parameter (``TensorShards``), and the optimizer's state
    and the EMA twin follow the block. The modules compute with the blocks
    as parallel/tensor.py says.
  * data (``sharded``): under ``zero_opt`` the optimizer's state, and
    under ``fsdp`` the parameters and the EMA twin too, are cut over the D
    data ranks iff D·T' divides E, T' the leaf's tp factor (T if it is
    tp-sharded, else 1); there is no floor on the data factor (mesh.py:
    "unlike params there is no lane floor"). This is ``_zero_leaf_spec``:
    a tp-sharded leaf splits over data × tp, else over data where that
    divides, else it keeps its tp placement.

The data cut is made on the tp block, along the same axis, so data rank d
of tp rank t holds elements [t·E/T + d·E/(T·D), ...) of that axis: a
tp-major order, where the JAX mesh's ('data', 'tp') spec puts block d·T + t
there. The port's order keeps a tp rank's compute block inside one
data-group gather (fsdp gathers a tp block back over the data group before
a superstep), which the JAX order would not. Nothing outside a rank sees
the order: a checkpoint, the rescue and every rank-0 consumer get the
one-device tensors.

The flax trailing axis is where convert.py puts it in the torch layout
(``trailing_dim``): dim 0 for Conv and Linear weights and for biases and
norm parameters, dim 1 for ConvTranspose weights, the last dim for the SIREN
kernels kept in flax's (in, out) layout, dim 1 for HoloGAN's constant
volume (NDHWC → NCDHW). An ``nn.LSTMCell`` stacks flax's four gate denses
along dim 0; the rule reads one gate's extent H (``flax_extent``), and a
block is a contiguous 1/T of the stacked rows, which is only a storage
order: the cell always runs with its leaves gathered whole.
Buffers (BatchNorm statistics, the spectral norm's u), counters and the
task's extra state stay whole on every rank, as the JAX package replicates
them.

The update follows the JAX superstep's collectives: under ``zero_opt`` the
gradients are all-reduced whole (``dist.average_grads``: over tp too for a
leaf that is whole over tp) and each rank slices its blocks; under
``fsdp`` the data-sharded leaves' gradients are reduce-scattered and the
others all-reduced. Each rank's optimizer steps its blocks (and the whole
leaves), and one all-gather puts the updated data blocks back into the tp
blocks the next micro-step reads. Under ``fsdp`` those exist only while
they are in use: their storage is freed between supersteps (``release``)
and gathered again into the same tensors (``materialize``), so the modules'
references stay valid.

On a data × sp grid the data rule shards over the data axis alone, as the
JAX rule does (``opt_shardings`` takes ``mesh.shape['data']``): the sp
ranks of a data group hold the same blocks, the gathers and
reduce-scatters run in the data group, and a generator whose gradient is a
partial sum over each sp rank's rays has it summed over the sp group
before the reduce-scatter (as every gradient is: ``dist.average_grads``).
At one data rank nothing is data-sharded (the JAX rule's ``data > 1``).

Every function here that gathers is a collective: every rank calls it at
the same point. A checkpoint holds the full state in the one-device
optimizer's format (``full_state_dict``, ``full_optimizer_state``), so it
is the same file whatever the grid and the switches, and a restore slices
it on each rank without a collective (``load_optimizer_state``). Rank 0's
consumers of the state (validation, the figures, FID, ``eval_only``,
export) run inside ``StateSharding.full()``, which every rank enters: the
modules then hold the whole parameters and run the one-device forward,
with no tp collective inside.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from . import dist, tensor


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


def tp_sharded(extent: int, ndim: int, tp: int, min_shard: int = 8) -> bool:
    """The leaf rule of ``_tp_leaf_spec``: the trailing axis is cut over
    the ``tp`` ranks iff it divides by tp with at least ``min_shard`` per
    rank; a 0-d leaf stays whole."""
    return (ndim > 0 and tp > 1 and extent % tp == 0
            and extent // tp >= min_shard)


def sharded(extent: int, ndim: int, world: int, tp: int = 1) -> bool:
    """The data factor of ``_zero_leaf_spec``: the trailing axis is split
    over the ``world`` data ranks iff it divides by data × tp, ``tp`` the
    leaf's tp factor (1 for a leaf the tp rule leaves whole); a 0-d leaf
    stays whole."""
    return ndim > 0 and world > 1 and extent % (world * tp) == 0


def _owners(net: nn.Module):
    """(full name, module, its own name) of every parameter of ``net``."""
    for mod_name, m in net.named_modules():
        for pn, p in m.named_parameters(recurse=False):
            yield (f"{mod_name}.{pn}" if mod_name else pn), m, pn, p


class TPLeaf:
    """One tp-sharded parameter: its module and name, the dim it is cut
    along, the whole shape and this rank's block (the nn.Parameter now in
    the module, marked with ``tp_dim``)."""

    def __init__(self, name: str, module: nn.Module, pname: str,
                 whole: torch.Tensor, dim: int, tp: int, rank: int):
        self.name, self.module, self.pname, self.dim = name, module, pname, dim
        self.shape = tuple(whole.shape)
        self.size = whole.shape[dim] // tp
        self.rank = rank
        self.block = nn.Parameter(self.block_of(whole.detach()).clone(),
                                  requires_grad=whole.requires_grad)
        self.block.tp_dim = dim

    def block_of(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole-shaped tensor (a view)."""
        return full.narrow(self.dim, self.rank * self.size, self.size)


class TensorShards:
    """One net's parameters under the tp leaf rule on this rank: each
    tp-sharded parameter replaced in its module by this rank's block, and
    the torch layers among their modules run column-parallel
    (parallel/tensor.py). Cut once, before the optimizers are made."""

    def __init__(self, net: nn.Module, min_shard: int = 8,
                 tp: Optional[int] = None, rank: Optional[int] = None):
        """``tp`` and ``rank`` default to the group's tp axis and this
        rank's tp index (given, the blocks are cut without a group; nothing
        gathers then)."""
        self.tp = dist.tp_size() if tp is None else tp
        self.rank = dist.tp_rank() if rank is None else rank
        self.leaves: List[TPLeaf] = []
        seen = set()
        for name, m, pn, p in list(_owners(net)):
            if id(p) in seen:
                continue
            seen.add(id(p))
            dim = trailing_dim(m, pn, p)
            if not tp_sharded(flax_extent(m, p, dim), p.dim(), self.tp,
                              min_shard):
                continue
            if not tensor.reads_blocks(m):
                raise ValueError(f"num_tp: {type(m).__name__}.{pn} would be "
                                 "cut, but the module cannot run on blocks")
            lf = TPLeaf(name, m, pn, p, dim, self.tp, self.rank)
            m._parameters[pn] = lf.block
            if tensor.column_dim(m) is not None:
                tensor.make_column_parallel(m)
            self.leaves.append(lf)
        #: whether the modules hold the whole parameters (``whole_in``)
        self.whole = False

    @torch.no_grad()
    def whole_in(self, gather: bool = True):
        """Whole parameters in the modules in place of the blocks: gathered
        from every rank's blocks (a collective), or left for the caller to
        fill (``gather=False``, a restore)."""
        if self.whole:
            return
        blocks = [lf.block for lf in self.leaves]
        wholes = (tensor.gather_whole(blocks, [lf.dim for lf in self.leaves])
                  if gather else [b.new_empty(lf.shape) for b, lf
                                  in zip(blocks, self.leaves)])
        for lf, w in zip(self.leaves, wholes):
            lf.module._parameters[lf.pname] = nn.Parameter(
                w, requires_grad=lf.block.requires_grad)
        self.whole = True

    @torch.no_grad()
    def blocks_in(self, pull: bool = False):
        """The blocks back in the modules; with ``pull`` each takes its
        values from the whole parameter first (after a restore)."""
        if not self.whole:
            return
        for lf in self.leaves:
            if pull:
                lf.block.copy_(lf.block_of(lf.module._parameters[lf.pname]))
            lf.module._parameters[lf.pname] = lf.block
        self.whole = False


def tensor_parallel(task, min_shard: int = 8
                    ) -> Optional[Tuple[TensorShards, TensorShards]]:
    """G's and D's ``TensorShards`` on a grid with tp > 1 (cut at the
    first call, then the same), else None."""
    if dist.tp_size() == 1:
        return None
    cut = getattr(task, "_tp_shards", None)
    if cut is None:
        cut = (TensorShards(task.generator, min_shard),
               TensorShards(task.discriminator, min_shard))
        task._tp_shards, task._tp_min_shard = cut, min_shard
    elif task._tp_min_shard != min_shard:
        raise ValueError(f"the task's nets were cut at tp_min_shard="
                         f"{task._tp_min_shard}, not {min_shard}")
    return cut


class Leaf:
    """One parameter of a net (this rank's tp block of a tp-sharded one):
    its name, the tensor, its ``TPLeaf`` if it is tp-sharded, and for a
    data-sharded leaf the dim it is split along and this rank's block (own
    storage)."""

    def __init__(self, name: str, param: nn.Parameter, dim: Optional[int],
                 world: int, rank: int, tp: Optional[TPLeaf] = None):
        self.name, self.param, self.dim, self.tp = name, param, dim, tp
        self.shard: Optional[torch.Tensor] = None
        if dim is not None:
            self.size = param.shape[dim] // world
            self.shard = self.block(param, rank).detach().clone()

    def block(self, full: torch.Tensor, r: int) -> torch.Tensor:
        """Rank r's block of a full-shaped tensor (a view)."""
        return full.narrow(self.dim, r * self.size, self.size)


class NetShards:
    """One net's parameters under the data leaf rule on this rank, on top
    of its tp blocks (``tp``) where the grid has a tp axis."""

    def __init__(self, net: nn.Module, fsdp: bool,
                 world: Optional[int] = None, rank: Optional[int] = None,
                 tp: Optional[TensorShards] = None):
        """``world`` and ``rank`` default to the group's data ranks and
        this rank's data index (given, the blocks of that rank are cut
        without a group; nothing gathers then); ``world`` 1 shards nothing
        over data (tensor parallelism alone)."""
        self.net, self.fsdp, self.tp = net, fsdp, tp
        self.world = dist.data_size() if world is None else world
        self.rank = dist.data_rank() if rank is None else rank
        tp_of = {id(lf.block): lf for lf in (tp.leaves if tp else ())}
        owner = {id(p): (m, pn) for _, m, pn, p in _owners(net)}
        self.leaves: List[Leaf] = []
        for name, p in net.named_parameters():
            m, pn = owner[id(p)]
            dim = trailing_dim(m, pn, p)
            dim = dim if sharded(flax_extent(m, p, dim), p.dim(),
                                 self.world) else None
            self.leaves.append(Leaf(name, p, dim, self.world, self.rank,
                                    tp_of.get(id(p))))
        self.sharded = [lf for lf in self.leaves if lf.shard is not None]
        self._by_id = {id(t): lf for lf in self.leaves
                       for t in (lf.param, lf.shard) if t is not None}
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
        """This rank's data blocks (copies) of tensors shaped like the
        parameters, tp blocks where they are cut (the EMA twin)."""
        out = dict(full)
        for lf in self.sharded:
            out[lf.name] = lf.block(full[lf.name], self.rank).clone()
        return out

    def cut(self, name: str, whole: torch.Tensor, data: bool) -> torch.Tensor:
        """This rank's copy of the part it holds of a one-device tensor
        shaped like parameter ``name``: its tp block, then (``data``) its
        data block of that."""
        lf = self._by_name()[name]
        t = whole if lf.tp is None else lf.tp.block_of(whole)
        if data and lf.shard is not None:
            t = lf.block(t, self.rank)
        return t.clone()

    def _by_name(self) -> Dict[str, Leaf]:
        return {lf.name: lf for lf in self.leaves}

    # ---------------------------------------------------------- update
    def reduce_grads(self, ray_partial: bool = False):
        """Each gradient reduced by ``dist.average_grads``'s rule (summed
        over the tp group for a leaf whole over tp, over the sp group,
        averaged over the data group; ``ray_partial``: each sp rank holds
        its rays' partial sum), a data-sharded leaf's into its block's
        ``grad``: under zero_opt the flat all-reduces of every gradient
        there is, then this rank's blocks; under fsdp the data-sharded
        leaves' gradients summed over the tp group (those whole over tp)
        and the sp group and reduce-scattered over the data group, and the
        others all-reduced. The full gradients of sharded leaves are
        dropped."""
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
        for whole in (True, False):
            have = [lf for lf in self.sharded if lf.param.grad is not None
                    and (lf.tp is None) == whole]
            if not have:
                continue
            flat = torch.cat([lf.block(lf.param.grad, r).reshape(-1)
                              for r in range(self.world) for lf in have])
            if whole:
                dist.sum_over_tp(flat)
            mine = dist.reduce_scatter_flat(dist.sum_over_sp(flat))
            mine.div_(dist.grad_divisor(ray_partial, whole))
            for lf, g in zip(have, mine.split([lf.shard.numel()
                                               for lf in have])):
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
        """The net's state_dict with the one-device tensors: the sharded
        leaves gathered into new tensors from what this rank holds (a
        collective: under fsdp the data blocks, whether or not the
        parameters are materialized; the tp blocks, whether or not the
        modules hold the whole parameters)."""
        sd = self.net.state_dict()
        sd.update(self.gather_full({
            lf.name: lf.shard if self.fsdp and lf.shard is not None
            else lf.param for lf in self.leaves
            if lf.tp is not None or (self.fsdp and lf.shard is not None)},
            data=self.fsdp))
        return sd

    def gather_full(self, blocks: Dict[str, torch.Tensor], data: bool
                    ) -> Dict[str, torch.Tensor]:
        """One-device tensors (new storage) from every rank's blocks of the
        leaves named in ``blocks``: each the tp block of a tp-sharded leaf,
        and (``data``) the data block of a data-sharded one; other entries
        as they are."""
        by_name = self._by_name()
        names = [n for n in blocks if n in by_name]
        out = dict(blocks)
        for n, t in zip(names, self._to_whole(
                [(by_name[n], blocks[n]) for n in names], data)):
            out[n] = t
        return out

    def _to_whole(self, items: List[Tuple[Leaf, torch.Tensor]], data: bool
                  ) -> List[torch.Tensor]:
        """Each (leaf, tensor held for it) as the one-device tensor: with
        ``data`` the data block of a data-sharded leaf gathered over the
        data group (one all-gather), then the tp block of a tp-sharded leaf
        over the tp group (one more)."""
        out = [t for _, t in items]
        blocks = [i for i, (lf, _) in enumerate(items)
                  if data and lf.shard is not None]
        if blocks:
            parts = gather_blocks([out[i] for i in blocks])
            for i, per_rank in zip(blocks, parts):
                out[i] = torch.cat(per_rank, dim=items[i][0].dim)
        cut = [i for i, (lf, _) in enumerate(items) if lf.tp is not None]
        if cut:
            wholes = tensor.gather_whole([out[i] for i in cut],
                                         [items[i][0].tp.dim for i in cut])
            for i, w in zip(cut, wholes):
                out[i] = w
        return out

    def _optimizer_leaves(self, opt) -> List[Optional[Leaf]]:
        return [self._by_id.get(id(p)) for g in opt.param_groups
                for p in g["params"]]

    def full_optimizer_state(self, opt: torch.optim.Optimizer) -> dict:
        """``opt.state_dict()`` as the one-device optimizer gives it: every
        state tensor of a sharded leaf gathered to the parameter's shape
        (an all-gather per axis), the 0-d counts as they are."""
        sd = opt.state_dict()
        leaves = self._optimizer_leaves(opt)
        state = {i: dict(s) for i, s in sd["state"].items()}
        todo = [(i, k) for i, s in state.items() if leaves[i] is not None
                and (leaves[i].shard is not None or leaves[i].tp is not None)
                for k, v in s.items() if torch.is_tensor(v) and v.dim() > 0]
        if todo:
            wholes = self._to_whole([(leaves[i], state[i][k])
                                     for i, k in todo], data=True)
            for (i, k), w in zip(todo, wholes):
                state[i][k] = w
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_optimizer_state(self, opt: torch.optim.Optimizer, sd: dict):
        """Load a one-device optimizer state_dict: each whole state tensor
        of a sharded leaf cut to what this rank holds (no collective)."""
        leaves = self._optimizer_leaves(opt)
        state = {}
        for i, s in sd["state"].items():
            lf = leaves[int(i)]
            if lf is not None:
                s = {k: self.cut(lf.name, v, data=True)
                     if torch.is_tensor(v) and v.dim() > 0 else v
                     for k, v in s.items()}
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
    """A TrainState's sharding: G's and D's ``NetShards`` (over the data
    ranks under ``zero``, on top of the tp blocks of ``tp``), their
    optimizers stepping the data blocks, and under fsdp the EMA twin held
    as data blocks (as tp blocks under tp alone)."""

    def __init__(self, task, state, fsdp: bool, zero: bool = True,
                 tp: Optional[Tuple[TensorShards, TensorShards]] = None):
        self.fsdp = fsdp
        self.tp = tp
        world = None if zero else 1
        self.g = NetShards(task.generator, fsdp, world=world,
                           tp=tp[0] if tp else None)
        self.d = NetShards(task.discriminator, fsdp, world=world,
                           tp=tp[1] if tp else None)
        self.g.shard_optimizer(state.g_opt)
        self.d.shard_optimizer(state.d_opt)
        self.state = state
        if fsdp and state.g_ema is not None:
            state.g_ema = self.g.shard_tensors(state.g_ema)
        #: the gathered EMA twin inside ``full()``
        self.ema_full: Optional[Dict[str, torch.Tensor]] = None
        self._depth = 0
        self.release()

    def nets(self) -> Iterable[NetShards]:
        return (self.g, self.d)

    @property
    def whole(self) -> bool:
        """Whether the modules hold the one-device parameters: inside
        ``full()`` (or after ``finish``), or always without tp and fsdp."""
        if self.tp is not None and not self.tp[0].whole:
            return False
        return all(n.materialized for n in self.nets())

    def materialize(self):
        for n in self.nets():
            n.materialize()

    def release(self):
        for n in self.nets():
            n.release()

    def finish(self):
        """The trained G and D whole in the modules, for good (a
        collective): the end of training."""
        self.materialize()
        for t in self.tp or ():
            t.whole_in()

    @contextlib.contextmanager
    def full(self):
        """Within the block every rank's modules hold the one-device
        parameters and ``TrainState.eval_g_params`` returns the whole EMA
        twin (a collective under fsdp and under tp: every rank enters it at
        the same point). Re-entrant; nothing to do under zero_opt alone."""
        if not self.fsdp and self.tp is None:
            yield
            return
        self._depth += 1
        was = [n.materialized for n in self.nets()]
        was_whole = [t.whole for t in self.tp or ()]
        try:
            if self._depth == 1:
                self.materialize()
                for t in self.tp or ():
                    t.whole_in()
                if self.state.g_ema is not None:
                    self.ema_full = self.g.gather_full(self.state.g_ema,
                                                       data=self.fsdp)
            yield
        finally:
            self._depth -= 1
            if self._depth == 0:
                self.ema_full = None
                for t, w in zip(self.tp or (), was_whole):
                    if not w:
                        t.blocks_in()
                for n, m in zip(self.nets(), was):
                    if not m:
                        n.release()

    @contextlib.contextmanager
    def restoring(self):
        """Around a restore into the modules (between supersteps, not
        inside ``full()``): the one-device parameters' storage is there to
        be written (not gathered), and the blocks take the restored values
        afterwards. No collective."""
        was = [n.materialized for n in self.nets()]
        for n in self.nets():
            n.materialize(gather=False)
        for t in self.tp or ():
            t.whole_in(gather=False)
        try:
            yield
        finally:
            for t in self.tp or ():
                t.blocks_in(pull=True)
            for n, m in zip(self.nets(), was):
                n.pull()
                if not m:
                    n.release()

    def full_ema(self) -> Optional[Dict[str, torch.Tensor]]:
        """The one-device EMA twin, new tensors (a collective under fsdp
        and under tp)."""
        ema = self.state.g_ema
        if ema is None or (not self.fsdp and self.tp is None):
            return ema
        return self.g.gather_full(ema, data=self.fsdp)

    def load_ema(self, full: Dict[str, torch.Tensor]):
        """Restore the EMA twin from one-device tensors (this rank's tp
        blocks, and data blocks under fsdp; no collective)."""
        with torch.no_grad():
            for k, v in self.state.g_ema.items():
                v.copy_(self.g.cut(k, full[k], data=self.fsdp))


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
