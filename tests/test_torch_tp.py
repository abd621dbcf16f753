"""Tensor parallelism (``num_tp``: parallel/dist.py's data × sp × tp grid,
parallel/tensor.py's column-parallel layers, parallel/sharding.py's tp
blocks) on the CPU over gloo, at the JAX package's parallel/family_runs.py
tiny widths (global batch 4) with ``tp_min_shard`` = 1, as
tests/test_tp.py runs the JAX mesh.

  * The grid: rank → (data, sp, tp) with tp the minor axis, the data, sp
    and tp groups, and the refusals with make_mesh's and the Trainer's
    messages.
  * The leaf rule against the JAX package, leaf by leaf through
    convert.py's names: at tp 2 and 4 and ``tp_min_shard`` 1 and 8, alone
    and with zero_opt and fsdp at data 2, which leaves are cut and each
    rank's bytes of every parameter and of its optimizer moments equal
    what ``mesh.state_shardings`` gives on the virtual CPU mesh.
  * The tp collectives on 2 ranks against one process: a column-parallel
    dense, a norm scale gathered whole at use and the ``split`` /
    ``reduce_out`` pair, their forward, backward and a gradient of a
    gradient (R1's pattern: the penalty's gradient through the sharded
    weight).
  * π-GAN's fused SIREN trunk (the bf16 policy at width 128) on its tp
    blocks against the whole weights: the output and every gradient bit
    for bit, the blocks' gradients cut back from the whole ones.
  * All seven families on 1 × 1 × 2, dc_gan and gan_stability_r1 on
    2 × 1 × 2 and π-GAN on 1 × 2 × 2 against one device: the loss
    gradients at the initial parameters after the reduction (losses at
    rtol 1e-4, each leaf within 1e-3 · max(1, max|g|): test_tp.py's, and
    within the larger of 1e-4 · its own max|g| and 1e-5 · the net's),
    one superstep (metrics at rtol 2e-3, atol 1e-5; G's parameters within
    5e-3), the whole leaves and buffers bit-identical on every rank, and
    at least 4 leaves really cut.
  * zero_opt and fsdp on 2 × 1 × 2 end bit-identical to plain 2 × 1 × 2,
    and each rank holds its blocks.
  * One direct case: dc_gan and gan_stability_r1 on 2 × 1 × 2 against the
    JAX ``make_mesh(4, tp=2)`` from the same numpy weights, images and z:
    D's loss gradients at test_tp.py's tolerances (R1 in float32 on both
    sides).
  * The CLI: ``num_gpus=2 num_tp=2 --device cpu`` trains dc_gan, draws its
    SampleGrid, writes a checkpoint in the one-device format that resumes
    on one device, and ``train.fold_steps=2`` ends within test_tp.py's
    5e-4 of the unfolded run.
"""
import contextlib
import copy
import functools

import jax
import numpy as np
import pytest
import torch
from torch import nn

import run_network_torch
from lightning_gan_zoo_tpu.parallel import mesh as pmesh
from lightning_gan_zoo_tpu_torch.parallel import dist, sharding, tensor
from lightning_gan_zoo_tpu_torch.runtime.checkpoint import CheckpointManager
from lightning_gan_zoo_tpu_torch.runtime.state import (create_train_state,
                                                       full_state)
from lightning_gan_zoo_tpu_torch.runtime.steps import map_batch, superstep
from tests.test_torch_dist_families import (BATCH, DEADLINE, FAMILIES,
                                            family_batches, loss_grads,
                                            make_task, overrides_of,
                                            rank_rows, run_ranks,
                                            run_superstep)
from tests.test_torch_zero import (_jax_init, _port_task, _to_torch,
                                   assert_equal_trees)

torch.set_num_threads(2)

MIN_SHARD = 1
MODES = ("plain", "zero_opt", "fsdp")
#: the family that runs with the G weight EMA
EMA_FAMILY, EMA_DECAY = "dc_gan", 0.9
#: the families of the 2 × 1 × 2 grid (test_tp.py's strict pair)
DATA_TP = ("dc_gan", "gan_stability_r1")
TOL = dict(rtol=2e-3, atol=1e-5)


def tp_overrides(family: str):
    """The family's tiny config; R1 in float32 (its config's bf16 penalty
    rounds away part of the gradient of a gradient these tests check)."""
    extra = (["train.penalty_precision=32"]
             if family == "gan_stability_r1" else [])
    return overrides_of(family) + extra


def one_device(family: str, tmp) -> dict:
    """The loss gradients and superstep of tp_family_job on one device."""
    cfg, task = make_task(tp_overrides(family), tmp)
    batches = family_batches(cfg, family, BATCH)
    out = loss_grads(task, map_batch(lambda v: v[0], batches))
    cfg, task = make_task(tp_overrides(family), tmp)
    out.update(run_superstep(task, cfg, batches))
    return out


# ------------------------------------------------------------- the grid
def test_grid_positions_and_groups():
    assert [dist.grid_position(r, 2, 2) + (r % 2,) for r in range(8)] == [
        (0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
        (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)]
    data, sp = dist.grid_groups(8, 2, 2)
    assert data == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert sp == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert dist.tp_groups(8, 2) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert dist.grid_groups(4, 1, 2) == ([[0, 2], [1, 3]],
                                         [[0], [1], [2], [3]])
    assert (dist.tp_size(), dist.tp_rank()) == (1, 0)


@pytest.mark.parametrize("case", ["mesh", "one_device", "launch",
                                  "local_world_size", "trainer"])
def test_grid_refusals(case, monkeypatch, tmp_path):
    if case == "mesh":
        with pytest.raises(ValueError, match="num_sp=2 x num_tp=2 does not "
                           "divide the 2-device mesh"):
            dist.check_grid(2, 2, 2)
    elif case == "one_device":
        with pytest.raises(ValueError, match="num_sp=1 x num_tp=2 does not "
                           "divide the 1-device mesh"):
            dist.check_grid(1, 1, 2)
    elif case == "launch":          # refused before any rank starts
        with pytest.raises(ValueError, match="does not divide"):
            dist.launch(_grid_job, (), ["cpu"] * 2, backend="gloo", sp=2,
                        tp=2)
    elif case == "local_world_size":
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "4")
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="num_tp=2 x num_sp=2 must "
                           "divide the 2 ranks per node"):
            dist.init_from_env("cpu", sp=2, tp=2)
    else:
        from lightning_gan_zoo_tpu_torch.runtime.loop import Trainer
        cfg, _ = make_task(overrides_of("dc_gan") + ["num_tp=2"], tmp_path)
        with pytest.raises(ValueError, match="num_tp=2, but this process's "
                           "grid has tp=1"):
            Trainer(cfg, "cpu")
    assert not dist.is_initialized()


def _grid_job() -> dict:
    return {"rank": dist.rank(), "tp": (dist.tp_size(), dist.tp_rank()),
            "sp": (dist.sp_size(), dist.sp_rank()),
            "data": (dist.data_size(), dist.data_rank()),
            "rows": dist.local_rows(torch.arange(8)).tolist(),
            "tp_gathered": tensor.gather(
                torch.full((1, 1), float(dist.rank())), 1).tolist()}


# --------------------------------------------------------- the leaf rule
def _jax_tp_rule(family, tp, min_shard, zero, fsdp):
    """{net: {torch name: (cut over tp, param bytes, moment bytes)}} per
    rank, read from the JAX package's state_shardings on make_mesh(data ×
    tp, tp=tp), data 2 under zero_opt/fsdp, else 1."""
    g_vars, d_vars, st = _jax_init(family)
    data = 2 if zero or fsdp else 1
    mesh = pmesh.make_mesh(data * tp, tp=tp)
    sh = pmesh.state_shardings(st, mesh, min_shard, zero=zero, fsdp=fsdp)
    flat = jax.tree_util.tree_flatten_with_path
    rule, marked = {}, {}
    for net, variables, psh, osh in (("G", g_vars, sh.g_params, sh.g_opt),
                                     ("D", d_vars, sh.d_params, sh.d_opt)):
        params = variables["params"]
        leaves = flat(params)[0]
        specs = flat(psh, is_leaf=lambda x: hasattr(x, "spec"))[0]
        opt_specs = flat(osh, is_leaf=lambda x: hasattr(x, "spec"))[0]
        rule[net] = []
        for (path, x), (_, ps) in zip(leaves, specs):
            shape = tuple(x.shape)
            moments = {int(np.prod(s.shard_shape(shape))) * 4
                       for p, s in opt_specs if _moment_of(p, path)}
            assert len(moments) == 1, (net, path)
            cut = bool(shape) and pmesh._tp_leaf_spec(
                shape, tp, min_shard) != jax.sharding.PartitionSpec()
            rule[net].append((cut, int(np.prod(ps.shard_shape(shape))) * 4,
                              moments.pop()))
        marked[net] = {**jax.tree_util.tree_map(
            lambda x: np.zeros(tuple(x.shape), np.float32), variables),
            "params": jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params),
            [np.full(tuple(x.shape), i, np.float32)
             for i, (_, x) in enumerate(leaves)])}
    out = {}
    for net, sd in zip(("G", "D"), _to_torch(family, marked["G"],
                                             marked["D"])):
        out[net] = {}
        for name, t in sd.items():
            if name.endswith(".u") or "running" in name:
                continue                      # buffers: whole
            ids = torch.unique(t)
            assert len(ids) == 1, name
            out[net][name] = rule[net][int(ids[0])]
    return out


def _moment_of(opt_path, path) -> bool:
    """Whether an optax leaf's path is a moment of the parameter at
    ``path``: the parameter's path after the moment's (non-dict) key."""
    head = opt_path[:len(opt_path) - len(path)]
    return (opt_path[len(head):] == path and bool(head)
            and not isinstance(head[-1], jax.tree_util.DictKey))


def _port_tp_rule(family, tp, min_shard, zero, fsdp):
    """The same map from the blocks that parallel/sharding.py cuts on
    copies of the port's nets, tp rank by tp rank and data rank by data
    rank (no group). The blocks put together along their dims give each
    parameter back, tp-major."""
    task = _port_task(family)
    data = 2 if zero or fsdp else 1
    rule = {}
    for net, module in (("G", task.generator), ("D", task.discriminator)):
        whole = {n: p.detach().clone() for n, p in module.named_parameters()}
        per_tp = []
        for t in range(tp):
            m = copy.deepcopy(module)
            ts = sharding.TensorShards(m, min_shard, tp=tp, rank=t)
            per_tp.append((ts, [sharding.NetShards(
                m, fsdp, world=data if zero or fsdp else 1, rank=d, tp=ts)
                for d in range(data)]))
        rule[net] = {}
        cut = {lf.name for lf in per_tp[0][0].leaves}
        for i, lf in enumerate(per_tp[0][1][0].leaves):
            tp_parts = []
            for ts, per_data in per_tp:
                mine = [s.leaves[i] for s in per_data]
                if mine[0].shard is not None:
                    assert torch.equal(torch.cat([x.shard for x in mine],
                                                 mine[0].dim),
                                       mine[0].param.detach()), lf.name
                tp_parts.append(mine[0].param.detach())
            if lf.name in cut:
                assert lf.tp is not None and lf.param.tp_dim == lf.tp.dim
                back = torch.cat(tp_parts, lf.tp.dim)
            else:
                assert lf.tp is None and not tensor.is_block(lf.param)
                back = tp_parts[0]
            assert torch.equal(back, whole[lf.name]), lf.name
            held = lf.shard if lf.shard is not None else lf.param
            rule[net][lf.name] = (
                lf.name in cut,
                (held if fsdp else lf.param).numel() * 4,
                held.numel() * 4)
    return rule


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("min_shard", [1, 8])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family", FAMILIES)
def test_leaf_rule_matches_jax_state_shardings(family, tp, min_shard, mode):
    zero, fsdp = mode != "plain", mode == "fsdp"
    want = _jax_tp_rule(family, tp, min_shard, zero, fsdp)
    got = _port_tp_rule(family, tp, min_shard, zero, fsdp)
    for net in ("G", "D"):
        assert set(want[net]) == set(got[net]), net
        for name, w in want[net].items():
            assert got[net][name] == w, f"{family} {net} {name}"
    if min_shard == 1:
        assert any(cut for net in got.values() for cut, _, _ in
                   net.values())


def test_zero_leaf_rule_cases_with_tp():
    """tests/test_zero.py::test_zero_leaf_rule's data × tp cases on the
    port's rule: the data factor is read on the tp block's extent."""
    def spec(extent, ndim, data, tp, floor):
        on = sharding.tp_sharded(extent, ndim, tp, floor)
        per = tp if on else 1
        return on, sharding.sharded(extent, ndim, data, per)
    assert spec(16, 4, 2, 4, 1) == (True, True)      # ('data', 'tp')
    assert spec(16, 4, 2, 4, 8) == (False, True)     # floor: ('data',)
    assert spec(4, 1, 2, 4, 1) == (True, False)      # keeps 'tp'
    assert spec(10, 1, 2, 4, 1) == (False, True)     # (10,) over data
    assert spec(1, 0, 2, 4, 1) == (False, False)     # (): whole
    assert not sharding.tp_sharded(16, 4, 1, 1)      # no tp axis


def test_a_module_that_cannot_run_on_blocks_is_refused():
    class Scale(nn.Module):
        def __init__(self):
            super().__init__()
            self.weight = nn.Parameter(torch.ones(4))
    with pytest.raises(ValueError, match="cannot run on blocks"):
        sharding.TensorShards(Scale(), 1, tp=2, rank=0)


# ------------------------------------------------------- the tp collectives
def _ops_inputs():
    rng = np.random.default_rng(4)
    return {k: torch.from_numpy(rng.normal(size=s))
            for k, s in (("x", (3, 5)), ("w", (8, 5)), ("b", (8,)),
                         ("scale", (8,)), ("v", (3, 8)))}


def _ops_loss(y, v):
    """A replicated scalar with a dense Hessian in y."""
    return (torch.sin(y) * v).sum() ** 2


def _ops_graph(x, w, b, scale, v, dense, cut, whole, join):
    """y = (x·wᵀ + b) · scale, then the loss and R1's pattern: the
    gradient of |∂L/∂x|² with respect to the weights and x, through the
    dense (``dense``), the scale read whole (``whole``), and a split
    followed by a sum of the ranks' parts (``cut``, ``join``)."""
    y = dense(x, w, b) * whole(scale)
    y = y + join(cut(y))
    loss = _ops_loss(y, v)
    gx, = torch.autograd.grad(loss, x, create_graph=True)
    pen = (gx ** 2).sum()
    gw, gb, gs, gx2 = torch.autograd.grad(pen, (w, b, scale, x))
    return {"y": y.detach(), "loss": loss.detach(), "gx": gx.detach(),
            "gw": gw, "gb": gb, "gs": gs, "gx2": gx2}


def ops_job() -> dict:
    """The graph on this rank: the dense column-parallel on its blocks of
    w and b, the scale gathered whole from its block, and split /
    reduce_out (each rank's part of y, zero elsewhere, summed back)."""
    t, n = dist.tp_rank(), 8 // dist.tp_size()
    inp = _ops_inputs()
    x = inp["x"].clone().requires_grad_(True)
    w, b, s = (inp[k][t * n:(t + 1) * n].clone().requires_grad_(True)
               for k in ("w", "b", "scale"))
    for p in (w, b, s):
        p.tp_dim = 0

    def dense(x, w, b):
        return tensor.column_out(tensor.column_in(x, w) @ w.t() + b, w, -1)

    def join(part):
        full = torch.zeros(3, 8, dtype=part.dtype)
        full = full.index_copy(1, torch.arange(t * n, (t + 1) * n), part)
        return tensor.reduce_out(full)
    return _ops_graph(x, w, b, s, inp["v"], dense,
                      lambda y: tensor.split(y, 1), tensor.whole, join)


def _ops_one_process() -> dict:
    inp = _ops_inputs()
    x, w, b, s = (inp[k].clone().requires_grad_(True)
                  for k in ("x", "w", "b", "scale"))
    return _ops_graph(x, w, b, s, inp["v"], lambda x, w, b: x @ w.t() + b,
                      lambda y: y, lambda p: p, lambda y: y)


def _lstm_case(cut: bool) -> dict:
    """ANIGAN's LSTM deformer (its cell run through ``call_whole``, its
    denses column-parallel) on fixed points: the warp and the gradient of
    a loss of it with respect to the points and every parameter (blocks
    gathered whole)."""
    from lightning_gan_zoo_tpu_torch.anigan.deformer import LSTMDeformer
    torch.manual_seed(0)
    d = LSTMDeformer(template_subdivision=1, latent_size=8, hidden_size=16,
                     steps=2, n_verts=6,
                     generator=torch.Generator().manual_seed(1))
    with torch.no_grad():                 # a warp far from the identity
        d.out_affine.weight.normal_(0.0, 0.3,
                                    generator=torch.Generator().manual_seed(2))
    ts = sharding.TensorShards(d, MIN_SHARD) if cut else None
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(2, 5, 3))).float().requires_grad_()
    code = torch.from_numpy(rng.normal(size=(2, 8))).float()
    y = d.transform(x, None, None, None, code)
    params = {n: p for n, p in d.named_parameters() if p.requires_grad}
    grads = torch.autograd.grad((torch.sin(y) ** 2).sum(),
                                [x] + list(params.values()),
                                allow_unused=True)
    out = {"y": y.detach(), "gx": grads[0],
           "cut": [lf.name for lf in ts.leaves] if ts else []}
    for (n, p), g in zip(params.items(), grads[1:]):
        g = torch.zeros_like(p) if g is None else g
        out[n] = (tensor.gather_whole([g], [p.tp_dim])[0]
                  if tensor.is_block(p) else g)
    return out


def lstm_job() -> dict:
    return _lstm_case(cut=True)


#: a SirenNet that runs as the fused trunk: the bf16 policy at width 128
TRUNK_NET = dict(dim_in=3, dim_hidden=128, dim_out=128, num_layers=3)


def _trunk_case(cut: bool) -> dict:
    """π-GAN's fused SIREN trunk (on the CPU the wrapper's plain version)
    on this rank's tp blocks of its kernels and biases (``cut``: gathered
    whole by ``tensor.whole`` and stacked, their gradients cut back to the
    blocks by the gather's backward) or on the whole ones, at seeded
    points and FiLM parameters: the output, the gradients of a loss of it
    with respect to the points, γ, β and every kernel and bias (a block's
    as it is and gathered whole), and the wrapper's calls."""
    from lightning_gan_zoo_tpu_torch.nerf import siren
    net = siren.SirenNet(**TRUNK_NET, bf16=True,
                         generator=torch.Generator().manual_seed(3))
    ts = sharding.TensorShards(net, MIN_SHARD) if cut else None
    rng = np.random.default_rng(8)
    b, m, h, n = 2, 6, TRUNK_NET["dim_hidden"], TRUNK_NET["num_layers"]
    x, gam, bet, v = (torch.from_numpy(rng.normal(size=s)).float()
                      for s in ((b, m, 3), (b, n, h), (b, n, h), (b, m, h)))
    inputs = [t.requires_grad_(True) for t in (x, 1.0 + 0.1 * gam, 0.1 * bet)]
    params = dict(net.named_parameters())
    trunk, calls = siren.cuda_trunk.siren_trunk, []

    def counted(*args):
        calls.append(args[0].shape)
        return trunk(*args)

    siren.cuda_trunk.siren_trunk = counted
    try:
        y = net(*inputs)
    finally:
        siren.cuda_trunk.siren_trunk = trunk
    grads = torch.autograd.grad((y.float() * v).sum(),
                                inputs + list(params.values()))
    out = {"y": y.detach(), "calls": len(calls),
           "cut": [lf.name for lf in ts.leaves] if ts else [],
           **dict(zip(("dx", "dgammas", "dbetas"), grads))}
    for (k, p), g in zip(params.items(), grads[3:]):
        out[k] = g
        if tensor.is_block(p):
            out[f"{k} whole"] = tensor.gather_whole([g], [p.tp_dim])[0]
    return out


def trunk_job() -> dict:
    """The trunk on this rank's blocks, and on the whole weights in the
    same process (the same threads and kernels: the results must agree
    bit for bit)."""
    return {"tp": _trunk_case(cut=True), "one": _trunk_case(cut=False)}


# ---------------------------------------------------------- rank jobs
def _whole_grads(out: dict, task):
    """Each block's gradient in ``loss_grads``'s result gathered whole."""
    for side, net in (("d", task.discriminator), ("g", task.generator)):
        blocks = [(n, p) for n, p in net.named_parameters()
                  if tensor.is_block(p) and n in out[f"{side}_grads"]]
        wholes = tensor.gather_whole([out[f"{side}_grads"][n]
                                      for n, _ in blocks],
                                     [p.tp_dim for _, p in blocks])
        for (n, _), w in zip(blocks, wholes):
            out[f"{side}_grads"][n] = w


def _local(task) -> dict:
    """What this rank holds of G and D: the blocks and whole leaves, and
    the buffers."""
    return {net: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for net, m in (("G", task.generator),
                           ("D", task.discriminator))}


def tp_family_job(family: str, overrides, tmp, modes=("plain",)) -> dict:
    """The loss gradients at the initial parameters on the tp blocks (the
    reduced gradients, blocks gathered whole), then one superstep from the
    seed under each of ``modes``: its metrics, the full state (gathered to
    the one-device format), what the rank holds, its bytes, and which
    leaves were cut."""
    cfg, task = make_task(overrides, tmp)
    cut = sharding.tensor_parallel(task, MIN_SHARD)
    batches = rank_rows(family_batches(cfg, family, BATCH))
    out = loss_grads(task, map_batch(lambda v: v[0], batches))
    _whole_grads(out, task)
    out["cut"] = [lf.name for ts in cut for lf in ts.leaves]
    ema = family == EMA_FAMILY
    for mode in modes:
        cfg, task = make_task(overrides, tmp)
        state = create_train_state(task, steps_per_epoch=4, ema=ema,
                                   zero_opt=mode != "plain",
                                   fsdp=mode == "fsdp",
                                   tp_min_shard=MIN_SHARD)
        if family == EXPORT_FAMILY and mode == "plain":
            out["export"] = export_images(task, state)
        metrics = superstep(task, state, batches,
                            int(cfg.optimisation.disc_freq),
                            int(cfg.optimisation.gen_freq),
                            ema_decay=EMA_DECAY if ema else 0.0)
        held = sharding.held_bytes(task, state)
        with state.sharding.full():
            eval_keys = sorted(state.eval_g_params(task.generator))
        out[mode] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "held": held, "eval_keys": eval_keys,
            # fsdp frees the parameters' storage between supersteps
            "local": _local(task) if mode == "plain" else None,
            "state": torch.utils._pytree.tree_map(
                lambda v: v.detach().clone() if torch.is_tensor(v) else v,
                full_state(task, state))}
    return out


#: the family whose serving export is taken on the tp grid
EXPORT_FAMILY = "dc_gan"


def export_images(task, state=None) -> dict:
    """G's serving export at the initial parameters (inside ``full()`` on
    a tp grid, refused outside it) and its images for a fixed z and
    seed."""
    from lightning_gan_zoo_tpu_torch.serving.export import (
        build_exported_generator)
    out = {}
    if state is not None:
        try:
            build_exported_generator(task, 2)
        except ValueError as e:
            out["refused"] = str(e)
    with (state.sharding.full() if state is not None
          else contextlib.nullcontext()):
        program, _ = build_exported_generator(task, 2)
    task.generator.train()          # the export leaves G in eval mode
    z = torch.from_numpy(np.random.default_rng(9).normal(
        size=(2, int(task.noise_dim))).astype(np.float32))
    out["images"] = program.module()(z, torch.tensor(3))
    return out


def jax_fed_job(overrides, tmp, g_state, d_state, images, z) -> dict:
    """D's loss gradients on the grid from given state dicts, on given
    global images and z (each rank takes its data rows)."""
    cfg, task = make_task(overrides, tmp)
    task.generator.load_state_dict(g_state)
    task.discriminator.load_state_dict(d_state)
    sharding.tensor_parallel(task, MIN_SHARD)
    task.sample_z = lambda n, generator=None: dist.local_rows(
        torch.from_numpy(z))
    micro = {"image": dist.local_rows(torch.from_numpy(images).permute(
        0, 3, 1, 2).contiguous())}
    task.discriminator.requires_grad_(True)
    task.generator.requires_grad_(False)
    with dist.global_draws():
        loss, _ = task.disc_loss(micro, task.sample_z(0), {})
    loss.backward()
    dist.average_grads(task.discriminator.parameters())
    out = {"d_loss": float(dist.average_metrics({"l": loss.detach()})["l"]),
           "d_grads": {n: p.grad.clone() for n, p
                       in task.discriminator.named_parameters()
                       if p.grad is not None},
           "g_grads": {}}
    _whole_grads(out, task)
    return out


def jax_tp_grads(family: str, tmp: str):
    """The JAX D-loss gradients on make_mesh(4, tp=2) at numpy weights
    (test_tp.py::test_tp_grads_match_replicated's computation), and the
    port's job on the same weights, images and z."""
    from tests.test_torch_gan2d import CONVERT, _args, _images, make_pair
    # R1 in float32 on both sides: at penalty_precision 16 the JAX twin's
    # bf16 dtype and the port's bf16 autocast round differently
    extra = ["train.penalty_precision=32"]
    jtask, task, g_vars, d_vars = make_pair(family, tmp, extra)
    mesh = pmesh.make_mesh(4, tp=2)
    s = int(task.cfg.train.img_size)
    images = _images((BATCH, s, s, 3), 5)
    z = np.asarray(jtask.sample_z(jax.random.PRNGKey(11), BATCH))
    rows, rep = pmesh.batch_sharding(mesh, stacked=False), \
        pmesh.replicated(mesh)
    g_params = jax.device_put(g_vars["params"], pmesh.params_shardings(
        g_vars["params"], mesh, MIN_SHARD))
    d_params = jax.device_put(d_vars["params"], pmesh.params_shardings(
        d_vars["params"], mesh, MIN_SHARD))
    g_state, d_state = jax.device_put(
        ({k: v for k, v in g_vars.items() if k != "params"},
         {k: v for k, v in d_vars.items() if k != "params"}), rep)
    (loss, _), grads = jax.jit(pmesh.with_mesh_context(
        jax.value_and_grad(jtask.disc_loss, has_aux=True), mesh))(
        d_params, g_params, g_state, d_state,
        jax.device_put({"image": images}, rows), jax.device_put(z, rows),
        jax.random.PRNGKey(23), jax.device_put(jtask.initial_extra(), rep))
    to_g, to_d = CONVERT["resnet" if family == "gan_stability_r1" else "dc"]
    job = (_args(family, extra), tmp, to_g(g_vars), to_d(d_vars), images, z)
    return job, {"d_loss": float(loss),
                 "d_grads": to_d({"params": jax.device_get(grads)})}


def grid_jobs(tmp: str, n: int, sp: int, jax_jobs=None) -> list:
    jobs = [("grid", _grid_job, ())]
    if n == 2:
        jobs += [("ops", ops_job, ()), ("lstm", lstm_job, ()),
                 ("trunk", trunk_job, ())]
        jobs += [(f, tp_family_job, (f, tp_overrides(f), tmp))
                 for f in FAMILIES]
    elif sp == 1:
        jobs += [(f, tp_family_job, (f, tp_overrides(f), tmp, MODES))
                 for f in DATA_TP]
        jobs += [(f"jax_{f}", jax_fed_job, j) for f, j in jax_jobs.items()]
    else:
        jobs.append(("pigan", tp_family_job, ("pigan", tp_overrides("pigan"),
                                              tmp)))
    return jobs


#: the grids: (ranks, sp) → data × sp × tp = (n/(2·sp)) × sp × 2
GRIDS = {"1x1x2": (2, 1), "2x1x2": (4, 1), "1x2x2": (4, 2)}


@pytest.fixture(scope="module")
def jax_tp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_jax")
    return {f: jax_tp_grads(f, str(tmp / f)) for f in DATA_TP}


@pytest.fixture(scope="module")
def grids(tmp_path_factory, jax_tp):
    tmp = tmp_path_factory.mktemp("tp")
    jobs = {f: j for f, (j, _) in jax_tp.items()}
    return {g: run_ranks(grid_jobs(str(tmp), n, sp, jobs), tmp / g, n,
                         sp=sp, tp=2)
            for g, (n, sp) in GRIDS.items()}


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    """The one-device loss gradients and superstep of each family."""
    tmp = tmp_path_factory.mktemp("tp_one")
    return functools.lru_cache(maxsize=None)(lambda f: one_device(f, tmp))


# ------------------------------------------------------------- the tests
@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_of_the_ranks(grid, grids):
    n, sp = GRIDS[grid]
    data = n // (2 * sp)
    for r, got in enumerate(x["grid"] for x in grids[grid]):
        d, s = dist.grid_position(r, sp, 2)
        assert got["tp"] == (2, r % 2)
        assert got["sp"] == (sp, s) and got["data"] == (data, d)
        b = 8 // data
        assert got["rows"] == list(range(d * b, (d + 1) * b))
        base = r - r % 2
        assert got["tp_gathered"] == [[float(base), float(base + 1)]]


def test_tp_ops_forward_backward_and_second_order(grids):
    want = _ops_one_process()
    for t, got in enumerate(r["ops"] for r in grids["1x1x2"]):
        blk = slice(4 * t, 4 * t + 4)
        for k in ("y", "loss", "gx", "gx2"):
            torch.testing.assert_close(got[k], want[k], rtol=1e-10,
                                       atol=1e-10, msg=k)
        for k in ("gw", "gb", "gs"):
            torch.testing.assert_close(got[k], want[k][blk], rtol=1e-10,
                                       atol=1e-10, msg=k)


def test_lstm_deformer_on_blocks(grids):
    """The LSTM cell's gate leaves and the deformer's denses cut over tp:
    the warp and every gradient equal one process's."""
    want = _lstm_case(cut=False)
    for got in (r["lstm"] for r in grids["1x1x2"]):
        assert {"lstm.weight_ih", "lstm.weight_hh", "lstm.bias_hh",
                "offset_dense1.weight"} <= set(got.pop("cut"))
        want.pop("cut", None)
        assert set(got) == set(want)
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-6,
                                       msg=k)


def test_fused_trunk_on_blocks(grids):
    """The fused trunk under tp: every kernel and bias of the SirenNet cut,
    the wrapper called once, and the output, dx, dγ, dβ and each leaf's
    gradient (the rank's block, and every rank's gathered whole) equal, bit
    for bit, to the trunk on the whole weights."""
    n_leaves = 2 * (TRUNK_NET["num_layers"] + 1)
    for t, r in enumerate(x["trunk"] for x in grids["1x1x2"]):
        got, want = r["tp"], r["one"]
        assert len(got.pop("cut")) == n_leaves
        assert got.pop("calls") == want.pop("calls") == 1
        want.pop("cut")
        for k, w in want.items():
            torch.testing.assert_close(got[k + " whole"] if k.startswith(
                "layers.") else got[k], w, rtol=0, atol=0, msg=k)
            if k.startswith("layers."):
                blk = w.shape[-1] // 2
                torch.testing.assert_close(
                    got[k], w[..., t * blk:(t + 1) * blk], rtol=0, atol=0,
                    msg=f"{k} block {t}")


def _assert_grads_match(got, want, where):
    for side in ("d", "g"):
        np.testing.assert_allclose(got[f"{side}_loss"], want[f"{side}_loss"],
                                   rtol=1e-4, err_msg=f"{where} {side}_loss")
        assert set(got[f"{side}_grads"]) == set(want[f"{side}_grads"])
        net_max = max(float(a.abs().max())
                      for a in want[f"{side}_grads"].values())
        for k, a in want[f"{side}_grads"].items():
            tol = 1e-3 * max(1.0, float(a.abs().max()))
            np.testing.assert_allclose(got[f"{side}_grads"][k].numpy(),
                                       a.numpy(), atol=tol,
                                       err_msg=f"{where} {side} {k}")
            # and on the gradients' own scale: at these widths they are
            # far below 1, and so are R1's second-order terms. The floor
            # is float noise where a leaf's gradient is zero in exact
            # arithmetic (a conv bias before an instance norm)
            np.testing.assert_allclose(
                got[f"{side}_grads"][k].numpy(), a.numpy(),
                atol=max(1e-4 * float(a.abs().max()), 1e-5 * net_max),
                err_msg=f"{where} {side} {k} (own scale)")


def _cases():
    for f in FAMILIES:
        yield "1x1x2", f
    for f in DATA_TP:
        yield "2x1x2", f
    yield "1x2x2", "pigan"


CASES = list(_cases())


@pytest.mark.parametrize("grid,family", CASES)
def test_tp_loss_grads_match_one_device(grid, family, grids, one):
    want = one(family)
    for got in (r[family] for r in grids[grid]):
        _assert_grads_match(got, want, f"{family} {grid}")
        assert len(got["cut"]) >= 4, got["cut"]


@pytest.mark.parametrize("grid,family", CASES)
def test_tp_superstep_matches_one_device(grid, family, grids, one):
    ranks = [r[family]["plain"] for r in grids[grid]]
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        assert_equal_trees(r["state"], ranks[0]["state"])
    want = one(family)
    assert set(ranks[0]["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], v, **TOL,
                                   err_msg=f"{family} {grid} {k}")
    g = ranks[0]["state"]["generator"]
    assert set(g) == set(want["G"])
    for k, v in want["G"].items():
        np.testing.assert_allclose(g[k].numpy(), v.numpy(), atol=5e-3,
                                   err_msg=f"{family} {grid} G {k}")


@pytest.mark.parametrize("grid,family", CASES)
def test_whole_leaves_identical_and_blocks_held(grid, family, grids):
    """After the superstep every rank holds the same whole leaves and
    buffers, and each block is its tp rank's slice of the gathered
    one-device leaf (so the ranks of a data or sp group hold the same
    blocks); inside ``full()`` G's eval parameters are the whole ones."""
    ranks = [r[family] for r in grids[grid]]
    full = ranks[0]["plain"]["state"]
    cut = set(ranks[0]["cut"])
    for r, got in enumerate(ranks):
        assert got["cut"] == ranks[0]["cut"]
        for net, key in (("G", "generator"), ("D", "discriminator")):
            mine = got["plain"]["local"][net]
            assert set(mine) == set(full[key])
            for k, v in mine.items():
                whole = full[key][k]
                if v.shape == whole.shape:
                    assert torch.equal(v, ranks[0]["plain"]["local"][net][k]
                                       ), f"{family} {net} {k} rank {r}"
                    continue
                assert f"{'generator' if net == 'G' else 'discriminator'}" \
                    and any(c.endswith(k) for c in cut), k
                dim = _dim_of(whole.shape, v.shape)
                size = v.shape[dim]
                assert torch.equal(v, whole.narrow(dim, (r % 2) * size,
                                                   size)), f"{net} {k}"
        assert got["plain"]["eval_keys"] == sorted(
            k for k in full["generator"] if "running" not in k
            and not k.endswith(".u"))


def _dim_of(whole, block):
    dims = [i for i, (a, b) in enumerate(zip(whole, block)) if a != b]
    assert len(dims) == 1, (whole, block)
    return dims[0]


@pytest.mark.parametrize("mode", ["zero_opt", "fsdp"])
@pytest.mark.parametrize("family", DATA_TP)
def test_sharded_state_composes_with_tp(family, mode, grids):
    """zero_opt and fsdp on 2 × 1 × 2 end bit-identical to plain
    2 × 1 × 2 on every rank; zero_opt holds less optimizer state, fsdp
    fewer parameters too."""
    for r in grids["2x1x2"]:
        got, plain = r[family][mode], r[family]["plain"]
        assert got["metrics"] == plain["metrics"]
        assert_equal_trees(got["state"], plain["state"], f"{family} {mode}")
        assert got["held"]["optimizer"] < 0.75 * plain["held"]["optimizer"]
        if mode == "fsdp":
            assert got["held"]["params"] < 0.75 * plain["held"]["params"]
    if family == EMA_FAMILY:
        assert grids["2x1x2"][0][family][mode]["state"]["g_ema"] is not None


def test_tp_holds_a_share_of_the_state(grids, one):
    """On 1 × 1 × 2 each rank holds its blocks: about half of one
    device's parameters (and Adam's two moments of them), the two ranks
    equal shares."""
    for family in ("dc_gan", "hologan"):
        held = [r[family]["plain"]["held"] for r in grids["1x1x2"]]
        assert held[0] == held[1]
        whole = sum(v.numel() * 4 for net in ("G", "D")
                    for k, v in one(family)[net].items()
                    if "running" not in k and not k.endswith(".u"))
        assert 0.45 * whole < held[0]["params"] < 0.6 * whole
        assert held[0]["optimizer"] < 1.2 * whole


@pytest.mark.parametrize("family", DATA_TP)
def test_tp_grid_matches_the_jax_tp_mesh(family, grids, jax_tp):
    want = jax_tp[family][1]
    for got in (r[f"jax_{family}"] for r in grids["2x1x2"]):
        np.testing.assert_allclose(got["d_loss"], want["d_loss"], rtol=1e-4,
                                   err_msg=family)
        assert set(got["d_grads"]) == set(want["d_grads"]) - {
            k for k in want["d_grads"] if "running" in k or k.endswith(".u")}
        for k, a in got["d_grads"].items():
            w = want["d_grads"][k]
            tol = 1e-3 * max(1.0, float(w.abs().max()))
            np.testing.assert_allclose(a.numpy(), w.numpy(), atol=tol,
                                       err_msg=f"{family} {k}")


def test_export_from_the_gathered_generator(grids, tmp_path):
    """The serving export refuses G's tp blocks and, inside ``full()``,
    exports the whole G: its images equal the one-device export's."""
    _, task = make_task(tp_overrides(EXPORT_FAMILY), tmp_path)
    want = export_images(task)["images"]
    for got in (r[EXPORT_FAMILY]["export"] for r in grids["1x1x2"]):
        assert "tp blocks" in got["refused"]
        torch.testing.assert_close(got["images"], want, rtol=0, atol=0)


# --------------------------------------------------------------- the CLI
CLI = ["+expt=dc_gan", "dataset=synthetic", "calc_fid=False",
       "train.batch_size=4", "train.img_size=16", "train.features_disc=8",
       "train.features_gen=8", "model.noise_dim=8", "dataset.n=16",
       "train.num_epochs=1", "figure_details.fid_callback=False",
       "tp_min_shard=1"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_cli")
    runs = {}
    for fold in (1, 2):
        out = tmp / f"f{fold}"
        rc = run_network_torch.main(CLI + [
            "num_gpus=2", "num_tp=2", f"train.fold_steps={fold}",
            f"output_root={out}", "version=v", "--device", "cpu"],
            deadline=DEADLINE)
        assert rc == 0
        runs[fold] = out / "dc_gan" / "v"
    return runs


def _last_state(run):
    return CheckpointManager.restore(
        CheckpointManager.find_ckpt(run / "ckpts"))


def test_cli_trains_on_a_tp_grid_and_draws_its_figure(cli_runs):
    run = cli_runs[1]
    assert list((run / "figures").glob("SampleGrid*.png"))
    assert list((run / "images").glob("Fake_step*.png"))


def test_cli_tp_checkpoint_resumes_on_one_device(cli_runs, tmp_path):
    payload, meta = _last_state(cli_runs[1])
    assert meta["epoch"] == 0 and payload["step"] == 4
    # the one-device format: every tensor at its one-device shape
    cfg, task = make_task(CLI, tmp_path)
    for key, net in (("generator", task.generator),
                     ("discriminator", task.discriminator)):
        assert {k: tuple(v.shape) for k, v in payload[key].items()} == {
            k: tuple(v.shape) for k, v in net.state_dict().items()}
    rc = run_network_torch.main(CLI + [
        "train.num_epochs=2", f"train.ckpt_dir={cli_runs[1] / 'ckpts'}",
        f"output_root={tmp_path}", "version=resumed", "save_ckpts=False",
        "--device", "cpu"])
    assert rc == 0
    log = (tmp_path / "dc_gan" / "resumed" / "metrics.csv").read_text()
    assert "train/d_loss" in log


def test_cli_tp_fold_steps_matches_unfolded(cli_runs):
    """train.fold_steps=2 on the tp grid trains to within test_tp.py's
    5e-4 of the unfolded tp run: G's parameters in each run's
    checkpoint."""
    a, b = (_last_state(cli_runs[f])[0] for f in (1, 2))
    assert a["step"] == b["step"] == 4
    for k, v in a["generator"].items():
        np.testing.assert_allclose(b["generator"][k].numpy(), v.numpy(),
                                   atol=5e-4, err_msg=k)
