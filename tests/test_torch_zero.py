"""ZeRO-1 (``zero_opt``) and FSDP (``fsdp``) state sharding
(parallel/sharding.py) for all seven families, on the CPU over gloo.

  * The leaf rule against the JAX package: for every family at world 2 and
    4, the sharded leaves and each rank's bytes of every parameter leaf
    equal what ``mesh.state_shardings(..., zero=True|fsdp=True)`` gives on
    the JAX package's virtual CPU mesh, leaf by leaf through convert.py's
    names (each flax leaf is filled with its own index, so the converted
    torch tensor names its flax leaf).
  * Against plain data parallelism: two supersteps of every family on two
    ranks under zero_opt and under fsdp end bit-identical (``torch.equal``)
    to the plain two-rank run: parameters, buffers, the optimizers'
    state gathered to the one-device format, the EMA twin (dc_gan), and the
    metrics. Each rank holds only its blocks of what is sharded. WGAN's
    clipped D stays within its clip after the update.
  * On four ranks, dc_gan and gan_stability_r1 (the JAX test_zero.py pair)
    under zero_opt and fsdp against one device, at the tolerances of
    tests/test_torch_dist_families.py.
  * On one device both switches do nothing.
"""
import functools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lightning_gan_zoo_tpu.parallel import mesh as pmesh
from lightning_gan_zoo_tpu.parallel.family_runs import build_family
from lightning_gan_zoo_tpu.runtime.state import create_train_state as jax_state
from lightning_gan_zoo_tpu_torch import convert
from lightning_gan_zoo_tpu_torch.parallel import dist
from lightning_gan_zoo_tpu_torch.parallel import sharding
from lightning_gan_zoo_tpu_torch.runtime.state import (create_train_state,
                                                       full_state)
from lightning_gan_zoo_tpu_torch.runtime.steps import superstep
from tests.test_torch_dist_families import (BATCH, FAMILIES, family_batches,
                                            make_task, overrides_of,
                                            rank_rows, run_ranks)

torch.set_num_threads(2)

CONF_DIR = Path(__file__).resolve().parent.parent / "conf"
MODES = ("plain", "zero_opt", "fsdp")
SUPERSTEPS = 2
#: the 2D family that runs with the G weight EMA
EMA_FAMILY, EMA_DECAY = "dc_gan", 0.9


# ------------------------------------------------------------- leaf rule
def _to_torch(family, g_vars, d_vars):
    """convert.py's G and D state_dicts of flax variables."""
    if family == "hologan":
        return (convert.generator_state_dict(g_vars),
                convert.discriminator_state_dict(d_vars))
    if family in ("pigan", "anigan"):
        to_g = (convert.anigan_generator_state_dict if family == "anigan"
                else convert.pigan_generator_state_dict)
        return to_g(g_vars), convert.pigan_discriminator_state_dict(d_vars)
    if family == "gan_stability_r1":
        return (convert.resnet_generator_state_dict(g_vars),
                convert.resnet_discriminator_state_dict(d_vars))
    return (convert.dcgan_generator_state_dict(g_vars),
            convert.dcgan_discriminator_state_dict(d_vars))


@functools.lru_cache(maxsize=None)
def _jax_init(family):
    """The shapes of the JAX family's variables and of its TrainState
    (shared by the cases; the rule reads shapes only)."""
    _, task = build_family(CONF_DIR, family, BATCH)
    g_vars, d_vars = jax.eval_shape(task.init, jax.random.PRNGKey(0))
    d_tx, g_tx = task.configure_optimizers(steps_per_epoch=4)
    return g_vars, d_vars, jax.eval_shape(
        lambda g, d: jax_state(g, d, g_tx, d_tx), g_vars, d_vars)


@functools.lru_cache(maxsize=None)
def _port_task(family):
    return make_task(overrides_of(family), "/tmp/lgzt_zero_rule")[1]


def _jax_leaf_rule(family, world, fsdp):
    """{net: {torch name: (sharded, bytes per rank)}} of the parameter
    leaves, read from the JAX package's state_shardings on
    make_mesh(world): under zero the parameter's optimizer moments (every
    optax leaf whose path ends in the parameter's), under fsdp the
    parameter itself too (and its moments must agree)."""
    g_vars, d_vars, st = _jax_init(family)
    sh = pmesh.state_shardings(st, pmesh.make_mesh(world), zero=True,
                               fsdp=fsdp)
    flat = jax.tree_util.tree_flatten_with_path
    marked, per_leaf = {}, {}
    for net, variables, psh, osh in (("G", g_vars, sh.g_params, sh.g_opt),
                                     ("D", d_vars, sh.d_params, sh.d_opt)):
        params = variables["params"]
        leaves = flat(params)[0]
        opt_specs = flat(osh, is_leaf=lambda x: hasattr(x, "spec"))[0]
        rule = []
        for (path, x), (_, pspec) in zip(leaves, flat(
                psh, is_leaf=lambda x: hasattr(x, "spec"))[0]):
            moments = [s for p, s in opt_specs if p[-len(path):] == path]
            assert moments, (net, path)
            on = {not s.is_fully_replicated for s in moments}
            assert len(on) == 1, (net, path)
            assert pspec.is_fully_replicated != (fsdp and on == {True})
            shard = moments[0].shard_shape(tuple(x.shape))
            rule.append((on.pop(), int(np.prod(shard)) * 4))
        per_leaf[net] = rule
        # each flax leaf filled with its index names it after conversion
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
            ids = torch.unique(t)
            if name.endswith(".u") or "running" in name:
                continue                      # buffers: whole
            assert len(ids) == 1, name
            out[net][name] = per_leaf[net][int(ids[0])]
    return out


def _port_leaf_rule(family, world):
    """The same map from the blocks that parallel/sharding.py cuts on each
    of ``world`` ranks of the port's modules (no group: the blocks are cut,
    nothing gathers). Each rank's blocks are equal in size and, put
    together along their dim, give the parameter back."""
    task = _port_task(family)
    rule = {}
    for net, module in (("G", task.generator), ("D", task.discriminator)):
        per_rank = [sharding.NetShards(module, fsdp=False, world=world,
                                       rank=r) for r in range(world)]
        rule[net] = {}
        for leaves in zip(*(s.leaves for s in per_rank)):
            lf = leaves[0]
            if lf.shard is None:
                rule[net][lf.name] = (False, lf.param.numel() * 4)
                continue
            sizes = {x.shard.numel() * 4 for x in leaves}
            assert len(sizes) == 1, lf.name
            assert torch.equal(torch.cat([x.shard for x in leaves], lf.dim),
                               lf.param.detach()), lf.name
            rule[net][lf.name] = (True, sizes.pop())
    return rule


@pytest.mark.parametrize("fsdp", [False, True], ids=["zero_opt", "fsdp"])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("family", FAMILIES)
def test_leaf_rule_matches_jax_state_shardings(family, world, fsdp):
    """The sharded leaves and each rank's bytes, leaf by leaf, are the JAX
    package's at this world size: zero_opt's moments, and fsdp's
    parameters with their moments, all by one rule."""
    want = _jax_leaf_rule(family, world, fsdp)
    got = _port_leaf_rule(family, world)
    for net in ("G", "D"):
        assert set(want[net]) == set(got[net]), net
        for name, w in want[net].items():
            assert got[net][name] == w, f"{family} {net} {name}"
        assert any(on for on, _ in got[net].values()), net


def test_zero_leaf_rule_cases():
    """tests/test_zero.py::test_zero_leaf_rule's cases on the port's rule:
    the data-axis ones, then the data × tp ones (the data factor read with
    the leaf's tp factor, 1 where the tp rule leaves it whole)."""
    assert sharding.sharded(16, 4, 8)            # (3, 3, 8, 16) over 8
    assert sharding.sharded(16, 1, 8)            # (16,)
    assert not sharding.sharded(10, 1, 8)        # (10,): whole
    assert not sharding.sharded(1, 0, 8)         # (): whole
    assert not sharding.sharded(16, 4, 1)        # one rank: whole
    assert sharding.sharded(2, 1, 2)             # no floor on data
    # (data=2, tp=4): a tp-sharded leaf's moment gains the data axis too
    assert sharding.tp_sharded(16, 4, 4, 1) and sharding.sharded(16, 4, 2, 4)
    # the tp floor keeps the leaf whole over tp: its moment over data only
    assert not sharding.tp_sharded(16, 4, 4, 8)
    assert sharding.sharded(16, 4, 2, 1)
    # divisible by tp but not by data × tp: it keeps its tp placement
    assert sharding.tp_sharded(4, 1, 4, 1)
    assert not sharding.sharded(4, 1, 2, 4)


def test_jax_leaf_rule_spot_checks():
    """The JAX rule the comparison reads, as test_zero.py pins it."""
    P = jax.sharding.PartitionSpec
    assert pmesh._zero_leaf_spec((3, 3, 8, 16), 8, 1, 8) == \
        P(None, None, None, ("data",))
    assert pmesh._zero_leaf_spec((10,), 8, 1, 8) == P()


# -------------------------------------------------- against plain DP
def mode_job(family: str, overrides, tmp: str, n_steps: int = SUPERSTEPS,
             modes=MODES) -> dict:
    """``n_steps`` supersteps from the family's seed under each mode on
    this rank's rows: the metrics of each, the full state (gathered) and
    the bytes this rank holds of each part."""
    ema = family == EMA_FAMILY
    out = {}
    for mode in modes:
        cfg, task = make_task(overrides, tmp)
        batches = rank_rows(family_batches(cfg, family, BATCH))
        state = create_train_state(task, steps_per_epoch=4, ema=ema,
                                   zero_opt=mode != "plain",
                                   fsdp=mode == "fsdp")
        metrics = []
        for _ in range(n_steps):
            m = superstep(task, state, batches,
                          int(cfg.optimisation.disc_freq),
                          int(cfg.optimisation.gen_freq),
                          ema_decay=EMA_DECAY if ema else 0.0)
            metrics.append({k: float(v) for k, v in m.items()})
        held = sharding.held_bytes(task, state)
        full = full_state(task, state)
        out[mode] = {"metrics": metrics, "held": held,
                     "state": torch.utils._pytree.tree_map(
                         lambda v: v.detach().clone() if torch.is_tensor(v)
                         else v, full)}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero")
    jobs = [(f, mode_job, (f, overrides_of(f), str(tmp))) for f in FAMILIES]
    return run_ranks(jobs, tmp / "out")


def assert_equal_trees(a, b, where=""):
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.shape == b.shape, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_equal_trees(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_equal_trees(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("mode", ["zero_opt", "fsdp"])
@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_supersteps_equal_plain_data_parallelism(family, mode,
                                                         ranks):
    for r in ranks:
        got, want = r[family][mode], r[family]["plain"]
        assert got["metrics"] == want["metrics"]
        assert_equal_trees(got["state"], want["state"], f"{family} {mode}")
    assert_equal_trees(ranks[0][family][mode]["state"],
                       ranks[1][family][mode]["state"])
    if family == EMA_FAMILY:
        assert ranks[0][family][mode]["state"]["g_ema"] is not None
    if family == "wgan":
        clip = 0.01
        d = ranks[0][family][mode]["state"]["discriminator"]
        assert max(float(v.abs().max()) for k, v in d.items()
                   if "running" not in k) <= clip


@pytest.mark.parametrize("family", FAMILIES)
def test_each_rank_holds_its_blocks(family, ranks):
    """Per rank, zero_opt holds a share of the optimizer state and fsdp of
    the parameters and the EMA too; the ranks hold equal shares."""
    held = {m: [r[family][m]["held"] for r in ranks] for m in MODES}
    for m in MODES:
        assert held[m][0] == held[m][1], m
    plain, zero, fsdp = (held[m][0] for m in MODES)
    assert zero["optimizer"] < 0.75 * plain["optimizer"]
    assert fsdp["optimizer"] == zero["optimizer"]
    # zero_opt keeps the whole parameters beside the blocks it steps
    assert plain["params"] < zero["params"] < 1.75 * plain["params"]
    assert fsdp["params"] < 0.75 * plain["params"]
    assert fsdp["ema"] < 0.75 * plain["ema"] or family != EMA_FAMILY
    assert zero["ema"] == plain["ema"]


# ---------------------------------------------------- four ranks, one rank
FOUR_RANK_FAMILIES = ("dc_gan", "gan_stability_r1")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero4")
    jobs = [(f, mode_job, (f, overrides_of(f), str(tmp), 1,
                           ("zero_opt", "fsdp")))
            for f in FOUR_RANK_FAMILIES]
    return run_ranks(jobs, tmp / "out", n=4)


@pytest.mark.parametrize("family", FOUR_RANK_FAMILIES)
def test_four_ranks_match_one_device(family, four_ranks, tmp_path):
    """dc_gan and gan_stability_r1 (the JAX test_zero.py pair) on four
    ranks under zero_opt and fsdp: the ranks bit-identical, the metrics at
    tests/test_torch_dist_families.py's tolerances against one device."""
    ranks = four_ranks
    one = mode_job(family, overrides_of(family), str(tmp_path), 1,
                   modes=("plain",))["plain"]["metrics"][0]
    for mode in ("zero_opt", "fsdp"):
        for r in ranks[1:]:
            assert_equal_trees(r[family][mode]["state"],
                               ranks[0][family][mode]["state"])
        got = ranks[0][family][mode]["metrics"][0]
        assert set(got) == set(one)
        for k, v in one.items():
            np.testing.assert_allclose(got[k], v, rtol=2e-3, atol=1e-5,
                                       err_msg=f"{family} {mode} {k}")


def test_one_device_ignores_both_switches(tmp_path):
    """zero_opt=true fsdp=true on one device is bit-equal to both off (the
    JAX Trainer's ``multi`` rule)."""
    ov = overrides_of(EMA_FAMILY)
    a = mode_job(EMA_FAMILY, ov, str(tmp_path), modes=("plain",))["plain"]
    cfg, task = make_task(ov, tmp_path)
    state = create_train_state(task, steps_per_epoch=4, ema=True,
                               zero_opt=True, fsdp=True)
    assert state.sharding is None and not dist.is_initialized()
    batches = family_batches(cfg, EMA_FAMILY, BATCH)
    for m in a["metrics"]:
        got = superstep(task, state, batches, 1, 1, ema_decay=EMA_DECAY)
        assert {k: float(v) for k, v in got.items()} == m
    assert_equal_trees(full_state(task, state), a["state"])
