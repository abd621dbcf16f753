"""The optimizers' update counts and kinds against optax, on the CPU in
float32.

optax keeps one update count for the whole parameter tree and updates every
leaf at every step, a zero gradient standing in for a leaf the loss does not
reach. The port's superstep gives such a parameter a zero gradient
(runtime/steps.py::fill_missing_grads), so torch's optimizers count and
update as optax does. Checked here: a π-GAN run across a resolution step
(D's blocks above 16 px get no gradient until annealing brings them in)
against the JAX superstep, every parameter and every Adam moment and count
after each superstep; AdamW and SGD against optax over 20 scheduled updates
with some leaves left without a gradient; restoring optimizer state that
lacks some parameters; and both kinds through the port's CLI. Each test
states its bound.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import run_network_torch
from tests.conftest import CONF_DIR
from tests.test_torch_pigan import B, PIGAN_TINY, _images, _random_variables
from lightning_gan_zoo_tpu.config import compose as jax_compose
from lightning_gan_zoo_tpu.config.registry import instantiate as jax_inst
from lightning_gan_zoo_tpu.runtime import optim as jax_optim
from lightning_gan_zoo_tpu.runtime.state import create_train_state as jax_state
from lightning_gan_zoo_tpu.runtime.steps import build_superstep
from lightning_gan_zoo_tpu_torch import convert
from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.config.node import Config
from lightning_gan_zoo_tpu_torch.config.registry import instantiate
from lightning_gan_zoo_tpu_torch.runtime import optim
from lightning_gan_zoo_tpu_torch.runtime.state import create_train_state
from lightning_gan_zoo_tpu_torch.runtime.steps import (fill_missing_grads,
                                                        superstep)

torch.set_num_threads(2)

#: π-GAN enters D at 16 px, then at 32; D holds blocks up to 64 px
ANNEAL = [a for a in PIGAN_TINY if not a.startswith(
    "resolution_annealing.resolutions")] + [
    "resolution_annealing.resolutions=[16,32,32]"]
STEPS_16, STEPS_32 = 2, 5


def _adam_state(opt_state):
    """optax's ScaleByAdamState inside a chained transform's state."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def _jax_zs(jtask, rng, n_micro):
    """The z the JAX superstep draws for each micro-step."""
    return [np.array(jtask.sample_z(
        jax.random.split(jax.random.fold_in(rng, i))[0], B))
        for i in range(n_micro)]


def _check_against_jax(task, state, jst, when):
    """Every parameter within 2·lr of JAX's (tests/test_torch_pigan.py's
    bound), Adam's count equal to optax's for every parameter, and each
    moment within 1e-3 of its tensor's max |ref| (float32 sums in another
    order; a moment of a block outside the path is exactly zero in
    both)."""
    for name, net, opt, params, opt_state, to_sd, lr in (
            ("G", task.generator, state.g_opt, jst.g_params, jst.g_opt,
             convert.pigan_generator_state_dict, 5e-5),
            ("D", task.discriminator, state.d_opt, jst.d_params, jst.d_opt,
             convert.pigan_discriminator_state_dict, 4e-4)):
        adam = _adam_state(opt_state)
        want_p = to_sd({"params": params})
        want_mu = to_sd({"params": adam.mu})
        want_nu = to_sd({"params": adam.nu})
        count = int(adam.count)
        for k, p in net.named_parameters():
            what = f"{when}: {name} {k}"
            np.testing.assert_allclose(p.detach().numpy(),
                                       want_p[k].numpy(), atol=2 * lr,
                                       err_msg=what)
            st = opt.state[p]
            assert st, f"{what}: no optimizer state"
            assert int(st["step"]) == count, (what, int(st["step"]), count)
            for mine, want in ((st["exp_avg"], want_mu[k]),
                               (st["exp_avg_sq"], want_nu[k])):
                w = want.numpy()
                assert np.abs(mine.numpy() - w).max() <= (
                    1e-3 * np.abs(w).max() + 1e-12), what


def _sync_from_jax(task, state, jst):
    """The port's parameters and Adam moments set to JAX's, so that each
    superstep starts from the same state; the counts stay the port's
    own."""
    with torch.no_grad():
        for net, opt, params, opt_state, to_sd in (
                (task.generator, state.g_opt, jst.g_params, jst.g_opt,
                 convert.pigan_generator_state_dict),
                (task.discriminator, state.d_opt, jst.d_params, jst.d_opt,
                 convert.pigan_discriminator_state_dict)):
            adam = _adam_state(opt_state)
            net.load_state_dict(to_sd({"params": params}))
            mu = to_sd({"params": adam.mu})
            nu = to_sd({"params": adam.nu})
            for k, p in net.named_parameters():
                opt.state[p]["exp_avg"].copy_(mu[k])
                opt.state[p]["exp_avg_sq"].copy_(nu[k])


def test_pigan_across_a_resolution_step_matches_jax_counts_and_moments(
        tmp_path):
    """2 supersteps at 16 px, ``increase_resolution(32)``, 5 at 32 px, both
    packages from the same weights, batches and z: after every superstep
    every parameter, every Adam moment and every count as JAX's (see
    _check_against_jax). Each superstep starts from the same state: the
    port takes JAX's parameters and moments after each comparison (not its
    counts), so float noise does not compound through the GAN's feedback.
    D's 32- and 64-px blocks have no gradient at 16 px; without a zero one
    torch's Adam would start their count at the resolution step, with
    betas (0, 0.9) a first step 1/√(1 − 0.9^k) times smaller than
    optax's."""
    jcfg = jax_compose(CONF_DIR, ANNEAL)
    jtask = jax_inst(jcfg.model.lm, jcfg, str(tmp_path))
    g_vars, d_vars = _random_variables(jtask)
    d_tx, g_tx = jtask.configure_optimizers(4)
    jst = jax_state(g_vars, d_vars, g_tx, d_tx, extra=jtask.initial_extra())

    cfg = compose(CONF_DIR, ANNEAL)
    task = instantiate(cfg.model.lm, cfg, str(tmp_path), device="cpu")
    task.generator.load_state_dict(convert.pigan_generator_state_dict(g_vars))
    task.discriminator.load_state_dict(
        convert.pigan_discriminator_state_dict(d_vars))
    state = create_train_state(task, steps_per_epoch=4)
    zs = []
    task.sample_z = lambda n, generator=None: torch.from_numpy(zs.pop(0))

    def one(s, step_fn):
        imgs = _images(seed=10 + s, n=2)
        rng = jax.random.PRNGKey(100 + s)
        zs.extend(_jax_zs(jtask, rng, 2))
        new, _ = step_fn(jst, {"image": imgs,
                               "label": np.zeros((2, B), np.int32)}, rng)
        superstep(task, state, {
            "image": torch.from_numpy(imgs).permute(0, 1, 4, 2, 3)}, 1, 1)
        return jax.device_get(new)

    step16 = jax.jit(build_superstep(jtask, g_tx, d_tx, 1, 1))
    for s in range(STEPS_16):
        jst = one(s, step16)
        _check_against_jax(task, state, jst, f"16 px, superstep {s}")
        _sync_from_jax(task, state, jst)
    unused = [k for k, p in task.discriminator.named_parameters()
              if not bool(state.d_opt.state[p]["exp_avg"].any())]
    assert any("32" in k for k in unused), unused

    jtask.increase_resolution(32)
    jst = jst.replace(extra=jtask.reset_alpha(jst.extra))
    task.increase_resolution(32)
    state.extra = task.reset_alpha(state.extra)
    step32 = jax.jit(build_superstep(jtask, g_tx, d_tx, 1, 1))
    for s in range(STEPS_16, STEPS_16 + STEPS_32):
        jst = one(s, step32)
        _check_against_jax(task, state, jst, f"32 px, superstep {s}")
        _sync_from_jax(task, state, jst)
    assert state.d_steps == int(jst.d_steps) == STEPS_16 + STEPS_32


def test_restore_gives_every_parameter_the_shared_count():
    """Adam state that lacks some parameters (or holds a later start for
    them), as a checkpoint written before the zero gradients holds, comes
    back with zero moments and the optimizer's update count for all of
    them: the state optax would hold."""
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    opt = optim.adam(net.parameters(), lr=1e-3, betas=(0.0, 0.9))
    first = list(net[0].parameters())
    for _ in range(4):
        for p in first:
            p.grad = torch.ones_like(p)
        opt.step()
    saved = opt.state_dict()
    assert len(saved["state"]) == 2

    fresh = optim.adam(net.parameters(), lr=1e-3, betas=(0.0, 0.9))
    fresh.load_state_dict(saved)
    optim.share_update_count(fresh, 4)
    for p in net.parameters():
        st = fresh.state[p]
        assert int(st["step"]) == 4
        if any(p is q for q in first):
            assert torch.equal(st["exp_avg"], saved["state"][
                [id(q) for q in net.parameters()].index(id(p))]["exp_avg"])
        else:
            assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()
    # the next step of a parameter that had no state is optax's: count 5
    for p in net.parameters():
        p.grad = torch.ones_like(p)
    before = net[1].bias.detach().clone()
    fresh.step()
    want = 1e-3 / (1.0 / np.sqrt(1 - 0.9 ** 5) * np.sqrt(0.1) + 1e-8)
    np.testing.assert_allclose((before - net[1].bias.detach()).numpy(),
                               want, rtol=1e-5)


#: (config node, optax transform's kind): AdamW with and without its
#: default decay, SGD with and without momentum, and Adam and RMSprop for
#: the missing-gradient rule
KINDS = [
    {"_target_": "torch.optim.AdamW", "lr": 1e-2, "betas": [0.5, 0.99]},
    {"_target_": "torch.optim.AdamW", "lr": 1e-2, "weight_decay": 0.1},
    {"_target_": "torch.optim.SGD", "lr": 5e-2, "momentum": 0.9},
    {"_target_": "torch.optim.SGD", "lr": 5e-2},
    {"_target_": "torch.optim.Adam", "lr": 1e-2, "betas": [0.0, 0.9]},
    {"_target_": "torch.optim.RMSprop", "lr": 1e-2, "momentum": 0.5},
]


@pytest.mark.parametrize("node", KINDS, ids=lambda n: "-".join(
    f"{v}" for v in n.values()).replace("torch.optim.", ""))
def test_optimizer_kind_matches_optax_over_scheduled_updates(node):
    """20 updates at lr × a decaying schedule (the π-GAN ramp over 12
    updates), gradients from numpy, the second leaf without a gradient at
    every third step and the third leaf without one for the first 8: the
    port's optimizer (built from the config node through the registry,
    missing gradients filled as the superstep fills them) against the JAX
    package's ``build_optimizer`` with zero gradients there. Parameters
    within 1e-6 + 1e-5·|p| after every update."""
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (3,), (5, 2)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(20)]

    def missing(step, leaf):
        return (leaf == 1 and step % 3 == 0) or (leaf == 2 and step < 8)

    lr = float(node["lr"])
    tx = jax_optim.build_optimizer(
        node, jax_optim.pigan_decay_schedule(lr, lr / 4, span=12))
    jparams = [jnp.asarray(a) for a in init]
    jstate = tx.init(jparams)

    net = torch.nn.Module()
    net.leaves = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init])
    opt = instantiate(Config(node), net.parameters())
    assert type(opt).__name__ == {
        "torch.optim.AdamW": "AdamW", "torch.optim.SGD": "SGD",
        "torch.optim.Adam": "Adam", "torch.optim.RMSprop": "RMSprop",
    }[node["_target_"]]
    schedule = optim.pigan_decay_schedule(lr, lr / 4, span=12)
    for step, gs in enumerate(grads):
        jg = [jnp.zeros_like(p) if missing(step, i) else jnp.asarray(g)
              for i, (p, g) in enumerate(zip(jparams, gs))]
        upd, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for i, (p, g) in enumerate(zip(net.leaves, gs)):
            p.grad = None if missing(step, i) else torch.from_numpy(g)
        fill_missing_grads(net)
        optim.optimizer_step(opt, schedule, step)
        for i, (p, w) in enumerate(zip(net.leaves, jparams)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"update {step}, leaf {i}")


@pytest.mark.parametrize("target,extra", [
    ("torch.optim.AdamW", ["+optimiser.weight_decay=0.05"]),
    ("torch.optim.SGD", ["+optimiser.momentum=0.5"])])
def test_cli_trains_with_adamw_and_sgd(tmp_path, capsys, target, extra):
    """Both kinds train dc_gan through run_network_torch.py on the CPU: an
    epoch's losses logged, finite."""
    assert run_network_torch.main(
        ["+expt=dc_gan", "dataset=synthetic", "calc_fid=False",
         "save_ckpts=False", "train.img_size=16", "train.batch_size=4",
         "train.features_disc=4", "train.features_gen=4",
         "model.noise_dim=8", "dataset.n=16", "train.num_epochs=1",
         "~figures", f"optimiser._target_={target}", *extra,
         f"output_root={tmp_path}", "--device", "cpu"]) == 0
    line = re.search(r"^epoch 0 \[.*\] (.*)$", capsys.readouterr().out, re.M)
    assert line, "no epoch line"
    for k in ("d_loss", "g_loss"):
        m = re.search(rf"\b{k}=(-?[\d.e+-]+)", line.group(1))
        assert m and np.isfinite(float(m.group(1))), line.group(1)
