"""The port's π-GAN against the JAX package's, on the CPU in float32, at the
JAX tests' tiny widths (noise 16, SIREN 32 × 2, 4 + 4 points, D init_chan
8): the generator (explicit views, deterministic depths), the progressive
discriminator at two entry resolutions with α = 0.5, both losses with their
gradients (R1's double backward included), one superstep's Adam updates,
the LR decay, and the Trainer's epoch schedule replay. Weights come from
numpy through convert.py; each test states its bound.

The view is pinned (azimuth_low = azimuth_high) and stratification is off,
so both frameworks render the same rays at the same depths without sharing
random streams.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import CONF_DIR
from lightning_gan_zoo_tpu.config import compose as jax_compose
from lightning_gan_zoo_tpu.config.registry import instantiate as jax_inst
from lightning_gan_zoo_tpu.runtime.loop import Trainer as JaxTrainer
from lightning_gan_zoo_tpu.runtime.optim import (
    pigan_decay_schedule as jax_decay)
from lightning_gan_zoo_tpu.runtime.state import create_train_state as jax_state
from lightning_gan_zoo_tpu.runtime.steps import build_superstep
from lightning_gan_zoo_tpu_torch import convert
from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.config.registry import instantiate
from lightning_gan_zoo_tpu_torch.runtime import loop
from lightning_gan_zoo_tpu_torch.runtime.optim import pigan_decay_schedule
from lightning_gan_zoo_tpu_torch.runtime.state import create_train_state
from lightning_gan_zoo_tpu_torch.runtime.steps import superstep

PIGAN_TINY = ["+expt=pigan", "machine=local", "dataset=synthetic",
              "model.noise_dim=16", "nerf.siren_dim_hidden=32",
              "nerf.siren_num_layers=2", "nerf.n_pts_per_ray=4",
              "nerf.n_pts_per_ray_fine=4", "train.features_disc=8",
              "train.img_size=64", "resolution_annealing.resolutions=[8,16,32]",
              "variable_batch_size.batch_sizes=[2,2,2]", "precision=32",
              "~figures", "nerf.stratified=False",
              "generator.view_args.azimuth_low=250",
              "generator.view_args.azimuth_high=250"]
B = 2


def _random_variables(jtask, seed=0):
    """Every parameter N(0, 1/fan_in), biases N(0, 0.1²), from numpy; the
    shapes come from an abstract trace of the JAX init."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if jax.tree_util.keystr(path).endswith("['bias']"):
            return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)
                ).astype(np.float32)
    shapes = jax.eval_shape(jtask.init, jax.random.PRNGKey(0))
    return [jax.tree_util.tree_map_with_path(fill, v) for v in shapes]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX task, port task, g_vars, d_vars) on the same weights."""
    out = str(tmp_path_factory.mktemp("pigan"))
    jcfg = jax_compose(CONF_DIR, PIGAN_TINY)
    jtask = jax_inst(jcfg.model.lm, jcfg, out)
    g_vars, d_vars = _random_variables(jtask)
    task = instantiate(compose(CONF_DIR, PIGAN_TINY).model.lm,
                       compose(CONF_DIR, PIGAN_TINY), out, device="cpu")
    task.generator.load_state_dict(convert.pigan_generator_state_dict(g_vars))
    task.discriminator.load_state_dict(
        convert.pigan_discriminator_state_dict(d_vars))
    return jtask, task, g_vars, d_vars


def _z(seed=1):
    return np.random.default_rng(seed).normal(size=(B, 16)).astype(np.float32)


def _images(seed=2, n=None):
    shape = (B, 64, 64, 3) if n is None else (n, B, 64, 64, 3)
    return (np.random.default_rng(seed).normal(size=shape) * 0.3
            ).astype(np.float32)


def _extra(alpha):
    return ({"alpha": jnp.float32(alpha), "iterations": jnp.int32(0)},
            {"alpha": torch.tensor(alpha), "iterations": 0})


def test_state_dicts_cover_every_parameter(pair):
    _, task, g_vars, d_vars = pair
    for net, sd in ((task.generator,
                     convert.pigan_generator_state_dict(g_vars)),
                    (task.discriminator,
                     convert.pigan_discriminator_state_dict(d_vars))):
        assert set(sd) == set(net.state_dict())


def test_generator_matches_jax(pair):
    """RGBA at 8 px from explicit views, train=False: within 1e-4."""
    jtask, task, g_vars, _ = pair
    views = np.zeros((B, 6), np.float32)
    views[:, 0] = np.deg2rad([230.0, 305.0])
    views[:, 2] = 1.0
    want = np.asarray(jtask.generator.apply(
        g_vars, jnp.asarray(_z()), sample_res=8, view_in=jnp.asarray(views),
        train=False))
    with torch.no_grad():
        got = task.generator(torch.from_numpy(_z()), sample_res=8,
                             view_in=torch.from_numpy(views), train=False)
    assert got.shape == (B, 8, 8, 4)
    assert want[..., :3].std() > 1e-3
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("res", [16, 32])
def test_discriminator_matches_jax(pair, res):
    """Entry at 16 and 32 px with the fade-in at α = 0.5: within 1e-4."""
    jtask, task, _, d_vars = pair
    img = np.random.default_rng(res).normal(size=(B, res, res, 3)
                                            ).astype(np.float32)
    want = np.asarray(jtask.discriminator.apply(
        d_vars, jnp.asarray(img), alpha=0.5, current_res=res, train=False))
    with torch.no_grad():
        got = task.discriminator(torch.from_numpy(img).permute(0, 3, 1, 2),
                                 torch.tensor(0.5), res)
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _grads_close(have, want, what):
    """Each tensor's gradient within 1e-3 of its max |ref| (float32 sums in
    another order, through a double backward for R1). A parameter the
    loss does not reach has no gradient in torch and a zero one in JAX."""
    assert set(have) == set(want), what
    for k, w in want.items():
        w = w.numpy()
        h = np.zeros_like(w) if have[k] is None else have[k].numpy()
        assert np.abs(h - w).max() <= 1e-3 * np.abs(w).max() + 1e-7, \
            f"{what} {k}"


def test_losses_and_gradients_match_jax(pair):
    """disc_loss (hinge + R1) and gen_loss: values at rtol 1e-4, gradients
    with respect to D's and G's parameters as _grads_close."""
    jtask, task, g_vars, d_vars = pair
    j_extra, t_extra = _extra(0.5)
    img = _images()
    batch = {"image": jnp.asarray(img)}
    z = jnp.asarray(_z())
    (d_loss, d_aux), d_grads = jax.jit(jax.value_and_grad(
        jtask.disc_loss, has_aux=True))(
        d_vars["params"], g_vars["params"], {}, {}, batch, z,
        jax.random.PRNGKey(0), j_extra)
    (g_loss, _), g_grads = jax.jit(jax.value_and_grad(
        jtask.gen_loss, has_aux=True))(
        g_vars["params"], d_vars["params"], {}, {}, batch, z,
        jax.random.PRNGKey(0), j_extra)

    tbatch = {"image": torch.from_numpy(img).permute(0, 3, 1, 2)}
    tz = torch.from_numpy(_z())
    task.discriminator.zero_grad()
    loss, metrics = task.disc_loss(tbatch, tz, t_extra)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(d_loss), rtol=1e-4)
    np.testing.assert_allclose(float(metrics["r1"]),
                               float(d_aux["metrics"]["r1"]), rtol=1e-4)
    assert float(metrics["r1"]) > 0
    _grads_close({k: p.grad for k, p in
                  task.discriminator.named_parameters()},
                 convert.pigan_discriminator_state_dict(
                     {"params": jax.device_get(d_grads)}), "D")

    task.generator.zero_grad()
    loss, metrics = task.gen_loss(tbatch, tz, t_extra)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(g_loss), rtol=1e-4)
    _grads_close({k: p.grad for k, p in task.generator.named_parameters()},
                 convert.pigan_generator_state_dict(
                     {"params": jax.device_get(g_grads)}), "G")


def test_superstep_matches_jax(pair):
    """One 1 D + 1 G superstep from the same weights, batch and z. Metrics
    at rtol 1e-4; α and the iteration count as JAX's; parameters after Adam
    within 2·lr (one update each: Adam's first step is about lr·sign(g),
    so a gradient that is zero up to float noise may flip it), and the
    updates themselves within 1e-6 on at least 99 % of the elements."""
    jtask, task, g_vars, d_vars = pair
    d_tx, g_tx = jtask.configure_optimizers(4)
    st0 = jax_state(g_vars, d_vars, g_tx, d_tx, extra=jtask.initial_extra())
    imgs = _images(seed=3, n=2)
    rng = jax.random.PRNGKey(7)
    st1, metrics = jax.jit(build_superstep(jtask, g_tx, d_tx, 1, 1))(
        st0, {"image": imgs, "label": np.zeros((2, B), np.int32)}, rng)
    zs = iter([np.array(jtask.sample_z(
        jax.random.split(jax.random.fold_in(rng, i))[0], B))
        for i in range(2)])

    task.generator.load_state_dict(convert.pigan_generator_state_dict(g_vars))
    task.discriminator.load_state_dict(
        convert.pigan_discriminator_state_dict(d_vars))
    task.sample_z = lambda n, generator=None: torch.from_numpy(next(zs))
    state = create_train_state(task, steps_per_epoch=4)
    got = superstep(task, state, {
        "image": torch.from_numpy(imgs).permute(0, 1, 4, 2, 3)}, 1, 1)
    assert set(got) == set(metrics) == {"d_loss", "r1", "g_loss"}
    for k in metrics:
        np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                   rtol=1e-4, err_msg=k)
    assert state.extra["iterations"] == int(st1.extra["iterations"]) == 2
    assert float(state.extra["alpha"]) == float(st1.extra["alpha"]) == 0.0

    st1 = jax.device_get(st1)
    n_off = n_all = 0
    for name, net, before, after, lr in (
            ("G", task.generator, convert.pigan_generator_state_dict(g_vars),
             convert.pigan_generator_state_dict({"params": st1.g_params}),
             5e-5),
            ("D", task.discriminator,
             convert.pigan_discriminator_state_dict(d_vars),
             convert.pigan_discriminator_state_dict(
                 {"params": st1.d_params}), 4e-4)):
        have = net.state_dict()
        for k, want in after.items():
            np.testing.assert_allclose(have[k].numpy(), want.numpy(),
                                       atol=2 * lr, err_msg=f"{name} {k}")
            d_have = (have[k] - before[k]).numpy()
            d_want = (want - before[k]).numpy()
            n_off += int(np.sum(np.abs(d_have - d_want) > 1e-6))
            n_all += d_want.size
    assert n_off <= 0.01 * n_all, (n_off, n_all)


def test_pigan_decay_schedule_matches_jax():
    for base, target in ((4e-4, 1e-4), (5e-5, 1e-5)):
        want = jax_decay(base, target)
        got = pigan_decay_schedule(base, target)
        for count in (0, 1, 2500, 9999, 10000, 10001, 50000):
            assert got(count) == pytest.approx(float(want(count)), rel=1e-6)


@pytest.mark.parametrize("overrides", [
    ["machine=small", "resolution_annealing.update_epochs=[1,2]",
     "train.num_epochs=3", "dataset.n=512"],
    ["machine=small", "resolution_annealing.update_epochs=[2,3]",
     "train.num_epochs=5", "dataset.n=200", "train.fold_steps=3"],
])
def test_epoch_schedule_replay_matches_jax_trainer(overrides, tmp_path):
    """Per epoch: batch size, training resolution, accumulation factor and
    supersteps (the fold clamp included) as the JAX Trainer's own
    arithmetic gives them. (The schedule does not depend on the widths,
    which are cut to keep the models cheap to build.)"""
    args = ["+expt=pigan", "dataset=synthetic", "~figures",
            f"output_root={tmp_path}", *overrides, "model.noise_dim=16",
            "nerf.siren_dim_hidden=32", "train.features_disc=8"]
    jt = JaxTrainer(jax_compose(CONF_DIR, args))
    n_epochs = int(jt.cfg.train.num_epochs)
    table = jt._epoch_superstep_table(int(jt.cfg.dataset.n), n_epochs)
    tt = loop.Trainer(compose(CONF_DIR, args), "cpu")
    for e in range(n_epochs):
        jt.epoch = tt.epoch = e
        jt._update_epoch_schedules()
        tt._update_epoch_schedules()
        loader = tt._make_train_loader()
        assert tt.current_batch_size == jt.current_batch_size \
            == jt._batch_size_at(e) == tt._batch_size_at(e)
        assert tt.task.training_resolution == jt.task.training_resolution
        assert tt._accum_factor() == jt._accum_factor(e)
        assert loader.steps_per_epoch() * tt._active_fold == table[e], e
