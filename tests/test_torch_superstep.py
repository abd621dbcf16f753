"""One full HoloGAN superstep (1 D + 2 G Adam updates) of the port against
the JAX package's jitted ``build_superstep``, from the same converted
parameters, the same batch and the same z, in float32 on the CPU.

The views are fixed by a degenerate ``view_args`` (each low = high), so
view sampling is deterministic in both frameworks; the port is handed the z
that the JAX step draws, recomputed from its key derivation. Losses, metrics
and the spectral-norm u compare at rtol 1e-4. Parameters after Adam compare
at atol 2·lr per update (lr = 1e-4): 2e-4 for D's one update, 4e-4 for G's
two. Adam's first step is about lr·sign(g), so a gradient that is zero up to
float noise may flip a step by 2·lr, in each update. That bound alone would
pass a port that barely updates, so the updates themselves must also agree
to 1e-6 on at least 99 % of the elements.

The biases of the convolutions that feed an instance norm (AdaIN in G, the
DiscBlock norm in D) have an exactly-zero gradient: the norm removes any
per-channel constant. Their gradient is float noise in both frameworks, and
Adam turns noise into steps of ±lr, so those are held only to the bound
|Δ| ≤ lr per update.
"""
import re

import jax
import numpy as np
import pytest

from tests.conftest import CONF_DIR
from lightning_gan_zoo_tpu.config import compose as jax_compose
from lightning_gan_zoo_tpu.config.registry import instantiate as jax_inst
from lightning_gan_zoo_tpu.runtime.optim import (
    hologan_schedule as jax_hologan_schedule)
from lightning_gan_zoo_tpu.runtime.state import create_train_state as jax_state
from lightning_gan_zoo_tpu.runtime.steps import build_superstep
from lightning_gan_zoo_tpu_torch import convert
from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.config.registry import instantiate
from lightning_gan_zoo_tpu_torch.runtime.optim import hologan_schedule
from lightning_gan_zoo_tpu_torch.runtime.state import create_train_state
from lightning_gan_zoo_tpu_torch.runtime.steps import superstep

import torch

OVERRIDES = [
    "+expt=hologan", "dataset=synthetic", "precision=32", "calc_fid=False",
    "save_ckpts=False", "~figures", "generator.in_planes=4",
    "discriminator.out_planes=4", "model.noise_dim=8", "train.batch_size=2",
    "generator.view_args.azimuth_low=250",
    "generator.view_args.azimuth_high=250",
    "generator.view_args.elevation_low=80",
    "generator.view_args.elevation_high=80",
    "generator.view_args.scale_low=1.1", "generator.view_args.scale_high=1.1",
    "generator.view_args.transX_low=0.3",
    "generator.view_args.transX_high=0.3",
    "generator.view_args.transZ_low=-0.2",
    "generator.view_args.transZ_high=-0.2",
]
LR = 1e-4
NORMED_BIAS = re.compile(r"block(3d|2d)?_\d\.convt?\.bias")


def _random_variables(jtask):
    """The task's variable trees filled from numpy: weights N(0, 0.02²),
    the constant volume N(0, 1), spectral u at its 1/sqrt(out) start. (The
    shapes come from an abstract trace: running flax's init op by op takes
    far longer on the CPU than the superstep itself.)"""
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['u']"):
            return np.full(leaf.shape, 1 / np.sqrt(leaf.shape[0]), np.float32)
        scale = 1.0 if name.endswith("['const']") else 0.02
        return (rng.normal(size=leaf.shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map_with_path(
        fill, jax.eval_shape(jtask.init, jax.random.PRNGKey(0)))


def test_hologan_superstep_matches_jax(tmp_path):
    jcfg = jax_compose(CONF_DIR, OVERRIDES + ["generator.resample=gather"])
    jtask = jax_inst(jcfg.model.lm, jcfg, str(tmp_path))
    d_tx, g_tx = jtask.configure_optimizers(steps_per_epoch=4)
    g_vars, d_vars = _random_variables(jtask)
    st0 = jax_state(g_vars, d_vars, g_tx, d_tx)
    images = np.random.default_rng(0).normal(
        size=(3, 2, 64, 64, 3)).astype(np.float32) * 0.5
    rng = jax.random.PRNGKey(7)
    st1, metrics = jax.jit(build_superstep(jtask, g_tx, d_tx, 1, 2))(
        st0, {"image": images, "label": np.zeros((3, 2), np.int32)}, rng)
    # the z of micro-step i, derived as the JAX superstep derives it
    zs = [np.array(jtask.sample_z(
        jax.random.split(jax.random.fold_in(rng, i))[0], 2))
        for i in range(3)]

    cfg = compose(CONF_DIR, OVERRIDES)
    task = instantiate(cfg.model.lm, cfg, str(tmp_path), device="cpu")
    task.generator.load_state_dict(convert.generator_state_dict(g_vars))
    task.discriminator.load_state_dict(
        convert.discriminator_state_dict(d_vars))
    z_iter = iter(zs)
    task.sample_z = lambda n, generator=None: torch.from_numpy(next(z_iter))
    state = create_train_state(task, steps_per_epoch=4)
    got = superstep(task, state, {
        "image": torch.from_numpy(images).permute(0, 1, 4, 2, 3)}, 1, 2)

    assert set(got) == set(metrics) == {"d_loss", "g_loss", "q_loss"}
    for k in metrics:
        np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                   rtol=1e-4, err_msg=k)
    assert (state.step, state.d_steps, state.g_steps) == (3, 1, 2)
    assert (int(st1.step), int(st1.d_steps), int(st1.g_steps)) == (3, 1, 2)

    st1 = jax.device_get(st1)
    before = {"G": convert.generator_state_dict(g_vars),
              "D": convert.discriminator_state_dict(d_vars)}
    after = {"G": convert.generator_state_dict({"params": st1.g_params}),
             "D": convert.discriminator_state_dict(
                 {"params": st1.d_params, **st1.d_state})}
    n_off = n_all = 0
    for name, net, n_upd in (("G", task.generator, 2),
                             ("D", task.discriminator, 1)):
        have = net.state_dict()
        assert set(have) == set(after[name])
        for k, want in after[name].items():
            if NORMED_BIAS.fullmatch(k):
                for v in (have[k], want):
                    assert float((v - before[name][k]).abs().max()) <= \
                        n_upd * LR * 1.001, f"{name} {k}"
                continue
            tol = (dict(rtol=1e-4, atol=1e-7) if k.endswith(".u")
                   else dict(atol=2 * LR * n_upd))
            np.testing.assert_allclose(have[k].numpy(), want.numpy(),
                                       err_msg=f"{name} {k}", **tol)
            # the updates themselves (~lr per element) agree except where
            # a near-zero gradient flipped sign
            d_have = (have[k] - before[name][k]).numpy()
            d_want = (want - before[name][k]).numpy()
            n_off += int(np.sum(np.abs(d_have - d_want) > 1e-6))
            n_all += d_want.size
    assert n_off <= 0.01 * n_all, (n_off, n_all)


@pytest.mark.parametrize("freq", [1, 2])
def test_hologan_schedule_matches_jax(freq):
    want = jax_hologan_schedule(10, steps_per_epoch=3,
                                updates_per_superstep=freq)
    got = hologan_schedule(10, steps_per_epoch=3, updates_per_superstep=freq)
    for count in range(0, 3 * freq * 11):
        assert got(count) == pytest.approx(float(want(count)), abs=1e-7)
