"""The port's HoloGAN Generator and Discriminator against the JAX package's,
on the same converted random weights and the same explicit z, views and
images, in float32 on the CPU (atol 1e-4). The JAX generator resamples with
its XLA gather (resample="gather"); the port's takes its autograd.Function,
which on a CPU tensor runs the plain version."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_gan_zoo_tpu.config.node import Config
from lightning_gan_zoo_tpu.models import hologan as jh
from lightning_gan_zoo_tpu_torch import convert
from lightning_gan_zoo_tpu_torch.models import hologan as th

VIEW_ARGS = dict(elevation_low=70, elevation_high=110, azimuth_low=220,
                 azimuth_high=320, scale_low=1, scale_high=1,
                 transX_low=0, transX_high=0, transY_low=0, transY_high=0,
                 transZ_low=0, transZ_high=0)
# nonzero azimuth, elevation, scale and translation on every sample
VIEWS = np.array([[math.radians(250), math.radians(80), 1.1, 0.5, -0.3, 0.2],
                  [math.radians(300), math.radians(100), 0.9, -0.4, 0.1,
                   -0.6]], np.float32)


def _randomise(variables, seed, scale=0.2):
    """Replace every parameter (not the spectral u) with N(0, scale²), so
    the outputs are far from the near-zero values of the 0.02 init."""
    rng = np.random.default_rng(seed)
    out = dict(jax.device_get(variables))
    out["params"] = jax.tree.map(
        lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32),
        out["params"])
    return out


def test_generator_matches_jax():
    rng = np.random.default_rng(0)
    z = rng.uniform(-1, 1, (2, 8)).astype(np.float32)
    g = jh.Generator(in_planes=4, out_planes=3, z_planes=8,
                     view_args=Config(VIEW_ARGS), img_size=64,
                     resample="gather")
    # jitted: one XLA compile instead of one per op
    gv = _randomise(jax.jit(functools.partial(g.init, train=False))(
        {"params": jax.random.PRNGKey(0), "view": jax.random.PRNGKey(1)},
        jnp.asarray(z)), 1)
    want = np.asarray(jax.jit(functools.partial(g.apply, train=False))(
        gv, jnp.asarray(z), jnp.asarray(VIEWS)))
    tg = th.Generator(4, 3, 8, VIEW_ARGS, 64)
    tg.load_state_dict(convert.generator_state_dict(gv))
    with torch.no_grad():
        got = tg(torch.from_numpy(z), torch.from_numpy(VIEWS))
    assert got.shape == (2, 3, 64, 64)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-4)


def test_discriminator_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    d = jh.Discriminator(in_planes=3, out_planes=4, z_planes=8)
    dv = _randomise(jax.jit(functools.partial(d.init, train=False))(
        jax.random.PRNGKey(3), jnp.asarray(img)), 2)
    (logit, z_pred), new = jax.jit(functools.partial(
        d.apply, train=True, mutable=["spectral"]))(dv, jnp.asarray(img))
    td = th.Discriminator(3, 4, 8, 64)
    td.load_state_dict(convert.discriminator_state_dict(dv))
    with torch.no_grad():
        t_logit, t_z = td(torch.from_numpy(img).permute(0, 3, 1, 2))
    np.testing.assert_allclose(t_logit.numpy(), np.asarray(logit), atol=1e-4)
    np.testing.assert_allclose(t_z.numpy(), np.asarray(z_pred), atol=1e-4)
    for i in range(3):
        np.testing.assert_allclose(
            td.state_dict()[f"block_{i}.conv.u"].numpy(),
            np.asarray(new["spectral"][f"DiscBlock_{i}"]
                       ["SpectralNormConv_0"]["u"]), atol=1e-5)


def test_rigid_transform_project_matches_jax():
    rng = np.random.default_rng(2)
    vox = rng.normal(size=(2, 16, 16, 16, 5)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(
        jh.rigid_transform_project, size=16, new_size=16,
        resample="gather"))(jnp.asarray(vox), jnp.asarray(VIEWS)))
    for mode in ("auto", "gather"):
        got = th.rigid_transform_project(torch.from_numpy(vox),
                                         torch.from_numpy(VIEWS), 16, 16,
                                         resample=mode)
        # the two frameworks invert the 4x4 warp with ~1e-7 relative
        # differences, which move points by up to ~1e-6 voxels
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_sample_view_degenerate_ranges_are_exact():
    va = dict(VIEW_ARGS, azimuth_low=250, azimuth_high=250, elevation_low=80,
              elevation_high=80, scale_low=1.1, scale_high=1.1,
              transX_low=0.3, transX_high=0.3)
    want = np.asarray(jh.sample_view(jax.random.PRNGKey(0), 3, va))
    got = th.sample_view(torch.Generator().manual_seed(0), 3, va).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7)


def test_sample_view_ranges_and_shared_scale():
    va = dict(VIEW_ARGS, scale_low=0.8, scale_high=1.2)
    v = th.sample_view(torch.Generator().manual_seed(1), 64, va).numpy()
    deg = np.round(np.degrees(v[:, :2]))
    assert np.allclose(np.degrees(v[:, :2]), deg, atol=1e-3)  # integers
    assert 220 <= deg[:, 0].min() and deg[:, 0].max() < 320
    assert 70 <= deg[:, 1].min() and deg[:, 1].max() < 110
    assert np.all(v[:, 2] == v[0, 2]) and 0.8 <= v[0, 2] <= 1.2


def test_shear_resample_is_rejected():
    with pytest.raises(NotImplementedError, match="shear"):
        th.Generator(4, 3, 8, VIEW_ARGS, 64, resample="shear")
    with pytest.raises(ValueError, match="resample"):
        th.Generator(4, 3, 8, VIEW_ARGS, 64, resample="bogus")
