"""The port's NeRF pieces against the JAX package's, on the CPU in float32:
cameras, ray and pdf sampling (fed the uniform draws JAX made), the
border-clamped bilinear sample, the emission-absorption raymarch and its
division-free backward (saturated densities included), and the renderer's
chunk loop. Inputs come from numpy seeds; each test states its bound."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_gan_zoo_tpu.nerf import cameras as jc, renderer as jr
from lightning_gan_zoo_tpu.nerf import sampling as js
from lightning_gan_zoo_tpu.ops import grid_sample as jg
from lightning_gan_zoo_tpu_torch.nerf import cameras as tc, renderer as tr
from lightning_gan_zoo_tpu_torch.nerf import sampling as ts
from lightning_gan_zoo_tpu_torch.ops import grid_sample as tg

T = torch.from_numpy


def test_cameras_match_jax():
    """look_at, cameras_from_eye (the degenerate up ∥ z case included) and
    orthographic rays: within 1e-5 (f32 trig on two libraries)."""
    rng = np.random.default_rng(0)
    az = rng.uniform(0, 360, 5).astype(np.float32)
    el = rng.uniform(-60, 60, 5).astype(np.float32)
    want = jc.look_at_view_transform(0.1, jnp.asarray(el), jnp.asarray(az))
    got = tc.look_at_view_transform(0.1, T(el), T(az))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-5)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-5)
    eye = np.array([[0, 2.0, 0], [1.0, -1.0, 0.5]], np.float32)
    want = jc.cameras_from_eye(jnp.asarray(eye))
    got = tc.cameras_from_eye(T(eye))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-6)
    xy = rng.uniform(-1, 1, (2, 7, 2)).astype(np.float32)
    want_o, want_d = jc.world_rays_from_ndc(want, jnp.asarray(xy))
    got_o, got_d = tc.world_rays_from_ndc(got, T(xy))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=1e-5)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-4)


def test_convert_cam_pred_matches_jax():
    rng = np.random.default_rng(1)
    cam = np.concatenate([rng.uniform(0.5, 1.5, (3, 3)),
                          rng.normal(size=(3, 4))], 1).astype(np.float32)
    want, w_scale = jc.convert_cam_pred(jnp.asarray(cam))
    got, g_scale = tc.convert_cam_pred(T(cam))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-6)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=0)
    np.testing.assert_allclose(g_scale.numpy(), np.asarray(w_scale), atol=0)


def test_full_xys_and_stratify_match_jax():
    """The ray grid within 1e-7 (two linspace formulas); stratified depths
    from JAX's own draws within 1e-7."""
    np.testing.assert_allclose(ts.sample_full_xys(2, 8).numpy(),
                               np.asarray(js.sample_full_xys(2, 8)), atol=1e-7)
    key = jax.random.PRNGKey(3)
    z = jnp.broadcast_to(jnp.linspace(0.1, 1.0, 16), (2, 5, 16))
    want = js.stratify_depths(key, z)
    u = jax.random.uniform(key, z.shape, dtype=z.dtype)
    got = ts.stratify_depths(T(np.array(z)), u=T(np.array(u)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_matches_jax(det):
    """Inverse-CDF samples, deterministic and from JAX's draws: within 1e-5
    (the JAX package reads the bins with one-hot sums, the port with a
    searchsorted gather; both pick the same edges)."""
    rng = np.random.default_rng(4)
    bins = np.sort(rng.uniform(0.1, 1.0, (3, 6, 15)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (3, 6, 14)).astype(np.float32)
    w[0, 0] = 0.0                                 # an all-empty ray
    key = jax.random.PRNGKey(5)
    want = js.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 16, det=det)
    u = None if det else T(np.array(jax.random.uniform(
        key, (3, 6, 16), dtype=jnp.float32)))
    got = ts.sample_pdf(T(bins), T(w), 16, det=det, u=u)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_bilinear_sample_matches_jax():
    """Border clamp included (points outside [-1, 1]): within 1e-6."""
    rng = np.random.default_rng(6)
    img = rng.normal(size=(2, 9, 11, 3)).astype(np.float32)
    xy = rng.uniform(-1.3, 1.3, (2, 4, 5, 2)).astype(np.float32)
    want = jg.bilinear_sample(jnp.asarray(img), jnp.asarray(xy))
    got = tg.bilinear_sample(T(img), T(xy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    want = js.sample_images_at_xys(jnp.asarray(img), jnp.asarray(xy))
    got = ts.sample_images_at_xys(T(img), T(xy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("white_bg", [False, True])
@pytest.mark.parametrize("saturate", [False, True])
def test_ea_raymarch_forward_and_backward_match_jax(white_bg, saturate):
    """Outputs within 1e-6 and the custom backward within 1e-5 of max |ref|,
    also with densities of exactly 1.0, where a division-based backward
    would give 0/0."""
    rng = np.random.default_rng(7)
    d = rng.uniform(0, 1, (2, 5, 12, 1)).astype(np.float32)
    if saturate:
        d[:, :, 3] = 1.0
        d[0, 0, 7:] = 1.0
    f = rng.uniform(0, 1, (2, 5, 12, 3)).astype(np.float32)
    g_out = rng.normal(size=(2, 5, 4)).astype(np.float32)
    g_w = rng.normal(size=(2, 5, 12)).astype(np.float32)

    def jloss(dd, ff):
        out, w = jr.ea_raymarch(dd, ff, white_bg)
        return jnp.sum(out * g_out) + jnp.sum(w * g_w), (out, w)
    (_, (jout, jw)), (jdd, jdf) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(d), jnp.asarray(f))
    td, tf = T(d).requires_grad_(True), T(f).requires_grad_(True)
    out, w = tr.ea_raymarch(td, tf, white_bg)
    ((out * T(g_out)).sum() + (w * T(g_w)).sum()).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-6)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), atol=1e-6)
    for got, want in ((td.grad, jdd), (tf.grad, jdf)):
        want = np.asarray(want)
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-5 * np.abs(want).max())


def test_ea_raymarch_backward_is_autograd():
    """The division-free backward against autograd of the plain forward on
    densities away from 1 (float64, 1e-10)."""
    rng = np.random.default_rng(8)
    d = torch.tensor(rng.uniform(0, 0.9, (3, 10, 1)), requires_grad=True)
    f = torch.tensor(rng.uniform(0, 1, (3, 10, 3)), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda dd, ff: tr.ea_raymarch(dd, ff, True), (d, f), atol=1e-10)


def test_renderer_chunks_match_one_pass():
    """Ray chunks (chunk_size below the ray count, ragged last chunk)
    render what one pass renders, deterministic depths: within 1e-6."""
    kw = dict(n_pts_per_ray=4, n_pts_per_ray_fine=4, min_depth=0.1,
              max_depth=1.0, stratified=True, stratified_test=False,
              latent_z_dim=8, siren_dim_hidden=16, siren_num_layers=2,
              white_bg=False)
    whole = tr.RadianceFieldRenderer(chunk_size=0, **kw)
    chunked = tr.RadianceFieldRenderer(chunk_size=7, **kw)
    chunked.load_state_dict(whole.state_dict())
    z = torch.randn(2, 8, generator=torch.Generator().manual_seed(0))
    cams = tc.look_at_view_transform(0.1, torch.zeros(2),
                                     torch.tensor([230.0, 300.0]))
    xy = ts.sample_full_xys(2, 5)
    with torch.no_grad():
        a = whole(z, cams, xy, train=False)
        b = chunked(z, cams, xy, train=False)
    assert a.shape == (2, 5, 5, 4)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6)
