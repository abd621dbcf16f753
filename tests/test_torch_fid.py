"""The port's FID/KID stack against the JAX package's, in float32 on the CPU:
the FID Inception's pool3 from the same weights (the JAX package's random
init, converted by ``convert.inception_state_dict``), its resize, the weights
loader, the Fréchet distance and the KID."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lightning_gan_zoo_tpu.eval import fid as jax_fid
from lightning_gan_zoo_tpu.eval import inception as jax_inc
from lightning_gan_zoo_tpu_torch.convert import inception_state_dict
from lightning_gan_zoo_tpu_torch.eval import fid as pt_fid
from lightning_gan_zoo_tpu_torch.eval import inception as pt_inc

#: the suite runs several files at once (pytest-xdist workers) on a few
#: cores: two torch threads per worker keep them off each other's cores
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_inception():
    """The JAX package's random-init Inception (built once: its init traces
    the whole network) and a jitted pool3."""
    model, variables = jax_inc.init_random(jax.random.PRNGKey(3))
    return jax.jit(lambda x: model.apply(variables, x)), \
        jax.device_get(variables)


@pytest.fixture(scope="module")
def converted(jax_inception):
    return inception_state_dict(jax_inception[1])


def _port(state) -> pt_inc.InceptionV3FID:
    model = pt_inc.InceptionV3FID()
    model.load_state_dict(state, strict=False)
    return model


def _images(size, channels=3, seed=0):
    return np.random.default_rng(seed + size).uniform(
        0, 1, (2, size, size, channels)).astype(np.float32)


@pytest.mark.parametrize("size,grey", [(16, False), (32, False), (64, False),
                                       (32, True)])
def test_inception_pool3_matches_jax(jax_inception, converted, size, grey):
    """pool3 from the same weights within 1e-4 of max|ref| (f32 convolutions
    summed in another order); a greyscale image tiled to RGB, as the
    metrics callback tiles it, likewise."""
    x = _images(size, 1 if grey else 3)
    if grey:
        x = np.repeat(x, 3, axis=-1)
    want = np.asarray(jax_inception[0](jnp.asarray(x)))
    got = _port(converted)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("size", [16, 32, 64])
def test_resize_to_299_matches_jax_image_resize(size):
    """Upsampling to 299²: F.interpolate (bilinear, half-pixel centres,
    the source index clamped at the edges) equals jax.image.resize
    (bilinear, the out-of-range taps dropped and the rest renormalised)
    within f32 rounding (1e-6)."""
    x = _images(size)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3),
                                       method="bilinear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                        size=(299, 299), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_weights_file_loads_calibrated(converted, tmp_path, monkeypatch):
    """The converted state dict saved with torch.save, with the logits
    head a real file carries: build(path) reports calibrated and gives the
    same activations exactly; the drop-in path is taken when no path is
    configured, and without either the network is the random init."""
    path = tmp_path / "pt_inception.pth"
    torch.save({**converted, "fc.weight": torch.zeros(1008, 2048),
                "fc.bias": torch.zeros(1008)}, path)
    model, calibrated = pt_inc.build(str(path))
    assert calibrated
    x = torch.from_numpy(_images(32))
    assert torch.equal(model(x), _port(converted)(x))
    monkeypatch.setattr(pt_inc, "DEFAULT_WEIGHTS_PATH", path)
    assert pt_inc.build(None)[1]
    monkeypatch.setattr(pt_inc, "DEFAULT_WEIGHTS_PATH", tmp_path / "none")
    assert not pt_inc.build(None)[1]
    assert not pt_inc.build(str(tmp_path / "missing.pth"))[1]
    path.unlink()           # 92 MB: the suite's basetemp keeps no weights


@pytest.mark.parametrize("fault,message", [
    ("renamed", r"unmapped keys: \['Mixed_5b\.branchXxX\.conv\.weight'\]"),
    ("renamed", r"missing parameters: \['Mixed_5b\.branch1x1\.conv\.weight'\]"),
    ("shape", r"Mixed_5b\.branch1x1\.conv\.weight: got \(7, 7, 3, 3\)"),
    ("missing", r"missing parameters: \['Mixed_6a\.branch3x3\.bn\.running_var'\]"),
])
def test_weights_loader_names_what_does_not_map(converted, tmp_path, fault,
                                                message):
    state = dict(converted)
    if fault == "renamed":
        state["Mixed_5b.branchXxX.conv.weight"] = state.pop(
            "Mixed_5b.branch1x1.conv.weight")
    elif fault == "shape":
        state["Mixed_5b.branch1x1.conv.weight"] = torch.zeros(7, 7, 3, 3)
    else:
        state.pop("Mixed_6a.branch3x3.bn.running_var")
    torch.save(state, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match=message):
        pt_inc.load_weights(tmp_path / "bad.pth")
    (tmp_path / "bad.pth").unlink()     # 84 MB, as above


def test_random_init_keeps_features_alive():
    """The He-rescaled random init keeps pool3 O(1) (LeCun's would decay it
    through ~94 layers), and a seed gives the same network."""
    x = torch.from_numpy(_images(16))
    a = pt_inc.init_random(torch.Generator().manual_seed(1))(x)
    b = pt_inc.init_random(torch.Generator().manual_seed(1))(x)
    assert torch.equal(a, b)
    assert 0.05 < float(a.std()) < 20.0


def test_stats_match_numpy_cov():
    acts = np.random.default_rng(2).normal(size=(200, 16)).astype(np.float32)
    mu, sigma = pt_fid.stats_from_activations(torch.from_numpy(acts))
    np.testing.assert_allclose(mu.numpy(), acts.mean(0), atol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), np.cov(acts, rowvar=False),
                               atol=1e-5)


def _two_sets(n=400, d=64, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, d)).astype(np.float32)
    b = (rng.normal(size=(n, d)) * 1.3 + 0.4).astype(np.float32)
    return a, b


def test_frechet_distance_matches_jax_and_scipy():
    """Well-conditioned stats (64-d from 400 samples each): the f32
    Newton–Schulz FID within 1e-4 relative of the JAX function and of the
    float64 scipy formula."""
    a, b = _two_sets()
    stats = [pt_fid.stats_from_activations(torch.from_numpy(x))
             for x in (a, b)]
    got = pt_fid.frechet_distance(*stats[0], *stats[1])
    jstats = [jax_fid.stats_from_activations(jnp.asarray(x)) for x in (a, b)]
    want_jax = float(jax_fid.frechet_distance(*jstats[0], *jstats[1]))
    want_np = float(pt_fid.frechet_distance_np(
        a.mean(0), np.cov(a, rowvar=False), b.mean(0),
        np.cov(b, rowvar=False)))
    assert got == pytest.approx(want_jax, rel=1e-4)
    assert got == pytest.approx(want_np, rel=1e-4)


def test_frechet_distance_falls_back_to_scipy_when_ill_conditioned():
    """Eigenvalues over 14 decades: 30 f32 Newton–Schulz steps do not
    converge (residual above its 1e-2 bound), so the scipy path answers,
    within 1e-3 relative of the float64 formula, as in the JAX tests."""
    rng = np.random.default_rng(5)
    d = 24
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    s1 = (q * np.logspace(-8, 6, d)) @ q.T
    s2 = (q * np.logspace(-6, 6, d)[::-1]) @ q.T
    mu1, mu2 = rng.normal(size=d), rng.normal(size=d)
    args = [torch.tensor(v, dtype=torch.float32) for v in (mu1, s1, mu2, s2)]
    _, residual = pt_fid._frechet_distance_with_residual(*args)
    assert not float(residual) <= 1e-2
    want = float(pt_fid.frechet_distance_np(mu1, s1, mu2, s2))
    assert pt_fid.frechet_distance(*args) == pytest.approx(want, rel=1e-3)


def test_kid_matches_jax_with_whole_set_subsets():
    """With subset_size ≥ N every subset is the whole set in some order and
    the MMD does not depend on the order: the port's KID within 1e-5
    relative of the JAX package's."""
    a, b = _two_sets(n=96, d=32, seed=3)
    want = float(jax_fid.kid_from_activations(
        jax.random.PRNGKey(0), jnp.asarray(a), jnp.asarray(b), n_subsets=3,
        subset_size=1000))
    got = pt_fid.kid_from_activations(torch.Generator().manual_seed(0),
                                      torch.from_numpy(a), torch.from_numpy(b),
                                      n_subsets=3, subset_size=1000)
    assert got == pytest.approx(want, rel=1e-5)


def test_kid_subsets_follow_the_generator():
    """Subsets smaller than the sets: the same seed gives the same KID;
    separated sets a clearly positive one, and identical sets one near 0
    (within the JAX tests' 0.15: subsets of one set overlap)."""
    a, b = _two_sets(n=200, d=32, seed=4)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    def kid(x, y, seed):
        return pt_fid.kid_from_activations(torch.Generator().manual_seed(seed),
                                           x, y, n_subsets=10, subset_size=64)

    assert kid(ta, tb, 7) == kid(ta, tb, 7)
    assert kid(ta, tb, 7) > 0.5
    assert abs(kid(ta, ta, 7)) < 0.15
