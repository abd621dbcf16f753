"""The JAX → PyTorch weight converter, per layer kind: a flax layer and its
PyTorch counterpart, run on converted random weights and the same input,
agree in float32 (atol 1e-5)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from lightning_gan_zoo_tpu.models.layers import (
    SpectralNormConv as JaxSpectralNormConv)
from lightning_gan_zoo_tpu_torch import convert
from lightning_gan_zoo_tpu_torch.models.layers import SpectralNormConv


def _rand_params(variables, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32),
        jax.device_get(variables))


def _load(module, sd):
    module.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    return module


def _nhwc_to_nchw(x):
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


@pytest.mark.parametrize("n", [2, 4])
def test_conv_transpose3d_k3s2_same_is_padding0_cropped(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(2, n, n, n, 5)).astype(np.float32)
    layer = nn.ConvTranspose(3, (3, 3, 3), strides=(2, 2, 2), padding="SAME")
    params = _rand_params(jax.jit(layer.init)(jax.random.PRNGKey(0), x), 1)
    want = np.asarray(jax.jit(layer.apply)(params, x))  # (2, 2n, 2n, 2n, 3)

    sd = convert._conv_transpose(params["params"], "m")
    w, b = sd["m.weight"], sd["m.bias"]
    xt = _nhwc_to_nchw(x)
    got = F.conv_transpose3d(xt, w, b, stride=2, padding=0)
    assert got.shape[2:] == (2 * n + 1,) * 3
    got = got[:, :, :-1, :-1, :-1].permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the obvious symmetric padding is NOT flax's "SAME"
    wrong = F.conv_transpose3d(xt, w, b, stride=2, padding=1,
                               output_padding=1).permute(0, 2, 3, 4, 1)
    assert np.abs(wrong.numpy() - want).max() > 1e-2


@pytest.mark.parametrize("n", [4, 8])
def test_conv_transpose2d_k4s2_same_is_padding1(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(2, n, n, 6)).astype(np.float32)
    layer = nn.ConvTranspose(4, (4, 4), strides=(2, 2), padding="SAME")
    params = _rand_params(jax.jit(layer.init)(jax.random.PRNGKey(0), x), 2)
    want = np.asarray(jax.jit(layer.apply)(params, x))
    m = _load(torch.nn.ConvTranspose2d(6, 4, 4, stride=2, padding=1),
              convert._conv_transpose(params["params"], "m"))
    got = m(_nhwc_to_nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("k,stride,pad", [(5, 2, 2), (1, 1, 0), (3, 1, 1)])
def test_conv2d(k, stride, pad):
    x = np.random.default_rng(k).normal(size=(2, 16, 16, 5)).astype(
        np.float32)
    layer = nn.Conv(7, (k, k), strides=(stride, stride),
                    padding=[(pad, pad), (pad, pad)])
    params = _rand_params(jax.jit(layer.init)(jax.random.PRNGKey(0), x), 3)
    want = np.asarray(jax.jit(layer.apply)(params, x))
    m = _load(torch.nn.Conv2d(5, 7, k, stride=stride, padding=pad),
              convert._conv(params["params"], "m"))
    got = m(_nhwc_to_nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_dense():
    x = np.random.default_rng(0).normal(size=(3, 11)).astype(np.float32)
    layer = nn.Dense(6)
    params = _rand_params(jax.jit(layer.init)(jax.random.PRNGKey(0), x), 4)
    want = np.asarray(jax.jit(layer.apply)(params, x))
    m = _load(torch.nn.Linear(11, 6), convert._dense(params["params"], "m"))
    np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(), want,
                               atol=1e-5)


def test_spectral_norm_conv_output_and_u_over_two_calls():
    """u starts at 1/sqrt(out), carries across, and updates once per call:
    the second call sees the first call's u (HoloGAN's D runs twice in
    its loss)."""
    rng = np.random.default_rng(5)
    x1, x2 = (rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
              for _ in range(2))
    layer = JaxSpectralNormConv(8, (5, 5), strides=(2, 2),
                                padding=[(2, 2), (2, 2)])
    variables = layer.init(jax.random.PRNGKey(0), x1)
    params = _rand_params({"params": variables["params"]}, 6)["params"]
    np.testing.assert_allclose(np.asarray(variables["spectral"]["u"]),
                               np.full(8, 1 / np.sqrt(8)), rtol=1e-6)
    spectral = jax.device_get(variables["spectral"])
    apply = jax.jit(functools.partial(layer.apply, mutable=["spectral"]))

    m = SpectralNormConv(4, 8, 5, 2, 2, torch.Generator())
    sd = convert._conv(params, "m")
    sd["m.u"] = torch.from_numpy(np.asarray(spectral["u"]).copy())
    _load(m, sd)
    for x in (x1, x2):
        want, new = apply({"params": params, "spectral": spectral}, x)
        spectral = new["spectral"]
        got = m(_nhwc_to_nchw(x)).permute(0, 2, 3, 1).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(m.u.numpy(), np.asarray(spectral["u"]),
                                   atol=1e-6)


def test_spectral_norm_conv_weight_gradient_keeps_sigma_term():
    """σ = vᵀWu keeps its W-gradient (u, v detached), as in the JAX layer."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    g = rng.normal(size=(2, 4, 4, 6)).astype(np.float32)
    layer = JaxSpectralNormConv(6, (5, 5), strides=(2, 2),
                                padding=[(2, 2), (2, 2)])
    variables = jax.device_get(jax.jit(layer.init)(jax.random.PRNGKey(0), x))
    params = _rand_params({"params": variables["params"]}, 8)["params"]

    def loss(p):
        out, _ = layer.apply({"params": p, "spectral": variables["spectral"]},
                             x, mutable=["spectral"])
        return jnp.sum(out * g)
    want = jax.jit(jax.grad(loss))(params)

    m = SpectralNormConv(3, 6, 5, 2, 2, torch.Generator())
    sd = convert._conv(params, "m")
    sd["m.u"] = torch.from_numpy(np.asarray(variables["spectral"]["u"]).copy())
    _load(m, sd)
    (m(_nhwc_to_nchw(x)) * _nhwc_to_nchw(g)).sum().backward()
    got = convert._conv({"kernel": np.asarray(want["kernel"]),
                         "bias": np.asarray(want["bias"])}, "m")
    np.testing.assert_allclose(m.weight.grad.numpy(), got["m.weight"].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(m.bias.grad.numpy(), got["m.bias"].numpy(),
                               atol=1e-4)
