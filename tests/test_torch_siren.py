"""The port's SIREN trunk against the JAX package's, on the CPU: the sine
polynomial, the trunk's plain version (the CUDA kernels' oracle and CPU
path) against the Pallas trunk in interpret mode and against JAX's plain
SirenNet, the hand-written backward, and the SirenNet module's dispatch.
Widths are small (H = 128, 2–3 FiLM layers, M not a multiple of the TPU's
512-row tile); inputs come from numpy seeds. Each test states its bound."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_gan_zoo_tpu.nerf.siren import SirenNet as JSirenNet
from lightning_gan_zoo_tpu.ops import fast_math as jfm
from lightning_gan_zoo_tpu.ops.pallas.siren_trunk import (
    _sin_poly as j_sin_poly, siren_trunk as j_trunk)
from lightning_gan_zoo_tpu_torch.nerf.siren import SirenNet
from lightning_gan_zoo_tpu_torch.ops import fast_math, siren_trunk as pt
from lightning_gan_zoo_tpu_torch.ops.cuda import siren_trunk as ct

B, M, H = 2, 600, 128
NAMES = ("x", "w0k", "wmid", "bs", "gammas", "betas")


def _inputs(nl, seed=0, n_film=None):
    """x, w0k, wmid, bs, γ, β, dy as numpy, with the SIREN init's bounds."""
    rng = np.random.default_rng(seed)
    nf = nl if n_film is None else n_film
    f32 = np.float32
    return (rng.normal(size=(B, M, 3)).astype(f32) * 0.5,
            rng.uniform(-1 / 3, 1 / 3, (3, H)).astype(f32),
            rng.uniform(-1, 1, (nl, H, H)).astype(f32) * np.sqrt(6 / H),
            rng.uniform(-1, 1, (nl + 1, H)).astype(f32) * np.sqrt(6 / H),
            (rng.normal(size=(B, nf, H)) * 0.1 + 1).astype(f32),
            (rng.normal(size=(B, nf, H)) * 0.1).astype(f32),
            rng.normal(size=(B, M, H)).astype(f32))


def _w0s(nl):
    return (30.0,) + (1.0,) * nl


def _jax_params(w0k, wmid, bs):
    p = {f"Siren_{i}": {"Dense_0": {"kernel": w0k if i == 0 else wmid[i - 1],
                                    "bias": bs[i]}}
         for i in range(len(bs))}
    return {"params": jax.tree.map(jnp.asarray, p)}


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_fast_sin_and_derivative_match_jax():
    """The same f32 polynomial and reduction: within 2e-6 (a last-bit
    difference of the reduction at |x| ≈ 300)."""
    x = np.linspace(-300.0, 300.0, 20001, dtype=np.float32)
    s, ds = fast_math.sin_poly(torch.from_numpy(x))
    js, jds = j_sin_poly(jnp.asarray(x))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=2e-6)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), atol=2e-6)
    np.testing.assert_allclose(fast_math.fast_sin(torch.from_numpy(x)).numpy(),
                               np.asarray(jfm.fast_sin(jnp.asarray(x))),
                               atol=2e-6)
    assert np.abs(s.numpy() - np.sin(x)).max() < 7e-4


@pytest.mark.parametrize("nl,n_film", [(2, 2), (3, 3), (3, 1)])
def test_plain_trunk_matches_pallas_and_plain_sirennet(nl, n_film):
    """bf16 policy, within 0.04 absolute (the JAX test's bound for its
    kernel against its plain loop: outputs lie in [-1, 1] and the bf16 FiLM
    rounding order differs)."""
    x, w0k, wmid, bs, g, bt, _ = _inputs(nl, n_film=n_film)
    got = pt.trunk_forward(*_t(x, w0k, wmid, bs, g, bt), _w0s(nl))
    assert got.dtype == torch.bfloat16 and got.shape == (B, M, H)
    got = got.float().numpy()
    want_k = np.asarray(j_trunk(*map(jnp.asarray, (x, w0k, wmid, bs, g, bt)),
                                _w0s(nl), True), np.float32)
    np.testing.assert_allclose(got, want_k, atol=0.04)
    if n_film == nl:      # JAX's plain SirenNet FiLMs every hidden layer
        net = JSirenNet(H, H, nl, dtype=jnp.bfloat16, fused=False)
        want_p = np.asarray(net.apply(_jax_params(w0k, wmid, bs),
                                      jnp.asarray(x), jnp.asarray(g),
                                      jnp.asarray(bt)), np.float32)
        np.testing.assert_allclose(got, want_p, atol=0.04)


def test_f32_sirennet_matches_jax():
    """f32 policy: the exact-sine f32 layer loop, within 1e-5."""
    nl = 3
    x, w0k, wmid, bs, g, bt, _ = _inputs(nl, seed=1)
    net = JSirenNet(H, H, nl, dtype=jnp.float32)
    want = np.asarray(net.apply(_jax_params(w0k, wmid, bs), jnp.asarray(x),
                                jnp.asarray(g), jnp.asarray(bt)))
    tnet = SirenNet(3, H, H, nl)
    with torch.no_grad():
        for i, lyr in enumerate(tnet.layers):
            lyr.kernel.copy_(torch.from_numpy(w0k if i == 0 else wmid[i - 1]))
            lyr.bias.copy_(torch.from_numpy(bs[i]))
        got = tnet(*_t(x, g, bt))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("n_film", [3, 1])
def test_plain_backward_is_autograd_of_plain_forward_in_f32(n_film):
    """With f32 as the working type there is no rounding point left, so the
    hand-written backward must equal autograd of the forward: rtol 1e-4 of
    each group's max |ref| (float32 sums in another order)."""
    nl = 3
    arrs = _inputs(nl, seed=2, n_film=n_film)
    *ins, dy = _t(*arrs)
    ins = [t.requires_grad_(True) for t in ins]
    y = pt.trunk_forward(*ins, _w0s(nl), dtype=torch.float32)
    (y * dy).sum().backward()
    got = pt.trunk_backward(*[t.detach() for t in ins], dy, _w0s(nl),
                            dtype=torch.float32)
    for name, t, g in zip(NAMES, ins, got):
        scale = float(t.grad.abs().max())
        assert scale > 0
        assert float((g - t.grad).abs().max()) <= 1e-4 * scale, name


def test_plain_backward_matches_pallas_grads():
    """bf16 policy against JAX's hand-written kernel backward: every group
    within 0.03 of its max |ref| (tests/test_siren_trunk.py's bound)."""
    nl = 3
    x, w0k, wmid, bs, g, bt, dy = _inputs(nl, seed=3)
    jargs = tuple(map(jnp.asarray, (x, w0k, wmid, bs, g, bt)))
    jdy = jnp.asarray(dy)

    def loss(args):
        return jnp.sum(j_trunk(*args, _w0s(nl), True).astype(jnp.float32)
                       * jdy.astype(jnp.bfloat16).astype(jnp.float32))
    want = jax.grad(loss)(jargs)
    got = pt.trunk_backward(*_t(x, w0k, wmid, bs, g, bt),
                            torch.from_numpy(dy).to(torch.bfloat16), _w0s(nl))
    for name, w, g_ in zip(NAMES, want, got):
        w = np.asarray(w)
        assert g_.shape == w.shape, name
        assert np.abs(g_.numpy() - w).max() <= 0.03 * np.abs(w).max(), name


@pytest.mark.parametrize("film", [True, False])
def test_sirennet_trunk_dispatch_is_the_plain_layer_loop(film):
    """Under bf16 on the CPU, SirenNet's trunk branch (the autograd function
    taking its plain version) and the layer loop (fused=False) compute the
    same ops: equal outputs, and gradients within 0.03 of max |ref| (the
    trunk's backward is the hand-written one, the loop's is autograd)."""
    nl = 2
    x, _, _, _, g, bt, dy = _inputs(nl, seed=4)
    fused = SirenNet(3, H, H, nl, bf16=True, generator=torch.Generator()
                     .manual_seed(0))
    plain = SirenNet(3, H, H, nl, bf16=True, fused=False)
    plain.load_state_dict(fused.state_dict())
    args = _t(x, g, bt) if film else _t(x)
    outs, grads = [], []
    for net in (fused, plain):
        net.zero_grad()
        y = net(*args)
        (y.float() * torch.from_numpy(dy)).sum().backward()
        outs.append(y)
        grads.append([p.grad.clone() for p in net.parameters()])
    assert outs[0].dtype == torch.bfloat16
    assert torch.equal(outs[0], outs[1])
    for gf, gp in zip(*grads):
        assert float((gf - gp).abs().max()) <= 0.03 * float(gp.abs().max())


def test_trunk_function_counts_nothing_on_the_cpu_and_launch_refuses_it():
    """A CPU tensor takes the plain version (no kernel launch); the launch
    functions themselves refuse a CPU tensor rather than fall back."""
    nl = 2
    x, w0k, wmid, bs, g, bt, _ = _inputs(nl)
    args = _t(x, w0k, wmid, bs, g, bt)
    before = ct.FWD_LAUNCHES
    y = ct.siren_trunk(*args, _w0s(nl))
    assert ct.FWD_LAUNCHES == before
    assert torch.equal(y, pt.trunk_forward(*args, _w0s(nl)))
    with pytest.raises(ValueError, match="CUDA"):
        ct.launch_forward(*args, _w0s(nl))


@pytest.mark.parametrize("h,layers,cin,message", [
    (96, 3, 3, "dim_hidden"), (128, 17, 3, "layers"), (128, 3, 5, "input")])
def test_kernel_shape_limits_raise(h, layers, cin, message):
    """Shapes the kernels cannot take raise before any launch."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 10, cin)).astype(np.float32))
    args = (x, torch.zeros(cin, h), torch.zeros(layers - 1, h, h),
            torch.zeros(layers, h), torch.ones(2, 1, h), torch.zeros(2, 1, h))
    with pytest.raises(ValueError, match=message):
        ct.launch_forward(*args, (30.0,) + (1.0,) * (layers - 1))


def _core_matrix_operand(chunks, h):
    """The (N, K) matrix a K-major wgmma operand holds, read back from its
    64-row chunks of K the way the kernel's descriptors address them: core
    matrices of 8 rows × 8 K-values (16 bytes per row), 128 bytes apart
    along N (the stride byte offset) and h·16 bytes apart along K (the
    leading byte offset)."""
    flat = chunks.reshape(-1)
    n = np.arange(h)[:, None]
    k = np.arange(h)[None, :]
    idx = (k // 64) * 64 * h + (k % 64 // 8) * (h * 16 // 2) \
        + (n // 8) * (128 // 2) + (n % 8) * 8 + k % 8
    return flat[idx]


@pytest.mark.parametrize("h,layers", [(64, 2), (128, 3), (256, 4)])
def test_pack_weights_is_what_the_ring_feeds_wgmma(h, layers):
    """The backward's packed weights: matrix j < L−1 is the recompute
    product's B operand (b[n][k] = W_j[k][n]), matrix L−1+j the walk back's
    (b[n][k] = W_j[n][k]), each W rounded to bf16 as the plain version
    rounds it."""
    rng = np.random.default_rng(h)
    wmid = torch.from_numpy(
        rng.uniform(-1, 1, (layers - 1, h, h)).astype(np.float32))
    packed = ct.pack_weights(wmid)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.numel() == 2 * (layers - 1) * h * h
    mats = packed.float().reshape(2 * (layers - 1), -1).numpy()
    w16 = wmid.to(torch.bfloat16).float().numpy()
    for j in range(layers - 1):
        np.testing.assert_array_equal(_core_matrix_operand(mats[j], h),
                                      w16[j].T)
        np.testing.assert_array_equal(
            _core_matrix_operand(mats[layers - 1 + j], h), w16[j])


@pytest.mark.parametrize("b,m,h,layers", [
    (128, 8192, 256, 7), (3, 560, 256, 7), (1, 63, 64, 2), (2, 65, 128, 5),
    (5, 1000, 128, 3)])
def test_dw_splits_cover_every_k_step_once(b, m, h, layers):
    """The weight gradient's split-K: every one of the n_steps 64-row
    k-steps falls in exactly one block's range, no block's range is empty,
    and the blocks fill about two waves of 132 SMs, not more."""
    n_steps = b * -(-m // ct.STEP_ROWS)
    splits = ct.dw_splits(n_steps, h, layers)
    per = -(-n_steps // splits)     # as the launch computes it
    ranges = [range(s * per, min(n_steps, (s + 1) * per))
              for s in range(splits)]
    assert all(len(r) > 0 for r in ranges)
    assert sorted(i for r in ranges for i in r) == list(range(n_steps))
    tiles = max(1, h // 128) * (layers - 1)
    assert splits * tiles <= 264 + tiles
