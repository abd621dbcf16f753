"""Tests of the port that need a CUDA card: the hand-written kernels have no
CPU mode. Each skips without a card. This file imports no JAX, so it runs on
a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from lightning_gan_zoo_tpu_torch.models import hologan
from lightning_gan_zoo_tpu_torch.models.layers import BatchNorm2d
from lightning_gan_zoo_tpu_torch.nerf.siren import SirenNet
from lightning_gan_zoo_tpu_torch.ops import grid_sample
from lightning_gan_zoo_tpu_torch.ops import siren_trunk as pt
from lightning_gan_zoo_tpu_torch.ops.cuda import siren_trunk as st
from lightning_gan_zoo_tpu_torch.ops.cuda import trilinear as kt
from lightning_gan_zoo_tpu_torch.runtime.optim import RMSprop

pytestmark = pytest.mark.cuda

VIEW_ARGS = dict(elevation_low=70, elevation_high=110, azimuth_low=220,
                 azimuth_high=320, scale_low=1, scale_high=1,
                 transX_low=0, transX_high=0, transY_low=0, transY_high=0,
                 transZ_low=0, transZ_high=0)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.Generator("cuda").manual_seed(0)


@pytest.mark.parametrize("b,d,h,w,c,n", [(3, 7, 7, 7, 5, 1001),
                                         (2, 16, 16, 16, 64, 4096),
                                         (1, 4, 5, 6, 1, 64)])
def test_kernel_matches_plain(gen, b, d, h, w, c, n):
    vox = torch.randn(b, d, h, w, c, generator=gen, device="cuda")
    size = torch.tensor([w, h, d], device="cuda", dtype=torch.float32)
    pts = (torch.rand(b, n, 3, generator=gen, device="cuda") * (size + 4)
           - 2).contiguous()                   # 2 voxels outside each side
    got = kt.launch_forward(vox, pts)
    ref = grid_sample.trilinear_resample(vox, pts)
    assert float((got - ref).abs().max()) <= 1e-5
    g = torch.randn(got.shape, generator=gen, device="cuda")
    dv = kt.launch_backward(pts, g, vox.shape)
    dref = grid_sample.trilinear_resample_vox_grad(pts, g, vox.shape)
    # atomics sum in a run-dependent order: relative to the largest value
    assert float((dv - dref).abs().max()) <= 1e-4 * float(dref.abs().max())


def test_function_under_bf16_autocast_takes_f32_and_counts(gen):
    vox = torch.randn(2, 6, 6, 6, 8, generator=gen, device="cuda")
    pts = (torch.rand(2, 50, 3, generator=gen, device="cuda") * 6).contiguous()
    v = vox.to(torch.bfloat16).requires_grad_(True)
    fwd, bwd = kt.FWD_LAUNCHES, kt.BWD_LAUNCHES
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = kt.trilinear_resample(v, pts)
    assert out.dtype == torch.float32
    out.sum().backward()
    assert (kt.FWD_LAUNCHES - fwd, kt.BWD_LAUNCHES - bwd) == (1, 1)
    assert v.grad is not None and v.grad.dtype == torch.bfloat16


def test_generator_kernel_matches_gather_twin(gen):
    g = hologan.Generator(8, 3, 16, VIEW_ARGS, 64).cuda()
    twin = hologan.Generator(8, 3, 16, VIEW_ARGS, 64,
                             resample="gather").cuda()
    twin.load_state_dict(g.state_dict())
    z = torch.rand(4, 16, generator=gen, device="cuda") * 2 - 1
    views = hologan.sample_view(gen, 4, VIEW_ARGS)
    with torch.no_grad():
        np.testing.assert_allclose(g(z, views).cpu().numpy(),
                                   twin(z, views).cpu().numpy(), atol=1e-4)


def _trunk_inputs(gen, b, m, h, layers, n_film, unfilmed=False):
    """SIREN-init weights, x ~ N(0, 0.25), γ ~ 1 + N(0, 0.01), β ~ N(0, 0.01)
    (or γ = 1, β = 0 when ``unfilmed``), and a bf16 cotangent."""
    d = dict(device="cuda")
    bound = (6 / h) ** 0.5
    x = torch.randn(b, m, 3, generator=gen, **d) * 0.5
    w0k = (torch.rand(3, h, generator=gen, **d) * 2 - 1) / 3
    wmid = (torch.rand(layers - 1, h, h, generator=gen, **d) * 2 - 1) * bound
    bs = (torch.rand(layers, h, generator=gen, **d) * 2 - 1) * bound
    if unfilmed:
        g, bt = torch.ones(b, 1, h, **d), torch.zeros(b, 1, h, **d)
    else:
        g = torch.randn(b, n_film, h, generator=gen, **d) * 0.1 + 1
        bt = torch.randn(b, n_film, h, generator=gen, **d) * 0.1
    dy = torch.randn(b, m, h, generator=gen, **d).to(torch.bfloat16)
    return (x, w0k, wmid, bs, g, bt), dy


@pytest.mark.parametrize("b,m,h,layers,n_film,unfilmed", [
    (2, 300, 128, 3, 2, False), (3, 1000, 256, 7, 6, False),
    (3, 999, 256, 7, 1, True), (2, 77, 64, 4, 4, False),
    # the backward's 64-row tiles and k-steps: M one short of and one past
    # a tile, a single sample, every width
    (1, 63, 64, 2, 1, False), (1, 65, 128, 5, 3, False),
    (1, 1000, 256, 7, 6, False), (2, 65, 256, 3, 1, True),
    # 27 k-steps over 14 dW blocks of 2: the last block takes one
    (3, 560, 256, 7, 6, False)])
def test_trunk_kernels_match_plain(gen, b, m, h, layers, n_film, unfilmed):
    """Forward within 2⁻⁸ absolute and every gradient group within 0.01 of
    its max |ref| (the JAX tests allow 0.04 and 0.03; these kernels round
    where the plain version rounds, so the forward lands bit-identical),
    and the backward bit-identical from run to run (no atomics)."""
    args, dy = _trunk_inputs(gen, b, m, h, layers, n_film, unfilmed)
    w0s = (30.0,) + (1.0,) * (layers - 1)
    y = st.launch_forward(*args, w0s)
    err = (y.float() - pt.trunk_forward(*args, w0s).float()).abs().max()
    assert float(err) <= 2.0 ** -8
    got = st.launch_backward(*args, dy, w0s)
    want = pt.trunk_backward(*args, dy, w0s)
    for g_, w in zip(got, want):
        assert float((g_ - w).abs().max()) <= 0.01 * float(w.abs().max())
    again = st.launch_backward(*args, dy, w0s)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


def test_sirennet_bf16_runs_the_kernels_and_counts(gen):
    """Under precision 16 a CUDA SirenNet goes through one forward and one
    backward launch, with finite float32 gradients."""
    net = SirenNet(3, 128, 128, 3, bf16=True).cuda()
    x = torch.randn(2, 500, 3, generator=gen, device="cuda")
    g = torch.randn(2, 3, 128, generator=gen, device="cuda") * 0.1 + 1
    fwd, bwd = st.FWD_LAUNCHES, st.BWD_LAUNCHES
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y = net(x, g.to(torch.bfloat16), (g - 1).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y.shape == (2, 500, 128)
    y.float().square().sum().backward()
    assert (st.FWD_LAUNCHES - fwd, st.BWD_LAUNCHES - bwd) == (1, 1)
    assert all(bool(torch.isfinite(p.grad).all()) for p in net.parameters())


def test_sirennet_kernel_refuses_a_width_it_cannot_take(gen):
    net = SirenNet(3, 96, 96, 2, bf16=True).cuda()
    with pytest.raises(ValueError, match="dim_hidden"):
        net(torch.randn(1, 10, 3, generator=gen, device="cuda"))


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_under_bf16_autocast_matches_f32(gen, train):
    """The flax-semantics BatchNorm on the card under the bf16 policy
    against its float32 self: outputs within 2 bf16 steps of their scale,
    and the running statistics (reduced in float32 from the bf16 input)
    within one bf16 rounding of the input."""
    x = torch.randn(8, 16, 12, 12, generator=gen, device="cuda") * 2 + 0.5
    bn32, bn16 = BatchNorm2d(16).cuda(), BatchNorm2d(16).cuda()
    with torch.no_grad():
        for bn in (bn32, bn16):
            bn.weight.copy_(torch.linspace(0.5, 1.5, 16))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, 16))
            bn.running_var.fill_(2.0)
            bn.train(train)
        want = bn32(x)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            got = bn16(x.to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    scale = float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= 2 * 2.0 ** -8 * scale
    for name in ("running_mean", "running_var"):
        a, b = getattr(bn16, name), getattr(bn32, name)
        assert a.dtype == torch.float32
        assert float((a - b).abs().max()) <= 2.0 ** -8 * float(b.abs().max())


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_rmsprop_on_the_card_matches_the_cpu(gen, momentum):
    """The optax-rule RMSprop on CUDA tensors against the same steps on the
    CPU, at gradients near 1e-3: within a few float32 steps."""
    p0 = torch.randn(3, 257, generator=gen, device="cuda")
    grads = [torch.randn(3, 257, generator=gen, device="cuda") * 1e-3
             for _ in range(6)]
    out = []
    for dev in ("cuda", "cpu"):
        p = torch.nn.Parameter(p0.to(dev).clone())
        opt = RMSprop([p], lr=1e-2, momentum=momentum)
        for g in grads:
            p.grad = g.to(dev)
            opt.step()
        out.append(p.detach().cpu())
    torch.testing.assert_close(out[0], out[1], rtol=1e-6, atol=1e-6)
