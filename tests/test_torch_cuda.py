"""Tests of the port that need a CUDA card: the hand-written kernels have no
CPU mode. Each skips without a card. This file imports no JAX, so it runs on
a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from lightning_gan_zoo_tpu_torch.models import hologan
from lightning_gan_zoo_tpu_torch.ops import grid_sample
from lightning_gan_zoo_tpu_torch.ops.cuda import trilinear as kt

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
