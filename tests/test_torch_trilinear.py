"""The port's trilinear resample against the JAX package's.

On the CPU the autograd.Function takes the plain PyTorch version, which must
match the JAX gather (f32, atol 1e-5) and the Pallas kernel in interpret mode
(atol 3e-2, since the TPU kernel's matmuls run in bf16). The CUDA kernel
itself runs only on a card: tests/test_torch_cuda.py holds it against the
plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_gan_zoo_tpu.ops.grid_sample import (
    trilinear_resample as jax_resample)
from lightning_gan_zoo_tpu.ops.pallas.trilinear import trilinear_resample_mxu
from lightning_gan_zoo_tpu_torch.ops import grid_sample
from lightning_gan_zoo_tpu_torch.ops.cuda import trilinear as kt

# the clamp cases of tests/test_pallas_trilinear.py
EDGE_POINTS = [[-5.0, -5.0, -5.0], [100.0, 100.0, 100.0], [0.0, 0.0, 0.0],
               [7.0, 7.0, 7.0]]


def _inputs(b=2, s=8, c=16, n=100, seed=0, edge=True):
    rng = np.random.default_rng(seed)
    vox = rng.normal(size=(b, s, s, s, c)).astype(np.float32)
    pts = rng.uniform(-1.0, s, size=(b, n, 3)).astype(np.float32)
    if edge:
        pts = np.concatenate(
            [pts, np.broadcast_to(np.float32(EDGE_POINTS), (b, 4, 3))], 1)
    return vox, np.ascontiguousarray(pts)


@pytest.mark.parametrize("shape", [dict(), dict(b=1, s=4, c=3, n=37, seed=1),
                                   dict(b=3, s=5, c=8, n=300, seed=2)])
def test_plain_forward_matches_jax_gather(shape):
    vox, pts = _inputs(**shape)
    want = np.asarray(jax_resample(jnp.asarray(vox), jnp.asarray(pts)))
    got = grid_sample.trilinear_resample(torch.from_numpy(vox),
                                         torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_function_forward_matches_pallas_interpret():
    vox, pts = _inputs()
    want = np.asarray(trilinear_resample_mxu(jnp.asarray(vox),
                                             jnp.asarray(pts), True))
    got = kt.trilinear_resample(torch.from_numpy(vox), torch.from_numpy(pts))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-2)


@pytest.mark.parametrize("seed", [0, 3])
def test_function_backward_matches_jax_grad(seed):
    vox, pts = _inputs(b=2, s=6, c=8, n=400, seed=seed)
    g = np.random.default_rng(seed + 10).normal(
        size=(2, pts.shape[1], 8)).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda v: jnp.sum(jax_resample(v, jnp.asarray(pts)) * g))(
            jnp.asarray(vox)))

    v = torch.from_numpy(vox).requires_grad_(True)
    p = torch.from_numpy(pts).requires_grad_(True)
    out = kt.trilinear_resample(v, p)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), want, atol=1e-5)
    assert p.grad is None          # coordinates get no gradient


def test_cpu_path_launches_no_kernel():
    fwd, bwd = kt.FWD_LAUNCHES, kt.BWD_LAUNCHES
    vox, pts = _inputs(b=1, s=4, c=4, n=10)
    v = torch.from_numpy(vox).requires_grad_(True)
    kt.trilinear_resample(v, torch.from_numpy(pts)).sum().backward()
    assert (kt.FWD_LAUNCHES, kt.BWD_LAUNCHES) == (fwd, bwd)


def test_kernel_wrappers_reject_what_the_kernel_does_not_take():
    vox, pts = _inputs(b=1, s=4, c=4, n=10)
    v, p = torch.from_numpy(vox), torch.from_numpy(pts)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kt.launch_forward(v, p)              # no plain fallback here
    with pytest.raises(TypeError, match="float32"):
        kt.launch_forward(v.double(), p)
    with pytest.raises(ValueError, match="contiguous"):
        kt.launch_forward(v.transpose(1, 2), p)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kt.launch_backward(p, torch.zeros(1, p.shape[1], 4), v.shape)

