"""The port's trilinear resample against the JAX package's.

On the CPU the autograd.Function takes the plain PyTorch version, which must
match the JAX gather (f32, atol 1e-5) and the Pallas kernel in interpret mode
(atol 3e-2, since the TPU kernel's matmuls run in bf16). The CUDA kernel
itself runs only on a card: tests/test_torch_cuda.py holds it against the
plain version there, and bit for bit against ``ordered_vox_grad``, its
summation order in plain PyTorch, which is held here against the JAX
package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_gan_zoo_tpu.ops.grid_sample import (
    trilinear_resample as jax_resample)
from lightning_gan_zoo_tpu.ops.pallas.trilinear import (
    _backward_vox, trilinear_resample_mxu)
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


@pytest.mark.parametrize("shape", [dict(), dict(b=1, s=4, c=3, n=37, seed=1),
                                   dict(b=3, s=5, c=8, n=300, seed=2)])
def test_ordered_vox_grad_matches_jax(shape):
    """The backward kernel's order (each voxel's (point, corner) entries in
    ascending order of point·8 + corner, summed one by one), with the clamp
    cases, whose corners fall on one voxel and count once each: within f32
    rounding of the JAX gather's gradient, and of the Pallas ``_backward_vox``
    in interpret mode within its tests' bf16 bound (6e-2)."""
    vox, pts = _inputs(**shape)
    b, s, c = vox.shape[0], vox.shape[1], vox.shape[-1]
    g = np.random.default_rng(shape.get("seed", 0) + 10).normal(
        size=(b, pts.shape[1], c)).astype(np.float32)
    got = kt.ordered_vox_grad(torch.from_numpy(pts), torch.from_numpy(g),
                              vox.shape).numpy()
    _, vjp = jax.vjp(lambda v: jax_resample(v, jnp.asarray(pts)),
                     jnp.asarray(vox))
    np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=1e-5)
    pallas = _backward_vox(jnp.asarray(pts), jnp.asarray(g), s, s, s, c,
                           interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=6e-2)


def test_ordered_vox_grad_sums_each_bin_in_entry_order():
    """Three points on one voxel cell, a cotangent whose terms cancel
    unless they are added in order: the sum is ((t0 + t1) + t2), term by
    term, not the plain scatter's."""
    pts = torch.tensor([[[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]]])
    g = torch.tensor([[[1.0], [1e8], [-1e8]]])
    got = kt.ordered_vox_grad(pts, g, (1, 2, 2, 2, 1))
    t0, t1, t2 = np.float32(1.0), np.float32(1e8), np.float32(-1e8)
    assert (t0 + t1) + t2 != t0 + (t1 + t2)          # f32: 0 against 1
    assert float(got[0, 0, 0, 0, 0]) == (t0 + t1) + t2
    assert float(got.abs().sum()) == 0.0     # the other corners weigh 0


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


@pytest.mark.parametrize("shape", [dict(), dict(b=1, s=4, c=3, n=37, seed=1)])
def test_grid_sample_yardstick_is_the_same_map(shape):
    """The library call the card timings hold the kernel against
    (utils/kernel_bench.py: F.grid_sample, border, align_corners, on the
    normalised grid; aten's volume gradient) computes the JAX package's
    border-clamped resample and its volume gradient, points outside the
    volume included: within 1e-5 of the JAX gather (the normalisation
    rounds the coordinates)."""
    from lightning_gan_zoo_tpu_torch.utils import kernel_bench as kb
    vox, pts = _inputs(**shape)
    v, p = torch.from_numpy(vox), torch.from_numpy(pts)
    vol, grid = kb.grid_sample_inputs(v, p)
    got = kb.grid_sample_fwd(vol, grid)[:, :, 0, 0].permute(0, 2, 1)
    want = np.asarray(jax_resample(jnp.asarray(vox), jnp.asarray(pts)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    g = np.random.default_rng(7).normal(size=want.shape).astype(np.float32)
    g_lib = torch.from_numpy(g).permute(0, 2, 1)[:, :, None, None]
    dvol = kb.grid_sample_bwd(vol, grid, g_lib.contiguous())
    _, vjp = jax.vjp(lambda x: jax_resample(x, jnp.asarray(pts)),
                     jnp.asarray(vox))
    np.testing.assert_allclose(dvol.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-5)


def test_kernel_bounds_at_the_main_paths_shapes():
    """The bounds the card run reports: the trilinear passes move 68.7 MB
    (0.0205 ms at 3.35 TB/s); the trunk does 0.82 TFLOP forward and 3×
    that backward at π-GAN's 16-px shape (0.834 and 2.501 ms at 989
    TFLOP/s)."""
    from lightning_gan_zoo_tpu_torch.utils import kernel_bench as kb
    tri = kb.trilinear_bound((32, 16, 16, 16, 64), 4096)
    assert tri["bound_by"] == "bytes"
    assert tri["bound_ms"] == pytest.approx(0.0205, abs=1e-4)
    fwd = kb.trunk_bound(128, 8192, 256, 7)
    bwd = kb.trunk_bound(128, 8192, 256, 7, backward=True)
    assert fwd["bound_by"] == bwd["bound_by"] == "operations"
    assert fwd["bound_ms"] == pytest.approx(0.8338, abs=1e-4)
    assert bwd["bound_ms"] == pytest.approx(2.5014, abs=1e-4)
