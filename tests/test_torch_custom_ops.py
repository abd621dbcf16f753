"""The kernels as torch.library custom ops (ops/cuda/{trilinear,siren_trunk}
.py) on the CPU, where each op's CPU implementation is its plain version:
``torch.library.opcheck`` (schema, autograd registration, fake tensors,
AOT dispatch with dynamic shapes) on each of the four ops at small shapes;
the autograd wiring equal to the plain functions bit for bit; and an
exported graph with one node per kernel call, under a symbolic batch too."""
import pytest
import torch

from lightning_gan_zoo_tpu_torch.ops import grid_sample
from lightning_gan_zoo_tpu_torch.ops import siren_trunk as plain_trunk
from lightning_gan_zoo_tpu_torch.ops.cuda import siren_trunk as st
from lightning_gan_zoo_tpu_torch.ops.cuda import trilinear as kt

torch.set_num_threads(2)


def trilinear_inputs(b=2, n=37, c=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    vox = torch.randn(b, 3, 4, 6, c, generator=g)
    # points reaching outside the volume on every side (the clamp)
    pts = torch.rand(b, n, 3, generator=g) * torch.tensor([8.0, 6.0, 5.0]) - 1
    return vox, pts, torch.randn(b, n, c, generator=g)


def trunk_inputs(b=2, m=9, cin=3, h=16, layers=3, n_film=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    args = (torch.randn(b, m, cin, generator=g),
            torch.randn(cin, h, generator=g) / cin,
            torch.randn(layers - 1, h, h, generator=g) / h ** 0.5,
            torch.randn(layers, h, generator=g) * 0.1,
            1 + 0.1 * torch.randn(b, n_film, h, generator=g),
            0.1 * torch.randn(b, n_film, h, generator=g))
    dy = torch.randn(b, m, h, generator=g).to(torch.bfloat16)
    return args, dy, [30.0] + [1.0] * (layers - 1)


def test_opcheck_trilinear_fwd():
    vox, pts, _ = trilinear_inputs()
    torch.library.opcheck(kt.trilinear_fwd,
                          (vox.requires_grad_(True), pts))


def test_opcheck_trilinear_bwd():
    vox, pts, g = trilinear_inputs()
    torch.library.opcheck(kt.trilinear_bwd, (pts, g, list(vox.shape)))


@pytest.mark.parametrize("n_film", [1, 3])
def test_opcheck_siren_trunk_fwd(n_film):
    args, _, w0s = trunk_inputs(n_film=n_film)
    torch.library.opcheck(
        st.siren_trunk_fwd,
        (*[a.requires_grad_(True) for a in args], w0s, None))


@pytest.mark.parametrize("n_film", [1, 3])
def test_opcheck_siren_trunk_bwd(n_film):
    args, dy, w0s = trunk_inputs(n_film=n_film)
    torch.library.opcheck(st.siren_trunk_bwd, (*args, dy, w0s, None))


def test_trilinear_op_gradient_is_the_plain_transpose():
    """Autograd through the op gives the plain vox gradient, which equals
    autograd of the plain resample bit for bit."""
    vox, pts, g = trilinear_inputs(b=3, n=200, c=8)
    v = vox.clone().requires_grad_(True)
    out = kt.trilinear_resample(v, pts)
    (dv,) = torch.autograd.grad(out, v, g)
    v2 = vox.clone().requires_grad_(True)
    (dv2,) = torch.autograd.grad(grid_sample.trilinear_resample(v2, pts),
                                 v2, g)
    assert torch.equal(out, grid_sample.trilinear_resample(vox, pts))
    assert torch.equal(dv, dv2)
    assert torch.equal(dv, grid_sample.trilinear_resample_vox_grad(
        pts, g, vox.shape))


def test_trunk_op_matches_plain_forward_and_backward():
    args, dy, w0s = trunk_inputs(b=2, m=33, cin=5)
    leaves = [a.clone().requires_grad_(True) for a in args]
    y = st.siren_trunk(*leaves, w0s)
    grads = torch.autograd.grad(y, leaves, dy)
    assert torch.equal(y, plain_trunk.trunk_forward(*args, w0s))
    for got, want in zip(grads, plain_trunk.trunk_backward(*args, dy, w0s)):
        assert torch.equal(got, want)


class _TwoCalls(torch.nn.Module):
    """Two resamples and one trunk call per forward."""

    def __init__(self):
        super().__init__()
        args, _, self.w0s = trunk_inputs(b=1)
        self.w = torch.nn.ParameterList(args[1:4])

    def forward(self, vox, pts, x, gammas, betas):
        a = kt.trilinear_resample(vox, pts)
        b = kt.trilinear_resample(vox * 2, pts)
        h = st.siren_trunk(x, *self.w, gammas, betas, self.w0s)
        return a + b, h


@pytest.mark.parametrize("dynamic", [False, True])
def test_export_records_one_node_per_kernel_call(dynamic):
    from lightning_gan_zoo_tpu_torch.serving.export import kernel_nodes
    vox, pts, _ = trilinear_inputs(b=3)
    args, _, _ = trunk_inputs(b=3)
    inputs = (vox, pts, args[0], args[4], args[5])
    shapes = None
    if dynamic:
        batch = torch.export.Dim("batch", min=1, max=64)
        shapes = tuple({0: batch} for _ in inputs)
    module = _TwoCalls()
    with torch.no_grad():
        program = torch.export.export(module, inputs, dynamic_shapes=shapes)
    assert kernel_nodes(program) == {"lgzt.trilinear_fwd.default": 2,
                                     "lgzt.siren_trunk_fwd.default": 1}
    got = program.module()(*inputs)
    want = module(*inputs)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
