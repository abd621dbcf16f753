"""The radiance field's rgb/α head as one op (ops/siren_head.py, the plain
version; ops/cuda/siren_head.py, the custom ops whose CPU implementation it
is) on the CPU: the plain forward equal bit for bit to the layers' eager
chain (``to_rgb_siren`` → ``to_rgb`` → sigmoid, ``to_alpha`` → sigmoid)
under the bf16 policy and under float32; the hand-written backward equal to
autograd at float32 and within a stated bound of it under bf16;
``torch.library.opcheck`` and an export under a symbolic batch; the fields'
dispatch rule; and the kernels' names, which the benchmark's breakdown must
class as no kind of its own."""
import pytest
import torch

from lightning_gan_zoo_tpu_torch.nerf import siren
from lightning_gan_zoo_tpu_torch.ops import siren_head as ph
from lightning_gan_zoo_tpu_torch.ops.cuda import siren_head as sh

torch.set_num_threads(2)

BF16, F32 = torch.bfloat16, torch.float32
GROUPS = ("x", "dirs", "w", "b", "gamma", "beta", "w_rgb", "b_rgb",
          "w_alpha", "b_alpha")


def layers(h=32, seed=0):
    """The field's head layers, initialised as the field does."""
    g = torch.Generator().manual_seed(seed)
    sine = siren.Siren(h + 3, h, bf16=True, generator=g)
    to_rgb, to_alpha = siren.dense(h, 3, g), siren.dense(h, 1, g)
    with torch.no_grad():   # dense() zeroes the biases
        to_rgb.bias.normal_(0.0, 0.1, generator=g)
        to_alpha.bias.normal_(0.0, 0.1, generator=g)
    return sine, to_rgb, to_alpha


def inputs(b=2, rays=8, p=8, h=32, dtype=BF16, seed=1):
    """Trunk-like features, unit directions per ray, FiLM near 1 and 0."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand(b, rays * p, h, generator=g) * 2 - 1).to(dtype)
    dirs = torch.nn.functional.normalize(torch.randn(b, rays, 3, generator=g),
                                         dim=-1)
    gamma = 1 + 0.3 * torch.randn(b, h, generator=g)
    beta = 0.3 * torch.randn(b, h, generator=g)
    return x, dirs, gamma, beta


def head_args(sine, to_rgb, to_alpha, x, dirs, gamma, beta, alpha=True):
    return (x, dirs, sine.kernel, sine.bias, gamma, beta, to_rgb.weight,
            to_rgb.bias, to_alpha.weight if alpha else None,
            to_alpha.bias if alpha else None, sine.w0)


def eager_chain(sine, to_rgb, to_alpha, x, dirs, gamma, beta, bf16):
    """What SirenRadianceField's layer path computes on the trunk's
    features, under the task's autocast."""
    b, m, _ = x.shape
    rows = dirs[:, :, None, :].expand(b, dirs.shape[1], m // dirs.shape[1],
                                      3).reshape(b, m, 3)
    with torch.autocast("cpu", dtype=BF16, enabled=bf16):
        alpha = torch.sigmoid(to_alpha(x))
        h = sine(torch.cat([x, rows.to(x.dtype)], dim=-1), gamma, beta)
        return torch.sigmoid(to_rgb(h)), alpha


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("alpha", [True, False])
def test_plain_forward_is_the_eager_chain_bit_for_bit(bf16, alpha):
    sine, to_rgb, to_alpha = layers()
    sine.bf16 = bf16
    x, dirs, gamma, beta = inputs(dtype=BF16 if bf16 else F32)
    rgb, a = ph.head_forward(*head_args(sine, to_rgb, to_alpha, x, dirs,
                                        gamma, beta, alpha),
                             dtype=BF16 if bf16 else F32)
    want_rgb, want_a = eager_chain(sine, to_rgb, to_alpha, x, dirs, gamma,
                                   beta, bf16)
    assert rgb.dtype == want_rgb.dtype == (BF16 if bf16 else F32)
    assert torch.equal(rgb, want_rgb)
    if alpha:
        assert torch.equal(a, want_a)
    else:
        assert a is None


def _autograd_and_plain(dtype, alpha=True, seed=2):
    sine, to_rgb, to_alpha = layers()
    x, dirs, gamma, beta = inputs(dtype=dtype)
    args = head_args(sine, to_rgb, to_alpha, x, dirs, gamma, beta, alpha)
    leaves = [a.detach().clone().requires_grad_(True)
              if isinstance(a, torch.Tensor) else a for a in args]
    rgb, a = ph.head_forward(*leaves, dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    g_rgb = torch.randn(rgb.shape, generator=g).to(rgb.dtype)
    g_a = torch.randn(x.shape[:2] + (1,), generator=g).to(rgb.dtype)
    outs, cots = ([rgb, a], [g_rgb, g_a]) if alpha else ([rgb], [g_rgb])
    tensors = [t for t in leaves[:10] if t is not None]
    want = dict(zip([n for n, t in zip(GROUPS, leaves) if t is not None],
                    torch.autograd.grad(outs, tensors, cots)))
    got = ph.head_backward(x, dirs, args[2], args[3], gamma, beta, args[6],
                           args[8], rgb.detach(),
                           None if a is None else a.detach(), g_rgb,
                           g_a if alpha else None, args[10], dtype=dtype)
    got = dict(zip(("x", "dirs", "w", "b", "gamma", "beta", "w_rgb",
                    "b_rgb", "w_alpha", "b_alpha"), got))
    return got, want


@pytest.mark.parametrize("alpha", [True, False])
def test_plain_backward_is_autograd_at_float32(alpha):
    got, want = _autograd_and_plain(F32, alpha)
    assert set(want) == {n for n, t in got.items() if t is not None}
    for name, w in want.items():
        scale = float(w.abs().max())
        torch.testing.assert_close(got[name], w, rtol=1e-5,
                                   atol=1e-5 * scale, msg=name)


#: Under bf16 autograd differentiates the rounded chain (bf16 FiLM and bf16
#: cotangents through every bf16 op), the hand-written backward the trunk
#: backward's way (float32 FiLM and derivative); each group agrees within
#: this share of its largest value (measured: at most 0.0077, on the
#: directions; 0.0044 on the features).
BF16_BWD_RTOL = 0.02


def test_plain_backward_is_near_autograd_under_bf16():
    got, want = _autograd_and_plain(BF16)
    for name, w in want.items():
        w = w.detach().float()
        err = float((got[name].float() - w).abs().max())
        assert err <= BF16_BWD_RTOL * float(w.abs().max()), name


def _op_args(alpha=True, b=2):
    sine, to_rgb, to_alpha = layers(h=16)
    x, dirs, gamma, beta = inputs(b=b, rays=4, p=16, h=16)
    return head_args(sine, to_rgb, to_alpha, x, dirs, gamma, beta, alpha)


@pytest.mark.parametrize("alpha", [True, False])
def test_opcheck_siren_head_fwd(alpha):
    args = [a.detach().clone().requires_grad_(a.is_floating_point()
                                              and i != 1)
            if isinstance(a, torch.Tensor) else a
            for i, a in enumerate(_op_args(alpha))]
    torch.library.opcheck(sh.siren_head_fwd, (*args, None))


@pytest.mark.parametrize("alpha", [True, False])
def test_opcheck_siren_head_bwd(alpha):
    (x, dirs, w, b, gamma, beta, w_rgb, b_rgb, w_a, b_a, w0) = [
        a.detach() if isinstance(a, torch.Tensor) else a
        for a in _op_args(alpha)]
    rgb, a = sh.siren_head_fwd(x, dirs, w, b, gamma, beta, w_rgb, b_rgb, w_a,
                               b_a, w0, None)
    g = torch.Generator().manual_seed(3)
    g_rgb = torch.randn(rgb.shape, generator=g).to(BF16)
    g_a = torch.randn(a.shape, generator=g).to(BF16)
    for need_ddirs in (True, False):
        torch.library.opcheck(sh.siren_head_bwd,
                              (x, dirs, w, b, gamma, beta, w_rgb, w_a, rgb, a,
                               g_rgb, g_a, w0, need_ddirs, None))


def test_op_autograd_is_the_plain_backward():
    args = _op_args()
    leaves = [a.detach().clone().requires_grad_(True)
              if isinstance(a, torch.Tensor) else a for a in args]
    rgb, a = sh.siren_head(*leaves)
    g = torch.Generator().manual_seed(4)
    g_rgb = torch.randn(rgb.shape, generator=g).to(BF16)
    g_a = torch.randn(a.shape, generator=g).to(BF16)
    grads = torch.autograd.grad([rgb, a], leaves[:10], [g_rgb, g_a])
    want_rgb, want_a = ph.head_forward(*args)
    assert torch.equal(rgb, want_rgb) and torch.equal(a, want_a)
    want = ph.head_backward(*args[:7], args[8], want_rgb, want_a, g_rgb, g_a,
                            args[10])
    for name, got, w in zip(GROUPS, grads, want):
        assert torch.equal(got, w), name


class _Head(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.sine, self.to_rgb, self.to_alpha = layers(h=16)

    def forward(self, x, dirs, gamma, beta):
        return sh.siren_head(*head_args(self.sine, self.to_rgb,
                                        self.to_alpha, x, dirs, gamma, beta))


def test_fake_gives_the_shapes_under_a_symbolic_batch():
    """An export with a symbolic batch records one head node whose outputs
    carry the batch symbol, and the program computes what the module does
    at another batch."""
    from lightning_gan_zoo_tpu_torch.serving.export import kernel_nodes
    module = _Head()
    batch = torch.export.Dim("batch", min=1, max=64)
    ins = inputs(b=3, rays=4, p=16, h=16)
    with torch.no_grad():
        program = torch.export.export(module, ins, dynamic_shapes=tuple(
            {0: batch} for _ in ins))
    assert kernel_nodes(program) == {"lgzt.siren_head_fwd.default": 1}
    node = next(n for n in program.graph.nodes
                if str(n.target) == "lgzt.siren_head_fwd.default")
    rgb_shape, alpha_shape = (t.shape for t in node.meta["val"])
    assert str(rgb_shape[0]) == str(alpha_shape[0]) == "s0" or \
        not isinstance(rgb_shape[0], int)
    assert tuple(rgb_shape[1:]) == (64, 3) and tuple(alpha_shape[1:]) == (
        64, 1)
    other = inputs(b=5, rays=4, p=16, h=16, seed=6)
    got = program.module()(*other)
    with torch.no_grad():
        want = module(*other)
    assert got[0].shape == (5, 64, 3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _record_heads(monkeypatch):
    calls = []
    real = siren.cuda_head.siren_head

    def record(*args, **kwargs):
        calls.append(args[8] is not None)
        return real(*args, **kwargs)
    monkeypatch.setattr(siren.cuda_head, "siren_head", record)
    return calls


def _radiance(field, b=2, n=4, p=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    pts = torch.randn(b, n, p, 3, generator=g) * 0.3
    dirs = torch.randn(b, n, 3, generator=g)
    z = torch.randn(b, 8, generator=g)
    with torch.no_grad(), torch.autocast("cpu", dtype=BF16,
                                         enabled=field.siren.bf16):
        return field(pts, dirs, z)


@pytest.mark.parametrize("case,h,bf16,p,fused,takes", [
    ("bf16 pi-GAN", 128, True, 16, True, True),
    ("f32 policy", 128, False, 16, True, False),
    ("width 192", 192, True, 16, True, False),
    ("rows not whole tiles", 128, True, 5, True, True),
    ("layer-loop twin", 128, True, 16, False, False)])
def test_dispatch_rule_of_the_pigan_field(monkeypatch, case, h, bf16, p,
                                          fused, takes):
    field = siren.SirenRadianceField(8, 2, h, bf16=bf16)
    field.siren.fused = fused
    calls = _record_heads(monkeypatch)
    alpha, rgb = _radiance(field, p=p)
    assert calls == ([True] if takes else []), case
    assert alpha.shape == (2, 4, p, 1) and rgb.shape == (2, 4, p, 3)


def test_dispatch_rule_of_the_anigan_field(monkeypatch):
    """ANIGAN's α comes from its own trunk: the op runs without α."""
    field = siren.SirenSingleShape(8, 2, 128, bf16=True)
    calls = _record_heads(monkeypatch)
    alpha, rgb = _radiance(field)
    assert calls == [False]
    assert alpha.shape == (2, 4, 16, 1) and rgb.shape == (2, 4, 16, 3)


@pytest.mark.parametrize("field_cls", [siren.SirenRadianceField,
                                       siren.SirenSingleShape])
def test_fused_field_equals_its_layer_path(monkeypatch, field_cls):
    """On the CPU the op is the plain version, the layers' chain op for
    op: the field's outputs do not move when the rule sends it to the
    layers (``fused = False``, which sends the trunk to its layer loop, the
    trunk's plain version op for op)."""
    field = field_cls(8, 2, 128, bf16=True)
    torch.manual_seed(7)   # ANIGAN's deformation noise, without inputs
    fused = _radiance(field, seed=5)
    calls = _record_heads(monkeypatch)
    field.siren.fused = False
    torch.manual_seed(7)
    layered = _radiance(field, seed=5)
    assert calls == []
    assert all(torch.equal(a, b) for a, b in zip(fused, layered))


KERNEL_NAMES = (
    "void (anonymous namespace)::siren_head_fwd_kernel<256>(__nv_bfloat16 "
    "const*, float const*, __nv_bfloat16 const*, float const*, float const*,"
    " float const*, float const*, float const*, float const*, float const*, "
    "__nv_bfloat16*, __nv_bfloat16*, int, int, int, float)",
    "void (anonymous namespace)::siren_head_bwd_kernel<256>(__nv_bfloat16 "
    "const*, float const*, __nv_bfloat16 const*, float const*, float const*,"
    " float const*, float const*, float const*, __nv_bfloat16 const*, "
    "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
    "__nv_bfloat16*, float*, __nv_bfloat16*, float*, int, int, int, float)",
    "void (anonymous namespace)::siren_head_bwd_dw_kernel<128>(__nv_bfloat16"
    " const*, __nv_bfloat16 const*, float*, int, int, int)",
    "(anonymous namespace)::siren_head_bwd_dw_sum_kernel(float const*, "
    "float*, int, int)",
    "(anonymous namespace)::siren_head_bwd_sum_kernel(float const*, float*, "
    "float*, float*, float*, float*, float*, float*, float*, int, int, int)",
    "void__anonymous_namespace_::siren_head_fwd_kernel_256__nv_bfloat16_")


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_kernel_names_fall_in_no_class(name):
    from perfbench.trace import kind_of
    assert kind_of(name) == "other"
