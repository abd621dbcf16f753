"""Tests of the port that need a CUDA card: the hand-written kernels have no
CPU mode. Each skips without a card. This file imports no JAX, so it runs on
a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.config.registry import instantiate
from lightning_gan_zoo_tpu_torch.models import hologan
from lightning_gan_zoo_tpu_torch.models.layers import BatchNorm2d
from lightning_gan_zoo_tpu_torch.nerf.siren import SirenNet
from lightning_gan_zoo_tpu_torch.ops import grid_sample
from lightning_gan_zoo_tpu_torch.ops import siren_trunk as pt
from lightning_gan_zoo_tpu_torch.ops.cuda import siren_trunk as st
from lightning_gan_zoo_tpu_torch.ops.cuda import trilinear as kt
from lightning_gan_zoo_tpu_torch.runtime import steps
from lightning_gan_zoo_tpu_torch.runtime.optim import RMSprop
from lightning_gan_zoo_tpu_torch.runtime.state import create_train_state

pytestmark = pytest.mark.cuda

CONF_DIR = Path(__file__).resolve().parents[1] / "conf"

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
    # the forward rounds where the plain version rounds
    assert torch.equal(got, ref)
    assert torch.equal(got, kt.launch_forward(vox, pts))
    g = torch.randn(got.shape, generator=gen, device="cuda")
    dv = kt.launch_backward(pts, g, vox.shape)
    dref = grid_sample.trilinear_resample_vox_grad(pts, g, vox.shape)
    # the plain version sums each voxel's terms in another order
    assert float((dv - dref).abs().max()) <= 1e-4 * float(dref.abs().max())
    # no atomics: the same bits every call, those of the kernel's order
    assert torch.equal(dv, kt.launch_backward(pts, g, vox.shape))
    assert torch.equal(dv, kt.ordered_vox_grad(pts, g, vox.shape))


@pytest.mark.parametrize("c", [1, 4, 5, 8, 64])
def test_forward_equals_plain_bit_for_bit(gen, c):
    """The float4 path (C % 4 == 0) and the scalar path (C = 1, 5), on a
    ragged point count with points outside the volume: equal to the plain
    version and across calls."""
    vox = torch.randn(3, 6, 7, 8, c, generator=gen, device="cuda")
    size = torch.tensor([8, 7, 6], device="cuda", dtype=torch.float32)
    pts = (torch.rand(3, 777, 3, generator=gen, device="cuda") * (size + 6)
           - 3).contiguous()
    got = kt.launch_forward(vox, pts)
    assert torch.equal(got, grid_sample.trilinear_resample(vox, pts))
    assert torch.equal(got, kt.launch_forward(vox, pts))


@pytest.mark.parametrize("c", [8, 3])
def test_backward_long_bins_over_point_groups(gen, c):
    """3,000 points inside one voxel cell and 600 clamped to a corner: bins
    of thousands of entries, each made of 4 point groups of the map's
    counting sort: still the ordered sum, bit for bit."""
    vox_shape = (2, 4, 5, 6, c)
    near = torch.rand(2, 3000, 3, generator=gen, device="cuda") + 1.0
    far = -3.0 - torch.rand(2, 600, 3, generator=gen, device="cuda")
    pts = torch.cat([near, far], 1).contiguous()
    g = torch.randn(2, 3600, c, generator=gen, device="cuda")
    dv = kt.launch_backward(pts, g, vox_shape)
    dref = grid_sample.trilinear_resample_vox_grad(pts, g, vox_shape)
    assert float((dv - dref).abs().max()) <= 1e-4 * float(dref.abs().max())
    assert torch.equal(dv, kt.ordered_vox_grad(pts, g, vox_shape))


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


def _trunk_inputs(gen, b, m, h, layers, n_film, unfilmed=False, cin=3):
    """SIREN-init weights, x ~ N(0, 0.25) with ``cin`` channels, γ ~ 1 +
    N(0, 0.01), β ~ N(0, 0.01) (or γ = 1, β = 0 when ``unfilmed``), and a
    bf16 cotangent."""
    d = dict(device="cuda")
    bound = (6 / h) ** 0.5
    x = torch.randn(b, m, cin, generator=gen, **d) * 0.5
    w0k = (torch.rand(cin, h, generator=gen, **d) * 2 - 1) / cin
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
    (3, 560, 256, 7, 6, False),
    # the forward's tiles and blocks: M one tile, two tiles and a row, one
    # block of ROWS_PER_BLOCK and one row past it
    (1, 64, 128, 3, 2, False), (2, 129, 256, 7, 6, False),
    (1, 256, 64, 4, 2, True), (2, 257, 256, 7, 6, False)])
def test_trunk_kernels_match_plain(gen, b, m, h, layers, n_film, unfilmed):
    """Forward within 2⁻⁸ absolute and every gradient group within 0.01 of
    its max |ref| (the JAX tests allow 0.04 and 0.03; these kernels round
    where the plain version rounds), and both directions bit-identical from
    run to run (no atomics)."""
    args, dy = _trunk_inputs(gen, b, m, h, layers, n_film, unfilmed)
    w0s = (30.0,) + (1.0,) * (layers - 1)
    y = st.launch_forward(*args, w0s)
    err = (y.float() - pt.trunk_forward(*args, w0s).float()).abs().max()
    assert float(err) <= 2.0 ** -8
    assert torch.equal(y, st.launch_forward(*args, w0s))
    got = st.launch_backward(*args, dy, w0s)
    want = pt.trunk_backward(*args, dy, w0s)
    for g_, w in zip(got, want):
        assert float((g_ - w).abs().max()) <= 0.01 * float(w.abs().max())
    again = st.launch_backward(*args, dy, w0s)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("b,m,rays,h,alpha", [
    # whole tiles; a partial last tile; a sample shorter than one tile;
    # blocks of several tiles whose last is partial, without α; width 128
    (2, 4096, 128, 256, True), (3, 999, 111, 256, True),
    (2, 40, 8, 256, True), (128, 999, 333, 256, False),
    (3, 65, 13, 128, False)])
def test_head_kernels_match_plain(gen, b, m, rays, h, alpha):
    """The rgb/α head: forward within 2⁻⁷ absolute (a linear's output can
    round to the neighbouring bf16 value), every gradient group within 0.01
    of its max |ref|, and both directions bit-identical from run to run."""
    from lightning_gan_zoo_tpu_torch.ops import siren_head as ph
    from lightning_gan_zoo_tpu_torch.ops.cuda import siren_head as sh
    from lightning_gan_zoo_tpu_torch.utils import kernel_bench as kb
    args, cot = kb.head_inputs(gen, b, m, rays, h, alpha)
    outs = sh.launch_forward(*args)
    for g_, w in zip(outs, [t for t in ph.head_forward(*args)
                            if t is not None]):
        assert float((g_.float() - w.float()).abs().max()) <= 2.0 ** -7
    assert all(map(torch.equal, outs, sh.launch_forward(*args)))
    bargs = kb.head_backward_args(args, outs, cot)
    got = sh.launch_backward(*bargs)
    for g_, w in zip(got, ph.head_backward(*bargs)):
        if w is not None:
            assert float((g_.float() - w.float()).abs().max()) <= \
                0.01 * float(w.float().abs().max())
    assert all(map(torch.equal, got, sh.launch_backward(*bargs)))


@pytest.mark.parametrize("cin,b,m,h,layers,n_film,unfilmed", [
    (1, 2, 300, 256, 7, 6, False), (3, 2, 129, 128, 4, 3, False),
    (5, 1, 257, 256, 7, 6, False), (45, 2, 1000, 256, 7, 6, False),
    (45, 2, 999, 256, 7, 1, True), (64, 3, 65, 64, 3, 2, False)])
def test_trunk_kernels_take_every_input_width(gen, cin, b, m, h, layers,
                                              n_film, unfilmed):
    """Input widths 1 to 64 (45: ANIGAN's displacement deformer, its rgb
    trunk filmed and its alpha trunk not): forward within 2⁻⁸, each gradient
    group within 0.01 of its max|ref|, both directions bit-identical across
    two calls."""
    args, dy = _trunk_inputs(gen, b, m, h, layers, n_film, unfilmed, cin)
    w0s = (30.0,) + (1.0,) * (layers - 1)
    y = st.launch_forward(*args, w0s)
    err = (y.float() - pt.trunk_forward(*args, w0s).float()).abs().max()
    assert float(err) <= 2.0 ** -8
    assert torch.equal(y, st.launch_forward(*args, w0s))
    got = st.launch_backward(*args, dy, w0s)
    want = pt.trunk_backward(*args, dy, w0s)
    assert got[0].shape == (b, m, cin) and got[1].shape == (cin, h)
    for g_, w in zip(got, want):
        assert float((g_ - w).abs().max()) <= 0.01 * float(w.abs().max())
    again = st.launch_backward(*args, dy, w0s)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


def test_trunk_kernel_refuses_more_than_64_input_channels(gen):
    args, _ = _trunk_inputs(gen, 1, 64, 64, 2, 1, cin=65)
    with pytest.raises(ValueError, match="input channels"):
        st.launch_forward(*args, (30.0, 1.0))


def test_hologan_generator_gradients_replay_bit_for_bit(gen):
    """A small HoloGAN generator's forward and backward through the
    trilinear kernels, twice from the same weights and inputs, with cuDNN
    held to its deterministic algorithms (inside this test only): every
    parameter gradient bit-identical."""
    g = hologan.Generator(8, 3, 16, VIEW_ARGS, 64).cuda()
    z = torch.rand(4, 16, generator=gen, device="cuda") * 2 - 1
    views = hologan.sample_view(gen, 4, VIEW_ARGS)
    w = torch.randn(4, 3, 64, 64, generator=gen, device="cuda")
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        grads = []
        for _ in range(2):
            g.zero_grad(set_to_none=True)
            bwd = kt.BWD_LAUNCHES
            (g(z, views) * w).sum().backward()
            assert kt.BWD_LAUNCHES - bwd == 1
            grads.append([p.grad.clone() for p in g.parameters()])
    finally:
        torch.backends.cudnn.deterministic = was
    assert all(torch.equal(a, b) for a, b in zip(*grads))


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
    """The trunk op on the card raises at a width its kernels do not take
    (SirenNet itself no longer sends it one: the next test)."""
    h, layers = 96, 2
    x = torch.randn(1, 10, 3, generator=gen, device="cuda")
    args = [torch.zeros(*s, device="cuda") for s in
            ((3, h), (layers, h, h), (layers + 1, h))]
    g = torch.ones(1, 1, h, device="cuda")
    with pytest.raises(ValueError, match="dim_hidden"):
        st.siren_trunk(x, *args, g, torch.zeros_like(g),
                       (30.0,) + (1.0,) * layers)


@pytest.mark.parametrize("h", [96, 48])
def test_sirennet_off_a_multiple_of_128_runs_the_layer_loop(gen, h):
    """As the JAX SirenNet, a bf16 SirenNet whose width is not a multiple
    of 128 runs the layer loop on the card: no trunk launch, finite bf16
    output and float32 gradients."""
    net = SirenNet(3, h, h, 2, bf16=True).cuda()
    x = torch.randn(2, 10, 3, generator=gen, device="cuda")
    g = torch.randn(2, 2, h, generator=gen, device="cuda") * 0.1 + 1
    fwd, bwd = st.FWD_LAUNCHES, st.BWD_LAUNCHES
    y = net(x, g, g - 1)
    y.float().square().sum().backward()
    assert (st.FWD_LAUNCHES - fwd, st.BWD_LAUNCHES - bwd) == (0, 0)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 10, h)
    assert bool(torch.isfinite(y.float()).all())
    assert all(bool(torch.isfinite(p.grad).all()) for p in net.parameters())


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


def test_inception_on_the_card_matches_the_cpu(gen):
    """The FID Inception's pool3 on the card in f32 (TF32 off for cuDNN's
    convolutions, as the Trainer sets it) within 1e-3 of max|ref| of the
    same network on the CPU."""
    import copy
    from lightning_gan_zoo_tpu_torch.eval import inception
    model = inception.init_random()
    x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    ref = model(x)
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = copy.deepcopy(model).cuda()(x.cuda()).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = was
    assert float((got - ref).abs().max()) <= 1e-3 * float(ref.abs().max())


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


#: π-GAN at small widths under bf16: D's casts go through autocast's cache
D_SIDE_PIGAN = ["+expt=pigan", "machine=local", "dataset=synthetic",
                "calc_fid=False", "~figures", "save_ckpts=False",
                "model.noise_dim=16", "nerf.siren_dim_hidden=32",
                "nerf.siren_num_layers=2", "nerf.n_pts_per_ray=4",
                "nerf.n_pts_per_ray_fine=4", "train.features_disc=8",
                "train.img_size=32",
                "resolution_annealing.resolutions=[8,16,32]",
                "variable_batch_size.batch_sizes=[4,2,2]", "precision=16"]


def _d_side_run(tmp_path, monkeypatch, replay, grows, penalty_precision):
    """Four supersteps (D then G, two micro-batches each, Adam between
    them) from the seed's weights: every loss, every gradient the
    optimizers take, G's loss gradient at D's input, the parameters and
    the random streams after, and the graphs captured. With ``grows`` the
    last two supersteps run at 16 px on batches of 2."""
    cfg = compose(CONF_DIR, D_SIDE_PIGAN + [
        f"train.penalty_precision={penalty_precision}"])
    task = instantiate(cfg.model.lm, cfg, str(tmp_path), device="cuda")
    if not replay:
        task.d_side.replayable = lambda: False
    state = create_train_state(task, steps_per_epoch=4)
    grads, through = [], []
    step = steps.optimizer_step

    def recorded_step(opt, sched, count):
        grads.append([p.grad.clone() for group in opt.param_groups
                      for p in group["params"]])
        step(opt, sched, count)

    divergence = task._g_divergence

    def recorded_divergence(fake, extra):
        fake.register_hook(lambda g: through.append(g.clone()))
        return divergence(fake, extra)

    task._g_divergence = recorded_divergence
    images = torch.rand(4, 4, 3, 32, 32,
                        generator=torch.Generator().manual_seed(3)) * 2 - 1
    losses = []
    with monkeypatch.context() as patch:
        patch.setattr(steps, "optimizer_step", recorded_step)
        for k in range(4):
            batch = images.cuda()
            if grows and k >= 2:
                if k == 2:
                    task.increase_resolution(16)
                    state.extra = task.reset_alpha(state.extra)
                batch = batch[:, :2]
            metrics = steps.superstep(task, state, {"image": batch}, 1, 1, 2)
            losses.append({k: v.clone() for k, v in metrics.items()})
    torch.cuda.synchronize()
    params = [p.detach().clone() for net in (task.generator,
                                             task.discriminator)
              for p in net.parameters()]
    return {"losses": losses, "grads": grads, "through": through,
            "params": params,
            "streams": [g.get_state() for g in task.generators().values()]
            + [torch.cuda.get_rng_state()],
            "graphs": len(task.d_side.graphs)}


@pytest.mark.parametrize("grows,penalty_precision", [(False, 32),
                                                     (True, 16)])
def test_pigan_d_side_replay_equals_eager_bit_for_bit(
        gen, tmp_path, monkeypatch, grows, penalty_precision):
    """π-GAN's discriminator side replayed from CUDA graphs against the
    eager calls, under deterministic algorithms: every loss, every D and
    G gradient at the optimizers, G's loss gradient at D's input, the
    parameters and every random stream bit-identical over four supersteps
    of two micro-batches. The weights move between replays, so a stale
    bf16 cast would show, and the micro-batches' metrics and gradients
    add up, so an output or gradient left in a graph's buffer would. A new
    resolution and batch capture a new pair of graphs."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = [_d_side_run(tmp_path, monkeypatch, replay, grows,
                            penalty_precision) for replay in (False, True)]
    finally:
        torch.use_deterministic_algorithms(False)
    eager, replayed = runs
    assert eager["graphs"] == 0
    assert replayed["graphs"] == (4 if grows else 2)
    for a, b in zip(eager["losses"], replayed["losses"]):
        assert a.keys() == b.keys() == {"d_loss", "r1", "g_loss"}
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert len(eager["grads"]) == len(replayed["grads"]) == 8
    for a, b in zip(eager["grads"], replayed["grads"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert len(eager["through"]) == len(replayed["through"]) == 8
    for key in ("through", "params", "streams"):
        assert all(torch.equal(x, y)
                   for x, y in zip(eager[key], replayed[key])), key
