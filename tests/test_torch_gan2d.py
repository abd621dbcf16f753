"""The port's 2D families (dc_gan, wgan, wgan_gp, gan_stability_r1) against
the JAX package's, on the CPU in float32 at small widths (features 4, 16–32
px, batch 4). Weights come from numpy through convert.py; inputs, z and the
WGAN-GP α are made from seeds and handed to both sides.

Tolerances:
  * modules (outputs, BatchNorm running statistics): atol 1e-5;
  * losses, penalties and their gradients with respect to D's parameters:
    rtol 1e-4 (gradients: atol 1e-4 of their largest magnitude);
  * RMSprop against optax.rmsprop over six steps: rtol 1e-5 on the change
    of the parameters, atol one float32 step of the parameters; the LR
    schedules: exact up to float rounding;
  * one superstep per family against the JAX package's jitted
    ``build_superstep``: losses at rtol 1e-4, BatchNorm running statistics
    at rtol 1e-4; parameters after the update at atol n_updates × the
    optimizer's largest single step (2·lr for Adam, lr/√(1−α) = 10·lr for
    RMSprop), and the updates themselves within 1e-6 on at least 99 % of
    the elements. At ``train.penalty_precision=16`` the R1 penalty runs in
    bf16 in both frameworks, whose convolutions round differently (the
    losses then differ by ~3e-4 relative), so that case holds its losses at
    rtol 5e-3, its parameters at twice the largest step (a near-zero
    gradient whose sign the rounding flips moves a step from +10·lr to
    −10·lr), and the median element's update within 5 % of the largest
    step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from tests.conftest import CONF_DIR
from lightning_gan_zoo_tpu.config import compose as jax_compose
from lightning_gan_zoo_tpu.config.registry import instantiate as jax_inst
from lightning_gan_zoo_tpu.ops import losses as JL
from lightning_gan_zoo_tpu.runtime.loop import Trainer as JaxTrainer
from lightning_gan_zoo_tpu.runtime.optim import build_lr_schedule
from lightning_gan_zoo_tpu.runtime.state import create_train_state as jax_state
from lightning_gan_zoo_tpu.runtime.steps import build_superstep
from lightning_gan_zoo_tpu.tasks.base import apply_model
from lightning_gan_zoo_tpu_torch import convert
from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.config.registry import instantiate
from lightning_gan_zoo_tpu_torch.models.layers import BatchNorm2d
from lightning_gan_zoo_tpu_torch.ops import losses as L
from lightning_gan_zoo_tpu_torch.runtime import loop
from lightning_gan_zoo_tpu_torch.runtime.optim import RMSprop, step_lr
from lightning_gan_zoo_tpu_torch.runtime.state import create_train_state
from lightning_gan_zoo_tpu_torch.runtime.steps import superstep

#: the suite runs several files at once (pytest-xdist workers) on a few
#: cores: two torch threads per worker keep them off each other's cores
torch.set_num_threads(2)

B = 4
SMALL = ["dataset=synthetic", "precision=32", "calc_fid=False", "~figures",
         "train.batch_size=4", "train.features_disc=4",
         "train.features_gen=4", "model.noise_dim=8", "train.img_size=32"]
RESNET = ["train.img_size=16", "generator.nfilter=4",
          "generator.nfilter_max=8", "discriminator.nfilter=4",
          "discriminator.nfilter_max=8"]
CONVERT = {
    "dc": (convert.dcgan_generator_state_dict,
           convert.dcgan_discriminator_state_dict),
    "resnet": (convert.resnet_generator_state_dict,
               convert.resnet_discriminator_state_dict)}


def _args(expt, extra=()):
    return [f"+expt={expt}", *SMALL,
            *(RESNET if expt == "gan_stability_r1" else ()), *extra]


def _fill(shapes, seed):
    """Kernels N(0, 1/fan_in), biases and BatchNorm means N(0, 0.1²),
    scales 1 + N(0, 0.1²), variances 1 + |N(0, 0.1²)|, from numpy."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        n = rng.normal(size=leaf.shape)
        if name.endswith("['scale']"):
            v = 1 + 0.1 * n
        elif name.endswith("['var']"):
            v = 1 + 0.1 * np.abs(n)
        elif name.endswith("['mean']") or name.endswith("['bias']"):
            v = 0.1 * n
        else:
            v = n / np.sqrt(np.prod(leaf.shape[:-1]))
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def make_pair(expt, tmp, extra=(), seed=0):
    """(JAX task, port task, g_vars, d_vars): both tasks on the same
    weights."""
    jcfg = jax_compose(CONF_DIR, _args(expt, extra))
    jtask = jax_inst(jcfg.model.lm, jcfg, str(tmp))
    g_vars, d_vars = (dict(v) for v in _fill(
        jax.eval_shape(jtask.init, jax.random.PRNGKey(0)), seed))
    cfg = compose(CONF_DIR, _args(expt, extra))
    task = instantiate(cfg.model.lm, cfg, str(tmp), device="cpu")
    to_g, to_d = CONVERT["resnet" if expt == "gan_stability_r1" else "dc"]
    task.generator.load_state_dict(to_g(g_vars))
    task.discriminator.load_state_dict(to_d(d_vars))
    return jtask, task, g_vars, d_vars


def _state(variables):
    return {k: v for k, v in variables.items() if k != "params"}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(x), -1, 1)))


def _images(shape, seed=3):
    return (np.random.default_rng(seed).normal(size=shape) * 0.5
            ).astype(np.float32)


def _check_stats(module, to_sd, variables, new_state):
    """The port's running statistics against the JAX batch_stats."""
    want = to_sd({**variables, **new_state})
    for k, v in module.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                       err_msg=k)


# -------------------------------------------------------------- modules
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("expt", ["dc_gan", "gan_stability_r1"])
def test_generator_matches_jax(expt, train, tmp_path):
    jtask, task, g_vars, _ = make_pair(expt, tmp_path)
    z = np.random.default_rng(1).normal(size=(B, 8)).astype(np.float32)
    want, new_state = apply_model(jtask.generator, g_vars["params"],
                                  _state(g_vars), z, train=train)
    task.generator.train(train)
    with torch.no_grad():
        got = task.generator(torch.from_numpy(z))
    assert got.shape == (B, 3, task.cfg.train.img_size,
                         task.cfg.train.img_size)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5)
    _check_stats(task.generator, convert.dcgan_generator_state_dict
                 if expt == "dc_gan" else convert.resnet_generator_state_dict,
                 g_vars, new_state)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("expt", ["dc_gan", "wgan_gp", "gan_stability_r1"])
def test_discriminator_matches_jax(expt, train, tmp_path):
    """dc_gan's D has BatchNorm, wgan_gp's InstanceNorm, R1's is the
    ResNet (its NHWC flatten pinned by the Dense rows)."""
    jtask, task, _, d_vars = make_pair(expt, tmp_path)
    s = int(task.cfg.train.img_size)
    x = _images((B, s, s, 3))
    want, new_state = apply_model(jtask.discriminator, d_vars["params"],
                                  _state(d_vars), x, train=train)
    task.discriminator.train(train)
    with torch.no_grad():
        got = task.discriminator(_nchw(x))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    if expt != "gan_stability_r1":
        _check_stats(task.discriminator,
                     convert.dcgan_discriminator_state_dict, d_vars,
                     new_state)


def test_resnet_generator_reads_its_dense_output_nhwc(tmp_path):
    """Reading G's Dense output as NCHW (the torch habit) would give another
    image: the module's NHWC reshape is what makes the weights carry
    across unpermuted."""
    jtask, task, g_vars, _ = make_pair("gan_stability_r1", tmp_path)
    g = task.generator
    z = torch.from_numpy(np.random.default_rng(1).normal(
        size=(B, 8)).astype(np.float32))
    with torch.no_grad():
        nhwc = g.fc(z).reshape(B, 4, 4, g.nf0).permute(0, 3, 1, 2)
        nchw = g.fc(z).reshape(B, g.nf0, 4, 4)
    assert float((nhwc - nchw).abs().max()) > 1e-2


def test_batch_norm_running_stats_after_two_calls(tmp_path):
    """Two train-mode calls of G move its BatchNorm buffers as flax's
    batch_stats move, and eval mode then uses them."""
    jtask, task, g_vars, _ = make_pair("dc_gan", tmp_path)
    state = _state(g_vars)
    for seed in (1, 2):
        z = np.random.default_rng(seed).normal(size=(B, 8)).astype(np.float32)
        _, state = apply_model(jtask.generator, g_vars["params"], state, z)
        with torch.no_grad():
            task.generator(torch.from_numpy(z))
    _check_stats(task.generator, convert.dcgan_generator_state_dict, g_vars,
                 state)
    z = np.random.default_rng(3).normal(size=(B, 8)).astype(np.float32)
    want, _ = apply_model(jtask.generator, g_vars["params"], state, z,
                          train=False)
    got = task.generate(torch.from_numpy(z))
    assert task.generator.training     # generate restores train mode
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5)


def test_batch_norm_updates_with_the_biased_variance():
    """flax updates batch_stats.var with the biased batch variance; torch's
    BatchNorm2d with the unbiased one (0.99260 against 0.99524 here)."""
    x = np.random.default_rng(0).normal(size=(4, 3, 3, 2)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), x)
    _, upd = bn.apply(variables, x, mutable=["batch_stats"])
    want = np.asarray(upd["batch_stats"]["var"])
    ours, theirs = BatchNorm2d(2), torch.nn.BatchNorm2d(2, momentum=0.1)
    xt = _nchw(x)
    ours(xt), theirs(xt)
    np.testing.assert_allclose(ours.running_var.numpy(), want, rtol=1e-6)
    assert np.abs(theirs.running_var.numpy() - want).max() > 1e-3


# ---------------------------------------------------------- losses
def test_wasserstein_losses_match_jax():
    rng = np.random.default_rng(0)
    r, f = rng.normal(size=7).astype(np.float32), rng.normal(size=7).astype(
        np.float32)
    assert float(L.wasserstein_d_loss(torch.from_numpy(r),
                                      torch.from_numpy(f))) == pytest.approx(
        float(JL.wasserstein_d_loss(r, f)), rel=1e-6)
    assert float(L.wasserstein_g_loss(torch.from_numpy(f))) == pytest.approx(
        float(JL.wasserstein_g_loss(f)), rel=1e-6)


def _grads_close(net, to_sd, jgrads):
    want = to_sd({"params": jgrads})
    for name, p in net.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_gradient_penalty_matches_jax(tmp_path):
    """wgan_gp's instance-norm D: the penalty at JAX's α, and its gradient
    with respect to D's parameters (a double backward)."""
    jtask, task, _, d_vars = make_pair("wgan_gp", tmp_path)
    real, fake = _images((B, 32, 32, 3), 1), _images((B, 32, 32, 3), 2)
    key = jax.random.PRNGKey(5)

    def jgp(params):
        return JL.gradient_penalty(
            lambda x: apply_model(jtask.discriminator, params, {}, x)[0],
            real, fake, key)
    want, jgrads = jax.value_and_grad(jgp)(d_vars["params"])
    alpha = np.asarray(jax.random.uniform(key, (B, 1, 1, 1), jnp.float32))
    gp = L.gradient_penalty(task.discriminator, _nchw(real), _nchw(fake),
                            torch.from_numpy(alpha))
    gp.backward()
    assert float(gp) == pytest.approx(float(want), rel=1e-4)
    _grads_close(task.discriminator, convert.dcgan_discriminator_state_dict,
                 jgrads)


def test_r1_penalty_and_logits_matches_jax(tmp_path):
    """The R1 ResNet D: one forward gives the logits and the penalty; the
    gradient of r1 + mean(logits) with respect to D's parameters."""
    jtask, task, _, d_vars = make_pair("gan_stability_r1", tmp_path)
    real = _images((B, 16, 16, 3), 1)

    def jloss(params):
        r1, logits = JL.r1_penalty_and_logits(
            lambda x: apply_model(jtask.discriminator, params, {}, x)[0],
            real)
        return r1 + jnp.mean(logits), (r1, logits)
    (_, (want_r1, want_logits)), jgrads = jax.value_and_grad(
        jloss, has_aux=True)(d_vars["params"])
    r1, logits = L.r1_penalty_and_logits(task.discriminator, _nchw(real))
    (r1 + logits.mean()).backward()
    assert float(r1) == pytest.approx(float(want_r1), rel=1e-4)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), atol=1e-5)
    _grads_close(task.discriminator, convert.resnet_discriminator_state_dict,
                 jgrads)


@pytest.mark.parametrize("precision,dtype", [(32, torch.float32),
                                             (16, torch.bfloat16)])
def test_penalty_scope_precision_and_frozen_stats(precision, dtype, tmp_path):
    """The penalty twin runs D at train.penalty_precision and leaves its
    BatchNorm buffers alone (JAX: mutable=False)."""
    _, task, _, _ = make_pair(
        "dc_gan", tmp_path, [f"+train.penalty_precision={precision}"])
    d = task.discriminator
    before = {k: v.clone() for k, v in d.state_dict().items()}
    x = _nchw(_images((B, 32, 32, 3)))
    with task.autocast(), task.penalty_scope():
        out = d.stem(x)
        gp = L.gradient_penalty(d, x, x.flip(0), torch.full((B, 1, 1, 1),
                                                             0.3))
    assert out.dtype == dtype and torch.isfinite(gp)
    for k, v in d.state_dict().items():
        assert torch.equal(v, before[k]), k
    d(x)                                  # outside the scope they move
    assert not torch.equal(d.state_dict()["blocks.0.norm.running_mean"],
                           before["blocks.0.norm.running_mean"])


# ----------------------------------------------------- optimizers, LR
@pytest.mark.parametrize("momentum", [None, 0.9])
def test_rmsprop_matches_optax(momentum):
    """Gradients near 1e-3, where ε's place shows: optax's ε inside the
    square root gives 7.07·lr on the first step, torch.optim.RMSprop's ε
    outside gives 10·lr. The port follows optax over six steps, and
    torch's rule does not."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(3, 40)).astype(np.float32)
    grads = [(rng.normal(size=p0.shape) * 1e-3).astype(np.float32)
             for _ in range(6)]
    lr = 1e-2
    tx = optax.rmsprop(lr, decay=0.99, eps=1e-8, momentum=momentum)
    jp, opt_state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for g in grads:
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
    want = np.asarray(jp) - p0

    def run(make):
        p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = make([p])
        for g in grads:
            p.grad = torch.from_numpy(g)
            opt.step()
        return p.detach().numpy() - p0
    got = run(lambda ps: RMSprop(ps, lr, momentum=momentum or 0.0))
    # atol: one float32 step of the parameters (|p| < 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-7)
    torch_rule = run(lambda ps: torch.optim.RMSprop(
        ps, lr, alpha=0.99, eps=1e-8, momentum=momentum or 0.0))
    assert np.abs(torch_rule - want).max() > 0.1 * np.abs(want).max()


def test_rmsprop_target_builds_the_optax_rule(tmp_path):
    cfg = compose(CONF_DIR, _args("wgan"))
    opt = instantiate(cfg.disc_optimiser, [torch.nn.Parameter(
        torch.zeros(3))])
    assert type(opt) is RMSprop
    assert opt.defaults == dict(lr=5e-5, alpha=0.99, eps=1e-8, momentum=0.0)


@pytest.mark.parametrize("freq", [1, 5])
@pytest.mark.parametrize("table", [[3, 3, 5, 5, 2, 2], [4, 4, 4, 4]])
def test_step_lr_matches_jax(freq, table):
    """The decaying StepLR over a per-epoch superstep table that changes at
    variable-batch boundaries (and one that does not)."""
    node = jax_compose(CONF_DIR, _args("dc_gan", [
        "lr_scheduler.step_size=2", "lr_scheduler.gamma=0.5"]))
    want = build_lr_schedule(node.optimisation.lr_scheduler,
                             steps_per_epoch=3, total_epochs=len(table),
                             updates_per_superstep=freq,
                             epoch_supersteps=table)
    got = step_lr(2, 0.5, steps_per_epoch=3, updates_per_superstep=freq,
                  epoch_supersteps=table)
    for count in range(sum(table) * freq + 4):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-7), \
            count


@pytest.mark.parametrize("overrides", [
    ["+expt=pigan", "machine=small", "resolution_annealing.update_epochs=[1,2]",
     "train.num_epochs=4", "dataset.n=512", "train.fold_steps=3"],
    ["+expt=wgan", "train.num_epochs=3", "dataset.n=700",
     "+variable_batch_size.batch_sizes=[64,32,16]",
     "+variable_batch_size.update_epochs=[1,2]"],
])
def test_epoch_superstep_table_matches_jax_trainer(overrides, tmp_path):
    """The table the LR schedules read, against the JAX Trainer's."""
    args = ["dataset=synthetic", "~figures", "calc_fid=False",
            f"output_root={tmp_path}", "save_ckpts=False", *overrides,
            "model.noise_dim=16", "train.features_disc=8"]
    if "+expt=pigan" in overrides:
        args.append("nerf.siren_dim_hidden=32")
    jt = JaxTrainer(jax_compose(CONF_DIR, args))
    n, e = int(jt.cfg.dataset.n), int(jt.cfg.train.num_epochs)
    tt = loop.Trainer(compose(CONF_DIR, args), "cpu")
    assert tt._epoch_superstep_table(n, e) == jt._epoch_superstep_table(n, e)


# ------------------------------------------------------------ supersteps
LR = {"dc_gan": (2e-4, 2), "wgan": (5e-5, 10), "wgan_gp": (1e-4, 2),
      "gan_stability_r1": (1e-4, 10)}   # (lr, largest step / lr)


@pytest.mark.parametrize("expt,extra", [
    ("dc_gan", []), ("wgan", []), ("wgan_gp", []),
    ("gan_stability_r1", ["train.penalty_precision=32"]),
    ("gan_stability_r1", ["train.penalty_precision=16"])])
def test_superstep_matches_jax(expt, extra, tmp_path):
    jtask, task, g_vars, d_vars = make_pair(expt, tmp_path, extra)
    cfg = task.cfg
    df, gf = int(cfg.optimisation.disc_freq), int(cfg.optimisation.gen_freq)
    n_micro, s = df + gf, int(cfg.train.img_size)
    d_tx, g_tx = jtask.configure_optimizers(steps_per_epoch=4)
    st0 = jax_state(g_vars, d_vars, g_tx, d_tx)
    images = _images((n_micro, B, s, s, 3))
    rng = jax.random.PRNGKey(7)
    st1, metrics = jax.jit(build_superstep(jtask, g_tx, d_tx, df, gf))(
        st0, {"image": images, "label": np.zeros((n_micro, B), np.int32)},
        rng)
    st1 = jax.device_get(st1)
    # z and the GP α of micro-step i, derived as the JAX superstep does
    keys = [jax.random.split(jax.random.fold_in(rng, i))
            for i in range(n_micro)]
    zs = iter([np.array(jtask.sample_z(k[0], B)) for k in keys])
    alphas = iter([np.array(jax.random.uniform(k[1], (B, 1, 1, 1)))
                   for k in keys])
    task.sample_z = lambda n, generator=None: torch.from_numpy(next(zs))
    task.sample_gp_alpha = lambda n: torch.from_numpy(next(alphas))
    state = create_train_state(task, steps_per_epoch=4)
    got = superstep(task, state, {"image": torch.from_numpy(
        images).permute(0, 1, 4, 2, 3)}, df, gf)

    bf16_penalty = "train.penalty_precision=16" in extra
    rtol = 5e-3 if bf16_penalty else 1e-4
    assert set(got) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                   rtol=rtol, err_msg=k)
    assert (state.step, state.d_steps, state.g_steps) == (n_micro, df, gf)

    lr, step_max = LR[expt]
    upd_diffs = []
    to_g, to_d = CONVERT["resnet" if expt == "gan_stability_r1" else "dc"]
    before = {"G": to_g(g_vars), "D": to_d(d_vars)}
    after = {"G": to_g({"params": st1.g_params, **st1.g_state}),
             "D": to_d({"params": st1.d_params, **st1.d_state})}
    for name, net, n_upd in (("G", task.generator, gf),
                             ("D", task.discriminator, df)):
        have = net.state_dict()
        params = dict(net.named_parameters())
        assert set(have) == set(after[name])
        for k, want in after[name].items():
            if k not in params:           # BatchNorm running statistics
                np.testing.assert_allclose(have[k].numpy(), want.numpy(),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=f"{name} {k}")
                continue
            # at the bf16 penalty a step whose sign flipped moves by two
            np.testing.assert_allclose(
                have[k].numpy(), want.numpy(),
                atol=step_max * lr * n_upd * (2 if bf16_penalty else 1),
                err_msg=f"{name} {k}")
            d_have = (have[k] - before[name][k]).numpy()
            d_want = (want - before[name][k]).numpy()
            upd_diffs.append(np.abs(d_have - d_want).ravel())
    upd_diffs = np.concatenate(upd_diffs)
    if bf16_penalty:
        assert np.median(upd_diffs) <= 0.05 * step_max * lr
    else:
        assert np.mean(upd_diffs > 1e-6) <= 0.01
    if expt == "wgan":
        # D was clamped at the top of the G micro-step and not updated since
        c = float(cfg.train.weight_clip)
        for p in list(task.discriminator.parameters()) + \
                jax.tree_util.tree_leaves(st1.d_params):
            assert float(np.abs(np.asarray(p.detach() if torch.is_tensor(p)
                                           else p)).max()) <= c


def test_g_ema_follows_the_weighted_average(tmp_path):
    """train.ema_decay: after the G update, ema = decay·init +
    (1 − decay)·new (tests/test_train_step.py's rule); the Fake grid's
    parameters are the EMA's, with G's live buffers."""
    _, task, _, _ = make_pair("dc_gan", tmp_path)
    decay = 0.9
    state = create_train_state(task, steps_per_epoch=4, ema=True)
    init = {k: v.clone() for k, v in state.g_ema.items()}
    images = torch.from_numpy(_images((2, B, 32, 32, 3))).permute(
        0, 1, 4, 2, 3)
    superstep(task, state, {"image": images}, 1, 1, ema_decay=decay)
    live = dict(task.generator.named_parameters())
    for k, e in state.g_ema.items():
        want = init[k] * decay + live[k].detach() * (1 - decay)
        np.testing.assert_allclose(e.numpy(), want.numpy(), atol=1e-6)
    assert state.eval_g_params(task.generator) is state.g_ema
    z = torch.randn(B, 8, generator=torch.Generator().manual_seed(0))
    twin = instantiate(task.cfg.generator,
                       init_generator=torch.Generator().manual_seed(1))
    twin.load_state_dict({**task.generator.state_dict(), **state.g_ema})
    with torch.no_grad():
        want = twin.eval()(z)
    got = task.generate(z, params=state.eval_g_params(task.generator))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
