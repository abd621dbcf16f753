"""``nerf.remat`` (nerf/renderer.py): the radiance field recomputed in the
backward under torch.utils.checkpoint. On the CPU at tiny widths: a π-GAN
superstep with remat equals one without bit for bit (losses and every
parameter after Adam), the trunk's forward runs once more per G micro-step
(the recompute) and no more; ANIGAN's field, which reads deformation noise
without shape analyses, gets the same noise in the recompute and leaves its
stream where the plain run leaves it; the switch runs through
run_network_torch.py; and the port's π-GAN superstep with remat matches
the JAX package's with nerf.remat=true at tests/test_torch_pigan.py's
bounds."""
import re

import jax
import numpy as np
import torch

import run_network_torch
from tests.conftest import CONF_DIR
from tests.test_torch_pigan import B, PIGAN_TINY, _images, _random_variables
from lightning_gan_zoo_tpu.config import compose as jax_compose
from lightning_gan_zoo_tpu.config.registry import instantiate as jax_inst
from lightning_gan_zoo_tpu.runtime.state import create_train_state as jax_state
from lightning_gan_zoo_tpu.runtime.steps import build_superstep
from lightning_gan_zoo_tpu_torch import convert
from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.config.registry import instantiate
from lightning_gan_zoo_tpu_torch.ops.cuda import siren_trunk as st
from lightning_gan_zoo_tpu_torch.runtime.state import create_train_state
from lightning_gan_zoo_tpu_torch.runtime.steps import superstep

torch.set_num_threads(2)

#: the bf16 policy at a SIREN width of 128, so the field runs the fused
#: trunk (its plain version on the CPU): under the JAX rule a width that is
#: not a multiple of 128 runs the layer loop
BF16 = [a for a in PIGAN_TINY
        if a not in ("precision=32", "nerf.siren_dim_hidden=32")] + [
    "precision=16", "nerf.siren_dim_hidden=128"]
REMAT = ["+nerf.remat=true"]


def _task(tmp_path, overrides):
    cfg = compose(CONF_DIR, overrides)
    return instantiate(cfg.model.lm, cfg, str(tmp_path), device="cpu")


def _superstep(tmp_path, overrides, monkeypatch):
    """(metrics, parameters after one 1 D + 1 G superstep, trunk forward
    calls) from the seed's weights."""
    calls = []
    plain = st.plain.trunk_forward
    monkeypatch.setattr(st.plain, "trunk_forward",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    task = _task(tmp_path, overrides)
    state = create_train_state(task, steps_per_epoch=4)
    images = torch.from_numpy(_images(seed=3, n=2)).permute(0, 1, 4, 2, 3)
    metrics = superstep(task, state, {"image": images}, 1, 1)
    params = [p.detach().clone() for net in (task.generator,
                                             task.discriminator)
              for p in net.parameters()]
    return {k: float(v) for k, v in metrics.items()}, params, len(calls)


def test_remat_superstep_is_bit_identical(tmp_path, monkeypatch):
    m0, p0, n0 = _superstep(tmp_path, BF16, monkeypatch)
    m1, p1, n1 = _superstep(tmp_path, BF16 + REMAT, monkeypatch)
    assert m0 == m1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    # D micro-step: coarse + fine (no grad); G: coarse (no grad) + fine,
    # and with remat the fine pass once more in the backward
    assert (n0, n1) == (4, 5)


def test_remat_replays_anigan_deformation_noise(tmp_path):
    """The single-shape field without shape analyses reads noise from the
    deformation stream: the recompute must see the same noise, and the
    stream must end where the plain run leaves it."""
    over = ["+expt=anigan", "machine=local", "model.noise_dim=16",
            "nerf.siren_dim_hidden=32", "nerf.siren_num_layers=2",
            "nerf.n_pts_per_ray=4", "nerf.n_pts_per_ray_fine=4",
            "train.img_size=8", "~figures"]
    z = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16)).astype(np.float32))
    views = torch.tensor([[0.5, 0, 1, 0, 0, 0], [2.0, 0, 1, 0, 0, 0]])
    out = []
    for extra in ([], REMAT):
        task = _task(tmp_path, over + extra)
        gen = torch.Generator().manual_seed(9)
        with task.autocast():
            img = task.generator(z, sample_res=8, view_in=views,
                                 train=False, deform_generator=gen)
        grads = torch.autograd.grad(img.float().square().sum(),
                                    list(task.generator.parameters()),
                                    allow_unused=True)
        out.append((img.detach(), grads, gen.get_state()))
    (i0, g0, s0), (i1, g1, s1) = out
    assert torch.equal(i0, i1)
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(g0, g1))
    assert torch.equal(s0, s1)


def test_cli_runs_pigan_with_remat(tmp_path, capsys):
    assert run_network_torch.main(
        ["+expt=pigan", "machine=local", "dataset=synthetic", "~figures",
         "model.noise_dim=16", "nerf.siren_dim_hidden=32",
         "nerf.siren_num_layers=2", "nerf.n_pts_per_ray=4",
         "nerf.n_pts_per_ray_fine=4", "train.features_disc=8",
         "resolution_annealing.resolutions=[8,16,32]",
         "variable_batch_size.batch_sizes=[4,2,2]", "train.num_epochs=1",
         "dataset.n=16", "+nerf.remat=true", f"output_root={tmp_path}",
         "--device", "cpu"]) == 0
    line = re.search(r"^epoch 0 \[.*\] (.*)$", capsys.readouterr().out, re.M)
    assert line and re.search(r"\bg_loss=-?\d", line.group(1))


def test_remat_superstep_matches_jax(tmp_path):
    """One 1 D + 1 G superstep from the same weights, batch and z, both
    packages with nerf.remat=true: metrics at rtol 1e-4, parameters after
    Adam within 2·lr (tests/test_torch_pigan.py's bounds)."""
    jcfg = jax_compose(CONF_DIR, PIGAN_TINY + REMAT)
    jtask = jax_inst(jcfg.model.lm, jcfg, str(tmp_path))
    assert jcfg.nerf.remat is True
    g_vars, d_vars = _random_variables(jtask)
    d_tx, g_tx = jtask.configure_optimizers(4)
    st0 = jax_state(g_vars, d_vars, g_tx, d_tx, extra=jtask.initial_extra())
    imgs = _images(seed=3, n=2)
    rng = jax.random.PRNGKey(7)
    st1, metrics = jax.jit(build_superstep(jtask, g_tx, d_tx, 1, 1))(
        st0, {"image": imgs, "label": np.zeros((2, B), np.int32)}, rng)
    zs = iter([np.array(jtask.sample_z(
        jax.random.split(jax.random.fold_in(rng, i))[0], B))
        for i in range(2)])

    task = _task(tmp_path, PIGAN_TINY + REMAT)
    assert task.generator.nerf_renderer.remat
    task.generator.load_state_dict(convert.pigan_generator_state_dict(g_vars))
    task.discriminator.load_state_dict(
        convert.pigan_discriminator_state_dict(d_vars))
    task.sample_z = lambda n, generator=None: torch.from_numpy(next(zs))
    state = create_train_state(task, steps_per_epoch=4)
    got = superstep(task, state, {
        "image": torch.from_numpy(imgs).permute(0, 1, 4, 2, 3)}, 1, 1)
    for k in metrics:
        np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                   rtol=1e-4, err_msg=k)
    st1 = jax.device_get(st1)
    for name, net, after, lr in (
            ("G", task.generator,
             convert.pigan_generator_state_dict({"params": st1.g_params}),
             5e-5),
            ("D", task.discriminator,
             convert.pigan_discriminator_state_dict(
                 {"params": st1.d_params}), 4e-4)):
        have = net.state_dict()
        for k, want in after.items():
            np.testing.assert_allclose(have[k].numpy(), want.numpy(),
                                       atol=2 * lr, err_msg=f"{name} {k}")
