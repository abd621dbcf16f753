"""The port's figure callbacks against the JAX package's, on the CPU in
float32 at tiny widths, and the figure behaviours of the JAX package's
tests/test_figures.py.

Every figure class draws in both frameworks from the same converted
weights, with the same latents, poses and views handed to both: each
context's ``sample_z`` returns numpy latents by (count, salt), the task's
``sample_view`` returns numpy poses, and a generation without a view gets
numpy views (the JAX package draws those from its key, the port from a
torch.Generator). The drawn grids and frames, in [0, 1], agree within 1e-4
(HoloGAN, π-GAN, dc_gan) and 1e-3 (ANIGAN, whose TPS deformation goes
through a 46-unknown float32 solve).

SampleGrid and Interpolation draw on dc_gan, the pose figures on HoloGAN
(AzimuthStep also on π-GAN, whose poses become cameras), FullShapeAnalysis
and AniganTurntable on ANIGAN with procedural analysed data.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import CONF_DIR
from lightning_gan_zoo_tpu import figures as jfig
from lightning_gan_zoo_tpu.config import compose as jax_compose
from lightning_gan_zoo_tpu.config.registry import instantiate as jax_inst
from lightning_gan_zoo_tpu.figures.types import FigureContext as JaxContext
from lightning_gan_zoo_tpu.runtime.loop import train as jax_train
from lightning_gan_zoo_tpu_torch import convert
from lightning_gan_zoo_tpu_torch import figures as tfig
from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.config.registry import instantiate
from lightning_gan_zoo_tpu_torch.data.procedural import (
    overrides, write_analysed_birds)
from lightning_gan_zoo_tpu_torch.figures.types import FigureContext
from lightning_gan_zoo_tpu_torch.runtime import loop

#: the suite runs several files at once (pytest-xdist workers) on a few
#: cores: two torch threads per worker keep them off each other's cores
torch.set_num_threads(2)

DCGAN = ["+expt=dc_gan", "dataset=synthetic", "train.img_size=16",
         "train.features_gen=8", "train.features_disc=8",
         "model.noise_dim=16", "precision=32", "calc_fid=False"]
HOLOGAN = ["+expt=hologan", "dataset=synthetic", "train.img_size=64",
           "generator.in_planes=4", "discriminator.out_planes=4",
           "model.noise_dim=8", "precision=32", "calc_fid=False",
           "generator.resample=gather"]
PIGAN = ["+expt=pigan", "machine=local", "dataset=synthetic",
         "model.noise_dim=16", "nerf.siren_dim_hidden=32",
         "nerf.siren_num_layers=2", "nerf.n_pts_per_ray=4",
         "nerf.n_pts_per_ray_fine=4", "train.features_disc=8",
         "train.img_size=8", "resolution_annealing.resolutions=[8,8,8]",
         "variable_batch_size.batch_sizes=[2,2,2]", "precision=32",
         "calc_fid=False"]
ANIGAN = ["+expt=anigan", "machine=local", "model.noise_dim=16",
          "nerf.siren_dim_hidden=32", "nerf.siren_num_layers=2",
          "nerf.n_pts_per_ray=4", "nerf.n_pts_per_ray_fine=4",
          "train.features_disc=8", "train.img_size=16", "precision=32",
          "resolution_annealing.resolutions=[8,16,16]",
          "variable_batch_size.batch_sizes=[2,2,2]", "calc_fid=False"]
CONVERT = {"dc_gan": convert.dcgan_generator_state_dict,
           "hologan": convert.generator_state_dict,
           "pigan": convert.pigan_generator_state_dict,
           "anigan": convert.anigan_generator_state_dict}


@pytest.fixture(scope="module")
def birds(tmp_path_factory):
    root = tmp_path_factory.mktemp("birds")
    return overrides(*write_analysed_birds(root, n=4, img_size=16,
                                           subdivisions=1, seed=0))


def _randomise(variables, seed):
    """Every parameter N(0, 1/fan_in), biases N(0, 0.1²), from numpy; the
    other collections (BatchNorm statistics) as the init made them."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if jax.tree_util.keystr(path).endswith("['bias']"):
            return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)
                ).astype(np.float32)
    out = dict(jax.device_get(variables))
    out["params"] = jax.tree_util.tree_map_with_path(fill, out["params"])
    return out


class Draws:
    """The numpy latents, poses and views both contexts are handed."""

    def __init__(self, noise_dim, view_args, seed=0):
        self.rng = np.random.default_rng(seed)
        self.noise_dim, self.va = noise_dim, view_args
        self.z, self.poses = {}, []

    def latents(self, n, salt):
        if (n, salt) not in self.z:
            self.z[(n, salt)] = self.rng.uniform(
                -1, 1, (n, self.noise_dim)).astype(np.float32)
        return self.z[(n, salt)]

    def pose(self, i, n):
        """The i-th pose batch of n rows, in the config's ranges."""
        while len(self.poses) <= i:
            self.poses.append(self.rng.uniform(size=(64, 2)))
        u = self.poses[i][:n]
        va = self.va
        az = va["azimuth_low"] + u[:, 0] * (va["azimuth_high"]
                                            - va["azimuth_low"])
        el = va["elevation_low"] + u[:, 1] * (va["elevation_high"]
                                              - va["elevation_low"])
        v = np.zeros((n, 6), np.float32)
        v[:, 0], v[:, 1], v[:, 2] = np.radians(az), np.radians(el), 1.0
        return v


def _contexts(family, args, tmp_path):
    """(cfg, JAX context, port context) on the same weights, with the
    draws patched in."""
    jcfg = jax_compose(CONF_DIR, args)
    jtask = jax_inst(jcfg.model.lm, jcfg, str(tmp_path))
    g_vars = _randomise(jtask.init(jax.random.PRNGKey(0))[0], 1)
    cfg = compose(CONF_DIR, args)
    task = instantiate(cfg.model.lm, cfg, str(tmp_path), device="cpu")
    task.generator.load_state_dict(CONVERT[family](g_vars))
    jctx = JaxContext(task=jtask, g_params=g_vars["params"],
                      g_state={k: v for k, v in g_vars.items()
                               if k != "params"},
                      cfg=jcfg, epoch=0, rng=jax.random.PRNGKey(1))
    tctx = FigureContext(task=task, g_params=None, cfg=cfg, epoch=0, seed=0)
    d = Draws(int(cfg.model.noise_dim), cfg.generator.get("view_args"))
    jctx.sample_z = lambda n, salt=0: jnp.asarray(d.latents(n, salt))
    tctx.sample_z = lambda n, salt=0: torch.from_numpy(d.latents(n, salt))
    j_calls, t_calls = iter(range(100)), iter(range(100))
    jtask.sample_view = lambda rng, n: jnp.asarray(d.pose(next(j_calls), n))
    task.sample_view = lambda n, g: torch.from_numpy(d.pose(next(t_calls), n))
    if family in ("hologan", "pigan"):
        j_gen, t_gen = jctx.generate, tctx.generate
        jctx.generate = lambda z, **kw: j_gen(
            z, **{"view_in": jnp.asarray(d.pose(50, len(z))), **kw})
        tctx.generate = lambda z, **kw: t_gen(
            z, **{"view_in": torch.from_numpy(d.pose(50, len(z))), **kw})
    return cfg, jctx, tctx


def _close(got, want, atol):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, atol)
        return
    want = np.asarray(want)
    assert got.shape == want.shape and got.ndim == 3
    assert 0.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_allclose(got, want, atol=atol)


CASES = [
    ("dc_gan", "SampleGrid", dict(ncol=2)),
    ("dc_gan", "Interpolation", dict(n_frames=3)),
    ("hologan", "SampleGrid", dict(ncol=2)),
    ("hologan", "Interpolation3d", dict(n_frames=2)),
    ("hologan", "AzimuthStep", dict(n_steps=3, n_objs=2)),
    ("hologan", "ElevationStep", dict(n_steps=3, n_objs=2)),
    ("hologan", "AzimuthGif", dict(ncol=2, n_frames=3)),
    ("hologan", "ElevationGif", dict(num_objs=4, n_frames=2)),
    ("pigan", "AzimuthStep", dict(n_steps=2, n_objs=2)),
]


@pytest.mark.parametrize("family,name,kw", CASES,
                         ids=[f"{f}-{n}" for f, n, _ in CASES])
def test_figure_matches_jax(family, name, kw, tmp_path):
    args = {"dc_gan": DCGAN, "hologan": HOLOGAN, "pigan": PIGAN}[family]
    cfg, jctx, tctx = _contexts(family, args, tmp_path)
    want = getattr(jfig, name)(jctx.cfg.figure_details, str(tmp_path / "j"),
                               **kw).draw(jctx)
    got = getattr(tfig, name)(cfg.figure_details, str(tmp_path / "t"),
                              **kw).draw(tctx)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("name", ["FullShapeAnalysis", "AniganTurntable"])
def test_anigan_figure_matches_jax(name, birds, tmp_path):
    kw = dict(val_dataset=None, n_objs=2)
    if name == "AniganTurntable":
        kw["n_frames"] = 3
    cfg, jctx, tctx = _contexts("anigan", ANIGAN + birds, tmp_path)
    want = getattr(jfig, name)(jctx.cfg.figure_details, str(tmp_path / "j"),
                               **{**kw, "val_dataset": jctx.cfg.dataset.val}
                               ).draw(jctx)
    got = getattr(tfig, name)(cfg.figure_details, str(tmp_path / "t"),
                              **{**kw, "val_dataset": cfg.dataset.val}
                              ).draw(tctx)
    _close(got, want, 1e-3)
    rows = 5 if name == "FullShapeAnalysis" else 2
    grid = got if name == "FullShapeAnalysis" else got[0]
    assert grid.shape == (rows * 18 + 2, 2 * 18 + 2, 3)


# ------------------------------------------- the JAX tests' behaviours
def _dcgan_ctx(tmp_path, args=DCGAN):
    cfg = compose(CONF_DIR, args)
    task = instantiate(cfg.model.lm, cfg, str(tmp_path), device="cpu")
    return cfg, FigureContext(task=task, g_params=None, cfg=cfg, epoch=0,
                              seed=0)


def test_fid_gating(tmp_path):
    cfg, ctx = _dcgan_ctx(tmp_path)
    fig = tfig.SampleGrid(cfg.figure_details, str(tmp_path), monitor="fid",
                          ncol=2)
    out = tmp_path / "figures" / "SampleGrid.png"
    fig.on_validation_end(ctx, {})                  # no fid yet: no draw
    assert not out.exists()
    fig.on_validation_end(ctx, {"fid": 10.0})
    assert out.exists() and fig.last_drawn_epoch == 0
    mtime = out.stat().st_mtime_ns
    fig.on_validation_end(ctx, {"fid": 20.0})       # worse: no redraw
    assert out.stat().st_mtime_ns == mtime
    ctx.epoch = 1
    fig.on_validation_end(ctx, {"fid": 5.0})        # better: redraw
    assert out.stat().st_mtime_ns > mtime and fig.last_drawn_epoch == 1


def test_save_all_epoch_folders_and_same_draws_each_run(tmp_path):
    cfg, ctx = _dcgan_ctx(tmp_path)
    details = cfg.figure_details.copy()
    details["save_all"] = True
    fig = tfig.SampleGrid(details, str(tmp_path), ncol=2)
    fig.on_validation_end(ctx, {})
    first = fig.last_artefact
    ctx.epoch = 3
    fig.on_validation_end(ctx, {})
    for e in (0, 3):
        assert (tmp_path / "figures" / f"epoch_{e}" / "SampleGrid.png"
                ).exists()
    # one epoch's draws come from (seed, epoch, salt): the same every run
    ctx.epoch = 0
    np.testing.assert_array_equal(fig.draw(ctx), first)
    assert not np.array_equal(fig.last_artefact, first)


def _gif_frames(path):
    from PIL import Image
    with Image.open(path) as im:
        return im.n_frames


def test_gif_frame_counts(tmp_path):
    """Animations play forwards then backwards: 2·n_frames frames drawn
    (PIL merges the palindrome's repeated middle frame on writing)."""
    cfg, tctx = _dcgan_ctx(tmp_path, HOLOGAN)
    for fig in (tfig.Interpolation3d(cfg.figure_details, str(tmp_path),
                                     n_frames=3),
                tfig.AzimuthGif(cfg.figure_details, str(tmp_path), ncol=2,
                                n_frames=3),
                tfig.ElevationGif(cfg.figure_details, str(tmp_path),
                                  num_objs=4, n_frames=3)):
        fig.draw_and_save(tctx)
        assert len(fig.last_artefact) == 6
        assert _gif_frames(fig._out_path(tctx)) in (5, 6)
    assert np.abs(fig.last_artefact[0] - fig.last_artefact[1]).max() > 1e-4


def test_anigan_figures_need_shape_analyses(tmp_path):
    """On a dataset without shape analyses both ANIGAN figures raise the
    JAX package's RuntimeError at their first draw."""
    cfg, ctx = _dcgan_ctx(tmp_path)
    for cls in (tfig.FullShapeAnalysis, tfig.AniganTurntable):
        fig = cls(cfg.figure_details, str(tmp_path),
                  val_dataset=cfg.dataset.val, n_objs=2)
        with pytest.raises(RuntimeError, match="need a dataset with shape "
                                               "analyses"):
            fig.draw(ctx)


# ------------------------------------------------------- the Trainer
def test_training_draws_figures_and_eval_only_draws_them_again(tmp_path):
    """dc_gan with its config's figures (SampleGrid, Interpolation) and
    fid_callback off: one epoch draws both and logs each (the GIF's middle
    frame); eval_only on its checkpoint draws them again into its own run
    and writes no checkpoint."""
    args = DCGAN + ["train.batch_size=4", "dataset.n=8",
                    "figure_details.fid_callback=False",
                    f"output_root={tmp_path}"]
    trainer = loop.Trainer(compose(CONF_DIR, args + [
        "train.num_epochs=1", "save_ckpts=True", "version=a"]), "cpu")
    assert [type(f).__name__ for f in trainer.figures] == [
        "SampleGrid", "Interpolation"]
    trainer.fit()
    run = tmp_path / "dc_gan" / "a"
    for name in ("SampleGrid.png", "Interpolation.gif"):
        assert (run / "figures" / name).exists()
    for name in ("SampleGrid", "Interpolation"):
        assert (run / "images" / "figures" / f"{name}_step2.png").exists()
    assert _gif_frames(run / "figures" / "Interpolation.gif") in (79, 80)
    ev = loop.Trainer(compose(CONF_DIR, args + [
        "eval_only=true", "version=b", f"train.ckpt_dir={run / 'ckpts'}"]),
        "cpu")
    ev.evaluate()
    assert ev.state.step == trainer.state.step
    assert (tmp_path / "dc_gan" / "b" / "figures" / "SampleGrid.png").exists()
    assert not (tmp_path / "dc_gan" / "b" / "ckpts").exists()


def test_a_figure_with_a_bad_argument_fails_the_run(tmp_path):
    """Only a missing dataset skips a figure; any other error at build
    time fails the Trainer, as in the JAX package."""
    args = DCGAN + [f"output_root={tmp_path}", "figures.sample_grid.ncol=abc"]
    with pytest.raises(ValueError):
        loop.Trainer(compose(CONF_DIR, args), "cpu")


def test_pigan_machine_small_figures_raise_as_in_jax(tmp_path):
    """machine=small adds AniganTurntable to π-GAN as well; on synthetic
    data (no shape analyses) the first validation raises the same
    RuntimeError in both packages (an eval_only validation here, which
    needs no training)."""
    args = ["+expt=pigan", "machine=small", "dataset=synthetic",
            "model.noise_dim=16", "nerf.siren_dim_hidden=32",
            "nerf.siren_num_layers=2", "nerf.n_pts_per_ray=4",
            "nerf.n_pts_per_ray_fine=4", "train.features_disc=8",
            "train.img_size=8", "resolution_annealing.resolutions=[8,8,8]",
            "precision=32", "calc_fid=False", "save_ckpts=False",
            "eval_only=true", "~figures.sample_grid"]
    cfg = compose(CONF_DIR, args + [f"output_root={tmp_path}/t"])
    assert "anigan_turntable" in cfg.figures
    with pytest.raises(RuntimeError) as got:
        loop.Trainer(cfg, "cpu").evaluate()
    with pytest.raises(RuntimeError) as want:
        jax_train(jax_compose(CONF_DIR, args + [f"output_root={tmp_path}/j"]))
    assert str(got.value) == str(want.value)
    assert "need a dataset with shape analyses" in str(got.value)


def test_view_rows_are_radians(tmp_path):
    """The pose sweeps' 6-dof rows: azimuth and elevation in radians, unit
    scale, no translation."""
    from lightning_gan_zoo_tpu_torch.figures.types import _view_in
    _, ctx = _dcgan_ctx(tmp_path)
    v = _view_in(ctx, 90.0, 45.0, 3)
    assert v.shape == (3, 6)
    np.testing.assert_allclose(v[0].numpy(), [math.pi / 2, math.pi / 4, 1.0,
                                              0.0, 0.0, 0.0], rtol=1e-6)
