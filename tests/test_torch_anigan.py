"""The port's ANIGAN against the JAX package's, on the CPU in float32 at tiny
widths (noise 16, SIREN 32 × 2, 4 + 4 points, D init_chan 8): the TPS
solve and warp, the six deformers, SirenSingleShape, the generator from the
analysis cameras, one superstep, AnimalAnalysisFolder, both mesh
rasterizers, and an exact resume. Weights come from numpy through
convert.py, the analysed data from data/procedural.py; each test states its
bound.

Stratification is off, and ANIGAN renders from the analysis cameras, so
both frameworks render the same rays at the same depths without sharing
random streams.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import CONF_DIR
from lightning_gan_zoo_tpu.anigan import deformer as jdef
from lightning_gan_zoo_tpu.anigan import tps as jtps
from lightning_gan_zoo_tpu.config import compose as jax_compose
from lightning_gan_zoo_tpu.config.registry import instantiate as jax_inst
from lightning_gan_zoo_tpu.data.datasets import (
    AnimalAnalysisFolder as JaxFolder)
from lightning_gan_zoo_tpu.nerf import cameras as jcam
from lightning_gan_zoo_tpu.nerf import rasterize as jras
from lightning_gan_zoo_tpu.nerf.siren import SirenSingleShape as JaxField
from lightning_gan_zoo_tpu.runtime.state import create_train_state as jax_state
from lightning_gan_zoo_tpu.runtime.steps import build_superstep
from lightning_gan_zoo_tpu_torch import convert
from lightning_gan_zoo_tpu_torch.anigan import deformer as tdef
from lightning_gan_zoo_tpu_torch.anigan import tps
from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.config.registry import instantiate
from lightning_gan_zoo_tpu_torch.data.datasets import AnimalAnalysisFolder
from lightning_gan_zoo_tpu_torch.data.procedural import (
    icosphere, overrides, write_analysed_birds)
from lightning_gan_zoo_tpu_torch.nerf import cameras as tcam
from lightning_gan_zoo_tpu_torch.nerf import rasterize as tras
from lightning_gan_zoo_tpu_torch.nerf.siren import SirenSingleShape
from lightning_gan_zoo_tpu_torch.runtime import loop
from lightning_gan_zoo_tpu_torch.runtime.state import create_train_state
from lightning_gan_zoo_tpu_torch.runtime.steps import superstep
from tests.test_torch_checkpoint import assert_same

#: the suite runs several files at once (pytest-xdist workers) on a few
#: cores: two torch threads per worker keep them off each other's cores
torch.set_num_threads(2)

B = 2
ANIGAN_TINY = ["+expt=anigan", "machine=local", "model.noise_dim=16",
               "nerf.siren_dim_hidden=32", "nerf.siren_num_layers=2",
               "nerf.n_pts_per_ray=4", "nerf.n_pts_per_ray_fine=4",
               "train.features_disc=8", "train.img_size=16", "precision=32",
               "resolution_annealing.resolutions=[8,16,16]",
               "variable_batch_size.batch_sizes=[2,2,2]",
               "nerf.stratified=False", "~figures"]


@pytest.fixture(scope="module")
def birds(tmp_path_factory):
    """8 analysed images at 16 px on an icosphere of subdivision 1 (42
    verts, 80 faces); returns the config overrides that read them."""
    root = tmp_path_factory.mktemp("birds")
    return overrides(*write_analysed_birds(root, n=8, img_size=16,
                                           subdivisions=1, seed=0))


def _sa(seed=0, n_verts=42):
    """A numpy shape-analysis batch: jittered spheres, the template, 15
    keypoints, analysis cameras (unit quaternions) and masks."""
    rng = np.random.default_rng(seed)
    sphere, faces = icosphere(1)
    mean = (sphere[:n_verts] * [0.3, 0.25, 0.4]).astype(np.float32)
    verts = (mean[None] * rng.uniform(0.85, 1.15, (B, 1, 3))
             + rng.normal(0, 0.02, (B, n_verts, 3))).astype(np.float32)
    q = rng.normal(size=(B, 4))
    cam = np.concatenate([rng.uniform(1.3, 1.7, (B, 1)),
                          rng.uniform(-0.1, 0.1, (B, 2)),
                          q / np.linalg.norm(q, axis=1, keepdims=True)], 1)
    return {"cam_pred": cam.astype(np.float32),
            "mean_shape": np.repeat(mean[None], B, 0),
            "verts": verts, "kp_verts": verts[:, 1::2][:, :15],
            "mask_pred": rng.uniform(size=(B, 16, 16)).astype(np.float32),
            "faces": np.repeat(faces[None], B, 0).astype(np.float32)}


def _jax(sa):
    return {k: jnp.asarray(v) for k, v in sa.items()}


def _torch(sa):
    return {k: torch.from_numpy(v) for k, v in sa.items()}


def _randomise(variables, seed):
    """Every parameter N(0, 1/fan_in), biases N(0, 0.1²), from numpy."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if jax.tree_util.keystr(path).endswith("['bias']"):
            return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)
                ).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, variables)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


# ---------------------------------------------------------------- TPS
def test_tps_solve_and_warp_match_jax():
    """Control points on a jittered sphere (well conditioned), targets a
    smooth warp of them: the warped query points within 1e-4 of max|ref|,
    the coefficients within 1e-3 (a linear solve of 44 unknowns in float32),
    and the spline through its control points within 1e-4."""
    rng = np.random.default_rng(3)
    sphere, _ = icosphere(1)
    ctrl = (sphere[None] * rng.uniform(0.8, 1.2, (B, 1, 3))
            + rng.normal(0, 0.03, (B, 42, 3))).astype(np.float32)
    target = (ctrl + 0.1 * np.sin(2 * ctrl[..., ::-1])).astype(np.float32)
    pts = rng.uniform(-1, 1, (B, 50, 3)).astype(np.float32)
    w_jax = jtps.find_coefficients(jnp.asarray(ctrl), jnp.asarray(target))
    want = jtps.transform(jnp.asarray(pts), jnp.asarray(ctrl), w_jax)
    w = tps.find_coefficients(torch.from_numpy(ctrl),
                              torch.from_numpy(target))
    got = tps.transform(torch.from_numpy(pts), torch.from_numpy(ctrl), w)
    assert w.shape == (B, 46, 3)
    assert _rel(w, w_jax) <= 1e-3
    assert _rel(got, want) <= 1e-4
    through = tps.transform(torch.from_numpy(ctrl), torch.from_numpy(ctrl), w)
    assert _rel(through, target) <= 1e-4


# ---------------------------------------------------------- deformers
DEFORMERS = {
    "TPSDeformer": {"template_subdivision": 1},
    "RBFDeformer": {"template_subdivision": 8},
    "KernelDeformer": {"template_subdivision": 8, "sigma": 0.5,
                       "normalised": True},
    "DisplacementDeformer": {"template_subdivision": 8},
    "LSTMDeformer": {"template_subdivision": 8},
    "SirenDeformer": {"template_subdivision": 8},
}


@pytest.mark.parametrize("name", sorted(DEFORMERS))
def test_deformer_matches_jax(name):
    """calculate_deformation within 1e-3 of max|ref| (TPS and RBF: a solve;
    the others 1e-5), transform within 1e-4 of max|ref|, on converted
    random weights."""
    kw = DEFORMERS[name]
    sa = _sa(seed=1)
    x = np.random.default_rng(2).uniform(-0.5, 0.5, (B, 30, 3)
                                         ).astype(np.float32)
    jd = getattr(jdef, name)(**kw)

    def both(mdl, sa, x):
        dp = mdl.calculate_deformation(sa)
        return dp, mdl.transform(x, sa["verts"], sa["mean_shape"],
                                 sa["kp_verts"], dp)
    variables = jax.jit(lambda s, xx: jd.init(jax.random.PRNGKey(0), s, xx,
                                              method=both))(_jax(sa), x)
    variables = _randomise(jax.device_get(variables), 4)
    want_dp, want = jax.jit(lambda v, s, xx: jd.apply(v, s, xx, method=both)
                            )(variables, _jax(sa), x)

    td = getattr(tdef, name)(**kw, n_verts=42)
    td.load_state_dict(convert.deformer_state_dict(
        variables.get("params", {})))
    with torch.no_grad():
        dp = td.calculate_deformation(_torch(sa))
        got = td.transform(torch.from_numpy(x), *(
            torch.from_numpy(sa[k]) for k in ("verts", "mean_shape",
                                              "kp_verts")), dp)
    assert td.siren_input_channels == jd.siren_input_channels
    if want_dp is None:
        assert dp is None
    else:
        tol = 1e-3 if name in ("TPSDeformer", "RBFDeformer") else 1e-5
        assert _rel(dp, want_dp) <= tol
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-4


# --------------------------------------------------- field and generator
def test_single_shape_field_matches_jax():
    """SirenSingleShape with the displacement deformer (45 input
    channels): densities and colours within 1e-5."""
    rng = np.random.default_rng(5)
    sa = _sa(seed=6)
    pts = rng.uniform(-0.5, 0.5, (B, 3, 4, 3)).astype(np.float32)
    dirs = rng.normal(size=(B, 3, 3)).astype(np.float32)
    z = rng.normal(size=(B, 16)).astype(np.float32)
    field = JaxField(latent_z_dim=16, num_layers=2, dim_hidden=32,
                     deformer=jdef.DisplacementDeformer(), input_channels=45)
    kw = dict(deformed_verts=sa["verts"], mean_shape_verts=sa["mean_shape"],
              kp_verts=sa["kp_verts"])
    variables = _randomise(jax.device_get(field.init(
        jax.random.PRNGKey(0), pts, dirs, z, **kw)), 7)
    want = field.apply(variables, pts, dirs, z, **kw)
    tf = SirenSingleShape(16, 2, 32, deformer=tdef.DisplacementDeformer(),
                          input_channels=45)
    sd = convert.anigan_generator_state_dict(
        {"params": {"nerf_renderer": {"rad_field": variables["params"]}}})
    tf.load_state_dict({k.split("rad_field.", 1)[1]: v
                        for k, v in sd.items()})
    with torch.no_grad():
        got = tf(torch.from_numpy(pts), torch.from_numpy(dirs),
                 torch.from_numpy(z),
                 **{k: torch.from_numpy(v) for k, v in kw.items()})
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def _random_variables(jtask, seed=0):
    shapes = jax.eval_shape(jtask.init, jax.random.PRNGKey(0))
    return [_randomise(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), v), seed + i)
        for i, v in enumerate(shapes)]


@pytest.fixture(scope="module")
def pair(birds, tmp_path_factory):
    """(JAX task, port task, g_vars, d_vars) on the same weights."""
    out = str(tmp_path_factory.mktemp("anigan"))
    args = ANIGAN_TINY + birds
    jcfg = jax_compose(CONF_DIR, args)
    jtask = jax_inst(jcfg.model.lm, jcfg, out)
    g_vars, d_vars = _random_variables(jtask)
    cfg = compose(CONF_DIR, args)
    task = instantiate(cfg.model.lm, cfg, out, device="cpu")
    task.generator.load_state_dict(convert.anigan_generator_state_dict(g_vars))
    task.discriminator.load_state_dict(
        convert.pigan_discriminator_state_dict(d_vars))
    return jtask, task, g_vars, d_vars


def test_state_dicts_cover_every_parameter(pair):
    _, task, g_vars, d_vars = pair
    assert set(convert.anigan_generator_state_dict(g_vars)) == \
        set(task.generator.state_dict())
    assert set(convert.pigan_discriminator_state_dict(d_vars)) == \
        set(task.discriminator.state_dict())


def test_generator_from_analysis_cameras_matches_jax(pair):
    """RGBA at 8 px, train=False, explicit z, the cameras and ray scale of
    cam_pred and the TPS deformation: within 1e-4."""
    jtask, task, g_vars, _ = pair
    sa = _sa(seed=8)
    z = np.random.default_rng(9).normal(size=(B, 16)).astype(np.float32)
    cams, scale = jcam.convert_cam_pred(jnp.asarray(sa["cam_pred"]))
    dp = jtask.deformation_parameters(g_vars["params"], {}, _jax(sa))
    want = np.asarray(jtask.generator.apply(
        g_vars, jnp.asarray(z), sample_res=8, cameras=cams, ray_scale=scale,
        deformation_parameters=dp, deformed_verts=sa["verts"],
        mean_shape_verts=sa["mean_shape"], kp_verts=sa["kp_verts"],
        train=False))
    with torch.no_grad():
        got = task.generator(torch.from_numpy(z), sample_res=8, train=False,
                             **task.deformation_inputs(_torch(sa)))
    assert got.shape == (B, 8, 8, 4)
    assert want[..., :3].std() > 1e-3
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_superstep_matches_jax(pair):
    """One 1 D + 1 G superstep from the same weights, images, analyses and
    z: d_loss, r1, g_loss and silhouette at rtol 1e-4; parameters after Adam
    within 2·lr, the updates within 1e-6 on at least 99 % of the
    elements (as tests/test_torch_pigan.py)."""
    jtask, task, g_vars, d_vars = pair
    d_tx, g_tx = jtask.configure_optimizers(4)
    st0 = jax_state(g_vars, d_vars, g_tx, d_tx, extra=jtask.initial_extra())
    rng = np.random.default_rng(10)
    imgs = (rng.normal(size=(2, B, 16, 16, 3)) * 0.3).astype(np.float32)
    sas = [_sa(seed=11), _sa(seed=12)]
    sa = {k: np.stack([s[k] for s in sas]) for k in sas[0]}
    key = jax.random.PRNGKey(7)
    st1, metrics = jax.jit(build_superstep(jtask, g_tx, d_tx, 1, 1))(
        st0, {"image": imgs, "label": np.zeros((2, B), np.int32),
              "shape_analysis": sa}, key)
    zs = iter([np.array(jtask.sample_z(
        jax.random.split(jax.random.fold_in(key, i))[0], B))
        for i in range(2)])

    task.generator.load_state_dict(convert.anigan_generator_state_dict(g_vars))
    task.discriminator.load_state_dict(
        convert.pigan_discriminator_state_dict(d_vars))
    task.sample_z = lambda n, generator=None: torch.from_numpy(next(zs))
    state = create_train_state(task, steps_per_epoch=4)
    got = superstep(task, state, {
        "image": torch.from_numpy(imgs).permute(0, 1, 4, 2, 3),
        "shape_analysis": _torch(sa)}, 1, 1)
    assert set(got) == set(metrics) == {"d_loss", "r1", "g_loss",
                                        "silhouette"}
    for k in metrics:
        np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                   rtol=1e-4, err_msg=k)
    st1 = jax.device_get(st1)
    n_off = n_all = 0
    for name, net, before, after, lr in (
            ("G", task.generator, convert.anigan_generator_state_dict(g_vars),
             convert.anigan_generator_state_dict({"params": st1.g_params}),
             5e-5),
            ("D", task.discriminator,
             convert.pigan_discriminator_state_dict(d_vars),
             convert.pigan_discriminator_state_dict(
                 {"params": st1.d_params}), 4e-4)):
        have = net.state_dict()
        for k, want in after.items():
            np.testing.assert_allclose(have[k].numpy(), want.numpy(),
                                       atol=2 * lr, err_msg=f"{name} {k}")
            d_have = (have[k] - before[k]).numpy()
            d_want = (want - before[k]).numpy()
            n_off += int(np.sum(np.abs(d_have - d_want) > 1e-6))
            n_all += d_want.size
    assert n_off <= 0.01 * n_all, (n_off, n_all)


# ------------------------------------------------------------ data
def test_animal_analysis_folder_matches_jax(birds):
    """The same files through both readers: images within 1e-6 and every
    analysis array equal."""
    kw = dict(img_size=16, n_channels=3, data_mean=0.0, data_std=1.0)
    roots = dict(root=birds[0].split("=", 1)[1] + "/train",
                 analysis_root=birds[1].split("=", 1)[1])
    want = JaxFolder(**roots, **kw).load([0, 3, 5])
    got = AnimalAnalysisFolder(**roots, **kw).load([0, 3, 5])
    np.testing.assert_allclose(got["image"], want["image"], atol=1e-6)
    assert set(got["shape_analysis"]) == set(want["shape_analysis"]) == {
        "cam_pred", "mean_shape", "verts", "kp_verts", "mask_pred", "faces"}
    for k, v in want["shape_analysis"].items():
        np.testing.assert_array_equal(got["shape_analysis"][k], v)
    assert got["shape_analysis"]["verts"].shape == (3, 42, 3)


# ---------------------------------------------------------- rasterizers
@pytest.mark.parametrize("kind", ["phong", "lambert"])
def test_rasterizers_match_jax(kind):
    """An icosphere mesh (subdivision 2, jittered) under two oblique
    cameras at 48 px: at most 0.5 % of pixels differ (coverage decided by a
    last-bit barycentric sign on a triangle edge), the rest within 1e-5;
    white background."""
    rng = np.random.default_rng(13)
    sphere, faces = icosphere(2)
    verts = (sphere[None] * [0.7, 0.5, 0.6]
             + rng.normal(0, 0.02, (B,) + sphere.shape)).astype(np.float32)
    elev, azim = np.array([10.0, 35.0]), np.array([20.0, 200.0])
    jc = jcam.look_at_view_transform(2.0, elev, azim)
    tc = tcam.look_at_view_transform(2.0, torch.tensor(elev),
                                     torch.tensor(azim))
    fn_j = jras.render_mesh_phong if kind == "phong" else \
        jras.render_mesh_lambert
    fn_t = tras.render_mesh_phong if kind == "phong" else \
        tras.render_mesh_lambert
    want = np.asarray(fn_j(jnp.asarray(verts), jnp.asarray(faces), jc, 48,
                           face_chunk=128))
    got = fn_t(torch.from_numpy(verts), torch.from_numpy(faces), tc, 48,
               face_chunk=128).numpy()
    assert got.shape == want.shape == (B, 48, 48, 3)
    off = np.abs(got - want).max(-1) > 1e-5
    assert off.mean() <= 0.005, off.mean()
    assert (want[..., 0] < 0.999).mean() > 0.2       # the mesh is drawn
    assert got[0, 0, 0].tolist() == [1.0, 1.0, 1.0]


def test_lambert_colours():
    """Per-instance albedo tints the shade and leaves white albedo
    bit-identical to no colours."""
    verts = torch.tensor([[[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0],
                           [0.0, 0.6, 0.0]]] * 2)
    cams = tcam.look_at_view_transform(2.0, torch.tensor([30.0, 30.0]),
                                       torch.tensor([40.0, 40.0]))
    faces = torch.tensor([[0, 1, 2]])
    plain = tras.render_mesh_lambert(verts, faces, cams, 32)
    tinted = tras.render_mesh_lambert(
        verts, faces, cams, 32, colors=torch.tensor([[1.0, 1.0, 1.0],
                                                     [1.0, 0.5, 0.0]]))
    assert torch.equal(tinted[0], plain[0])
    fg = tinted[1, :, :, 0] < 0.999
    assert int(fg.sum()) > 20
    torch.testing.assert_close(tinted[1][fg][:, 1], tinted[1][fg][:, 0] * 0.5)
    assert tinted[1, 0, 0].tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("face_chunk", [1, 2])
def test_equal_depths_draw_the_first_face(face_chunk):
    """Two coincident triangles (the second on a copy of the first's
    verts), shaded by their first vertex's index: every covered pixel
    shows the first, within a chunk (argmin) and across chunks."""
    tri = [[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.0, 0.6, 0.0]]
    verts = torch.tensor([tri + tri])
    cams = tcam.look_at_view_transform(2.0, 30.0, 40.0)
    faces = torch.tensor([[0, 1, 2], [3, 4, 5]])
    vview, v2d, zs = tras._project(verts, cams, 32)
    zbuf, shade = tras._rasterize(
        vview, v2d, zs, faces, 32, face_chunk,
        lambda f, w0, w1, w2: f[None, :, :1].float())
    covered = torch.isfinite(zbuf)
    assert int(covered.sum()) > 20
    assert bool((shade[covered] == 0).all())


# ----------------------------------------------------------- resume
def test_resumed_epoch_equals_the_uninterrupted_run(birds, tmp_path):
    """ANIGAN trained 2 epochs straight equals 1 epoch, a checkpoint and a
    resumed second epoch, bit for bit: modules, optimizers, counters,
    extra state and every random stream, the deformation-noise stream
    included."""
    args = ANIGAN_TINY + birds + ["calc_fid=False"]

    def train(epochs, version, *extra):
        cfg = compose(CONF_DIR, [*args, f"train.num_epochs={epochs}",
                                 f"output_root={tmp_path}",
                                 f"version={version}", *extra])
        trainer = loop.Trainer(cfg, "cpu")
        trainer.fit()
        return trainer

    straight = train(2, "a", "save_ckpts=False")
    train(1, "b", "save_ckpts=True")
    resumed = train(2, "c", "save_ckpts=False",
                    f"train.ckpt_dir={tmp_path / 'anigan' / 'b' / 'ckpts'}")
    assert "deform" in straight.checkpoint_payload()["rng"]
    assert straight.state.step == resumed.state.step > 0
    assert_same(straight.checkpoint_payload(), resumed.checkpoint_payload())
