"""The port's serving export against the JAX package's, on the same
converted weights, in float32 on the CPU: dc_gan's (z, seed) program, and
HoloGAN's and π-GAN's pose-conditioned (z, view_in, seed) programs, fed
the same numpy z and views. JAX's artifact comes from its own
``build_exported_generator`` (jax.export); the port's from
``torch.export`` and back through ``torch.export.save`` / ``load``.
Bounds: the families' generator parity bounds (dc_gan 1e-5, HoloGAN and
π-GAN 1e-4, as tests/test_torch_{gan2d,hologan,pigan}.py hold them)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import CONF_DIR
from lightning_gan_zoo_tpu.config import compose as jax_compose
from lightning_gan_zoo_tpu.config.registry import instantiate as jax_inst
from lightning_gan_zoo_tpu.serving import export as jax_export
from lightning_gan_zoo_tpu_torch import convert
from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.config.registry import instantiate
from lightning_gan_zoo_tpu_torch.serving import export

torch.set_num_threads(2)

FAMILIES = {
    "dc_gan": (["+expt=dc_gan", "dataset=synthetic", "calc_fid=False",
                "train.img_size=32", "train.features_gen=8",
                "train.features_disc=8", "model.noise_dim=16",
                "precision=32"],
               convert.dcgan_generator_state_dict, 1e-5),
    "hologan": (["+expt=hologan", "dataset=synthetic", "calc_fid=False",
                 "precision=32", "generator.in_planes=4",
                 "discriminator.out_planes=4", "model.noise_dim=8"],
                convert.generator_state_dict, 1e-4),
    "pigan": (["+expt=pigan", "machine=local", "dataset=synthetic",
               "calc_fid=False", "precision=32", "model.noise_dim=16",
               "nerf.siren_dim_hidden=32", "nerf.siren_num_layers=2",
               "nerf.n_pts_per_ray=4", "nerf.n_pts_per_ray_fine=4",
               "train.img_size=16", "~figures"],
              convert.pigan_generator_state_dict, 1e-4),
}
B = 2
#: azimuth, elevation, scale and translation all off their defaults
VIEWS = np.array([[math.radians(250), math.radians(80), 1.1, 0.3, -0.2, 0.1],
                  [math.radians(300), math.radians(100), 0.9, -0.1, 0.2,
                   -0.3]], np.float32)


def _random_g_vars(jtask, seed=0):
    """G's variables with every parameter N(0, 1/fan_in) and biases
    N(0, 0.1²) from numpy (state collections as the init made them)."""
    rng = np.random.default_rng(seed)
    g_vars, _ = jax.jit(jtask.init)(jax.random.PRNGKey(0))
    g_vars = jax.device_get(dict(g_vars))

    def fill(path, leaf):
        if jax.tree_util.keystr(path).endswith("['bias']"):
            return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        fan_in = max(int(np.prod(leaf.shape[:-1])), 1)
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)
                ).astype(np.float32)
    g_vars["params"] = jax.tree_util.tree_map_with_path(fill,
                                                        g_vars["params"])
    return g_vars


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_export_matches_jax(family, tmp_path):
    overrides, to_torch, atol = FAMILIES[family]
    pose = family != "dc_gan"
    jcfg = jax_compose(CONF_DIR, overrides)
    jtask = jax_inst(jcfg.model.lm, jcfg, str(tmp_path))
    g_vars = _random_g_vars(jtask)
    params = g_vars["params"]
    state = {k: v for k, v in g_vars.items() if k != "params"}
    jexp, _ = jax_export.build_exported_generator(
        jtask, params, state, jtask.initial_extra(), B, pose=pose)

    cfg = compose(CONF_DIR, overrides)
    task = instantiate(cfg.model.lm, cfg, str(tmp_path), device="cpu")
    task.generator.load_state_dict(to_torch(g_vars))
    program, info = export.build_exported_generator(task, B, pose=pose)
    assert info == {"dynamic": False, "fallback_reason": None}
    torch.export.save(program, str(tmp_path / "g.pt2"))
    served = torch.export.load(str(tmp_path / "g.pt2")).module()

    z = np.random.default_rng(1).uniform(-1, 1, (B, int(task.noise_dim))
                                         ).astype(np.float32)
    jargs = [jnp.asarray(z)] + ([jnp.asarray(VIEWS)] if pose else [])
    want = np.asarray(jexp.call(*jargs, jnp.int32(0)), np.float32)
    targs = [torch.from_numpy(z)] + ([torch.from_numpy(VIEWS)] if pose
                                     else [])
    with torch.no_grad():
        got = served(*targs, torch.tensor(0)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, atol=max(atol, 1e-5 * np.abs(
        want).max()))
