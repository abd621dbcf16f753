"""The port's serving export (serving/export.py) on the CPU at tiny widths:
the .pt2 round trip and its sidecar, the (z, seed) contract (same seed →
same images, another seed → other views), the pose-conditioned program
equal to eager generation, a symbolic batch serving 1, 3 and 5, bf16
weights, a checkpoint's weight EMA, the 2D family refusing
``serving.pose``, the CLI, and a kernel-bearing program that loads only
with the port's ops registered."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.conftest import CONF_DIR, REPO_ROOT
from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.config.registry import instantiate
from lightning_gan_zoo_tpu_torch.runtime.checkpoint import CheckpointManager
from lightning_gan_zoo_tpu_torch.serving import export

torch.set_num_threads(2)

DC = ["+expt=dc_gan", "dataset=synthetic", "calc_fid=False",
      "train.img_size=16", "train.features_gen=8", "train.features_disc=8",
      "model.noise_dim=8"]
HOLO = ["+expt=hologan", "dataset=synthetic", "calc_fid=False",
        "precision=32", "generator.in_planes=4",
        "discriminator.out_planes=4", "model.noise_dim=8"]
#: SIREN width 128: the JAX rule fuses the trunk (a kernel node in the
#: program) only at a multiple of 128
PIGAN = ["+expt=pigan", "machine=local", "dataset=synthetic",
         "calc_fid=False", "model.noise_dim=16", "nerf.siren_dim_hidden=128",
         "nerf.siren_num_layers=2", "nerf.n_pts_per_ray=4",
         "nerf.n_pts_per_ray_fine=4", "train.img_size=16", "~figures"]
FAMILIES = {"dc_gan": DC, "hologan": HOLO, "pigan": PIGAN}
VIEW = [0.6, 1.5, 1.0, 0.1, -0.1, 0.0]


def _export(tmp_path, overrides, name="g", batch=2, **kw):
    return export.export_generator(CONF_DIR, overrides, batch,
                                   tmp_path / f"{name}.pt2", device="cpu",
                                   **kw)


def _load(path):
    return torch.export.load(str(path)).module()


def _z(b, dim, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, dim)).astype(np.float32))


def _task(tmp_path, overrides):
    cfg = compose(CONF_DIR, overrides)
    return instantiate(cfg.model.lm, cfg, str(tmp_path), device="cpu")


def test_roundtrip_and_sidecar_dcgan(tmp_path):
    path, sidecar = _export(tmp_path, DC, batch=4)
    assert path.exists() and path.stat().st_size > 1000
    meta = json.loads(path.with_suffix(".pt2.json").read_text())
    assert meta == sidecar
    assert meta["expt"] == "dc_gan" and meta["batch"] == 4
    assert meta["z_dim"] == 8 and meta["img_size"] == 16
    assert meta["weights_dtype"] == "f32" and meta["device"] == "cpu"
    assert "fallback_reason" not in meta and "pose" not in meta
    assert "ops.cuda" not in meta["call"]       # no kernel in a 2D family
    g = _load(path)
    z = _z(4, 8)
    img = g(z, torch.tensor(0))
    assert img.shape == (4, 3, 16, 16)
    assert torch.isfinite(img).all()
    assert torch.equal(img, g(z, torch.tensor(5)))   # no randomness


@pytest.mark.parametrize("family", ["hologan", "pigan"])
def test_seed_gives_the_views(family, tmp_path):
    """(z, seed) → images: the same pair the same images, another seed
    other views (the JAX contract, tests/test_serving.py)."""
    path, sidecar = _export(tmp_path, FAMILIES[family])
    assert "import lightning_gan_zoo_tpu_torch.ops.cuda" in sidecar["call"]
    g = _load(path)
    z = _z(2, sidecar["z_dim"])
    a = g(z, torch.tensor(0))
    assert torch.isfinite(a).all()
    assert torch.equal(a, g(z, torch.tensor(0)))
    assert (a - g(z, torch.tensor(7))).abs().max() > 1e-4


@pytest.mark.parametrize("family", ["hologan", "pigan"])
def test_pose_program_equals_eager_generate(family, tmp_path):
    task = _task(tmp_path, FAMILIES[family])
    program, _ = export.build_exported_generator(task, 2, pose=True)
    z = _z(2, int(task.noise_dim), seed=3)
    views = torch.tensor([VIEW, [2.0, 1.2, 0.9, 0.0, 0.2, -0.1]])
    got = program.module()(z, views, torch.tensor(0))
    assert torch.equal(got, task.generate(z, view_in=views))
    other = program.module()(z, views.flip(0), torch.tensor(0))
    assert (got - other).abs().max() > 1e-4


def test_pose_rejects_2d_family(tmp_path):
    with pytest.raises(ValueError, match="view-conditioned"):
        _export(tmp_path, DC, pose=True)


@pytest.mark.parametrize("family", ["dc_gan", "hologan"])
def test_dynamic_batch(family, tmp_path):
    """One program serves batches 1, 3 and 5, each equal to the eager
    serving module at that batch on the same (z, seed)."""
    task = _task(tmp_path, FAMILIES[family])
    program, info = export.build_exported_generator(task, 4,
                                                    dynamic_batch=True)
    assert info == {"dynamic": True, "fallback_reason": None}
    torch.export.save(program, str(tmp_path / "dyn.pt2"))
    g = _load(tmp_path / "dyn.pt2")
    eager = export.ServingGenerator(task).eval()
    for b in (1, 3, 5):
        z = _z(b, int(task.noise_dim), seed=b)
        img = g(z, torch.tensor(5))
        assert img.shape[0] == b and torch.isfinite(img).all()
        np.testing.assert_allclose(img.numpy(),
                                   eager(z, torch.tensor(5)).numpy(),
                                   atol=1e-6)


def test_bf16_weights(tmp_path):
    """At the config's width (features 64) the weights are most of the
    file: bf16 halves it."""
    wide = [a for a in DC if not a.startswith("train.features")]
    p32, _ = _export(tmp_path, wide, name="g32")
    p16, sidecar = _export(tmp_path, wide, name="g16", dtype="bf16")
    assert sidecar["weights_dtype"] == "bf16"
    assert p16.stat().st_size < 0.66 * p32.stat().st_size
    z = _z(2, 8)
    a = _load(p32)(z, torch.tensor(0))
    b = _load(p16)(z, torch.tensor(0))
    assert torch.isfinite(b).all()
    # dc_gan trains under the bf16 policy, so its convolutions already
    # rounded the weights to bf16: the images barely move, if at all
    assert (a - b).abs().mean() < 0.05
    stored = torch.export.load(str(p16)).state_dict
    assert {t.dtype for t in stored.values() if t.is_floating_point()} \
        == {torch.bfloat16, torch.float32}     # BatchNorm's statistics stay
    assert all(t.dtype == torch.bfloat16 for k, t in stored.items()
               if k.endswith("weight") and t.dim() == 4)
    with pytest.raises(ValueError, match="f32|bf16"):
        _export(tmp_path, DC, name="bad", dtype="fp8")


def test_export_from_checkpoint_uses_the_weight_ema(tmp_path):
    """serving.ckpt restores G and puts the EMA twin in place of its
    parameters: the program reproduces generate with the EMA weights, not
    the live ones or the initialisation."""
    task = _task(tmp_path, DC)
    with torch.no_grad():
        for p in task.generator.parameters():
            p.add_(0.05)
    ema = {n: p.detach() * 0.5 for n, p in task.generator.named_parameters()}
    CheckpointManager(tmp_path / "ckpts").save_best(
        {"generator": task.generator.state_dict(), "g_ema": ema},
        epoch=3, fid=None)
    path, _ = _export(tmp_path, DC, ckpt=str(tmp_path / "ckpts"))
    z = _z(2, 8)
    want = task.generate(z, params=ema)
    got = _load(path)(z, torch.tensor(0))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert (got - task.generate(z)).abs().max() > 1e-3


@pytest.mark.parametrize("pose", [False, True])
def test_anigan_noise_comes_from_the_seed(tmp_path, pose):
    """ANIGAN's field reads noise in place of the deformed points without
    shape analyses: the program draws it from ``seed`` (one stream per
    field evaluation), so one seed repeats and another moves the images,
    with the view given too."""
    task = _task(tmp_path, ["+expt=anigan", "machine=local",
                            "dataset=synthetic", "calc_fid=False",
                            "model.noise_dim=16", "nerf.siren_dim_hidden=32",
                            "nerf.siren_num_layers=2",
                            "nerf.n_pts_per_ray=4",
                            "nerf.n_pts_per_ray_fine=4",
                            "train.img_size=8", "~figures"])
    streams = []
    real = export.hash_uniforms
    export.hash_uniforms = lambda *a, **kw: (
        streams.append(kw.get("stream", 0)) or real(*a, **kw))
    try:
        program, _ = export.build_exported_generator(task, 2, pose=pose)
    finally:
        export.hash_uniforms = real
    # the coarse and the fine pass each draw their own noise
    assert streams == ([1, 2] if pose else [0, 1, 2])
    g = program.module()
    z = _z(2, 16)
    args = (z, torch.tensor([VIEW, VIEW])) if pose else (z,)
    a = g(*args, torch.tensor(0))
    assert a.shape == (2, 4, 8, 8) and torch.isfinite(a).all()
    assert torch.equal(a, g(*args, torch.tensor(0)))
    assert (a - g(*args, torch.tensor(1))).abs().max() > 1e-4


def test_cli_and_loading_needs_the_ops(tmp_path):
    """The module's CLI writes the program; a fresh interpreter loads it
    only after importing the port's ops, as the sidecar's call line
    says."""
    out = tmp_path / "holo.pt2"
    assert export.main([*HOLO, "serving.batch=2", f"serving.out={out}",
                        "serving.pose=true", "--device", "cpu"]) == 0
    sidecar = json.loads(out.with_suffix(".pt2.json").read_text())
    assert sidecar["pose"] is True and sidecar["view_dim"] == 6
    code = ("import sys, torch\n"
            "try:\n"
            f"    torch.export.load({str(out)!r})\n"
            "    print('LOADED WITHOUT OPS')\n"
            "except Exception as e:\n"
            "    print('REFUSED', type(e).__name__)\n"
            "import lightning_gan_zoo_tpu_torch.ops.cuda\n"
            f"g = torch.export.load({str(out)!r}).module()\n"
            "img = g(torch.zeros(2, 8), torch.tensor([[0.5, 1.4, 1., 0., 0.,"
            " 0.]]).expand(2, 6), torch.tensor(0))\n"
            "print('SHAPE', tuple(img.shape))\n")
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "REFUSED" in proc.stdout and "SHAPE (2, 3, 64, 64)" in proc.stdout
