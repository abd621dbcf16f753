"""The port's CLI, run_network_torch.py, at small widths on the CPU: in a
subprocess it trains HoloGAN, π-GAN and the 2D families through the JAX
package's conf tree (dc_gan with a checkpoint and a resume from it) and
loads no JAX module; in-process it refuses what it cannot run with a clear
message."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import run_network_torch
from tests.conftest import CONF_DIR, REPO_ROOT
from lightning_gan_zoo_tpu.config import compose as jax_compose
from lightning_gan_zoo_tpu_torch.config import compose

#: the suite runs several files at once (pytest-xdist workers) on a few
#: cores: two torch threads per worker keep them off each other's cores
torch.set_num_threads(2)

SMALL = ["+expt=hologan", "dataset=synthetic", "calc_fid=False",
         "save_ckpts=False", "~figures", "precision=32",
         "generator.in_planes=4", "discriminator.out_planes=4",
         "model.noise_dim=8", "train.batch_size=2", "dataset.n=12",
         "train.num_epochs=1"]
PIGAN_SMALL = ["+expt=pigan", "machine=local", "dataset=synthetic",
               "~figures", "model.noise_dim=16", "nerf.siren_dim_hidden=32",
               "nerf.siren_num_layers=2", "nerf.n_pts_per_ray=4",
               "nerf.n_pts_per_ray_fine=4", "train.features_disc=8",
               "resolution_annealing.resolutions=[8,16,32]",
               "variable_batch_size.batch_sizes=[4,2,2]",
               "resolution_annealing.update_epochs=[1,2]",
               "train.num_epochs=3", "dataset.n=16"]
#: the 2D families at tiny widths, under the bf16 policy (precision 16)
SMALL_2D = ["dataset=synthetic", "calc_fid=False", "~figures",
            "train.img_size=16", "train.batch_size=4",
            "train.features_disc=4", "train.features_gen=4",
            "model.noise_dim=8", "generator.nfilter=4",
            "generator.nfilter_max=8", "discriminator.nfilter=4",
            "discriminator.nfilter_max=8", "dataset.n=48"]
FOREIGN = ("jax", "jaxlib", "flax", "optax", "orbax",
           "lightning_gan_zoo_tpu")


def _run_cli(args):
    """run_network_torch.main(args) in a fresh interpreter; prints the
    top-level packages of every loaded module that the port must not
    load."""
    code = (
        "import sys; import run_network_torch as r; "
        f"rc = r.main({args!r}); "
        f"print('FOREIGN', sorted({{m.split('.')[0] for m in sys.modules}}"
        f" & set({FOREIGN!r}))); sys.exit(rc)")
    env = {**os.environ, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_trains_hologan_without_jax(tmp_path):
    out = _run_cli(SMALL + [f"output_root={tmp_path}", "--device", "cpu"])
    assert out.returncode == 0, out.stderr
    line = re.search(r"^epoch 0 \[.*\] (.*)$", out.stdout, re.M)
    assert line, out.stdout
    for k in ("d_loss", "g_loss", "q_loss", "images_per_sec"):
        assert re.search(rf"\b{k}=\d", line.group(1)), line.group(1)
    assert "FOREIGN []" in out.stdout
    run = tmp_path / "hologan" / "version_0"
    assert (run / "metrics.csv").exists()
    assert {p.name for p in (run / "images").iterdir()} == {
        "Real_step6.png", "Fake_step6.png"}


def test_cli_trains_pigan_through_its_schedules_without_jax(tmp_path):
    """π-GAN's own config at tiny widths, bf16 policy (the trunk's plain
    version on the CPU): three epochs at 8, 16 and 32 px with batches 4, 2,
    2, the fold clamped to what 16 images fill (2, 4, then 1 under ×4
    accumulation), each epoch's losses logged."""
    out = _run_cli(PIGAN_SMALL + [f"output_root={tmp_path}", "--device",
                                  "cpu"])
    assert out.returncode == 0, out.stderr
    epochs = re.findall(r"^epoch (\d) \[.*\] (.*)$", out.stdout, re.M)
    assert [e for e, _ in epochs] == ["0", "1", "2"], out.stdout
    for _, line in epochs:
        for k in ("d_loss", "r1", "g_loss", "images_per_sec"):
            assert re.search(rf"\b{k}=-?\d", line), line
    assert "Training resolution → 16" in out.stdout
    assert "Training resolution → 32" in out.stdout
    assert "FOREIGN []" in out.stdout
    # micro-steps: 2 folded supersteps × 2, 4 × 2, 1 × (1 + 1)·4
    run = tmp_path / "pigan" / "version_0"
    assert {p.name for p in (run / "images").iterdir()} == {
        f"{kind}_step{s}.png" for kind in ("Real", "Fake")
        for s in (4, 12, 20)}


@pytest.mark.parametrize("extra,message", [
    (["generator.resample=shear"], "shear"),
    (["calc_fid=True"], "calc_fid"),
    (["eval_only=true"], "eval_only"),
    (["+expt=anigan"], "not yet ported"),
    (["num_sp=2"], "num_sp"),
    (["save_ckpts_async=true"], "save_ckpts_async"),
])
def test_cli_refuses_unported(extra, message, tmp_path, capsys):
    rc = run_network_torch.main(SMALL + extra + [f"output_root={tmp_path}",
                                                 "--device", "cpu"])
    assert rc != 0
    assert message in capsys.readouterr().err


def test_cli_refuses_figure_callbacks(tmp_path, capsys):
    rc = run_network_torch.main([a for a in SMALL if a != "~figures"]
                                + [f"output_root={tmp_path}",
                                   "--device", "cpu"])
    assert rc != 0
    assert "figure callbacks" in capsys.readouterr().err


@pytest.mark.parametrize("expt,keys", [
    ("wgan", ("d_loss", "g_loss")),
    ("wgan_gp", ("d_loss", "gp", "g_loss")),
    ("gan_stability_r1", ("d_loss", "r1", "g_loss"))])
def test_cli_trains_2d_family_without_jax(expt, keys, tmp_path):
    out = _run_cli([f"+expt={expt}", *SMALL_2D, "train.num_epochs=1",
                    "save_ckpts=False", f"output_root={tmp_path}",
                    "--device", "cpu"])
    assert out.returncode == 0, out.stderr
    line = re.search(r"^epoch 0 \[.*\] (.*)$", out.stdout, re.M)
    assert line, out.stdout
    for k in keys + ("images_per_sec",):
        assert re.search(rf"\b{k}=-?\d", line.group(1)), line.group(1)
    assert "FOREIGN []" in out.stdout


def test_cli_dc_gan_checkpoints_and_resumes_without_jax(tmp_path):
    """Two epochs with save_ckpts=True leave one checkpoint, model_epoch-1;
    a second run with train.ckpt_dir resumes there and trains epoch 2."""
    args = ["+expt=dc_gan", *SMALL_2D, "train.ema_decay=0.999",
            f"output_root={tmp_path}", "--device", "cpu"]
    first = _run_cli(args + ["train.num_epochs=2", "save_ckpts=True",
                             "version=first"])
    assert first.returncode == 0, first.stderr
    ckpts = tmp_path / "dc_gan" / "first" / "ckpts"
    assert [p.name for p in ckpts.iterdir()] == ["model_epoch-1"]
    second = _run_cli(args + ["train.num_epochs=3", f"train.ckpt_dir={ckpts}",
                              "version=second"])
    assert second.returncode == 0, second.stderr
    assert f"Resuming from {ckpts / 'model_epoch-1'} at epoch 2, step 24" \
        in second.stdout
    epochs = re.findall(r"^epoch (\d) \[.*\] (.*)$", second.stdout, re.M)
    assert [e for e, _ in epochs] == ["2"], second.stdout
    for k in ("d_loss", "g_loss"):
        assert re.search(rf"\b{k}=-?\d", epochs[0][1])
    assert "FOREIGN []" in first.stdout and "FOREIGN []" in second.stdout
    assert [p.name for p in (tmp_path / "dc_gan" / "second" / "ckpts"
                             ).iterdir()] == ["model_epoch-2"]


def test_cli_device_cuda_without_card_fails(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = run_network_torch.main(SMALL + [f"output_root={tmp_path}"])
    assert rc != 0
    assert "CUDA" in capsys.readouterr().err
    assert not (tmp_path / "hologan").exists()


def test_compose_matches_jax_package():
    args = SMALL + ["generator.view_args.azimuth_low=200"]
    assert compose(CONF_DIR, args) == jax_compose(CONF_DIR, args)


def test_package_imports_no_jax():
    pkg = Path(REPO_ROOT) / "lightning_gan_zoo_tpu_torch"
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|"
        r"lightning_gan_zoo_tpu)\b", re.M)
    files = list(pkg.rglob("*.py")) + [Path(REPO_ROOT) / "run_network_torch.py",
                                       Path(REPO_ROOT) / "chip_smoke.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders
