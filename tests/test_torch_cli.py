"""The port's CLI, run_network_torch.py, at small widths on the CPU: in a
subprocess it trains HoloGAN, π-GAN, ANIGAN (with its figures) and the 2D
families through the JAX package's conf tree (dc_gan with a checkpoint and
a resume from it, also on two gloo ranks with num_gpus=2, and a SIGTERM
rescue of a two-rank run), π-GAN on a grid of two ray-sharding ranks
(num_sp=2) with a resume on one rank, and loads no JAX module; in-process
it refuses what it cannot run with a clear message."""
import json
import os
import re
import signal
import subprocess
import sys
import time
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
    # zero_opt, fsdp and num_sp are ported: beside an unported switch the
    # refusal names that switch alone
    pytest.param(["num_gpus=2", "zero_opt=true", "num_sp=2", "num_tp=2"],
                 "num_tp", id="extra1-zero_opt"),
    # num_sp must divide the ranks (the JAX make_mesh rule)
    pytest.param(["num_gpus=2", "num_sp=3"],
                 "num_sp=3 x num_tp=1 does not divide the 2-device mesh",
                 id="extra2-num_sp"),
    (["num_tp=2"], "num_tp"),
    pytest.param(["zero_opt=true", "num_tp=2"], "num_tp",
                 id="extra4-zero_opt=true"),
    pytest.param(["num_gpus=2", "fsdp=true", "num_sp=2", "num_tp=2"],
                 "num_tp", id="extra5-fsdp=true"),
])
def test_cli_refuses_unported(extra, message, tmp_path, capsys):
    rc = run_network_torch.main(SMALL + extra + [f"output_root={tmp_path}",
                                                 "--device", "cpu"])
    assert rc != 0
    err = capsys.readouterr().err
    assert message in err
    assert "zero_opt" not in err and "fsdp" not in err


def test_cli_trains_anigan_with_figures_without_jax(tmp_path):
    """ANIGAN at tiny widths on procedural analysed data (8 images at 16 px,
    a 42-vertex mesh), bf16 policy, with its config's figures on
    (machine=local's SampleGrid and ANIGAN's FullShapeAnalysis, one folder
    per epoch): two epochs, each logging the silhouette loss."""
    from lightning_gan_zoo_tpu_torch.data.procedural import (
        overrides, write_analysed_birds)
    data = overrides(*write_analysed_birds(tmp_path / "birds", n=8,
                                           img_size=16, subdivisions=1))
    out = _run_cli(["+expt=anigan", "machine=local", *data,
                    "model.noise_dim=16", "nerf.siren_dim_hidden=32",
                    "nerf.siren_num_layers=2", "nerf.n_pts_per_ray=4",
                    "nerf.n_pts_per_ray_fine=4", "train.features_disc=8",
                    "train.img_size=16",
                    "resolution_annealing.resolutions=[8,16,16]",
                    "variable_batch_size.batch_sizes=[2,2,2]",
                    "train.num_epochs=2", f"output_root={tmp_path}",
                    "--device", "cpu"])
    assert out.returncode == 0, out.stderr
    epochs = re.findall(r"^epoch (\d) \[.*\] (.*)$", out.stdout, re.M)
    assert [e for e, _ in epochs] == ["0", "1"], out.stdout
    for _, line in epochs:
        for k in ("d_loss", "r1", "g_loss", "silhouette"):
            assert re.search(rf"\b{k}=-?\d", line), line
    assert "FOREIGN []" in out.stdout
    figures = tmp_path / "anigan" / "version_0" / "figures"
    for e in (0, 1):
        assert {p.name for p in (figures / f"epoch_{e}").iterdir()} == {
            "SampleGrid.png", "FullShapeAnalysis.png"}


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


def test_cli_dc_gan_without_val_split_still_checkpoints(tmp_path):
    """MNIST with only the train-* idx files (procedural digits, as
    chip_smoke.py writes them): validation prints that there is no val
    dataset, as the JAX Trainer does, draws the Fake grid and saves the
    epoch's checkpoint; the run ends rc 0."""
    import chip_smoke
    chip_smoke.write_mnist(n_train=48, n_val=0, root=tmp_path / "data")
    out = _run_cli(["+expt=dc_gan", "dataset=mnist",
                    f"filepaths.mnist_parent_directory={tmp_path / 'data'}",
                    *SMALL_2D[1:], "train.num_epochs=1", "save_ckpts=True",
                    "version=noval", f"output_root={tmp_path}", "--device",
                    "cpu"])
    assert out.returncode == 0, out.stderr
    assert "[val] no val dataset" in out.stdout
    assert re.search(r"^epoch 0 \[", out.stdout, re.M), out.stdout
    run = tmp_path / "dc_gan" / "noval"
    assert [p.name for p in (run / "ckpts").iterdir()] == ["model_epoch-0"]
    assert {p.name for p in (run / "images").iterdir()} == {"Fake_step12.png"}
    assert "FOREIGN []" in out.stdout


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
    for module in ("serving/export.py", "data/native_loader.py",
                   "utils/profiling.py", "ops/cuda/__init__.py"):
        assert pkg / module in files
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders


def test_cli_dc_gan_on_two_ranks_checkpoints_and_resumes(tmp_path):
    """num_gpus=2 on the CPU: two gloo ranks train two epochs of the global
    batch of 4 (6 supersteps of 2 rows × 2 micro-batches per rank and
    epoch) and leave one version directory that rank 0 alone wrote: one
    metrics row and one Real/Fake pair per epoch, one checkpoint. A 1-rank
    and a 2-rank run each resume from it at epoch 2."""
    args = ["+expt=dc_gan", *SMALL_2D, f"output_root={tmp_path}",
            "--device", "cpu"]
    first = _run_cli(args + ["num_gpus=2", "train.num_epochs=2",
                             "save_ckpts=True"])
    assert first.returncode == 0, first.stderr
    assert "[dist] num_gpus=2: world size 2, backend gloo" in first.stdout
    epochs = re.findall(r"^epoch (\d) \[.*\] (.*)$", first.stdout, re.M)
    assert [e for e, _ in epochs] == ["0", "1"], first.stdout
    assert "FOREIGN []" in first.stdout
    assert [p.name for p in (tmp_path / "dc_gan").iterdir()] == ["version_0"]
    run = tmp_path / "dc_gan" / "version_0"
    assert sorted(p.name for p in run.iterdir()) == [
        "ckpts", "images", "metrics.csv"]
    assert len((run / "metrics.csv").read_text().splitlines()) == 1 + 2
    assert {p.name for p in (run / "images").iterdir()} == {
        f"{kind}_step{s}.png" for kind in ("Real", "Fake") for s in (12, 24)}
    ckpts = run / "ckpts"
    assert [p.name for p in ckpts.iterdir()] == ["model_epoch-1"]
    for n in (1, 2):
        out = _run_cli(args + [f"num_gpus={n}", "train.num_epochs=3",
                               f"train.ckpt_dir={ckpts}", f"version=r{n}"])
        assert out.returncode == 0, out.stderr
        assert (f"Resuming from {ckpts / 'model_epoch-1'} at epoch 2, step "
                "24") in out.stdout
        epochs = re.findall(r"^epoch (\d) \[.*\] (.*)$", out.stdout, re.M)
        assert [e for e, _ in epochs] == ["2"], out.stdout
        for k in ("d_loss", "g_loss"):
            assert re.search(rf"\b{k}=-?\d", epochs[0][1])
        assert [p.name for p in (tmp_path / "dc_gan" / f"r{n}" / "ckpts"
                                 ).iterdir()] == ["model_epoch-2"]


def test_cli_pigan_on_two_sp_ranks_checkpoints_and_resumes(tmp_path):
    """num_gpus=2 num_sp=2 on the CPU: a grid of one data rank × two ray
    ranks trains π-GAN's first epoch (8 px, batch 4: each rank renders 32
    of every image's 64 rays), prints its grid and leaves a checkpoint in
    the one-device format, from which one rank resumes at epoch 1."""
    args = [*PIGAN_SMALL, f"output_root={tmp_path}", "save_ckpts=True",
            "--device", "cpu"]
    first = _run_cli(args + ["num_gpus=2", "num_sp=2",
                             "train.num_epochs=1"])
    assert first.returncode == 0, first.stderr
    assert "[dist] grid data=1 × sp=2" in first.stdout
    epochs = re.findall(r"^epoch (\d) \[.*\] (.*)$", first.stdout, re.M)
    assert [e for e, _ in epochs] == ["0"], first.stdout
    for k in ("d_loss", "r1", "g_loss"):
        assert re.search(rf"\b{k}=-?\d", epochs[0][1]), epochs[0][1]
    assert "FOREIGN []" in first.stdout
    ckpts = tmp_path / "pigan" / "version_0" / "ckpts"
    assert [p.name for p in ckpts.iterdir()] == ["model_epoch-0"]
    out = _run_cli(args + ["train.num_epochs=2", f"train.ckpt_dir={ckpts}",
                           "version=one"])
    assert out.returncode == 0, out.stderr
    assert f"Resuming from {ckpts / 'model_epoch-0'} at epoch 1" \
        in out.stdout
    assert "[dist]" not in out.stdout
    epochs = re.findall(r"^epoch (\d) \[.*\] (.*)$", out.stdout, re.M)
    assert [e for e, _ in epochs] == ["1"], out.stdout


def _sigterm_two_ranks(tmp_path, *extra) -> Path:
    """A 2-rank dc_gan run sent SIGTERM once its epoch 1 is logged: one
    rescue, every process exits 0, the rescue's epoch the last logged.
    Every wait is bounded. Returns the rescue checkpoint."""
    log = tmp_path / "train.log"
    env = {**os.environ, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}
    with log.open("w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(REPO_ROOT / "run_network_torch.py"),
             "+expt=dc_gan", *SMALL_2D, "num_gpus=2", "save_ckpts=False",
             "train.num_epochs=500", f"output_root={tmp_path}", "version=v0",
             *extra, "--device", "cpu"],
            cwd=REPO_ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
    try:
        t0 = time.monotonic()
        while "epoch 1 [" not in log.read_text(errors="replace"):
            assert proc.poll() is None and time.monotonic() - t0 < 120, \
                log.read_text()[-2000:]
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    text = log.read_text()
    assert rc == 0, text[-2000:]
    assert text.count("[rescue] checkpointed epoch") == 1, text[-2000:]
    rescue = list((tmp_path / "dc_gan" / "ckpts_rescue").iterdir())
    assert len(rescue) == 1, rescue
    meta = json.loads((rescue[0] / "train_meta.json").read_text())
    assert meta["rescue"] is True and meta["version"] == "v0"
    assert f"epoch {meta['epoch']} [" in text
    assert f"epoch {meta['epoch'] + 1} [" not in text
    return rescue[0]


def test_cli_sigterm_to_two_ranks_rescues_once(tmp_path):
    """SIGTERM to the launcher of a 2-rank run reaches both ranks; they
    agree to stop at the end of the epoch or of its validation, rank 0
    writes the one rescue and every process exits 0."""
    _sigterm_two_ranks(tmp_path)


def test_cli_sigterm_to_two_fsdp_ranks_rescues_the_full_state(tmp_path):
    """The same under fsdp (each rank holds its blocks of the parameters
    and the optimizer state): one rescue, exit 0, and the rescue's
    state.pt is the full state in the one-device format, every tensor of
    the shape a one-device run's checkpoint has; it resumes on one device
    at the next epoch."""
    from lightning_gan_zoo_tpu_torch.runtime.checkpoint import (
        CheckpointManager)
    from lightning_gan_zoo_tpu_torch.runtime.loop import Trainer
    rescue = _sigterm_two_ranks(tmp_path, "fsdp=true")
    payload, meta = CheckpointManager.restore(rescue)
    trainer = Trainer(compose(CONF_DIR, [
        "+expt=dc_gan", *SMALL_2D, f"output_root={tmp_path / 'one'}",
        "save_ckpts=False", "train.num_epochs=1"]), "cpu")
    trainer.fit()       # a one-device run's own state after an epoch
    want = trainer.checkpoint_payload()

    def shapes(tree):
        if torch.is_tensor(tree):
            return tuple(tree.shape)
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()
                    if k != "param_groups"}
        return None
    assert shapes(payload["generator"]) == shapes(want["generator"])
    assert shapes(payload["discriminator"]) == shapes(want["discriminator"])
    assert shapes(payload["g_opt"]) == shapes(want["g_opt"])
    assert shapes(payload["d_opt"]) == shapes(want["d_opt"])
    assert payload["g_opt"]["state"], "no optimizer state in the rescue"
    out = _run_cli(["+expt=dc_gan", *SMALL_2D,
                    f"output_root={tmp_path / 'resumed'}",
                    f"train.ckpt_dir={rescue.parent}",
                    f"train.num_epochs={meta['epoch'] + 2}", "--device",
                    "cpu"])
    assert out.returncode == 0, out.stderr
    assert f"Resuming from {rescue} at epoch {meta['epoch'] + 1}" \
        in out.stdout


def test_cli_two_ranks_fail_on_a_batch_they_cannot_split(tmp_path):
    """A global batch of 3 over 2 ranks fails in every rank with the JAX
    loader's error, and the launcher exits non-zero."""
    out = _run_cli(["+expt=dc_gan", *SMALL_2D, "train.batch_size=3",
                    "num_gpus=2", f"output_root={tmp_path}", "--device",
                    "cpu"])
    assert out.returncode != 0
    assert "global batch_size=3 must divide over 2 processes" in out.stderr
