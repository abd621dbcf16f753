"""The port's preemption rescue (runtime/loop.py::Trainer.fit) for real: a
run_network_torch.py subprocess training a tiny dc_gan on the CPU gets
SIGTERM mid-run, finishes its superstep, writes <output_root>/dc_gan/
ckpts_rescue with meta ``rescue: true`` and exits 0; a second run resumes
from the rescue and continues at the next epoch. Every wait is bounded."""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from tests.conftest import REPO_ROOT
from lightning_gan_zoo_tpu_torch.runtime.checkpoint import CheckpointManager

TINY = ["+expt=dc_gan", "dataset=synthetic", "calc_fid=False", "~figures",
        "save_ckpts=True", "train.img_size=16", "train.batch_size=4",
        "train.features_disc=4", "train.features_gen=4",
        "model.noise_dim=8", "dataset.n=48", "--device", "cpu"]


def _start(args, log: Path):
    env = {**os.environ, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}
    with log.open("w") as f:
        return subprocess.Popen(
            [sys.executable, str(REPO_ROOT / "run_network_torch.py"), *args],
            cwd=REPO_ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)


def _wait_for(log: Path, needle: str, proc, timeout: float) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if needle in log.read_text(errors="replace"):
            return True
        if proc.poll() is not None:
            return needle in log.read_text(errors="replace")
        time.sleep(0.1)
    return False


def test_sigterm_rescue_and_resume(tmp_path):
    out = tmp_path / "run"
    log = tmp_path / "train.log"
    proc = _start(TINY + ["train.num_epochs=500", f"output_root={out}",
                          "version=v0"], log)
    try:
        assert _wait_for(log, "epoch 1 [", proc, 120), log.read_text()[-2000:]
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    text = log.read_text()
    assert rc == 0, text[-2000:]
    assert f"[rescue] caught signal {int(signal.SIGTERM)}" in text
    assert "[rescue] checkpointed epoch" in text
    rescue = list((out / "dc_gan" / "ckpts_rescue").glob("model_*"))
    assert len(rescue) == 1, rescue
    meta = json.loads((rescue[0] / "train_meta.json").read_text())
    assert meta["rescue"] is True and meta["version"] == "v0"
    assert "best_fid" in meta and "fid_calibrated" in meta
    epoch = int(meta["epoch"])
    assert epoch >= 1 and f"epoch {epoch} [" in text
    assert f"epoch {epoch + 1} [" not in text
    assert list((out / "dc_gan" / "v0" / "ckpts").glob("model_*"))

    log2 = tmp_path / "resume.log"
    proc2 = _start(TINY + [f"train.num_epochs={epoch + 2}",
                           f"train.ckpt_dir={out / 'dc_gan' / 'v0' / 'ckpts'}",
                           f"output_root={tmp_path / 'resumed'}",
                           "version=v0"], log2)
    try:
        rc2 = proc2.wait(timeout=120)
    finally:
        if proc2.poll() is None:
            proc2.kill()
            proc2.wait(timeout=30)
    text2 = log2.read_text()
    assert rc2 == 0, text2[-2000:]
    assert f"Resuming from {rescue[0]}" in text2, text2[:2000]
    assert f"epoch {epoch + 1} [" in text2
    assert f"epoch {epoch} [" not in text2


def _ckpt(root: Path, name: str, epoch: int):
    path = root / name
    path.mkdir(parents=True)
    torch.save({"epoch": epoch}, path / "state.pt")
    (path / "train_meta.json").write_text(json.dumps({"epoch": epoch}))
    return path


def test_select_resume_scans_the_runs_own_rescue_dir(tmp_path):
    """``extra_rescue_dirs`` (the Trainer passes its run's own
    ckpts_rescue) compete with the configured directory by epoch; a tie
    goes to the rescue, an older rescue loses."""
    best = _ckpt(tmp_path / "old_run" / "v0" / "ckpts", "model_epoch-3", 3)
    elsewhere = tmp_path / "requeue" / "exp" / "ckpts_rescue"
    assert CheckpointManager.select_resume(
        best.parent, extra_rescue_dirs=[elsewhere]) == best
    rescue = _ckpt(elsewhere, "model_epoch-3", 3)
    assert CheckpointManager.select_resume(
        best.parent, extra_rescue_dirs=[elsewhere]) == rescue
    assert CheckpointManager.select_resume(best.parent) == best
    newer = _ckpt(tmp_path / "old_run" / "v0" / "ckpts", "model_epoch-5", 5)
    assert CheckpointManager.select_resume(
        best.parent, extra_rescue_dirs=[elsewhere]) == newer
    assert CheckpointManager.select_resume(
        None, extra_rescue_dirs=[elsewhere]) is None


@pytest.mark.parametrize("newer", [True, False])
def test_rescue_retention_keeps_a_newer_epoch(tmp_path, newer):
    """A rescue save never deletes a rescue of a newer epoch (another run
    of the same experiment) and replaces an older one."""
    mgr = CheckpointManager(tmp_path)
    other = _ckpt(tmp_path, "model_epoch-7", 7 if newer else 1)
    mgr.save_best({"w": torch.ones(2)}, epoch=4, fid=None,
                  meta={"rescue": True})
    assert (tmp_path / "model_epoch-4").exists()
    assert other.exists() == newer
