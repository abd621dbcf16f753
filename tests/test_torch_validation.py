"""The port's validation stage on the CPU at tiny widths (dc_gan, 16 px,
features 8, 8 FID samples in batches of 4): InceptionMetrics, its real-side
cache, the Trainer's best-FID checkpoint policy and its resume, and
``eval_only`` through the CLI. The policy is the JAX Trainer's
(lightning_gan_zoo_tpu/runtime/loop.py::validate and ``_init_state``)."""
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import run_network_torch
from tests.conftest import CONF_DIR
from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.config.registry import instantiate
from lightning_gan_zoo_tpu_torch.eval import inception, metrics_callback
from lightning_gan_zoo_tpu_torch.eval.metrics_callback import InceptionMetrics
from lightning_gan_zoo_tpu_torch.runtime import loop
from lightning_gan_zoo_tpu_torch.runtime.checkpoint import CheckpointManager
from lightning_gan_zoo_tpu_torch.runtime.state import create_train_state

#: the suite runs several files at once (pytest-xdist workers) on a few
#: cores: two torch threads per worker keep them off each other's cores
torch.set_num_threads(2)

TINY = ["+expt=dc_gan", "dataset=synthetic", "train.img_size=16",
        "train.batch_size=4", "train.features_disc=8",
        "train.features_gen=8", "model.noise_dim=8", "dataset.n=16",
        "val.fid_n_samples=8", "+val.fid_batch_size=4", "~figures"]


@pytest.fixture(autouse=True)
def no_weights_file(tmp_path, monkeypatch):
    """No FID weights at the drop-in path: the random-init Inception."""
    monkeypatch.setattr(inception, "DEFAULT_WEIGHTS_PATH",
                        tmp_path / "no_weights.pth")


def _cfg(tmp_path, *extra):
    return compose(CONF_DIR, TINY + [f"dataset.root={tmp_path / 'data'}",
                                     f"output_root={tmp_path / 'out'}",
                                     *extra])


def test_metrics_compute_and_real_cache(tmp_path, monkeypatch):
    """compute() gives finite *_uncalibrated keys; the real activations of
    a file-backed val split (MNIST idx files) are cached beside the dataset
    root under a name that carries `torch`, with no temporary file left; a
    second instance reads the cache without touching the dataset; another
    img_size misses it."""
    import chip_smoke
    chip_smoke.write_mnist(n_train=16, n_val=8, root=tmp_path / "data")
    cfg = _cfg(tmp_path, "dataset=mnist",
               f"filepaths.mnist_parent_directory={tmp_path / 'data'}")
    task = instantiate(cfg.model.lm, cfg, str(tmp_path), device="cpu")
    metrics = InceptionMetrics(cfg, task, "cpu")
    assert metrics.batch_size == 4 and not metrics.calibrated
    out = metrics.compute(None, torch.Generator().manual_seed(1))
    assert set(out) == {"fid_uncalibrated", "kid_uncalibrated"}
    assert all(math.isfinite(v) for v in out.values())
    assert out["fid_uncalibrated"] >= 0
    root = Path(str(cfg.dataset.root))
    assert root.is_relative_to(tmp_path)
    assert sorted(p.name for p in root.iterdir() if p.is_file()) == [
        "inception_cache_16px_n8_rnd_torch.npz"]
    cache = root / "inception_cache_16px_n8_rnd_torch.npz"
    acts = np.load(cache)["act"]
    assert acts.shape == (8, 2048)

    def no_dataset(*a, **kw):
        raise AssertionError("the cache was not read")

    monkeypatch.setattr(metrics_callback, "instantiate", no_dataset)
    second = InceptionMetrics(cfg, task, "cpu")
    assert second._cache_path() == cache
    np.testing.assert_array_equal(second._real_activations().numpy(), acts)
    other = InceptionMetrics(_cfg(tmp_path, "dataset=mnist",
                                  f"filepaths.mnist_parent_directory="
                                  f"{tmp_path / 'data'}",
                                  "train.img_size=32"), task, "cpu")
    assert other._cache_path() != cache


def test_synthetic_reals_write_nothing_at_the_default_root(tmp_path):
    """The synthetic split reads no files: with the config's own
    dataset.root (a fixed path outside the run), validation caches nothing
    and leaves that root as it found it."""
    cfg = compose(CONF_DIR, TINY + [f"output_root={tmp_path / 'out'}"])
    root = Path(str(cfg.dataset.root))
    before = sorted(root.iterdir()) if root.exists() else None
    task = instantiate(cfg.model.lm, cfg, str(tmp_path), device="cpu")
    metrics = InceptionMetrics(cfg, task, "cpu")
    assert metrics._cache_path() is None
    metrics._real_activations()
    assert (sorted(root.iterdir()) if root.exists() else None) == before


def _trainer(tmp_path, *extra):
    trainer = loop.Trainer(_cfg(tmp_path, "calc_fid=True", "save_ckpts=True",
                                *extra), "cpu")
    trainer.state = create_train_state(trainer.task, steps_per_epoch=1)
    return trainer


def _script(trainer, fids, calibrated=False):
    """Stub the evaluator: compute() returns the next FID of ``fids``."""
    trainer.metrics_eval.calibrated = calibrated
    tag = "" if calibrated else "_uncalibrated"
    seq = iter(fids)
    trainer.metrics_eval.compute = lambda params, gen: {
        f"fid{tag}": next(seq), f"kid{tag}": 0.0}


def _ckpts(trainer):
    return sorted(p.name for p in trainer.ckpt.dir.iterdir())


@pytest.mark.parametrize("calibrated", [False, True])
def test_best_fid_selection_follows_the_jax_rules(tmp_path, calibrated):
    """FIDs 5, 7, 3 at epochs 0, 1, 2: saved at epochs 0 and 2 (improved:
    no FID yet, or lower than the best), not at 1. An uncalibrated FID
    selects but never names a checkpoint; the meta carries best_fid and
    fid_calibrated."""
    trainer = _trainer(tmp_path)
    _script(trainer, [5.0, 7.0, 3.0], calibrated)
    names = []
    for epoch in range(3):
        trainer.epoch = epoch
        trainer.validate(epoch)
        names.append(_ckpts(trainer))
    if calibrated:
        assert names == [["model_best-5.00"], ["model_best-5.00"],
                         ["model_best-3.00"]]
    else:
        assert names == [["model_epoch-0"], ["model_epoch-0"],
                         ["model_epoch-2"]]
    meta = json.loads((trainer.ckpt.dir / names[-1][0] / "train_meta.json")
                      .read_text())
    assert meta == {"epoch": 2, "fid": 3.0 if calibrated else None,
                    "best_fid": 3.0, "fid_calibrated": calibrated}
    assert trainer.best_fid == 3.0


@pytest.mark.parametrize("flip", [False, True])
def test_resume_restores_best_fid_unless_calibration_flipped(tmp_path, flip):
    first = _trainer(tmp_path, "version=first")
    _script(first, [4.5])
    first.validate(0)
    ckpt_dir = first.ckpt.dir
    second = _trainer(tmp_path, "version=second",
                      f"train.ckpt_dir={ckpt_dir}")
    second.metrics_eval.calibrated = flip
    second.resume()
    assert second.epoch == 1
    assert second.best_fid == (float("inf") if flip else 4.5)


def test_resume_reads_a_meta_without_the_calibration_flag(tmp_path):
    """An older meta with only ``fid`` counts as calibrated."""
    first = _trainer(tmp_path, "version=first")
    path = first.ckpt.save_best(first.checkpoint_payload(), epoch=0,
                                fid=12.5)
    assert json.loads((path / "train_meta.json").read_text())["fid"] == 12.5
    second = _trainer(tmp_path, "version=second",
                      f"train.ckpt_dir={first.ckpt.dir}")
    second.metrics_eval.calibrated = True
    second.resume()
    assert second.best_fid == 12.5


def test_cli_trains_with_fid_then_evaluates_without_writing(tmp_path, capsys):
    """calc_fid=True through run_network_torch.main: the epoch prints and
    logs finite fid_uncalibrated / kid_uncalibrated and keeps the best-FID
    checkpoint; eval_only=true on that run prints `eval …`, exits 0 and
    writes no checkpoint. (Each FID takes ~15 s here: a 2048² Newton–Schulz
    square root on two CPU threads.)"""
    base = TINY + [f"dataset.root={tmp_path / 'data'}",
                   f"output_root={tmp_path / 'out'}", "calc_fid=True",
                   "--device", "cpu"]
    rc = run_network_torch.main(base + ["train.num_epochs=1",
                                        "save_ckpts=True", "version=train"])
    printed = capsys.readouterr().out
    assert rc == 0
    fids = re.findall(r"fid_uncalibrated=(\S+) kid_uncalibrated=(\S+)",
                      printed)
    assert len(fids) == 1 and all(math.isfinite(float(v))
                                  for pair in fids for v in pair)
    run = tmp_path / "out" / "dc_gan" / "train"
    with open(run / "metrics.csv") as f:
        header = f.readline()
    assert "fid_uncalibrated" in header and "kid_uncalibrated" in header
    (ckpt,) = (run / "ckpts").iterdir()
    meta = json.loads((ckpt / "train_meta.json").read_text())
    assert meta["fid_calibrated"] is False and meta["fid"] is None
    # printed to 3 decimals
    assert meta["best_fid"] == pytest.approx(float(fids[0][0]), abs=5e-4)

    rc = run_network_torch.main(base + ["eval_only=true", "version=eval",
                                        f"train.ckpt_dir={run / 'ckpts'}"])
    printed = capsys.readouterr().out
    assert rc == 0
    assert f"Resuming from {ckpt}" in printed
    line = re.search(r"^eval fid_uncalibrated=(\S+) kid_uncalibrated=(\S+)$",
                     printed, re.M)
    assert line and all(math.isfinite(float(v)) for v in line.groups())
    assert not (tmp_path / "out" / "dc_gan" / "eval" / "ckpts").exists()
    assert CheckpointManager.find_ckpt(run / "ckpts") == ckpt
