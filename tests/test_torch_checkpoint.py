"""Checkpoint and resume of the port (runtime/checkpoint.py and the
Trainer's save and resume), on the CPU at small widths.

  * For each 2D family, training two epochs straight equals training one
    epoch, checkpointing, and resuming for the second, bit for bit: both
    modules with their buffers, both optimizer states, the G weight EMA, the
    counters and every random stream (z, the WGAN-GP α).
  * A π-GAN resume across a resolution and batch-size boundary keeps the
    fade-in α, the iteration count, the resolution and the batch size, and
    continues bit for bit.
  * The retention and resume arbitration cases of the JAX package's
    tests/test_resume.py, with the port's staging names.
"""
import json
import pickle

import pytest
import torch

from tests.conftest import CONF_DIR
from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.runtime import loop
from lightning_gan_zoo_tpu_torch.runtime.checkpoint import CheckpointManager

#: the suite runs several files at once (pytest-xdist workers) on a few
#: cores: two torch threads per worker keep them off each other's cores
torch.set_num_threads(2)

SMALL_2D = ["dataset=synthetic", "calc_fid=False", "~figures",
            "precision=32", "train.img_size=16", "train.batch_size=4",
            "train.features_disc=4", "train.features_gen=4",
            "model.noise_dim=8", "dataset.n=24", "train.ema_decay=0.9"]
RESNET = ["generator.nfilter=4", "generator.nfilter_max=8",
          "discriminator.nfilter=4", "discriminator.nfilter_max=8"]
PIGAN = ["+expt=pigan", "machine=local", "dataset=synthetic",
         "model.noise_dim=16", "nerf.siren_dim_hidden=32",
         "nerf.siren_num_layers=2", "nerf.n_pts_per_ray=4",
         "nerf.n_pts_per_ray_fine=4", "train.features_disc=8",
         "train.img_size=32", "precision=32", "dataset.n=16",
         "calc_fid=False", "~figures",
         # boundary at epoch 1: resolution 8 → 16 and batch 2 → 4
         "resolution_annealing.resolutions=[8,16,32]",
         "resolution_annealing.update_epochs=[1,5]",
         "variable_batch_size.batch_sizes=[2,4,4]"]


def _train(args, root, version):
    cfg = compose(CONF_DIR, [*args, f"output_root={root}",
                             f"version={version}"])
    trainer = loop.Trainer(cfg, "cpu")
    trainer.fit()
    return trainer


def assert_same(a, b, where="state"):
    """Nested dicts / lists of tensors and numbers, equal bit for bit."""
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype \
            and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("expt", ["dc_gan", "wgan", "wgan_gp",
                                  "gan_stability_r1"])
def test_resumed_epoch_equals_the_uninterrupted_run(expt, tmp_path):
    args = [f"+expt={expt}", *SMALL_2D,
            *(RESNET if expt == "gan_stability_r1" else ())]
    straight = _train(args + ["train.num_epochs=2", "save_ckpts=False"],
                      tmp_path, "a")
    first = _train(args + ["train.num_epochs=1", "save_ckpts=True"],
                   tmp_path, "b")
    ckpt_dir = tmp_path / expt / "b" / "ckpts"
    assert sorted(p.name for p in ckpt_dir.iterdir()) == ["model_epoch-0"]
    resumed = _train(args + ["train.num_epochs=2", "save_ckpts=False",
                             f"train.ckpt_dir={ckpt_dir}"], tmp_path, "c")
    assert first.epoch == 1 and resumed.epoch == straight.epoch == 2
    assert resumed.state.step == straight.state.step > first.state.step
    assert_same(resumed.checkpoint_payload(), straight.checkpoint_payload())


def test_two_saves_leave_one_checkpoint(tmp_path):
    tr = _train(["+expt=dc_gan", *SMALL_2D, "train.num_epochs=2",
                 "save_ckpts=True"], tmp_path, "run")
    ckpt_dir = tmp_path / "dc_gan" / "run" / "ckpts"
    assert [p.name for p in ckpt_dir.iterdir()] == ["model_epoch-1"]
    payload, meta = CheckpointManager.restore(ckpt_dir / "model_epoch-1")
    assert meta["epoch"] == 1 and meta["fid"] is None
    assert_same(payload, tr.checkpoint_payload())


def test_pigan_resume_across_an_annealing_boundary(tmp_path):
    straight = _train(PIGAN + ["train.num_epochs=3", "save_ckpts=False"],
                      tmp_path, "a")
    _train(PIGAN + ["train.num_epochs=2", "save_ckpts=True"], tmp_path, "b")
    resumed = _train(PIGAN + [
        "train.num_epochs=3", "save_ckpts=False",
        f"train.ckpt_dir={tmp_path / 'pigan' / 'b' / 'ckpts'}"],
        tmp_path, "c")
    # the epoch schedules fast-forwarded across the boundary
    assert resumed.task.training_resolution == 16
    assert resumed.current_batch_size == 4
    assert resumed.epoch == straight.epoch == 3
    # the fade-in decayed after its reset at epoch 1 and was restored
    assert 0.0 < float(resumed.state.extra["alpha"]) < 1.0
    assert resumed.state.extra["iterations"] > 0
    assert_same(resumed.checkpoint_payload(), straight.checkpoint_payload())


def test_a_checkpoint_that_cannot_be_read_raises(tmp_path):
    bad = tmp_path / "ckpts" / "model_epoch-3"
    bad.mkdir(parents=True)
    (bad / "train_meta.json").write_text(json.dumps({"epoch": 3}))
    (bad / "state.pt").write_bytes(b"not a checkpoint")
    with pytest.raises(pickle.UnpicklingError):
        CheckpointManager.restore(bad)
    cfg = compose(CONF_DIR, ["+expt=dc_gan", *SMALL_2D, "train.num_epochs=5",
                             f"train.ckpt_dir={tmp_path / 'ckpts'}",
                             f"output_root={tmp_path}"])
    with pytest.raises(pickle.UnpicklingError):
        loop.Trainer(cfg, "cpu").fit()
    (bad / "state.pt").unlink()
    with pytest.raises(FileNotFoundError):
        loop.Trainer(cfg, "cpu").fit()


def _put(root, name, epoch, **extra):
    d = root / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "train_meta.json").write_text(json.dumps({"epoch": epoch, **extra}))
    return d


def test_find_ckpt_ignores_staging_dirs(tmp_path):
    """A process killed mid-save leaves its staging directory behind; it is
    never a resume candidate."""
    d = tmp_path / "ckpts"
    _put(d, "model_epoch-12.partial-4242", 12)
    assert CheckpointManager.find_ckpt(d) is None
    _put(d, "model_epoch-11", 11)
    assert CheckpointManager.find_ckpt(d) == d / "model_epoch-11"


def test_retention_keeps_newer_epochs_and_replaces_the_rest(tmp_path):
    """Save-then-delete: a save removes older checkpoints but never a newer
    epoch's."""
    d = tmp_path / "ckpts"
    mgr = CheckpointManager(d)
    _put(d, "model_epoch-9", 9)
    _put(d, "model_epoch-2", 2)
    mgr.save_best({"x": torch.ones(2)}, epoch=3, fid=None)
    assert sorted(p.name for p in d.iterdir()) == ["model_epoch-3",
                                                   "model_epoch-9"]
    assert CheckpointManager.find_ckpt(d).name == "model_epoch-9"
    mgr.save_best({"x": torch.zeros(2)}, epoch=10, fid=12.345)
    assert [p.name for p in d.iterdir()] == ["model_best-12.35"]
    payload, meta = CheckpointManager.restore(d / "model_best-12.35")
    assert meta == {"epoch": 10, "fid": 12.345}
    assert torch.equal(payload["x"], torch.zeros(2))
    assert CheckpointManager(d, save_ckpts=False).save_best(
        {}, epoch=11, fid=None) is None


def test_select_resume_prefers_newest(tmp_path):
    """Rescue-vs-best arbitration: the rescue wins only while it is the
    newest state."""
    ckpts, rescue = tmp_path / "ckpts", tmp_path / "ckpts_rescue"
    best = _put(ckpts, "model_best-12.34", 9)
    assert CheckpointManager.select_resume(ckpts) == best
    r = _put(rescue, "model_epoch-11", 11)
    assert CheckpointManager.select_resume(ckpts) == r
    _put(rescue, "model_epoch-11", 9)            # same epoch → rescue
    assert CheckpointManager.select_resume(ckpts).name == "model_epoch-11"
    _put(rescue, "model_epoch-11", 3)            # stale rescue → best
    assert CheckpointManager.select_resume(ckpts) == best
    for f in best.iterdir():
        f.unlink()
    best.rmdir()
    assert CheckpointManager.select_resume(ckpts).name == "model_epoch-11"
    assert CheckpointManager.select_resume(None) is None


def test_select_resume_requeue_chain_finds_newest_rescue(tmp_path):
    exp = tmp_path / "output" / "dc_gan"
    ckpts = exp / "version_0" / "ckpts"
    best = _put(ckpts, "model_best-12.34", 4)
    old_rescue = _put(exp / "version_0" / "ckpts_rescue", "model_epoch-7", 7)
    assert CheckpointManager.select_resume(ckpts) == old_rescue
    exp_rescue = _put(exp / "ckpts_rescue", "model_epoch-9", 9)
    assert CheckpointManager.select_resume(ckpts) == exp_rescue
    (best / "train_meta.json").write_text(json.dumps({"epoch": 12}))
    assert CheckpointManager.select_resume(ckpts) == best
