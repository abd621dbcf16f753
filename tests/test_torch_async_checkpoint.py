"""Asynchronous checkpoints (runtime/checkpoint.py, ``save_ckpts_async``),
as tests/test_runtime.py holds the JAX package's: the round trip after
``finalize``, the deferred meta, save-then-delete (the superseded
checkpoint stays until the new one has landed), the payload snapshotted
before ``save_best`` returns, a failed background save raised at the next
wait, and a training run through the CLI whose asynchronous checkpoint
equals a synchronous run's bit for bit."""
import json

import pytest
import torch

import run_network_torch
from lightning_gan_zoo_tpu_torch.runtime import checkpoint
from lightning_gan_zoo_tpu_torch.runtime.checkpoint import CheckpointManager

torch.set_num_threads(2)

SMALL_2D = ["+expt=dc_gan", "dataset=synthetic", "calc_fid=False",
            "~figures", "train.img_size=16", "train.batch_size=4",
            "train.features_disc=4", "train.features_gen=4",
            "model.noise_dim=8", "dataset.n=48", "train.num_epochs=2",
            "save_ckpts=True", "--device", "cpu"]


def _state():
    return {"w": torch.arange(4, dtype=torch.float32),
            "b": torch.ones(2, 3, dtype=torch.bfloat16),
            "opt": {"state": {0: {"step": torch.tensor(3.0)}},
                    "param_groups": [{"lr": 1e-3, "params": [0]}]},
            "rng": torch.ByteTensor([1, 2, 3]), "step": 7}


def test_async_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    state = _state()
    mgr.save_best(state, epoch=0, fid=12.3456)    # returns before the commit
    mgr.save_best(state, epoch=1, fid=8.1)        # lands the first one
    mgr.finalize()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["model_best-8.10"]
    meta = json.loads((tmp_path / "model_best-8.10" / "train_meta.json"
                       ).read_text())
    assert meta["epoch"] == 1 and abs(meta["fid"] - 8.1) < 1e-9
    payload, meta2 = CheckpointManager.restore(tmp_path / "model_best-8.10")
    assert meta2 == meta
    assert torch.equal(payload["w"], state["w"])
    assert payload["b"].dtype == torch.bfloat16
    assert torch.equal(payload["b"], state["b"])
    assert payload["opt"] == state["opt"] and payload["step"] == 7
    assert torch.equal(payload["rng"], state["rng"])


def test_save_then_delete_with_deferred_meta(tmp_path):
    """The superseded checkpoint disappears only after the new one has
    landed and its meta is written; until then the new one has no meta, so
    a resume still picks the old one."""
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save_best(_state(), epoch=0, fid=None)
    mgr.finalize()
    old = tmp_path / "model_epoch-0"
    assert (old / "train_meta.json").exists()
    new = mgr.save_best(_state(), epoch=1, fid=None)
    assert new == (tmp_path / "model_epoch-1").absolute()
    assert old.exists(), "deleted before the new checkpoint landed"
    assert not (new / "train_meta.json").exists()
    assert CheckpointManager.find_ckpt(tmp_path) == old
    mgr.finalize()
    assert not old.exists()
    assert json.loads((new / "train_meta.json").read_text())["epoch"] == 1
    assert CheckpointManager.find_ckpt(tmp_path) == new


def test_payload_is_snapshotted_before_return(tmp_path):
    """Training goes on while the save finishes: what is saved is the state
    at the call, not what the tensors hold later."""
    mgr = CheckpointManager(tmp_path, async_save=True)
    state = _state()
    mgr.save_best(state, epoch=0, fid=None)
    state["w"].add_(100.0)
    mgr.finalize()
    payload, _ = CheckpointManager.restore(tmp_path / "model_epoch-0")
    assert torch.equal(payload["w"], torch.arange(4, dtype=torch.float32))


def test_failed_background_save_raises_at_the_next_wait(tmp_path,
                                                       monkeypatch):
    def broken_save(obj, f):
        raise OSError("disk full")

    mgr = CheckpointManager(tmp_path, async_save=True)
    monkeypatch.setattr(checkpoint.torch, "save", broken_save)
    mgr.save_best(_state(), epoch=0, fid=None)    # the error stays pending
    with pytest.raises(OSError, match="disk full"):
        mgr.finalize()
    assert not (tmp_path / "model_epoch-0").exists()


def test_cli_async_checkpoint_equals_sync(tmp_path, capsys):
    """Two epochs of dc_gan through run_network_torch.py with
    save_ckpts_async=true and without: one checkpoint each, with meta, and
    the same state bit for bit (the CPU run is deterministic)."""
    found = {}
    for version, extra in (("sync", []), ("async",
                                          ["save_ckpts_async=true"])):
        assert run_network_torch.main(
            SMALL_2D + extra + [f"output_root={tmp_path}",
                                f"version={version}"]) == 0
        ckpts = sorted((tmp_path / "dc_gan" / version / "ckpts").iterdir())
        assert [p.name for p in ckpts] == ["model_epoch-1"]
        found[version] = CheckpointManager.restore(ckpts[0])
    assert "epoch 1 [" in capsys.readouterr().out
    (a, meta_a), (b, meta_b) = found["sync"], found["async"]
    assert meta_a == meta_b and meta_a["epoch"] == 1

    def same(x, y):
        if torch.is_tensor(x):
            return x.dtype == y.dtype and torch.equal(x, y)
        if isinstance(x, dict):
            return set(x) == set(y) and all(same(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(map(same, x, y))
        return x == y
    assert same(a, b)
