"""Checkpoint save and restore with best-FID retention (counterpart of
lightning_gan_zoo_tpu/runtime/checkpoint.py), with ``torch.save`` in place
of orbax.

A checkpoint is a directory ``model_best-{fid:.2f}`` (``model_epoch-N``
while there is no FID) holding ``state.pt``, the whole training state (see
runtime/loop.py::Trainer.checkpoint_payload), and ``train_meta.json`` (epoch,
FID). Its contents are tensors, dicts, lists and numbers, so
``torch.load(weights_only=True)`` reads them.

  * A save writes into a staging directory (``<tag>.partial-<pid>``) and
    renames it once both files are complete; ``find_ckpt`` never offers a
    staging name, so a run killed mid-save leaves nothing half-written to
    resume from.
  * Retention is save-then-delete: older checkpoints are removed only after
    the new one is in place, and never one of a newer epoch.
  * Saves are synchronous. A save or a restore that fails raises.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

STAGING = ".partial-"
STATE_FILE = "state.pt"
META_FILE = "train_meta.json"


class CheckpointManager:
    def __init__(self, ckpt_dir: str | Path, save_ckpts: bool = True):
        self.dir = Path(ckpt_dir)
        self.save_ckpts = bool(save_ckpts)
        if self.save_ckpts:
            self.dir.mkdir(parents=True, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save_best(self, payload: Dict[str, Any], *, epoch: int,
                  fid: Optional[float], meta: Optional[dict] = None
                  ) -> Optional[Path]:
        """Keep one checkpoint, named like the reference's
        model_best-{fid:.2f}. Returns its path (None when saving is off)."""
        if not self.save_ckpts:
            return None
        tag = (f"model_best-{fid:.2f}" if fid is not None
               else f"model_epoch-{epoch}")
        path = (self.dir / tag).absolute()
        olds = [old.absolute() for old in self.dir.glob("model_*")
                if old.absolute() != path and STAGING not in old.name
                and self.ckpt_epoch(old) <= epoch]
        staging = self.dir / f"{tag}{STAGING}{os.getpid()}"
        shutil.rmtree(staging, ignore_errors=True)
        staging.mkdir()
        torch.save(payload, staging / STATE_FILE)
        (staging / META_FILE).write_text(json.dumps(
            {"epoch": epoch, "fid": fid, **(meta or {})}))
        if path.exists():            # same tag: an identical fid
            shutil.rmtree(path)
        staging.rename(path)
        for old in olds:
            shutil.rmtree(old)
        return path

    # -- restore ------------------------------------------------------------
    @staticmethod
    def find_ckpt(ckpt_dir: Optional[str | Path]) -> Optional[Path]:
        """The checkpoint to resume from in ``ckpt_dir``: staging
        directories never count; with several (a crash between a save and
        its retention), the newest by recorded epoch (meta-less ones rank
        last), then by mtime."""
        if not ckpt_dir or not Path(ckpt_dir).is_dir():
            return None
        ckpts = [p for p in Path(ckpt_dir).glob("model_*")
                 if p.is_dir() and STAGING not in p.name]
        return max(ckpts, key=lambda p: (CheckpointManager.ckpt_epoch(p),
                                         p.stat().st_mtime), default=None)

    @staticmethod
    def select_resume(ckpt_dir: Optional[str | Path]) -> Optional[Path]:
        """The resume source: the checkpoint in ``ckpt_dir`` or the newest
        preemption rescue (a ``ckpts_rescue`` directory beside ``ckpt_dir``
        or one level up, where the JAX package's runs write them), whichever
        records the newer epoch; a tie goes to the rescue, written after
        that epoch's checkpoint. With ``ckpt_dir`` unset nothing is
        scanned: a fresh run never resumes on its own."""
        if not ckpt_dir:
            return None
        best = CheckpointManager.find_ckpt(ckpt_dir)
        found = (CheckpointManager.find_ckpt(Path(ckpt_dir).parents[k]
                                             / "ckpts_rescue")
                 for k in (0, 1))
        rescues = [r for r in found if r is not None]
        if not rescues:
            return best
        rescue = max(rescues, key=lambda p: (
            CheckpointManager.ckpt_epoch(p), p.stat().st_mtime))
        if best is None or (CheckpointManager.ckpt_epoch(rescue)
                            >= CheckpointManager.ckpt_epoch(best)):
            return rescue
        return best

    @staticmethod
    def ckpt_epoch(path: Path) -> int:
        """The epoch in a checkpoint's train_meta.json; -1 when the metadata
        is missing or unreadable."""
        meta_path = Path(path) / META_FILE
        if not meta_path.exists():
            return -1
        try:
            epoch = json.loads(meta_path.read_text()).get("epoch")
            return int(epoch) if epoch is not None else -1
        except (ValueError, TypeError, json.JSONDecodeError):
            return -1

    @staticmethod
    def restore(path: Path) -> Tuple[Dict[str, Any], dict]:
        """(payload on the CPU, meta) of the checkpoint at ``path``."""
        payload = torch.load(Path(path) / STATE_FILE, map_location="cpu",
                             weights_only=True)
        meta = json.loads((Path(path) / META_FILE).read_text())
        return payload, meta
