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
  * ``async_save`` (``save_ckpts_async``): ``save_best`` copies the payload
    to CPU tensors (a synchronising copy off the card) and returns; the
    ``torch.save`` and the rename finish on a background thread. The next
    save, or ``finalize()``, waits for it, then writes the deferred
    ``train_meta.json`` and only then deletes the superseded checkpoint.
    Until then the new directory has no meta, so ``find_ckpt`` ranks it
    last.
  * A save or a restore that fails raises; a failed background save raises
    at the next wait.
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

STAGING = ".partial-"
STATE_FILE = "state.pt"
META_FILE = "train_meta.json"


def _to_cpu(tree):
    """A copy of a payload with every tensor copied to the CPU (for a card
    tensor, a copy the host waits for)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, ckpt_dir: str | Path, save_ckpts: bool = True,
                 async_save: bool = False):
        self.dir = Path(ckpt_dir)
        self.save_ckpts = bool(save_ckpts)
        self.async_save = bool(async_save)
        self._executor: Optional[ThreadPoolExecutor] = None
        self._pending: Optional[Future] = None
        self._pending_meta: Optional[Tuple[Path, dict]] = None
        self._pending_cleanup: List[Path] = []
        if self.save_ckpts:
            self.dir.mkdir(parents=True, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save_best(self, payload: Dict[str, Any], *, epoch: int,
                  fid: Optional[float], meta: Optional[dict] = None
                  ) -> Optional[Path]:
        """Keep one checkpoint, named like the reference's
        model_best-{fid:.2f}. Returns its path (None when saving is off);
        with ``async_save`` the files land later (``finalize``)."""
        if not self.save_ckpts:
            return None
        self._flush_pending()
        tag = (f"model_best-{fid:.2f}" if fid is not None
               else f"model_epoch-{epoch}")
        path = (self.dir / tag).absolute()
        olds = [old.absolute() for old in self.dir.glob("model_*")
                if old.absolute() != path and STAGING not in old.name
                and self.ckpt_epoch(old) <= epoch]
        info = {"epoch": epoch, "fid": fid, **(meta or {})}
        if self.async_save:
            snapshot = _to_cpu(payload)
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    1, thread_name_prefix="ckpt")
            self._pending = self._executor.submit(self._commit, snapshot,
                                                  path, None)
            self._pending_meta = (path, info)
            self._pending_cleanup = olds
            return path
        self._commit(payload, path, info)
        for old in olds:
            shutil.rmtree(old)
        return path

    def _commit(self, payload, path: Path, info: Optional[dict]):
        """Write ``payload`` (and ``info``, when given) into a staging
        directory, then rename it to ``path``."""
        staging = self.dir / f"{path.name}{STAGING}{os.getpid()}"
        shutil.rmtree(staging, ignore_errors=True)
        staging.mkdir()
        torch.save(payload, staging / STATE_FILE)
        if info is not None:
            (staging / META_FILE).write_text(json.dumps(info))
        if path.exists():            # same tag: an identical fid
            shutil.rmtree(path)
        staging.rename(path)

    def _flush_pending(self):
        """Wait for a background save (raising its error), write its
        deferred meta, then delete the checkpoints it supersedes."""
        if self._pending is None:
            return
        pending, self._pending = self._pending, None
        pending.result()
        path, info = self._pending_meta
        (path / META_FILE).write_text(json.dumps(info))
        olds, self._pending_cleanup = self._pending_cleanup, []
        for old in olds:
            shutil.rmtree(old, ignore_errors=True)

    def finalize(self):
        """Land any background save (end of training or evaluation)."""
        try:
            self._flush_pending()
        finally:
            if self._executor is not None:
                self._executor.shutdown()
                self._executor = None

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
    def select_resume(ckpt_dir: Optional[str | Path],
                      extra_rescue_dirs: Sequence[str | Path] = ()
                      ) -> Optional[Path]:
        """The resume source: the checkpoint in ``ckpt_dir`` or the newest
        preemption rescue (a ``ckpts_rescue`` directory beside ``ckpt_dir``
        or one level up, where the runs write them, or one of
        ``extra_rescue_dirs``, the current run's own), whichever records
        the newer epoch; a tie goes to the rescue, written after that
        epoch's checkpoint. With ``ckpt_dir`` unset nothing is scanned: a
        fresh run never resumes on its own."""
        if not ckpt_dir:
            return None
        best = CheckpointManager.find_ckpt(ckpt_dir)
        dirs = {Path(d).absolute(): None for d in (
            Path(ckpt_dir).parent / "ckpts_rescue",
            Path(ckpt_dir).parent.parent / "ckpts_rescue",
            *extra_rescue_dirs)}
        found = (CheckpointManager.find_ckpt(d) for d in dirs)
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
