"""The training loop (counterpart of lightning_gan_zoo_tpu/runtime/loop.py),
for one device.

Builds the task on the device it is given, streams shuffled epochs of
stacked superstep batches from the EpochLoader, runs the superstep, logs the
epoch means and ``perf/images_per_sec``, and at each validation writes the
Real grid and the Fake grid generated from fixed noise (with the EMA of G's
parameters when ``train.ema_decay`` > 0) and, with ``save_ckpts``, a
checkpoint (runtime/checkpoint.py). ``train.ckpt_dir`` resumes from the
checkpoint there: the next epoch, the epoch schedules fast-forwarded without
resetting the restored extra state, and every random stream where the
saved run left it, so a resumed run continues as the uninterrupted run
would have.

The epoch schedules are the JAX Trainer's: ``variable_batch_size`` and
resolution annealing change the batch size and the training resolution at
their epochs (with the fade-in alpha reset), an epoch-scheduled
``accumulate_grad_batches`` turns accumulation on, and the loader is rebuilt
every epoch. ``train.fold_steps = K`` runs K consecutive supersteps over one
loader stack of K·n_micro micro-batches, with the JAX loader's clamp of K to
what the dataset can fill, so each epoch sees the same images as in JAX;
the JAX package's gain from folding, one dispatch for K supersteps, is not
reproduced here.

Features of the JAX Trainer that are not ported yet (FID/KID, figures,
eval_only, asynchronous checkpoints, the preemption rescue, multi-device
axes, profiling) raise NotImplementedError when switched on; none is
skipped quietly.
"""
from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config.node import Config
from ..config.registry import instantiate
from ..data.pipeline import EpochLoader
from ..figures.image_io import make_grid, unnormalise
from ..utils.logging import ExperimentLogger
from .checkpoint import CheckpointManager
from .state import create_train_state
from .steps import microbatch_count, superstep


def unported_features(cfg: Config) -> List[str]:
    """The switched-on config features this package cannot run yet."""
    found = []
    if cfg.get("calc_fid", False) and cfg.val.get("use_fid", True):
        found.append("calc_fid=True (FID/KID; pass calc_fid=False)")
    if cfg.get("save_ckpts_async", False):
        found.append("save_ckpts_async=true (asynchronous checkpoints)")
    if cfg.get("figures"):
        found.append("figure callbacks (pass '~figures')")
    if cfg.get("eval_only", False):
        found.append("eval_only=true")
    if (cfg.get("nerf") or {}).get("remat", False):
        found.append("nerf.remat=true")
    for key in ("num_gpus", "num_sp", "num_tp"):
        if int(cfg.get(key, 1) or 1) > 1:
            found.append(f"{key} > 1 (multi-device)")
    for key in ("zero_opt", "fsdp", "profile"):
        if cfg.get(key, False):
            found.append(f"{key}=true")
    for key in ("fast_dev_run", "verbose_shape"):
        if cfg.debug.get(key, False):
            found.append(f"debug.{key}=true")
    return found


def _resolve_version(cfg: Config, output_root: Path) -> str:
    """cfg.version, a cluster job id, else the next free version_N."""
    v = cfg.get("version")
    if v is not None:
        return str(v)
    for env in ("SLURM_JOB_ID", "SUBMITIT_JOB_ID"):
        if os.environ.get(env):
            return os.environ[env]
    base = output_root / cfg.name
    existing = [int(p.name.split("_")[-1]) for p in base.glob("version_*")
                if p.name.split("_")[-1].isdigit()] if base.is_dir() else []
    return f"version_{max(existing) + 1 if existing else 0}"


def _dataset_kwargs(cfg: Config) -> dict:
    return dict(img_size=int(cfg.train.img_size),
                n_channels=int(cfg.train.channels_img),
                data_mean=float(cfg.train.data_mean),
                data_std=float(cfg.train.data_std))


class Trainer:
    def __init__(self, cfg: Config, device):
        unported = unported_features(cfg)
        if unported:
            raise NotImplementedError(
                "not yet ported to lightning_gan_zoo_tpu_torch: "
                + "; ".join(unported))
        self.device = torch.device(device)
        # Explicit, since cuDNN defaults to TF32 for float32 convolutions.
        # Under precision 16 the convolutions and matmuls run in bf16
        # through autocast; what stays float32 (view geometry, the spectral
        # norm's power iteration) is meant to be full float32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.cfg = cfg
        self.seed = int(cfg.get("seed", 42))
        out_root = Path(cfg.get("output_root", "output"))
        self.version = _resolve_version(cfg, out_root)
        self.logging_dir = out_root / cfg.name / self.version
        self.logger = ExperimentLogger(self.logging_dir)
        # new checkpoints land in this run's directory; train.ckpt_dir is
        # only scanned for the resume
        self.ckpt = CheckpointManager(self.logging_dir / "ckpts",
                                      save_ckpts=bool(cfg.get("save_ckpts",
                                                              True)))
        self.ema_decay = float(cfg.train.get("ema_decay") or 0.0)
        self.task = instantiate(cfg.model.lm, cfg, str(self.logging_dir),
                                device=self.device)
        self.disc_freq = int(cfg.optimisation.disc_freq)
        self.gen_freq = int(cfg.optimisation.gen_freq)
        self.current_batch_size = self._initial_batch_size()
        self._active_fold = 1
        self.epoch = 0
        self._fixed_noise = self.task.sample_z(
            8, generator=self._generator(7))
        self.state = None

    def _generator(self, offset: int) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(self.seed + offset)

    # -------------------------------------------------- epoch schedules
    def _initial_batch_size(self) -> int:
        if "variable_batch_size" in self.cfg:
            return int(self.cfg.variable_batch_size.batch_sizes[0])
        return int(self.cfg.train.batch_size)

    def _accum_factor(self, epoch: Optional[int] = None) -> int:
        epoch = self.epoch if epoch is None else epoch
        node = self.cfg.get("accumulate_grad_batches", 1)
        if isinstance(node, (int, float)):
            return max(int(node), 1)
        start = int(node.get("start_epoch", 0))
        return int(node.get("accumulation_factor", 1)) if epoch >= start \
            else 1

    def _batch_size_at(self, epoch: int) -> int:
        """The batch size the variable_batch_size schedule sets at
        ``epoch``."""
        bs = self._initial_batch_size()
        if "variable_batch_size" not in self.cfg:
            return bs
        ups = list(self.cfg.variable_batch_size.update_epochs)
        sizes = list(self.cfg.variable_batch_size.batch_sizes)
        for e, up in enumerate(ups):
            if up <= epoch and e + 1 < len(sizes):
                bs = int(sizes[e + 1])
        return bs

    def _fold_at(self, dataset_len: int, batch_size: int, accum: int) -> int:
        """train.fold_steps, clamped so one fold span fits the dataset."""
        fold = max(1, int(self.cfg.train.get("fold_steps") or 1))
        span = batch_size * microbatch_count(self.disc_freq, self.gen_freq,
                                             accum)
        return min(fold, max(1, dataset_len // max(span, 1)))

    def _epoch_superstep_table(self, dataset_len: int,
                               num_epochs: int) -> List[int]:
        """The supersteps of every epoch, from the batch-size, accumulation
        and fold schedules, as the loader will count them: the LR schedules
        map an update count to its epoch through this table."""
        table = []
        for e in range(num_epochs):
            bs, accum = self._batch_size_at(e), self._accum_factor(e)
            span = bs * microbatch_count(self.disc_freq, self.gen_freq, accum)
            fold = self._fold_at(dataset_len, bs, accum)
            table.append((dataset_len // (span * fold)) * fold)
        return table

    def _update_epoch_schedules(self, replay: bool = False):
        """Variable batch size and resolution annealing at this epoch.
        ``replay`` fast-forwards them after a resume without resetting the
        restored fade-in alpha."""
        cfg = self.cfg
        if "variable_batch_size" in cfg:
            self.current_batch_size = self._batch_size_at(self.epoch)
            if self.epoch in list(cfg.variable_batch_size.update_epochs):
                print(f"Batch size for this epoch: "
                      f"{self.current_batch_size}")
        if bool(cfg.get("use_resolution_annealing", False)):
            ups = list(cfg.resolution_annealing.update_epochs)
            res = list(cfg.resolution_annealing.resolutions)
            if self.epoch in ups and ups.index(self.epoch) + 1 < len(res):
                new_res = int(res[ups.index(self.epoch) + 1])
                self.task.increase_resolution(new_res)
                if self.state is not None and not replay:
                    self.state.extra = self.task.reset_alpha(self.state.extra)
                print(f"Training resolution → {new_res}")

    def _make_train_loader(self) -> EpochLoader:
        ds = instantiate(self.cfg.dataset.train, **_dataset_kwargs(self.cfg))
        accum = self._accum_factor()
        self._active_fold = self._fold_at(len(ds), self.current_batch_size,
                                          accum)
        n_micro = microbatch_count(self.disc_freq, self.gen_freq, accum)
        return EpochLoader(ds, self.current_batch_size,
                           n_micro=n_micro * self._active_fold,
                           seed=self.seed)

    def _to_device(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        """[n_micro, B, H, W, C] numpy images → [n_micro, B, C, H, W] on the
        device."""
        img = torch.from_numpy(batch["image"]).to(self.device,
                                                  non_blocking=True)
        return {"image": img.permute(0, 1, 4, 2, 3).contiguous()}

    # ------------------------------------------------------ checkpoints
    def checkpoint_payload(self) -> dict:
        """The whole training state: both modules (buffers included), both
        optimizers, the EMA twin, the counters, the task's extra state and
        the state of every random stream the training step draws from."""
        st, task = self.state, self.task
        return {"generator": task.generator.state_dict(),
                "discriminator": task.discriminator.state_dict(),
                "g_opt": st.g_opt.state_dict(),
                "d_opt": st.d_opt.state_dict(),
                "g_ema": st.g_ema,
                "d_steps": st.d_steps, "g_steps": st.g_steps,
                "step": st.step, "extra": st.extra,
                "rng": {k: g.get_state()
                        for k, g in task.generators().items()}}

    def load_checkpoint_payload(self, payload: dict):
        st, task = self.state, self.task
        task.generator.load_state_dict(payload["generator"])
        task.discriminator.load_state_dict(payload["discriminator"])
        st.g_opt.load_state_dict(payload["g_opt"])
        st.d_opt.load_state_dict(payload["d_opt"])
        if st.g_ema is not None:
            if payload["g_ema"] is None:
                raise ValueError("train.ema_decay > 0 but the checkpoint "
                                 "holds no G weight EMA")
            with torch.no_grad():
                for k, v in st.g_ema.items():
                    v.copy_(payload["g_ema"][k])
        st.d_steps, st.g_steps, st.step = (int(payload[k]) for k in
                                           ("d_steps", "g_steps", "step"))
        st.extra = {k: v.to(self.device) if torch.is_tensor(v) else v
                    for k, v in payload["extra"].items()}
        for name, gen in task.generators().items():
            gen.set_state(payload["rng"][name])

    def resume(self):
        """Restore from train.ckpt_dir when it holds a checkpoint; the run
        then starts at the epoch after the saved one."""
        path = CheckpointManager.select_resume(self.cfg.train.get("ckpt_dir"))
        if path is None:
            return
        payload, meta = CheckpointManager.restore(path)
        self.load_checkpoint_payload(payload)
        self.epoch = int(meta["epoch"]) + 1
        print(f"Resuming from {path} at epoch {self.epoch}, step "
              f"{self.state.step}", flush=True)
        resumed_at = self.epoch
        for e in range(resumed_at):
            self.epoch = e
            self._update_epoch_schedules(replay=True)
        self.epoch = resumed_at

    # ------------------------------------------------------------ train
    def fit(self):
        num_epochs = int(self.cfg.train.num_epochs)
        loader = self._make_train_loader()
        self.state = create_train_state(
            self.task, loader.steps_per_epoch() * self._active_fold,
            epoch_supersteps=self._epoch_superstep_table(len(loader.dataset),
                                                         num_epochs),
            ema=self.ema_decay > 0.0)
        self.resume()
        while self.epoch < num_epochs:
            self._update_epoch_schedules()
            loader = self._make_train_loader()
            accum, fold = self._accum_factor(), self._active_fold
            n_micro = loader.n_micro // fold
            epoch_metrics: Dict[str, list] = {}
            t_epoch = time.perf_counter()
            n_steps = 0
            for batch in loader.epoch(self.epoch):
                stack = self._to_device(batch)
                # fold consecutive supersteps over one loader stack; no
                # per-step device sync: metrics stay on the device until
                # the epoch ends
                for f in range(fold):
                    metrics = superstep(
                        self.task, self.state,
                        {k: v[f * n_micro:(f + 1) * n_micro]
                         for k, v in stack.items()},
                        self.disc_freq, self.gen_freq, accum, self.ema_decay)
                    for k, v in metrics.items():
                        epoch_metrics.setdefault(f"train/{k}", []).append(v)
                n_steps += 1
            means = {k: float(torch.stack(v).mean())
                     for k, v in epoch_metrics.items()}
            dt = time.perf_counter() - t_epoch   # after the fetch above
            means["perf/images_per_sec"] = (
                self.current_batch_size * loader.n_micro * n_steps
                / max(dt, 1e-9))
            self.logger.log_scalars(means, self.state.step)
            loss_str = " ".join(f"{k.split('/')[-1]}={v:.4f}"
                                for k, v in means.items())
            print(f"epoch {self.epoch} [{dt:.1f}s] {loss_str}", flush=True)
            if self.epoch % int(self.cfg.val.get("every_n_epochs", 1)) == 0:
                self.validate(self.state.step)
            self.epoch += 1

    def validate(self, global_step: int):
        """Real grid from the val set; Fake grid from the fixed noise; with
        save_ckpts, a checkpoint. Without FID every validation counts as an
        improvement, so the latest epoch's checkpoint is the one kept."""
        cfg = self.cfg
        mean, std = cfg.train.data_mean, cfg.train.data_std
        val_ds = instantiate(cfg.dataset.val, **_dataset_kwargs(cfg))
        real = val_ds.load(list(range(min(8, len(val_ds)))))["image"]
        self.logger.log_image(
            "Real", make_grid(unnormalise(real, mean, std), ncol=8),
            global_step)
        fake = self.task.generate(
            self._fixed_noise, generator=self._generator(10_000 + self.epoch),
            params=self.state.eval_g_params(self.task.generator))
        fake = fake.permute(0, 2, 3, 1).cpu().numpy()
        self.logger.log_image(
            "Fake", make_grid(unnormalise(fake[..., :3], mean, std), ncol=8),
            global_step)
        self.ckpt.save_best(self.checkpoint_payload(), epoch=self.epoch,
                            fid=None, meta={"best_fid": None})
