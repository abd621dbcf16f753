"""The training loop (counterpart of lightning_gan_zoo_tpu/runtime/loop.py),
on one device or as one rank of a data-parallel group.

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

With ``calc_fid`` (and ``val.use_fid``) every validation also computes
FID and KID (eval/metrics_callback.py) and keeps the best-FID checkpoint by
the JAX Trainer's rules: a checkpoint is saved when there is no FID yet or
when the selection FID (``fid``, else ``fid_uncalibrated``) is lower than
the best so far; only a calibrated FID names it; its meta carries
``best_fid`` and ``fid_calibrated``, and a resume restores the threshold
unless the calibration flipped. ``eval_only=true`` (``evaluate``) restores
train.ckpt_dir and runs one validation without training or saving.

The config's figures (figures/types.py, figures/anigan_figures.py) are built
with the Trainer, as the JAX Trainer builds them: only a missing dataset
(FileNotFoundError) skips one, any other error fails the run. Each
validation hands them the eval parameters and the metrics, with the
uncalibrated FID standing in for ``fid`` in their gating; a figure that
raises NotImplementedError is reported and skipped, and what a figure drew
is also logged as an image (a GIF's middle frame).

The runtime switches, as the JAX Trainer has them:
  * the preemption rescue: ``fit`` catches SIGTERM and SIGUSR1, finishes
    the superstep in flight, saves the state to
    ``<output_root>/<name>/ckpts_rescue`` (meta ``rescue: true``, the
    version, ``best_fid``, ``fid_calibrated``; the interrupted epoch counts
    as done), prints ``[rescue] checkpointed epoch N …``, restores the old
    handlers and returns; a resume from ``train.ckpt_dir`` also scans the
    run's own rescue directory;
  * ``save_ckpts_async``: checkpoints finish on a background thread
    (runtime/checkpoint.py); ``fit`` and ``evaluate`` land the last one;
  * ``profile=true``: ``torch.profiler`` over supersteps 2–6, a Chrome
    trace under ``<run>/trace`` (utils/profiling.py) that shows, beside the
    operators and kernels, the program's ``zoo.`` spans: each superstep
    and its D and G forward, backward and update, the Trainer's wait for
    the loader's next stack and its copy to the device;
  * ``debug.fast_dev_run``: one epoch, no folding, a break after the first
    superstep, then one validation;
  * ``debug.verbose_shape``: before training, a table of G's submodules
    (depth 2) with their output shapes for 2 samples at the training
    resolution; a failure is printed and the run goes on.
Data parallelism (``num_gpus`` > 1; parallel/dist.py): the Trainer runs on
every rank of the group that run_network_torch.py or torchrun made, with
the JAX Trainer's multi-process contract. ``train.batch_size`` is global and
each rank's EpochLoader holds its stripe of it; the supersteps per epoch
come from the per-rank length; the run version is rank 0's; a caught signal
is agreed between the ranks every ``PREEMPT_SYNC_EVERY`` loader steps and at
the epoch's end, and the rescue is saved once; rank 0 alone validates (the
grids, FID/KID, the figures) and writes logs, traces and checkpoints, and
its FID/KID are broadcast so that every rank makes the same best-FID
decision. ``zero_opt`` (ZeRO-1: each rank holds its blocks of the
optimizer state) and ``fsdp`` (ZeRO-3: of the parameters and the EMA twin
too; implies zero_opt) shard the state over the ranks by the JAX leaf rule
(parallel/sharding.py); on one rank they do nothing, as in the JAX
Trainer. Where the full state leaves the superstep every rank gathers it
at the same point (the JAX Trainer's ``gather_tree``): a checkpoint, the
rescue, validation and its figures, ``eval_only``, ``debug.verbose_shape``
and the end of ``fit``; a checkpoint is the full state in the one-device
format, so it resumes at any world size with or without sharding.
``num_sp`` > 1 makes the ranks a data × sp grid (parallel/dist.py): the
batch contract above holds over the data ranks (the loader's stripes, the
supersteps per epoch, the fold's clamp), the sp ranks of a data group
hold the same rows, and π-GAN's and ANIGAN's renderers split every
image's rays over them in the training step (nerf/renderer.py); the
2D families and HoloGAN leave the axis idle. The state shards over the
data ranks alone. ``num_tp`` > 1 adds a tp axis minor to both
(parallel/dist.py): each tp rank holds its blocks of the parameters the
JAX leaf rule cuts (``tp_min_shard`` its floor), with their optimizer
state and EMA twin, and the convolutions and denses run column-parallel
(parallel/tensor.py). Every rank-0 consumer of G (validation, the
figures, FID/KID, ``eval_only``, ``debug.verbose_shape``) runs inside
``_full_state()``, which every rank enters and which puts the whole
parameters in the modules, so rank 0 runs the one-device forward with no
tp collective; checkpoints and the rescue are gathered to the one-device
format as under fsdp.
"""
from __future__ import annotations

import contextlib
import os
import signal
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config.node import Config
from ..config.registry import instantiate
from ..data.pipeline import EpochLoader
from ..figures.image_io import make_grid, unnormalise
from ..figures.types import FigureContext
from ..parallel import dist
from ..utils.logging import ExperimentLogger
from ..utils.profiling import TraceCapture, span
from .checkpoint import CheckpointManager
from .optim import share_update_count
from .state import create_train_state, full_state
from .steps import map_batch, microbatch_count, superstep


#: on more than one rank, the ranks agree on a caught signal every this
#: many loader steps and at the epoch's end: each agreement is a collective
#: that waits for the slowest rank (the JAX Trainer's _PREEMPT_SYNC_EVERY)
PREEMPT_SYNC_EVERY = 8


def _resolve_version(cfg: Config, output_root: Path) -> str:
    """cfg.version, a cluster job id, else the next free version_N (rank
    0's: a rank scanning after rank 0 made version_N would pick N+1)."""
    v = cfg.get("version")
    if v is not None:
        return str(v)
    for env in ("SLURM_JOB_ID", "SUBMITIT_JOB_ID"):
        if os.environ.get(env):
            return os.environ[env]
    base = output_root / cfg.name
    existing = [int(p.name.split("_")[-1]) for p in base.glob("version_*")
                if p.name.split("_")[-1].isdigit()] if base.is_dir() else []
    return f"version_{dist.broadcast_int(max(existing) + 1 if existing else 0)}"


def _dataset_kwargs(cfg: Config) -> dict:
    return dict(img_size=int(cfg.train.img_size),
                n_channels=int(cfg.train.channels_img),
                data_mean=float(cfg.train.data_mean),
                data_std=float(cfg.train.data_std))


class Trainer:
    def __init__(self, cfg: Config, device):
        for key, have in (("num_sp", dist.sp_size()),
                          ("num_tp", dist.tp_size())):
            want = int(cfg.get(key, 1) or 1)
            if want != have:
                axis = key[4:]
                raise ValueError(f"{key}={want}, but this process's grid has "
                                 f"{axis}={have} of {dist.world_size()} "
                                 "ranks (start the ranks with dist.launch or "
                                 f"init with {axis}={key})")
        self.tp_min_shard = int(cfg.get("tp_min_shard", 8) or 8)
        self.device = torch.device(device)
        # Explicit, since cuDNN defaults to TF32 for float32 convolutions.
        # Under precision 16 the convolutions and matmuls run in bf16
        # through autocast; what stays float32 (view geometry, the spectral
        # norm's power iteration) is meant to be full float32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.cfg = cfg
        self.seed = int(cfg.get("seed", 42))
        self.is_main = dist.is_main_process()
        out_root = Path(cfg.get("output_root", "output"))
        self.version = _resolve_version(cfg, out_root)
        self.logging_dir = out_root / cfg.name / self.version
        self.logger = ExperimentLogger(self.logging_dir, enabled=self.is_main)
        # new checkpoints land in this run's directory; train.ckpt_dir is
        # only scanned for the resume; an evaluation (eval_only) writes
        # none and makes no checkpoint directory
        self._saves = bool(cfg.get("save_ckpts", True)) and not bool(
            cfg.get("eval_only", False))
        self.ckpt = CheckpointManager(
            self.logging_dir / "ckpts", save_ckpts=self._saves and self.is_main,
            async_save=bool(cfg.get("save_ckpts_async", False)))
        self.zero_opt = bool(cfg.get("zero_opt", False))
        self.fsdp = bool(cfg.get("fsdp", False))
        self.trace = TraceCapture(self.logging_dir / "trace",
                                  enabled=bool(cfg.get("profile", False))
                                  and self.is_main)
        self.fast_dev_run = bool(cfg.debug.get("fast_dev_run", False))
        self._preempted = False
        self.ema_decay = float(cfg.train.get("ema_decay") or 0.0)
        self.task = instantiate(cfg.model.lm, cfg, str(self.logging_dir),
                                device=self.device)
        self.figures = self._build_figures()
        self.metrics_eval = None
        if bool(cfg.get("calc_fid", False)) and bool(cfg.val.get("use_fid",
                                                                 True)):
            from ..eval.metrics_callback import InceptionMetrics
            self.metrics_eval = InceptionMetrics(
                cfg, self.task, self.device, logging_dir=str(self.logging_dir))
        self.best_fid = float("inf")
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

    def _build_figures(self) -> list:
        """The config's figures; one whose dataset is missing is skipped
        with a message, any other error fails the run."""
        figs = []
        monitor = ("fid" if self.cfg.figure_details.get("fid_callback", False)
                   else None)
        for name, node in (self.cfg.get("figures") or {}).items():
            try:
                figs.append(instantiate(node, self.cfg.figure_details,
                                        str(self.logging_dir),
                                        monitor=monitor))
            except FileNotFoundError as e:
                print(f"[figures] skipping {name} (missing data): {e}")
        return figs

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

    def _rank_span(self, dataset_len: int, batch_size: int, accum: int):
        """(the rank's stripe of the dataset, the rows one superstep takes
        from it), as the EpochLoader counts them: the stripes are the data
        ranks'."""
        world = dist.data_size()
        local = max(batch_size // world, 1)
        return (dataset_len // world,
                local * microbatch_count(self.disc_freq, self.gen_freq, accum))

    def _fold_at(self, dataset_len: int, batch_size: int, accum: int) -> int:
        """train.fold_steps (1 under fast_dev_run), clamped so one fold span
        fits the rank's stripe of the dataset."""
        fold = 1 if self.fast_dev_run else max(
            1, int(self.cfg.train.get("fold_steps") or 1))
        per_rank, span = self._rank_span(dataset_len, batch_size, accum)
        return min(fold, max(1, per_rank // max(span, 1)))

    def _epoch_superstep_table(self, dataset_len: int,
                               num_epochs: int) -> List[int]:
        """The supersteps of every epoch, from the batch-size, accumulation
        and fold schedules, as the loader will count them: the LR schedules
        map an update count to its epoch through this table."""
        table = []
        for e in range(num_epochs):
            bs, accum = self._batch_size_at(e), self._accum_factor(e)
            per_rank, span = self._rank_span(dataset_len, bs, accum)
            fold = self._fold_at(dataset_len, bs, accum)
            table.append((per_rank // (span * fold)) * fold)
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
                           seed=self.seed, process_index=dist.data_rank(),
                           process_count=dist.data_size())

    def _to_device(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        """[n_micro, B, H, W, C] numpy images → [n_micro, B, C, H, W] on the
        device, and the shape analyses (ANIGAN) as they are."""
        def move(a):
            return torch.from_numpy(a).to(self.device, non_blocking=True)
        with span("zoo.to_device"):
            out = {"image": move(batch["image"]).permute(0, 1, 4, 2, 3)
                   .contiguous()}
            if "shape_analysis" in batch:
                out["shape_analysis"] = map_batch(move,
                                                  batch["shape_analysis"])
        return out

    # ------------------------------------------------------ checkpoints
    def checkpoint_payload(self) -> dict:
        """The whole training state: both modules (buffers included), both
        optimizers, the EMA twin, the counters, the task's extra state and
        the state of every random stream the training step draws from.
        Sharded, it is gathered to the one-device format: every rank calls
        this at the same point."""
        st, task = self.state, self.task
        return {**full_state(task, st),
                "d_steps": st.d_steps, "g_steps": st.g_steps,
                "step": st.step, "extra": st.extra,
                "rng": {k: g.get_state()
                        for k, g in task.generators().items()}}

    def load_checkpoint_payload(self, payload: dict):
        """Restore a checkpoint; sharded, each rank takes its blocks of the
        full state (no collective)."""
        st, task, sh = self.state, self.task, self.state.sharding
        with sh.restoring() if sh is not None else contextlib.nullcontext():
            task.generator.load_state_dict(payload["generator"])
            task.discriminator.load_state_dict(payload["discriminator"])
        if sh is None:
            st.g_opt.load_state_dict(payload["g_opt"])
            st.d_opt.load_state_dict(payload["d_opt"])
        else:
            sh.g.load_optimizer_state(st.g_opt, payload["g_opt"])
            sh.d.load_optimizer_state(st.d_opt, payload["d_opt"])
        share_update_count(st.g_opt, int(payload["g_steps"]))
        share_update_count(st.d_opt, int(payload["d_steps"]))
        if st.g_ema is not None:
            if payload["g_ema"] is None:
                raise ValueError("train.ema_decay > 0 but the checkpoint "
                                 "holds no G weight EMA")
            if sh is not None:
                sh.load_ema(payload["g_ema"])
            else:
                with torch.no_grad():
                    for k, v in st.g_ema.items():
                        v.copy_(payload["g_ema"][k])
        st.d_steps, st.g_steps, st.step = (int(payload[k]) for k in
                                           ("d_steps", "g_steps", "step"))
        st.extra = {k: v.to(self.device) if torch.is_tensor(v) else v
                    for k, v in payload["extra"].items()}
        for name, gen in task.generators().items():
            gen.set_state(payload["rng"][name])

    def _rescue_dir(self) -> Path:
        """The preemption rescue's directory, ``<output_root>/<name>/
        ckpts_rescue``: shared by every version of the experiment, so a
        requeued run finds the newest rescue."""
        return self.logging_dir.parent / "ckpts_rescue"

    def resume(self):
        """Restore from train.ckpt_dir when it holds a checkpoint (or a
        newer rescue, the run's own included); the run then starts at the
        epoch after the saved one."""
        path = CheckpointManager.select_resume(
            self.cfg.train.get("ckpt_dir"),
            extra_rescue_dirs=[self._rescue_dir()])
        if path is None:
            return
        payload, meta = CheckpointManager.restore(path)
        self.load_checkpoint_payload(payload)
        self.epoch = int(meta["epoch"]) + 1
        self.best_fid = self._restored_best_fid(meta)
        print(f"Resuming from {path} at epoch {self.epoch}, step "
              f"{self.state.step}", flush=True)
        resumed_at = self.epoch
        for e in range(resumed_at):
            self.epoch = e
            self._update_epoch_schedules(replay=True)
        self.epoch = resumed_at

    def _restored_best_fid(self, meta: dict) -> float:
        """The best-FID threshold of a checkpoint's meta (``best_fid``, else
        ``fid``; 0.0 is a FID, not "unset"). Calibrated and uncalibrated FIDs
        are different scales, so a threshold saved under the other
        calibration is dropped; a meta without ``fid_calibrated`` counts as
        calibrated exactly when it has a ``fid``."""
        bf = meta.get("best_fid")
        if bf is None:
            bf = meta.get("fid")
        cal_saved = meta.get("fid_calibrated")
        if cal_saved is None:
            cal_saved = meta.get("fid") is not None
        cal_now = self._fid_calibrated()
        if bf is not None and cal_now is not None \
                and bool(cal_saved) != cal_now:
            print(f"[resume] FID calibration changed ({cal_saved} → "
                  f"{cal_now}); resetting the best-FID selection threshold")
            bf = None
        return float(bf) if bf is not None else float("inf")

    def _fid_calibrated(self) -> Optional[bool]:
        """Whether the FID evaluator has the FID weights; None without an
        evaluator."""
        if self.metrics_eval is None:
            return None
        return bool(self.metrics_eval.calibrated)

    # ------------------------------------------------------------ train
    def _on_signal(self, signum, frame):
        print(f"[rescue] caught signal {signum}; will checkpoint and exit at "
              "the next superstep boundary", flush=True)
        self._preempted = True

    def _stop_for_rescue(self, n_steps: Optional[int] = None) -> bool:
        """Whether to stop and save the rescue after loader step ``n_steps``
        (None: at the epoch's end, and after its validation). One process
        reads its own flag. On more than one rank, the ranks agree
        (``any_process_flag``) at every PREEMPT_SYNC_EVERY-th step, at the
        epoch's end and after its validation, and nowhere else: a rank that
        stopped alone would leave the others waiting in their next
        collective."""
        if dist.world_size() == 1:
            return self._preempted
        if n_steps is not None and n_steps % PREEMPT_SYNC_EVERY:
            return False
        self._preempted = dist.any_process_flag(self._preempted)
        return self._preempted

    def fit(self):
        num_epochs = 1 if self.fast_dev_run else int(self.cfg.train.num_epochs)
        old_handlers = []
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                old_handlers.append((sig, signal.signal(sig, self._on_signal)))
            except ValueError:          # not the main thread
                pass
        try:
            self._fit(num_epochs)
        finally:
            for sig, handler in old_handlers:
                signal.signal(sig, handler)
        if self.state.sharding is not None:
            self.state.sharding.finish()        # the trained G and D, whole
        self.ckpt.finalize()
        self.trace.close()

    def _fit(self, num_epochs: int):
        loader = self._make_train_loader()
        self.state = create_train_state(
            self.task, loader.steps_per_epoch() * self._active_fold,
            epoch_supersteps=self._epoch_superstep_table(len(loader.dataset),
                                                         num_epochs),
            ema=self.ema_decay > 0.0, zero_opt=self.zero_opt, fsdp=self.fsdp,
            tp_min_shard=self.tp_min_shard)
        self.resume()
        self._print_shapes()
        while self.epoch < num_epochs:
            self._update_epoch_schedules()
            loader = self._make_train_loader()
            accum, fold = self._accum_factor(), self._active_fold
            n_micro = loader.n_micro // fold
            epoch_metrics: Dict[str, list] = {}
            t_epoch = time.perf_counter()
            n_steps = 0
            # iterated by hand so that the wait for the next stack is a
            # span of its own; closed on every exit, as a for loop would
            with contextlib.closing(loader.epoch(self.epoch)) as stacks:
                while True:
                    with span("zoo.loader_wait"):
                        batch = next(stacks, None)
                    if batch is None:
                        break
                    stack = self._to_device(batch)
                    # fold consecutive supersteps over one loader stack; no
                    # per-step device sync: metrics stay on the device until
                    # the epoch ends
                    for f in range(fold):
                        metrics = superstep(
                            self.task, self.state,
                            map_batch(lambda v: v[f * n_micro:
                                                  (f + 1) * n_micro], stack),
                            self.disc_freq, self.gen_freq, accum,
                            self.ema_decay)
                        self.trace.tick()
                        for k, v in metrics.items():
                            epoch_metrics.setdefault(f"train/{k}",
                                                     []).append(v)
                    n_steps += 1
                    if self.fast_dev_run or self._stop_for_rescue(n_steps):
                        break
            means = {k: float(torch.stack(v).mean())
                     for k, v in epoch_metrics.items()}
            dt = time.perf_counter() - t_epoch   # after the fetch above
            # the global batch: every rank's images
            means["perf/images_per_sec"] = (
                self.current_batch_size * loader.n_micro * n_steps
                / max(dt, 1e-9))
            self.logger.log_scalars(means, self.state.step)
            loss_str = " ".join(f"{k.split('/')[-1]}={v:.4f}"
                                for k, v in means.items())
            print(f"epoch {self.epoch} [{dt:.1f}s] {loss_str}", flush=True)
            if self._stop_for_rescue():
                self._save_rescue()
                return
            if (self.epoch % int(self.cfg.val.get("every_n_epochs", 1)) == 0
                    or self.fast_dev_run):
                self.validate(self.state.step)
                # a signal caught during the validation (while the other
                # ranks wait for rank 0's metrics) stops the run here, not
                # at the end of the whole next epoch
                if self._stop_for_rescue():
                    self._save_rescue()
                    return
            self.epoch += 1

    def _save_rescue(self):
        """The current state into the rescue directory, by rank 0 (every
        rank gathers a sharded state); the interrupted epoch counts as done
        (a resume starts at the next one)."""
        payload = self.checkpoint_payload()
        if not self.is_main:
            return
        CheckpointManager(self._rescue_dir()).save_best(
            payload, epoch=self.epoch, fid=None,
            meta={"rescue": True, "version": self.version,
                  "best_fid": (self.best_fid
                               if self.best_fid != float("inf") else None),
                  "fid_calibrated": self._fid_calibrated()})
        print(f"[rescue] checkpointed epoch {self.epoch} (step "
              f"{self.state.step}) to {self._rescue_dir()}; exiting",
              flush=True)

    def _print_shapes(self):
        """debug.verbose_shape: G's submodules to depth 2 with their output
        shapes, for 2 samples at the training resolution (forward hooks on
        one eval-mode generate); a failure is printed and the run goes
        on."""
        if not bool(self.cfg.debug.get("verbose_shape", False)):
            return
        with self._full_state():
            self._print_shapes_of_generator()

    def _full_state(self):
        """The full parameters and EMA twin in the modules for the block (a
        collective under fsdp and under tp; every rank enters it at the
        same point)."""
        sh = self.state.sharding
        return sh.full() if sh is not None else contextlib.nullcontext()

    def _print_shapes_of_generator(self):
        modules = [(name or "generator", m) for name, m
                   in self.task.generator.named_modules()
                   if name.count(".") < 2]
        seen: Dict[str, str] = {}

        def shapes(out):
            if torch.is_tensor(out):
                return str(tuple(out.shape))
            if isinstance(out, (tuple, list)):
                return ", ".join(shapes(o) for o in out)
            return type(out).__name__

        def hook(name):   # a module called twice keeps its first output
            def record(module, args, out):
                seen.setdefault(name, shapes(out))
            return record

        handles = [m.register_forward_hook(hook(name))
                   for name, m in modules]
        try:
            kw = {}
            if hasattr(self.task, "training_resolution"):
                kw["sample_res"] = self.task.training_resolution
            z = self.task.sample_z(2, generator=self._generator(11))
            self.task.generate(z, generator=self._generator(12), **kw)
            width = max(len(name) for name, _ in modules)
            print("[debug] generator output shapes (2 samples):")
            for name, m in modules:
                print(f"  {name:<{width}}  {type(m).__name__:<24} "
                      f"{seen.get(name, '(not called)')}")
        except Exception as e:  # noqa: BLE001 — a debug print never ends
            # the run, as in the JAX Trainer
            print(f"[debug] verbose_shape failed: {e}")
        finally:
            for h in handles:
                h.remove()

    def evaluate(self) -> Dict[str, float]:
        """``eval_only=true``: restore train.ckpt_dir (the same resume scan
        as training) and run one validation, with no training and no
        checkpoint written (the constructor turned saving off). Returns the
        validation's metrics."""
        self.state = create_train_state(self.task, steps_per_epoch=1,
                                        ema=self.ema_decay > 0.0,
                                        zero_opt=self.zero_opt, fsdp=self.fsdp,
                                        tp_min_shard=self.tp_min_shard)
        self.resume()
        self._print_shapes()
        if self.state.step == 0:
            print("[eval] no checkpoint restored (train.ckpt_dir unset or "
                  "empty): evaluating the random initialisation")
        metrics = self.validate(self.state.step)
        self.ckpt.finalize()
        return metrics

    def _draw_figures(self, params, metrics: Dict[str, float],
                      global_step: int):
        """Every figure's validation end. Their gating may use the
        uncalibrated FID (self-consistent within a run), so it stands in
        for ``fid``."""
        fig_metrics = dict(metrics)
        if "fid" not in fig_metrics and "fid_uncalibrated" in fig_metrics:
            fig_metrics["fid"] = fig_metrics["fid_uncalibrated"]
        ctx = FigureContext(task=self.task, g_params=params, cfg=self.cfg,
                            epoch=self.epoch, seed=self.seed)
        for fig in self.figures:
            try:
                fig.on_validation_end(ctx, fig_metrics)
            except NotImplementedError as e:
                print(f"[figures] {type(fig).__name__}: {e}")
            art = fig.last_artefact
            if art is not None and fig.last_drawn_epoch == self.epoch:
                frame = art[len(art) // 2] if isinstance(art, list) else art
                self.logger.log_image(f"figures/{type(fig).__name__}",
                                      np.asarray(frame), global_step)

    def validate(self, global_step: int) -> Dict[str, float]:
        """Real grid from the val set (skipped, as in the JAX Trainer, when
        the split is missing); Fake grid from the fixed noise; with an FID
        evaluator, FID and KID; the figures; with save_ckpts, the best-FID
        checkpoint.
        Without FID every validation counts as an improvement, so the
        latest epoch's checkpoint is the one kept. Rank 0 draws and
        measures; the other ranks wait in the broadcast of its metrics and
        then make the same best-FID decision (only rank 0 saves; a sharded
        state is gathered on every rank first). Returns the FID/KID metrics
        (empty without an evaluator)."""
        with self._full_state():
            return self._validate(global_step)

    def _validate(self, global_step: int) -> Dict[str, float]:
        metrics = dist.broadcast_metrics(
            self._draw_validation(global_step) if self.is_main else {})
        # the best-FID policy: selection on the uncalibrated FID where there
        # are no weights (self-consistent within a run), but only a
        # calibrated FID names a checkpoint
        fid = metrics.get("fid")
        fid_sel = fid if fid is not None else metrics.get("fid_uncalibrated")
        improved = fid_sel is None or fid_sel < self.best_fid
        if improved and fid_sel is not None:
            self.best_fid = fid_sel
        if improved and self._saves:
            self.ckpt.save_best(
                self.checkpoint_payload(), epoch=self.epoch, fid=fid,
                meta={"best_fid": (self.best_fid
                                   if self.best_fid != float("inf") else None),
                      "fid_calibrated": self._fid_calibrated()})
        return metrics

    def _draw_validation(self, global_step: int) -> Dict[str, float]:
        """The grids, FID/KID and the figures of one validation; returns
        the FID/KID metrics."""
        cfg = self.cfg
        mean, std = cfg.train.data_mean, cfg.train.data_std
        try:
            val_ds = instantiate(cfg.dataset.val, **_dataset_kwargs(cfg))
            real = val_ds.load(list(range(min(8, len(val_ds)))))["image"]
            self.logger.log_image(
                "Real", make_grid(unnormalise(real, mean, std), ncol=8),
                global_step)
        except FileNotFoundError as e:
            print(f"[val] no val dataset: {e}")
        params = self.state.eval_g_params(self.task.generator)
        fake = self.task.generate(
            self._fixed_noise, generator=self._generator(10_000 + self.epoch),
            params=params)
        fake = fake.permute(0, 2, 3, 1).cpu().numpy()
        self.logger.log_image(
            "Fake", make_grid(unnormalise(fake[..., :3], mean, std), ncol=8),
            global_step)
        metrics: Dict[str, float] = {}
        if self.metrics_eval is not None:
            metrics = self.metrics_eval.compute(
                params, self._generator(10_000 + self.epoch))
            self.logger.log_scalars(metrics, global_step)
            print("  " + " ".join(f"{k}={v:.3f}" for k, v in metrics.items()),
                  flush=True)
        self._draw_figures(params, metrics, global_step)
        return metrics
