"""One run of one cell: the program's Trainer driven through its own
``fit``, a timed window of whole epochs, an optional profiled stretch, and
the comparison of the first supersteps with the plain reference.

How the program is driven, without editing it:
  * where the configuration's reference module defines ``prepare_data``,
    the files its dataset reads are written once (``prepare``) and the
    config keys that point at them join the cell's values;
  * the Trainer is built from the ``conf/`` tree by the port's
    ``config.compose`` with the cell's overrides, and ``fit`` runs;
  * ``runtime.loop.superstep`` (the name ``fit`` calls) is wrapped for the
    run: the wrapper counts the images of every superstep, reads the
    correctness check's numbers over the run's first CHECK_STEPS
    supersteps, and starts and stops the profiler;
  * ``runtime.steps.optimizer_step`` (the name the superstep calls) is
    wrapped too: in the check's first superstep it reads each net's
    gradient as the optimizer takes it, at that net's first update, and
    otherwise passes straight through;
  * the Trainer's ``_update_epoch_schedules`` (the first call of every
    epoch) opens the window at the start of the first epoch after the warm
    ones, and its logger's ``log_scalars`` (called once per epoch, after
    the epoch's metric fetch has synchronised) closes it at the end of the
    first epoch that ends ``seconds`` or more after it opened, which ends
    ``fit``.
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from . import spec
from .reference import plain
from .trace import Context, from_profiler

#: supersteps of the correctness check: the run's first, in epoch 0
CHECK_STEPS = 3
#: where ``prepare`` writes a configuration's data, one directory a digest
DATA_ROOT = spec.ROOT / "build" / "perfbench" / "data"
#: the file, written last, whose presence makes a data directory whole
DATA_MARKER = "prepared.json"


class _Stop(Exception):
    """Ends ``fit``: the window closed, or the check is read."""


def _params(task) -> Dict[str, torch.Tensor]:
    out = {f"discriminator.{n}": p.detach().clone()
           for n, p in task.discriminator.named_parameters()}
    out.update({f"generator.{n}": p.detach().clone()
                for n, p in task.generator.named_parameters()})
    return out


def _change(now: Dict[str, torch.Tensor], p0: Dict[str, torch.Tensor]
            ) -> Dict[str, float]:
    """{leaf: ‖θ − θ₀‖}."""
    return {n: float((now[n].detach() - p0[n]).double().norm()) for n in p0}


class Probe:
    """Wraps the program's superstep for one run."""

    def __init__(self, trainer, superstep: Callable, warm_epochs: int,
                 seconds: float, trace_at: Optional[int], trace_len: int,
                 window: bool):
        self.trainer, self.superstep = trainer, superstep
        self.reading: Dict[str, object] = {"losses": []}
        self.warm_epochs, self.seconds = warm_epochs, seconds
        self.trace_at, self.trace_len = trace_at, trace_len
        self.window = window
        self.epoch, self.k = -1, 0
        self.t_open = self.t_close = None
        self.window_steps = self.window_images = 0
        self.failed_steps = 0
        self._epoch_steps = 0
        self.prof = None
        self.stretch_s = self.stretch_wall_s = None
        self.stretch_steps = 0
        #: {id(optimizer): (net's prefix, net)} whose next update reads the
        #: gradient: filled for the check's first superstep only
        self._first_update: Dict[int, tuple] = {}

    # -- the epoch boundaries ------------------------------------------------
    def epoch_start(self):
        if self.window and self.t_open is None \
                and self.trainer.epoch == self.warm_epochs:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.t_open = time.perf_counter()

    def epoch_end(self, means: dict):
        if self.t_open is None:
            return
        if not all(math.isfinite(float(v)) for v in means.values()):
            self.failed_steps += self._epoch_steps
        self._epoch_steps = 0
        now = time.perf_counter()
        if now - self.t_open >= self.seconds:
            self.t_close = now
            raise _Stop

    # -- every superstep ----------------------------------------------------
    def __call__(self, task, state, batches, disc_freq, gen_freq, accum,
                 ema_decay):
        if self.trainer.epoch != self.epoch:
            self.epoch, self.k = self.trainer.epoch, 0
        reading = None
        if self.k < CHECK_STEPS and "change" not in self.reading:
            if self.epoch != 0:
                raise RuntimeError(f"the check reads the first {CHECK_STEPS}"
                                   " supersteps, and epoch 0 holds fewer")
            reading = self.reading
            if self.k == 0:
                reading["params0"] = _params(task)
                reading["grad"] = {}
                self._first_update = {
                    id(state.d_opt): ("discriminator", task.discriminator),
                    id(state.g_opt): ("generator", task.generator)}
        in_window = self.t_open is not None and self.t_close is None
        if in_window and self.trace_at is not None and self.prof is None \
                and self.window_steps == self.trace_at:
            self._start_profiler()
        metrics = self.superstep(task, state, batches, disc_freq, gen_freq,
                                 accum, ema_decay)
        self._first_update = {}
        if in_window:
            self.window_steps += 1
            self._epoch_steps += 1
            img = batches["image"]
            self.window_images += int(img.shape[0]) * int(img.shape[1])
            if self.prof is not None and self.stretch_s is None:
                self.stretch_steps += 1
                if self.stretch_steps == self.trace_len:
                    self._stop_profiler()
        if reading is not None:
            reading["losses"].append({k: float(v) for k, v in metrics.items()})
            if self.k == 0:
                reading["change1"] = _change(_params(task),
                                             reading["params0"])
            if self.k == CHECK_STEPS - 1:
                reading["change"] = _change(_params(task),
                                            reading.pop("params0"))
        self.k += 1
        if not self.window and "change" in self.reading:
            raise _Stop
        return metrics

    def wrap_optimizer_step(self, step: Callable) -> Callable:
        """``step`` (the program's ``optimizer_step``, or a plant's in its
        place) reading, at each net's first update of the check's first
        superstep, the norm of every leaf's gradient as the optimizer is
        handed it: exact for any optimizer and any number of updates."""
        def optimizer_step(opt, schedule, count):
            first = self._first_update.pop(id(opt), None)
            if first is not None:
                prefix, net = first
                self.reading["grad"].update(plain.leaf_norms(
                    (f"{prefix}.{n}",
                     p.grad if p.grad is not None else torch.zeros_like(p))
                    for n, p in net.named_parameters()))
            return step(opt, schedule, count)
        return optimizer_step

    def _start_profiler(self):
        torch.cuda.synchronize()
        self._t_stretch0 = time.perf_counter()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            record_shapes=True)
        self.prof.start()
        self._t_prof = time.perf_counter()

    def _stop_profiler(self):
        """Ends the stretch. ``stretch_s`` is the profiled supersteps'
        seconds; ``stretch_wall_s`` the window's seconds the profiler
        held, its start and stop (the trace's flush) included, which the
        untraced rate of the window leaves out."""
        torch.cuda.synchronize()
        self.stretch_s = time.perf_counter() - self._t_prof
        self.prof.stop()
        self.stretch_wall_s = time.perf_counter() - self._t_stretch0


def _data_digest(mod, values: dict) -> str:
    """Of the values that shape the data (those the module names in
    ``DATA_KEYS``, which a module with ``prepare_data`` must define) and
    of the module's own source."""
    shaping = {k: values.get(k) for k in mod.DATA_KEYS}
    h = hashlib.sha256(json.dumps(shaping, sort_keys=True).encode())
    h.update(Path(mod.__file__).read_bytes())
    return h.hexdigest()[:16]


def _moved(v, old: Path, new: Path):
    """``v`` with ``old`` at its head replaced by ``new``, where ``v`` is
    a path under ``old``; any other value as it is."""
    if isinstance(v, (str, Path)):
        try:
            return str(new / Path(v).relative_to(old))
        except ValueError:
            pass
    return str(v) if isinstance(v, Path) else v


def prepare(c: dict) -> dict:
    """Cell ``c`` with its data prepared: where the configuration's
    reference module defines ``prepare_data(values, root) -> {key: value}``
    (and ``DATA_KEYS``, the values that shape the files), the files its
    dataset reads are written under ``DATA_ROOT/<config>/<digest>`` and
    the keys it returns (paths under ``root`` moved with it) join the
    cell's workload values and ``values``, so that the overrides point
    the program at them, ``spec.check_values`` holds the composed config
    to them and the reference reads the same files. A directory is
    trusted only where its marker exists: the files are written to a
    temporary directory beside it, the marker last, and it is renamed into
    place; one without the marker is made again. ``c`` as it is where the
    module defines no ``prepare_data``."""
    mod = spec.reference(c["config"]["name"])
    make = getattr(mod, "prepare_data", None)
    if make is None:
        return c
    root = DATA_ROOT / c["config"]["name"] / _data_digest(mod, c["values"])
    marker = root / DATA_MARKER
    if not marker.is_file():
        if root.exists():
            shutil.rmtree(root)
        root.parent.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix=f".{root.name}.",
                                    dir=root.parent))
        try:
            keys = make(dict(c["values"]), tmp)
            (tmp / DATA_MARKER).write_text(json.dumps(
                {k: _moved(v, tmp, root) for k, v in keys.items()}))
            try:
                os.rename(tmp, root)
            except OSError:
                if not marker.is_file():    # not another run's, whole
                    raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    data = json.loads(marker.read_text())
    work = dict(c["workload"], values={**c["workload"]["values"], **data})
    return dict(c, workload=work, values={**c["values"], **data})


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def drive(c: dict, seed: int, seconds: float, trace: bool, device: str,
          window: bool = True, plant: Optional[Callable] = None) -> dict:
    """Build the program's Trainer for cell ``c`` at ``seed``, its data
    prepared first, and run its ``fit`` until the window closes (or,
    without ``window``, until the check is read). ``plant(trainer)``,
    where given, is a context manager entered around ``fit`` (a
    deliberately broken program, for the tests of the comparison); the
    probe's wrap of ``optimizer_step`` goes over whatever step the plant
    leaves in place. Returns the probe's reading; the program's state is
    freed."""
    from lightning_gan_zoo_tpu_torch.config import compose
    from lightning_gan_zoo_tpu_torch.runtime import loop, steps

    c = prepare(c)
    cfg = compose(spec.ROOT / "conf", spec.overrides(c, seed))
    spec.check_values(cfg, c["values"])
    work = c["workload"]
    trainer = loop.Trainer(cfg, device)
    probe = Probe(trainer, loop.superstep, int(work["warm_epochs"]), seconds,
                  int(work["trace_at"]) if trace else None,
                  int(work["trace_supersteps"]), window)
    log_scalars = trainer.logger.log_scalars
    update = trainer._update_epoch_schedules

    def on_log(means, step):
        log_scalars(means, step)
        probe.epoch_end(means)

    def on_epoch(*a, **kw):
        update(*a, **kw)
        probe.epoch_start()

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(loop, "superstep", probe))
        stack.enter_context(patched(trainer.logger, "log_scalars", on_log))
        stack.enter_context(patched(trainer, "_update_epoch_schedules",
                                     on_epoch))
        if plant is not None:
            stack.enter_context(plant(trainer))
        stack.enter_context(patched(
            steps, "optimizer_step",
            probe.wrap_optimizer_step(steps.optimizer_step)))
        try:
            trainer.fit()
        except _Stop:
            pass
    if probe.prof is not None and probe.stretch_s is None:
        raise RuntimeError(
            f"the window closed after {probe.window_steps} supersteps, "
            f"before the profiled stretch ended (trace_at "
            f"{work['trace_at']}, {work['trace_supersteps']} supersteps)")
    params = [p for net in (trainer.task.generator,
                            trainer.task.discriminator)
              for p in net.parameters()]
    out = {"reading": probe.reading, "window_steps": probe.window_steps,
           "devices": len({p.device for p in params}),
           "window_images": probe.window_images,
           "failed_steps": probe.failed_steps, "t_open": probe.t_open,
           "t_close": probe.t_close, "prof": probe.prof,
           "stretch_s": probe.stretch_s,
           "stretch_wall_s": probe.stretch_wall_s,
           "stretch_steps": probe.stretch_steps}
    if window and probe.t_close is None:
        raise RuntimeError("fit ended before the window closed")
    if torch.cuda.is_available() and torch.device(device).type == "cuda":
        out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    del trainer, probe, params
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------- the check
def superstep_batch(c: dict, seed: int, epoch: int, k: int, batch: int,
                    n_micro: int, device) -> dict:
    """Superstep ``k`` of epoch ``epoch``'s batch, made by the reference
    alone: the configuration module's ``superstep_batch`` where it defines
    one, else ``plain.superstep_batch`` (the synthetic images)."""
    mod = spec.reference(c["config"]["name"])
    make = getattr(mod, "superstep_batch", plain.superstep_batch)
    return make(c["values"], seed, epoch, k, batch, n_micro, device)


def reference_readings(c: dict, seed: int, device,
                       quant: bool = False) -> dict:
    """The plain reference over the run's first CHECK_STEPS supersteps:
    its weights and its random streams drawn from the seed, each
    superstep's batch the reference's own (``superstep_batch``) in the
    loader's order."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = prepare(c)
    mod = spec.reference(c["config"]["name"])
    values = c["values"]
    ref = mod.Reference(values, device, quant=quant)
    ref.init_from_seed(seed)
    batch, accum, _ = plain.schedule_at(values, 0)
    n_micro = (ref.disc_freq + ref.gen_freq) * accum
    p0 = {n: p.detach().clone() for n, p in ref.named_leaves().items()}
    out = {"losses": []}
    for k in range(CHECK_STEPS):
        ls, gr = ref.superstep(
            superstep_batch(c, seed, 0, k, batch, n_micro, device), accum)
        out["losses"].append(ls)
        if k == 0:
            out["grad"] = {f"{net}.{n}": v for net, norms in gr.items()
                           for n, v in norms.items()}
            out["change1"] = _change(ref.named_leaves(), p0)
    out["change"] = _change(ref.named_leaves(), p0)
    return out


def _median(xs):
    return statistics.median(xs) if xs else 0.0


def _leaf_gaps(prog: dict, ref: dict, key: str, net: str):
    """{leaf: |program − reference| / max(reference, its net's median)}
    of one net's per-leaf norms ``key``; for a change only the leaves whose
    first reference gradient is at least a thousandth of the net's median
    (the others move by round-off alone under Adam)."""
    names = [n for n in ref["grad"] if n.startswith(net)]
    med_g = _median([ref["grad"][n] for n in names])
    if key != "grad":
        names = [n for n in names if ref["grad"][n] >= 1e-3 * med_g]
    scale = _median([ref[key][n] for n in names])
    out = {}
    for n in names:
        gap = abs(prog[key].get(n, float("nan")) - ref[key][n]) / max(
            ref[key][n], scale, 1e-30)
        out[n] = gap if math.isfinite(gap) else float("inf")
    return out


def _loss_gap(prog_losses, ref_losses) -> float:
    worst = 0.0
    for lp, lr in zip(prog_losses, ref_losses):
        for k, r in lr.items():
            p = lp.get(k, float("nan"))
            gap = abs(p - r) / max(abs(r), 1.0)
            worst = max(worst, gap) if math.isfinite(gap) else float("inf")
    return worst


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers of one check:
      loss       — the largest |program − reference| of any loss of the
                   supersteps, over max(|reference|, 1);
      loss1      — the same over the first superstep alone;
      grad       — the worst leaf of the first superstep's gradients:
                   |‖g‖ program − ‖g‖ reference| over the larger of the
                   reference's norm of that leaf and of its net's median
                   leaf;
      change1    — the same of ‖θ₁ − θ₀‖ after the first superstep (at
                   β₁ = 0 Adam's first update is lr·g/(|g| + ε), about lr
                   per element), over the leaves whose first reference
                   gradient is at least a thousandth of its net's median;
      change     — the same of ‖θ₃ − θ₀‖ after the supersteps, over those
                   leaves;
      change_med — the median leaf's gap of the change (the larger of
                   the two nets')."""
    out = {"loss": _loss_gap(prog["losses"], ref["losses"]),
           "loss1": _loss_gap(prog["losses"][:1], ref["losses"][:1])}
    for key in ("grad", "change1", "change"):
        gaps = [_leaf_gaps(prog, ref, key, net)
                for net in ("discriminator.", "generator.")]
        out[key] = max(max(g.values(), default=0.0) for g in gaps)
        if key == "change":
            out["change_med"] = max(_median(list(g.values())) for g in gaps)
    return out


def check(c: dict, seed: int, reading: dict, device,
          quant: bool = False) -> Dict[str, dict]:
    """{number: {"value": v, "limit": l}}; ``limit`` None where the
    number is not compared."""
    limits = c["workload"].get("limits", {})
    ref = reference_readings(c, seed, device, quant=quant)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {k: {"value": v, "limit": limits.get(k)}
            for k, v in compare(reading, ref).items()}


def is_correct(reading: dict, numbers: Dict[str, dict]) -> bool:
    """The check read whole, and every compared number finite and within
    its limit."""
    if "change" not in reading:
        return False
    return all(math.isfinite(x["value"]) and x["value"] <= x["limit"]
               for x in numbers.values() if x["limit"] is not None)


# ------------------------------------------------------------- FLOP count
def flops_per_superstep(c: dict, seed: int, epoch: int, device) -> float:
    """The plain reference's matmul and convolution operations in one
    superstep at epoch ``epoch``'s batch, accumulation and resolution:
    counted on the epoch's first superstep at a batch of one and scaled by
    the batch, as every counted product is linear in it."""
    c = prepare(c)
    mod = spec.reference(c["config"]["name"])
    values = c["values"]
    batch, accum, res = plain.schedule_at(values, epoch)
    ref = mod.Reference(values, device)
    ref.init_from_seed(seed)
    if hasattr(ref, "resolution"):
        ref.resolution = res
    n_micro = (ref.disc_freq + ref.gen_freq) * accum
    one = superstep_batch(c, seed, epoch, 0, 1, n_micro, device)
    return plain.flops_of_superstep(ref, one, accum) * batch


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def trace_context(run: dict, flops: Optional[float]) -> Context:
    """What the readers read of a traced run: the profiled stretch, and
    the window's seconds and supersteps outside it (the profiler's own
    work and the slower traced supersteps left out)."""
    t = from_profiler(run["prof"], run["stretch_s"], run["stretch_steps"])
    return Context(
        trace=t,
        untraced_s=run["t_close"] - run["t_open"] - run["stretch_wall_s"],
        untraced_supersteps=run["window_steps"] - run["stretch_steps"],
        flops_per_superstep=flops)
