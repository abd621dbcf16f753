"""Timing and tracing of the training loop (counterpart of
lightning_gan_zoo_tpu/utils/profiling.py), on ``torch.profiler``.

  * ``span(name)``: a named range of the program's own timeline. While a
    profiler records (the benchmark's traced stretch, ``TraceCapture``) it
    is ``torch.profiler.record_function(name)``, kept and exported by that
    profiler beside the operators and kernels, on the same clock; else it
    is one shared no-op context, and a span costs one flag read. It holds
    and writes nothing itself, and leaves grad mode, autocast and the
    stream as they are. Spans on a thread the profiler did not start on
    are not recorded, so the loader's worker thread has none. The
    vocabulary, each opened on the training thread:

      ``zoo.superstep``    the whole of runtime/steps.py::superstep
      ``zoo.d.forward``    a D micro-step's loss under autocast (R1's
      ``zoo.g.forward``    autograd.grad inside D's), and G's
      ``zoo.d.backward``   a micro-step's ``(loss / accum).backward()``
      ``zoo.g.backward``
      ``zoo.d.update``     after a phase's micro-steps: the gradient
      ``zoo.g.update``     reduction, the zero fill, the optimizer step,
                           the shard gather and (G) the EMA
      ``zoo.d_side.replay``  π-GAN's and ANIGAN's discriminator side of a
      ``zoo.d_side.eager``   loss (tasks/nerf_gan.py), inside the phase's
                             forward span: replayed from CUDA graphs, or
                             run eagerly (runtime/graphs.py)
      ``zoo.loader_wait``  the Trainer blocked on the loader's next stack
      ``zoo.to_device``    the Trainer's copy of one stack to the device

  * ``TraceCapture``: ``profile=true`` traces supersteps ``warmup`` to
    ``warmup + span`` (2 and 5 by default) with ``torch.profiler`` (host
    operators, the spans above, and the card's kernels where there is one)
    and writes a Chrome trace, ``<run>/trace/trace.json``, that Perfetto or
    chrome://tracing opens.
  * ``device_op_times`` and ``device_time_ms`` read such a trace: the
    card's kernel events by name, and the busy time as the union of their
    intervals (kernels on several streams overlap, so a sum would count
    twice). A trace taken without a card holds no kernel events.
"""
from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

TRACE_FILE = "trace.json"


#: what ``span`` returns while no profiler records
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context naming one range of the program's timeline: a
    ``record_function`` while a profiler records on this thread, else the
    shared no-op context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _kernel_events(trace_dir: str | Path) -> list:
    """The complete events of category ``kernel`` (the card's kernels) in
    ``trace_dir``'s Chrome trace."""
    data = json.loads((Path(trace_dir) / TRACE_FILE).read_text())
    return [e for e in data.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") == "kernel"]


def device_op_times(trace_dir: str | Path) -> Dict[str, Tuple[float, int]]:
    """{kernel name: (total µs, count)} of the trace's card kernels."""
    out: Dict[str, Tuple[float, int]] = {}
    for e in _kernel_events(trace_dir):
        dur, cnt = out.get(e["name"], (0.0, 0))
        out[e["name"]] = (dur + float(e.get("dur", 0.0)), cnt + 1)
    return out


def device_time_ms(trace_dir: str | Path) -> float:
    """The card's busy ms in the trace: the union of its kernels'
    intervals."""
    return union_us((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                    for e in _kernel_events(trace_dir)) / 1e3


class TraceCapture:
    """``torch.profiler`` over supersteps ``warmup`` … ``warmup + span``;
    ``tick`` after every superstep, ``close`` at the end of the run."""

    def __init__(self, out_dir: str | Path, enabled: bool = False,
                 warmup_steps: int = 2, trace_steps: int = 5):
        self.out_dir = Path(out_dir)
        self.enabled = enabled
        self.warmup, self.span = warmup_steps, trace_steps
        self._step = 0
        self._prof = None

    def tick(self):
        if not self.enabled:
            return
        if self._step == self.warmup:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
        elif self._prof is not None and self._step == self.warmup + self.span:
            self._stop()
        self._step += 1

    def _stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.out_dir / TRACE_FILE))
        self._prof = None
        print(f"[profile] trace written to {self.out_dir / TRACE_FILE}")

    def close(self):
        """Write a trace still open (a run shorter than the window)."""
        if self._prof is not None:
            self._stop()
