"""Timing and tracing of the training loop (counterpart of
lightning_gan_zoo_tpu/utils/profiling.py), on ``torch.profiler``.

  * ``StepTimer``: host wall-clock per step → images/s; the caller
    synchronises the device before ``stop`` where it times device work.
  * ``TraceCapture``: ``profile=true`` traces supersteps ``warmup`` to
    ``warmup + span`` (2 and 5 by default) with ``torch.profiler`` (host
    operators, and the card's kernels where there is one) and writes a Chrome
    trace, ``<run>/trace/trace.json``, that Perfetto or chrome://tracing
    opens.
  * ``device_op_times`` and ``device_time_ms`` read such a trace: the
    card's kernel events by name, and the busy time as the union of their
    intervals (kernels on several streams overlap, so a sum would count
    twice). A trace taken without a card holds no kernel events.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

TRACE_FILE = "trace.json"


class StepTimer:
    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self, images_per_step: int, skip_first: int = 1) -> dict:
        """Throughput stats, excluding the first ``skip_first`` steps."""
        ts = np.asarray(self.times[skip_first:] or self.times)
        mean = float(ts.mean()) if len(ts) else float("nan")
        return {
            "steps": len(self.times),
            "mean_step_s": mean,
            "p50_step_s": float(np.median(ts)) if len(ts) else float("nan"),
            "images_per_sec": images_per_step / mean if mean > 0 else 0.0,
        }


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
