"""A whole run of one cell and its result line."""
from __future__ import annotations

import math
import sys
import time
from typing import Dict, Tuple

import torch

from . import harness, spec


def run_cell(c: dict, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, plant=None) -> Tuple[dict, Dict[str, dict]]:
    """(the result object, the compared numbers). The end-to-end metrics
    come from the untraced run, the per-layer ones from the traced run;
    both check correctness the same way. ``plant`` (tests only) breaks
    the program underneath, as in ``harness.drive``."""
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    run = harness.drive(c, seed, seconds, trace, device, plant=plant)
    setup_s = run["t_open"] - t_start
    window_s = run["t_close"] - run["t_open"]
    card = harness.card_line()
    print(f"card: {card}")
    print(f"memory_peak_bytes: {run.get('memory_peak_bytes')}")

    work = c["workload"]
    numbers = harness.check(c, seed, run["reading"], device)
    correct = harness.is_correct(run["reading"], numbers)
    flops = harness.flops_per_superstep(c, seed, int(work["warm_epochs"]),
                                        device)
    print(f"flops_per_superstep: {flops!r}")
    print(f"window: {window_s!r} s, {run['window_steps']} supersteps, "
          f"{run['window_images']} images; setup {setup_s!r} s")

    metrics: Dict[str, dict] = {}
    readers = spec.metric_readers(c["name"], trace)
    breakdown = None
    dev = {"platform": "gpu",
           "kind": (torch.cuda.get_device_name(0)
                    if torch.cuda.is_available() else str(device)),
           "count": run["devices"],
           "memory_peak_bytes": run.get("memory_peak_bytes")}
    if trace:
        ctx = harness.trace_context(run, flops)
        for name, r in readers.items():
            v = r["read"](ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": r["entry"]["unit"]}
        dev["busy_s"] = ctx.trace.busy_s()
        dev["window_s"] = ctx.trace.stretch_s
        breakdown = {"device_ops": ctx.trace.top_device_ops(),
                     "idle_gaps": ctx.trace.idle_gaps()}
        print(f"traced: {ctx.trace.supersteps} supersteps, "
              f"{len(ctx.trace.kernels)} device events, device ms by kind "
              f"{ctx.trace.ms_by_kind()}")
    else:
        values = {"train_images_per_s": run["window_images"] / window_s,
                  "setup_s": setup_s}
        for name, r in readers.items():
            if name in values:
                metrics[name] = {"value": values[name],
                                 "unit": r["entry"]["unit"]}
    result = {"correct": bool(correct),
              "attempted": run["window_steps"],
              "failed": run["failed_steps"],
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in numbers.items()}
    bad = [k for k, v in result["checks"].items()
           if not math.isfinite(v["value"])]
    if bad:
        print(f"non-finite numbers: {bad}", file=sys.stderr)
    print(f"run seconds after the window: "
          f"{time.perf_counter() - run['t_close']!r}")
    return result, numbers
