"""The readings that the limits of ``correct`` are set from, on the card at
the cell's own size.

    python3 perfbench/calibrate.py --workload pigan.train16 \\
        --seeds 11,12,13 --out chiprun_out/cal.jsonl
    python3 perfbench/calibrate.py --workload pigan.train16 \\
        --seeds 11,12,13 --faults unchanged,half_batch,altered

For every seed, in one process: the program through its first supersteps
(the run's own path, without a window) against the plain reference, then
the control (the reference computed with every product in float8, put in
the program's place) against the reference; with ``--faults`` instead each
named fault (faults.py) planted in the program, against the reference.
One JSON line per reading: workload, seed, what ran ("program",
"control" or the fault's name), each compared number, and the raw losses
and per-leaf norms they came from.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _raw(reading: dict) -> dict:
    """A check's losses and per-leaf norms, for a look at them later."""
    return {k: reading[k] for k in ("losses", "grad", "change1", "change")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--faults", default="",
                    help="comma-separated faults (faults.py) to plant on "
                         "every seed, in place of the program and control")
    ap.add_argument("--out", default=None, help="append the lines here too")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from perfbench import faults, harness, spec
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 1
    c = spec.cell(args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(seed, what, numbers, t0, raw=None):
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "what": what, "seconds": time.time() - t0,
                           "numbers": numbers, "raw": raw})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    plants = [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        for what in plants or ["program"]:
            t0 = time.time()
            run = harness.drive(c, seed, 0.0, False, "cuda",
                                window=False,
                                plant=faults.FAULTS.get(what))
            reading = run["reading"]
            ref = harness.reference_readings(c, seed, "cuda")
            raw = {"program": _raw(reading), "reference": _raw(ref)}
            low = None
            if what == "program":
                low = harness.reference_readings(c, seed, "cuda",
                                                 quant=True)
                raw["control"] = _raw(low)
            emit(seed, what, harness.compare(reading, ref), t0, raw)
            if low is not None:
                emit(seed, "control", harness.compare(low, ref), t0)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
