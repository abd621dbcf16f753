"""The benchmark of lightning_gan_zoo_tpu_torch on NVIDIA cards.

    python3 perfbench/run.py --workload pigan.train16 --seed 7 \\
        --seconds 30 --trace 0

From the root of a checkout. Runs the cell ``--workload`` of
``BENCHMARK.json``: the program's Trainer trains the cell's configuration
through its own ``fit``; after the warm epochs a window of whole epochs is
timed for ``--seconds`` (with ``--trace 1`` a stretch of supersteps inside
it is profiled); once the window has closed, the first supersteps of the
run are compared with the configuration's plain reference. The last line
of standard output is one JSON object (correct, attempted, failed,
metrics, device; with ``--trace 1`` breakdown); before it the card, the
peak memory and the FLOP count; the numbers compared, each beside its
limit, end standard error and the JSON object. Exits 1, printing no
result, without a CUDA card or with fewer cards than the cell asks for,
or where the JAX package, jax, jaxlib or flax were loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHES = ROOT / "build" / "perfbench"
#: top-level module names the run must not load
FORBIDDEN = ("jax", "jaxlib", "flax", "lightning_gan_zoo_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHES / sub)
    sys.path.insert(0, str(ROOT))
    if not (ROOT / "lightning_gan_zoo_tpu_torch").is_dir():
        print("the checkout holds no lightning_gan_zoo_tpu_torch package",
              file=sys.stderr)
        return 1
    import torch
    from perfbench import spec
    try:
        c = spec.cell(args.workload)
    except (spec.SpecError, OSError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    chips = int(c["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA card(s); torch sees {seen} "
              f"(torch {torch.__version__})", file=sys.stderr)
        return 1
    from perfbench.runner import run_cell
    result, checks = run_cell(c, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 1
    for name, x in checks.items():
        print(f"check {name} = {x['value']!r} (limit {x['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
