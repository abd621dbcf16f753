"""The benchmark's files, found by name: ``BENCHMARK.json`` at the root of
the checkout, a cell's ``workloads/<name>.json``, its configuration's file,
the configuration's plain reference ``reference/<config>.py`` and each
per-layer metric's reader ``metrics/<metric>.py``."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class SpecError(Exception):
    pass


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise SpecError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, bench: dict = None) -> dict:
    """The cell ``name``: its entry in ``bench`` (BENCHMARK.json by
    default), its workload file, its configuration's entry and file, and
    ``values``, the configuration's numbers with the cell's settings over
    them."""
    bench = bench or benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                        f"(have {sorted(entries)})")
    entry = entries[name]
    if int(entry["chips"]) != 1:
        raise SpecError(f"workload {name!r} asks for {entry['chips']} cards; "
                        "the harness drives one single-process Trainer and "
                        "launches no ranks, so it runs one-card cells only")
    configs = {c["name"]: c for c in bench["configs"]}
    config = configs[entry["config"]]
    conf_file = json.loads((ROOT / config["file"]).read_text())
    work = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    values = {**conf_file["values"], **work["values"]}
    return {"name": name, "entry": entry, "config": config,
            "config_file": conf_file, "workload": work, "values": values}


def reference(config_name: str) -> ModuleType:
    """The configuration's plain reference module (a package-relative
    import of ``reference/plain.py`` inside it)."""
    return importlib.import_module(f"perfbench.reference.{config_name}")


def metric_readers(cell_name: str, trace: bool) -> Dict[str, dict]:
    """{metric name: {"entry": its BENCHMARK.json entry, "read": reader or
    None}} for the metrics this cell reports: with ``trace`` the per-layer
    ones (those whose ``workloads`` list the cell, or every one without the
    key), else the end-to-end ones."""
    bench = benchmark()
    kind = "per_layer" if trace else "end_to_end"
    out: Dict[str, dict] = {}
    for m in bench[kind]:
        if "workloads" in m and cell_name not in m["workloads"]:
            continue
        read = None
        if trace:
            read = load_module(HERE / "metrics" / f"{m['name']}.py",
                               f"perfbench_metric_{len(out)}").read
        out[m["name"]] = {"entry": m, "read": read}
    return out


def overrides(c: dict, seed: int) -> List[str]:
    """The program's config overrides for cell ``c`` at ``seed``: the
    configuration's, the cell's values, and the run's own: no FID, no
    checkpoints, no figures, no validation after epoch 0, output inside
    the checkout."""
    out = list(c["config_file"]["overrides"])
    out += [f"{k}={json.dumps(v)}" for k, v in c["workload"]["values"].items()]
    out += ["calc_fid=False", "save_ckpts=False", "profile=False",
            "train.num_epochs=1000000", "val.every_n_epochs=1000000",
            f"output_root=build/perfbench/runs/{c['name']}", "version=run",
            f"seed={int(seed)}"]
    return out


def check_values(cfg, values: dict):
    """The composed config holds every number of the configuration's and
    the cell's files; raises SpecError on the first that differs."""
    for key, want in values.items():
        have = cfg.select(key)
        if hasattr(have, "to_container"):
            have = have.to_container()
        if isinstance(want, (int, float)) and not isinstance(want, bool):
            ok = isinstance(have, (int, float)) and abs(
                float(have) - float(want)) <= 1e-12 * max(1.0, abs(want))
        else:
            ok = have == want
        if not ok:
            raise SpecError(f"config key {key}: the program composes "
                            f"{have!r}, the benchmark's files say {want!r}")
