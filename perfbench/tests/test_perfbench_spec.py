"""Every cell, configuration and metric of BENCHMARK.json parses and
reaches the harness by its name, within the benchmark's contract."""
import json
import re

import pytest

from perfbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def _one_line(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


@pytest.mark.parametrize("kind,keys,optional", [
    ("configs", {"name", "source", "file", "reduced", "why"}, set()),
    ("workloads", {"name", "config", "traffic", "chips", "why"}, set()),
    ("end_to_end", {"name", "unit", "better", "bound", "source"},
     {"workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"},
     {"workloads"}),
])
def test_every_entry_has_exactly_its_keys(kind, keys, optional):
    for entry in BENCH[kind]:
        assert keys <= set(entry) <= keys | optional, (kind, entry["name"])
        assert NAME.match(entry["name"])
        for key in ("why", "layer", "source"):
            if key in entry:
                assert _one_line(entry[key]), (kind, entry["name"], key)


def test_configs_are_used_and_their_cuts_are_names():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    ends = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in ends and ends["setup_s"]["bound"] <= 0.25
    for m in ends.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in ends
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_reaches_the_harness(name):
    c = spec.cell(name)
    assert c["entry"]["chips"] == 1
    assert len(c["entry"]["why"]) <= 200
    assert c["config"]["file"].startswith("perfbench/configs/")
    assert spec.reference(c["config"]["name"]).Reference
    for trace in (False, True):
        readers = spec.metric_readers(name, trace)
        assert readers
        if trace:
            assert all(callable(r["read"]) for r in readers.values())
    e2e = spec.metric_readers(name, False)
    assert {"train_images_per_s", "setup_s"} <= set(e2e)
    work = c["workload"]
    assert work["trace_supersteps"] >= 6 and work["warm_epochs"] >= 1
    assert work["limits"] and set(work["limits"]) <= {
        "loss", "loss1", "grad", "change1", "change", "change_med"}


@pytest.mark.parametrize("name", CELLS)
def test_program_composes_the_files_numbers(name):
    from lightning_gan_zoo_tpu_torch.config import compose
    c = spec.cell(name)
    cfg = compose(spec.ROOT / "conf", spec.overrides(c, 3_000_000_017))
    spec.check_values(cfg, c["values"])
    assert int(cfg.seed) == 3_000_000_017


def test_a_changed_number_is_refused():
    from lightning_gan_zoo_tpu_torch.config import compose
    c = spec.cell("pigan.train16")
    cfg = compose(spec.ROOT / "conf",
                  spec.overrides(c, 1) + ["nerf.siren_dim_hidden=128"])
    with pytest.raises(spec.SpecError):
        spec.check_values(cfg, c["values"])


def test_a_cell_on_more_than_one_card_is_refused():
    """The harness drives one single-process Trainer: a cell asking for 4
    cards is refused before anything runs."""
    bench = spec.benchmark()
    entry = dict(bench["workloads"][0], chips=4)
    with pytest.raises(spec.SpecError):
        spec.cell(entry["name"], {**bench, "workloads": [entry]})


def test_a_cell_without_tiny_widths_names_the_missing_file():
    from perfbench.tests.tiny import tiny_values
    with pytest.raises(spec.SpecError, match=r"tiny_cells/no\.such\.cell"
                                             r"\.json is missing"):
        tiny_values("no.such.cell")
