"""A configuration whose batch carries more than images joins through new
files alone: its module's ``superstep_batch`` makes the reference's
batches, its ``prepare_data`` writes the files its dataset reads once,
before the program is built, and ``half_batch`` cuts a nested batch. The
configuration here is ``stub_analysed`` (tests/stub_analysed.py), put in
place of a configuration's module by monkeypatching ``spec.reference``."""
import json
import time

import pytest
import torch

from perfbench import faults, harness, runner, spec
from perfbench.reference import plain
from perfbench.tests import stub_analysed as stub
from perfbench.tests import tiny
from perfbench.tests.tiny import tiny_cell

SEED = 3_000_000_061


def stub_cell(**values) -> dict:
    """``pigan.train16`` at its tiny widths over ``dataset=birds_analysed``
    and the stub's module, never a cell of BENCHMARK.json."""
    c = tiny_cell("pigan.train16", values=values)
    c["name"] = "stub.train16"
    c["config"] = dict(c["config"], name=stub.NAME)
    c["config_file"] = dict(c["config_file"], overrides=[
        "dataset=birds_analysed" if o == "dataset=synthetic" else o
        for o in c["config_file"]["overrides"]])
    return c


@pytest.fixture
def with_stub(monkeypatch, tmp_path):
    """``spec.reference`` finds the stub by its name, and prepared data
    goes under this test's own directory."""
    find = spec.reference
    monkeypatch.setattr(spec, "reference", lambda name: stub if
                        name == stub.NAME else find(name))
    monkeypatch.setattr(harness, "DATA_ROOT", tmp_path / "data")
    stub.calls.clear()
    stub.Reference.seen.clear()
    return tmp_path / "data"


def _recording(monkeypatch, owner, name):
    calls = []
    make = getattr(owner, name)

    def record(values, seed, epoch, k, batch, n_micro, device):
        calls.append((epoch, k, batch, n_micro))
        return make(values, seed, epoch, k, batch, n_micro, device)

    monkeypatch.setattr(owner, name, record)
    return calls


# ------------------------------------------------------- superstep_batch
def test_the_check_and_the_flop_count_take_the_modules_batch(
        with_stub, monkeypatch):
    c = stub_cell()
    mine = _recording(monkeypatch, stub, "superstep_batch")
    default = _recording(monkeypatch, plain, "superstep_batch")
    harness.reference_readings(c, SEED, "cpu")
    assert mine == [(0, k, 4, 2) for k in range(harness.CHECK_STEPS)]
    harness.flops_per_superstep(c, SEED, 1, "cpu")
    assert mine[-1] == (1, 0, 1, 2) and default == []


def test_the_check_and_the_flop_count_take_the_default_batch(monkeypatch):
    c = tiny_cell("pigan.train16")
    assert not hasattr(spec.reference("pigan_small"), "superstep_batch")
    default = _recording(monkeypatch, plain, "superstep_batch")
    harness.reference_readings(c, SEED, "cpu")
    harness.flops_per_superstep(c, SEED, 1, "cpu")
    assert default == [(0, k, 4, 2) for k in range(harness.CHECK_STEPS)] \
        + [(1, 0, 1, 2)]


def test_the_modules_batch_is_the_loaders(with_stub):
    """The stub's batch read from the files is the one the program's
    Trainer hands the superstep, leaf by leaf, nested analyses included."""
    c = harness.prepare(stub_cell())
    for k, want in enumerate(tiny.trainer_batches(c, SEED, 0, 3)):
        assert set(want["shape_analysis"]) == set(stub.KEYS)
        tiny.assert_same_batch(
            harness.superstep_batch(c, SEED, 0, k, 4, 2, "cpu"), want,
            f"superstep {k}: ")


class _Tiny(plain.GANReference):
    """Two one-layer nets; both losses keep the micro-batches they are
    handed."""

    def __init__(self):
        super().__init__({}, "cpu")
        self.D, self.G = torch.nn.Linear(3, 1), torch.nn.Linear(2, 3)
        self.opt_d = plain.Adam(list(self.D.parameters()), (0.0, 0.9))
        self.opt_g = plain.Adam(list(self.G.parameters()), (0.0, 0.9))
        self.lr_d = self.lr_g = lambda count: 1e-3
        self.handed = []

    def sample_z(self, n):
        return torch.ones(n, 2)

    def disc_loss(self, batch, z):
        self.handed.append(batch)
        loss = self.D(batch["image"].reshape(-1, 3)).mean()
        return loss, {"d": loss}

    def gen_loss(self, batch, z):
        self.handed.append(batch)
        loss = self.D(self.G(z)).mean()
        return loss, {"g": loss}


def test_superstep_hands_a_loss_the_nested_micro_batch():
    batch = {"image": torch.randn(2, 5, 3),
             "shape_analysis": {"verts": torch.randn(2, 5, 7, 3),
                                "deeper": {"mask": torch.randn(2, 5, 4)}}}
    ref = _Tiny()
    ref.superstep(batch, accum=1)
    assert len(ref.handed) == 2
    for i, micro in enumerate(ref.handed):
        assert torch.equal(micro["image"], batch["image"][i])
        sa = micro["shape_analysis"]
        assert torch.equal(sa["verts"], batch["shape_analysis"]["verts"][i])
        assert torch.equal(sa["deeper"]["mask"],
                           batch["shape_analysis"]["deeper"]["mask"][i])


# ------------------------------------------------------------ half_batch
def _halved(batch, z):
    handed = []

    class Task:
        def disc_loss(self, b, zz, extra):
            handed.append((b, zz, extra))

        gen_loss = disc_loss

    trainer = type("T", (), {"task": Task()})()
    with faults.half_batch(trainer):
        trainer.task.disc_loss(batch, z, "extra")
        trainer.task.gen_loss(batch, z, "extra")
    return handed


def test_half_batch_cuts_every_leaf_of_a_nested_batch():
    batch = {"image": torch.randn(6, 3, 4, 4),
             "shape_analysis": {"verts": torch.randn(6, 9, 3),
                                "faces": torch.randn(6, 5, 3),
                                "deeper": {"mask": torch.randn(6, 4, 4)}}}
    z = torch.randn(6, 8)
    for b, zz, extra in _halved(batch, z):
        assert extra == "extra" and torch.equal(zz, z[:3])
        assert torch.equal(b["image"], batch["image"][:3])
        sa, want = b["shape_analysis"], batch["shape_analysis"]
        assert sa.keys() == want.keys()
        assert torch.equal(sa["verts"], want["verts"][:3])
        assert torch.equal(sa["faces"], want["faces"][:3])
        assert torch.equal(sa["deeper"]["mask"], want["deeper"]["mask"][:3])


def test_half_batch_cuts_a_flat_batch_as_before():
    batch = {"image": torch.randn(5, 3, 4, 4), "label": torch.arange(5)}
    z = torch.randn(5, 8)
    for b, zz, _ in _halved(batch, z):
        before = {k: v[:2] for k, v in batch.items()}
        assert b.keys() == before.keys()
        assert all(torch.equal(b[k], before[k]) for k in before)
        assert torch.equal(zz, z[:2])


# ---------------------------------------------------------- prepare_data
def test_prepare_data_runs_once_for_a_digest(with_stub):
    c = stub_cell()
    for _ in range(2):
        harness.drive(c, SEED, 0.0, False, "cpu", window=False)
    assert len(stub.calls) == 1
    dirs = [p for p in (with_stub / stub.NAME).iterdir()]
    assert len(dirs) == 1 and (dirs[0] / harness.DATA_MARKER).is_file()
    data = json.loads((dirs[0] / harness.DATA_MARKER).read_text())
    assert data == {"filepaths.birds_root": str(dirs[0] / "images"),
                    "filepaths.birds_analysis_root": str(dirs[0]
                                                         / "analysis")}
    assert harness.prepare(c)["values"]["filepaths.birds_root"] == \
        data["filepaths.birds_root"]
    assert harness.prepare(harness.prepare(c))["values"] == \
        harness.prepare(c)["values"]
    assert len(stub.calls) == 1
    harness.drive(stub_cell(**{"dataset.n": 40}), SEED, 0.0, False, "cpu",
                  window=False)
    assert len(stub.calls) == 2
    assert len(list((with_stub / stub.NAME).iterdir())) == 2


def test_a_directory_without_its_marker_is_made_again(with_stub):
    c = stub_cell()
    first = harness.prepare(c)
    root = with_stub / stub.NAME / harness._data_digest(stub, c["values"])
    (root / harness.DATA_MARKER).unlink()
    (root / "images" / "train" / "birds" / "im_00000.png").write_bytes(b"")
    again = harness.prepare(c)
    assert len(stub.calls) == 2 and again["values"] == first["values"]
    assert (root / harness.DATA_MARKER).is_file()
    assert (root / "images" / "train" / "birds" / "im_00000.png"
            ).stat().st_size > 0
    assert [p.name for p in root.parent.iterdir()] == [root.name]


def test_a_configuration_without_prepare_data_is_as_it_was(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(harness, "DATA_ROOT", tmp_path / "data")
    c = tiny_cell("pigan.train16")
    assert harness.prepare(c) is c
    assert not (tmp_path / "data").exists()


# ------------------------------------------------------------- a whole run
def test_the_stub_runs_end_to_end_and_is_correct(with_stub):
    c = stub_cell()
    result, numbers = runner.run_cell(c, SEED, 0.0, False, "cpu",
                                      time.perf_counter())
    assert result["correct"], numbers
    assert result["attempted"] > 0 and result["failed"] == 0
    assert len(stub.calls) == 1
    # every micro-batch the reference's D loss was handed held the
    # analyses, as many rows of each as of images: 4 in the check's
    # supersteps, 1 in the FLOP count's
    rows = []
    for micro in stub.Reference.seen:
        rows.append(micro["image"][0])
        assert {k: v[0] for k, v in micro["shape_analysis"].items()} == \
            {k: rows[-1] for k in stub.KEYS}
    assert rows == [4] * harness.CHECK_STEPS + [1]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_each_fault_on_the_stub_is_not_correct(with_stub, fault):
    c = stub_cell()
    result, numbers = runner.run_cell(c, SEED, 0.0, False, "cpu",
                                      time.perf_counter(),
                                      plant=faults.FAULTS[fault])
    assert not result["correct"], numbers
