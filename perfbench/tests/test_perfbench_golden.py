"""``pigan.train16``'s reference readings at its tiny widths, frozen in
``goldens/pigan.train16.json`` from the harness as it was before the
reference took its superstep batch as a dict: every loss, every leaf's
gradient and change norms and the FLOP count come out the same bit for
bit. Read on one CPU thread, since the order of a product's sums follows
the thread count, and only under the torch build the golden was frozen on
(another build's kernels round otherwise)."""
import json
from pathlib import Path

import pytest
import torch

from perfbench import harness
from perfbench.tests.tiny import tiny_cell

GOLDEN = json.loads((Path(__file__).resolve().parent / "goldens"
                     / "pigan.train16.json").read_text())
FROZEN_ON = "2.13.0+cpu"


@pytest.fixture
def one_thread():
    if torch.__version__ != FROZEN_ON:
        pytest.skip(f"the golden was frozen under torch {FROZEN_ON}, "
                    f"this is {torch.__version__}")
    before = torch.get_num_threads()
    torch.set_num_threads(GOLDEN["torch_threads"])
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_reference_readings_are_the_golden(one_thread):
    c = tiny_cell(GOLDEN["cell"])
    got = harness.reference_readings(c, GOLDEN["seed"], "cpu")
    assert got["losses"] == GOLDEN["losses"]
    for key in ("grad", "change1", "change"):
        assert got[key] == GOLDEN[key], key


def test_flop_count_is_the_golden(one_thread):
    c = tiny_cell(GOLDEN["cell"])
    assert harness.flops_per_superstep(c, GOLDEN["seed"], 1, "cpu") == \
        GOLDEN["flops_per_superstep"]
