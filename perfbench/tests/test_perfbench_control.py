"""``correct`` comes out false for the lower-precision control and for a
broken program, and true for the sound one, each driven through a whole
run on the CPU (the harness's look for a card skipped) at tiny widths and
judged by the cell's own limits."""
import time

import pytest

from perfbench import faults, harness, runner, spec
from perfbench.tests.tiny import tiny_cell

SEED = 3_000_000_041
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _limits_set(c):
    lim = c["workload"]["limits"]
    return lim and all(v is not None for v in lim.values())


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(name):
    c = tiny_cell(name)
    result, numbers = runner.run_cell(c, SEED, 0.0, False, "cpu",
                                      time.perf_counter())
    assert result["correct"], numbers
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_program_is_not_correct(name, fault):
    c = tiny_cell(name)
    if not _limits_set(c):
        pytest.skip("the cell has no limits yet")
    result, numbers = runner.run_cell(c, SEED, 0.0, False, "cpu",
                                      time.perf_counter(),
                                      plant=faults.FAULTS[fault])
    assert not result["correct"], numbers


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference with every product in float8, in the program's
    place, fails the cell's limits."""
    c = tiny_cell(name)
    if not _limits_set(c):
        pytest.skip("the cell has no limits yet")
    ctrl = harness.reference_readings(c, SEED, "cpu", quant=True)
    ref = harness.reference_readings(c, SEED, "cpu")
    limits = c["workload"]["limits"]
    numbers = {k: {"value": v, "limit": limits.get(k)}
               for k, v in harness.compare(ctrl, ref).items()}
    assert not harness.is_correct(ctrl, numbers), numbers
