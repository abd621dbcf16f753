"""The command refuses to measure without a card, never falls back to the
CPU, and a run loads neither JAX nor the JAX package."""
import json
import os
import subprocess
import sys

import pytest

from perfbench import spec

ROOT = spec.ROOT


def _run(args, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env={**os.environ, **(env or {})})


def test_refuses_without_a_card():
    p = _run(["--workload", "pigan.train16", "--seed", "5", "--seconds", "1",
              "--trace", "0"], env={"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_refuses_an_unknown_workload():
    p = _run(["--workload", "nope", "--seed", "5", "--seconds", "1",
              "--trace", "0"])
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_loads_no_jax():
    """A whole tiny run on the CPU, in a process of its own: afterwards no
    module whose top-level name is jax, jaxlib, flax or
    lightning_gan_zoo_tpu is loaded."""
    code = (
        "import sys, time, json; sys.path.insert(0, %r)\n"
        "from perfbench import runner, run\n"
        "from perfbench.tests.tiny import tiny_cell\n"
        "runner.run_cell(tiny_cell('pigan.train16'), 7, 0.0, False, 'cpu',"
        " time.perf_counter())\n"
        "print(json.dumps(run.forbidden_modules()))\n" % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_whole_top_level_names():
    from perfbench import run
    sys.modules.setdefault("lightning_gan_zoo_tpu_torch_x", sys)
    try:
        assert "lightning_gan_zoo_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["lightning_gan_zoo_tpu_torch_x"]


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = _run(["--workload", "pigan.train16", "--seed", "5", "--seconds", "2",
              "--trace", "0"])
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
