"""The debug and profiling switches of the port's Trainer, each through
run_network_torch.py on the CPU at tiny widths: ``debug.fast_dev_run``
(exactly one superstep and one validation), ``debug.verbose_shape`` (the
table of G's submodules and their output shapes), ``profile=true`` (a
Chrome trace under <run>/trace, parsed by utils/profiling.py, that shows
the program's spans); and the trace readers on a hand-written trace."""
import json
import re

import pytest
import torch

import run_network_torch
from lightning_gan_zoo_tpu_torch.runtime import loop
from lightning_gan_zoo_tpu_torch.utils import profiling

torch.set_num_threads(2)

DC = ["+expt=dc_gan", "dataset=synthetic", "calc_fid=False", "~figures",
      "save_ckpts=False", "train.img_size=16", "train.batch_size=4",
      "train.features_disc=4", "train.features_gen=4", "model.noise_dim=8",
      "dataset.n=48", "--device", "cpu"]
HOLO = ["+expt=hologan", "dataset=synthetic", "calc_fid=False",
        "save_ckpts=False", "~figures", "precision=32",
        "generator.in_planes=4", "discriminator.out_planes=4",
        "model.noise_dim=8", "train.batch_size=2", "dataset.n=12",
        "train.num_epochs=1", "--device", "cpu"]


def test_fast_dev_run_one_superstep_one_validation(tmp_path, monkeypatch,
                                                  capsys):
    calls = {"superstep": 0, "validate": 0}
    real_superstep, real_validate = loop.superstep, loop.Trainer.validate

    def counting_superstep(*a, **kw):
        calls["superstep"] += 1
        return real_superstep(*a, **kw)

    def counting_validate(self, *a, **kw):
        calls["validate"] += 1
        return real_validate(self, *a, **kw)

    monkeypatch.setattr(loop, "superstep", counting_superstep)
    monkeypatch.setattr(loop.Trainer, "validate", counting_validate)
    assert run_network_torch.main(
        DC + ["train.num_epochs=5", "train.fold_steps=3",
              "debug.fast_dev_run=true", f"output_root={tmp_path}",
              "version=v"]) == 0
    assert calls == {"superstep": 1, "validate": 1}
    out = capsys.readouterr().out
    assert re.findall(r"^epoch (\d+) \[", out, re.M) == ["0"]
    images = sorted(p.name for p in
                    (tmp_path / "dc_gan" / "v" / "images").iterdir())
    # one superstep is dc_gan's two micro-steps (1 D, 1 G)
    assert [n for n in images if n.startswith("Fake")] == ["Fake_step2.png"]


def test_verbose_shape_prints_the_table(tmp_path, capsys):
    assert run_network_torch.main(
        HOLO + ["debug.verbose_shape=true", f"output_root={tmp_path}"]) == 0
    out = capsys.readouterr().out
    assert "[debug] generator output shapes (2 samples):" in out
    rows = {m.group(1): (m.group(2), m.group(3)) for m in re.finditer(
        r"^  (\S+)\s+(\S+)\s+(\(.*)$", out, re.M)}
    assert rows["generator"] == ("Generator", "(2, 3, 64, 64)")
    assert rows["block3d_1"] == ("GenBlock3D", "(2, 4, 16, 16, 16)")
    assert rows["block3d_1.convt"][0] == "ConvTranspose3d"
    assert rows["zmap"] == ("ZMapping", "(2, 32), (2, 32)")
    assert rows["out_conv"] == ("Conv2d", "(2, 3, 64, 64)")
    assert not any(name.count(".") > 1 for name in rows)   # depth 2
    assert re.search(r"^epoch 0 \[", out, re.M)            # training went on


def test_verbose_shape_failure_does_not_end_the_run(tmp_path, capsys,
                                                    monkeypatch):
    from lightning_gan_zoo_tpu_torch.tasks.gan2d import HOLOGAN
    real, calls = HOLOGAN.generate, []

    def broken_once(self, *a, **kw):     # the table's call only
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("no shapes today")
        return real(self, *a, **kw)

    monkeypatch.setattr(HOLOGAN, "generate", broken_once)
    assert run_network_torch.main(
        HOLO + ["debug.verbose_shape=true", f"output_root={tmp_path}"]) == 0
    out = capsys.readouterr().out
    assert "[debug] verbose_shape failed: no shapes today" in out


def test_profile_writes_and_parses_a_trace(tmp_path, capsys):
    """12 supersteps: the window (supersteps 2–6) closes inside the run.
    On the CPU the trace holds host operators and no card kernels."""
    assert run_network_torch.main(
        DC + ["train.num_epochs=2", "profile=true", f"output_root={tmp_path}",
              "version=v"]) == 0
    trace_dir = tmp_path / "dc_gan" / "v" / "trace"
    assert f"[profile] trace written to {trace_dir / 'trace.json'}" \
        in capsys.readouterr().out
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op"]
    assert any(e["name"] == "aten::convolution" for e in ops)
    assert profiling.device_op_times(trace_dir) == {}
    assert profiling.device_time_ms(trace_dir) == 0.0


def test_profile_trace_holds_the_trainer_spans(tmp_path):
    """The traced supersteps (the 4th to the 8th of 12, six an epoch, one
    loader stack each) show the program's spans as the Chrome trace's user
    annotations: each superstep and its phases, the Trainer's copy of each
    stack to the device and its wait for each, and for the end of epoch 0
    (the sixth wait)."""
    assert run_network_torch.main(
        DC + ["train.num_epochs=2", "profile=true", f"output_root={tmp_path}",
              "version=v"]) == 0
    trace = tmp_path / "dc_gan" / "v" / "trace" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    count = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            count[e["name"]] = count.get(e["name"], 0) + 1
    assert {n: count.get(n) for n in (
        "zoo.loader_wait", "zoo.to_device", "zoo.superstep", "zoo.d.forward",
        "zoo.d.backward", "zoo.d.update", "zoo.g.forward", "zoo.g.backward",
        "zoo.g.update")} == {
        "zoo.loader_wait": 6, "zoo.to_device": 5, "zoo.superstep": 5,
        "zoo.d.forward": 5, "zoo.d.backward": 5, "zoo.d.update": 5,
        "zoo.g.forward": 5, "zoo.g.backward": 5, "zoo.g.update": 5}


def test_trace_readers_union_the_kernels(tmp_path):
    """Kernels on two streams overlap: the busy time is their union, the
    per-name times their sums; host events are not counted."""
    events = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 10},
              {"ph": "X", "cat": "kernel", "name": "b", "ts": 5, "dur": 10},
              {"ph": "X", "cat": "kernel", "name": "a", "ts": 30, "dur": 5},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
               "dur": 100}]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    assert profiling.device_op_times(tmp_path) == {"a": (15.0, 2),
                                                   "b": (10.0, 1)}
    assert profiling.device_time_ms(tmp_path) == pytest.approx(0.020)
    assert profiling.union_us([(0, 10), (5, 15), (30, 35), (31, 32)]) == 20


def test_trace_capture_window_and_close(tmp_path):
    """tick() starts the profiler after ``warmup`` steps and writes the
    trace after ``span`` more; close() writes one still open."""
    cap = profiling.TraceCapture(tmp_path / "a", enabled=True,
                                 warmup_steps=1, trace_steps=2)
    for _ in range(4):
        torch.ones(8) @ torch.ones(8)
        cap.tick()
    assert (tmp_path / "a" / "trace.json").exists()
    cap = profiling.TraceCapture(tmp_path / "b", enabled=True,
                                 warmup_steps=0, trace_steps=50)
    cap.tick()
    cap.close()
    assert (tmp_path / "b" / "trace.json").exists()
    off = profiling.TraceCapture(tmp_path / "c")
    for _ in range(10):
        off.tick()
    off.close()
    assert not (tmp_path / "c").exists()
