"""The program's spans (utils/profiling.py::span), on the CPU at tiny
widths: one superstep under a profiler started and stopped around the call,
as the benchmark's traced stretch drives it, holds one ``zoo.superstep`` and,
nested in it, each phase's forward and backward per micro-step and update
per optimizer step, and ends with the losses and parameters bit for bit
where a run with no profiler ends; with no profiler no span enters
``record_function``."""
import pytest
import torch

from tests.conftest import CONF_DIR
from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.config.registry import instantiate
from lightning_gan_zoo_tpu_torch.runtime.state import create_train_state
from lightning_gan_zoo_tpu_torch.runtime.steps import (microbatch_count,
                                                       superstep)

torch.set_num_threads(2)

DC = ["+expt=dc_gan", "dataset=synthetic", "calc_fid=False", "~figures",
      "save_ckpts=False", "train.img_size=16", "train.batch_size=4",
      "train.features_disc=4", "train.features_gen=4", "model.noise_dim=8"]
PIGAN = ["+expt=pigan", "machine=local", "dataset=synthetic",
         "calc_fid=False", "~figures", "save_ckpts=False",
         "model.noise_dim=16", "nerf.siren_dim_hidden=32",
         "nerf.siren_num_layers=2", "nerf.n_pts_per_ray=4",
         "nerf.n_pts_per_ray_fine=4", "train.features_disc=8",
         "train.img_size=32", "resolution_annealing.resolutions=[8,16,32]",
         "variable_batch_size.batch_sizes=[2,2,2]", "precision=32"]
#: (overrides, rows a micro-batch, accumulation)
CASES = {"dc_gan": (DC, 4, 2), "pigan": (PIGAN, 2, 1)}


def _run(tmp_path, name, profiled):
    """(cfg, metrics, parameters after one superstep, the profiler's
    events or None) from the seed's weights."""
    overrides, rows, accum = CASES[name]
    cfg = compose(CONF_DIR, overrides)
    task = instantiate(cfg.model.lm, cfg, str(tmp_path), device="cpu")
    state = create_train_state(task, steps_per_epoch=4)
    df, gf = int(cfg.optimisation.disc_freq), int(cfg.optimisation.gen_freq)
    size, ch = int(cfg.train.img_size), int(cfg.dataset.n_channels)
    images = torch.rand(microbatch_count(df, gf, accum), rows, ch, size, size,
                        generator=torch.Generator().manual_seed(3)) * 2 - 1
    prof = None
    if profiled:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True)
        prof.start()
    try:
        metrics = superstep(task, state, {"image": images}, df, gf, accum)
    finally:
        if prof is not None:
            prof.stop()
    params = [p.detach().clone() for net in (task.generator,
                                             task.discriminator)
              for p in net.parameters()]
    return (cfg, {k: v.clone() for k, v in metrics.items()}, params,
            None if prof is None else prof.events())


def _ancestors(event):
    out, e = [], event.cpu_parent
    while e is not None:
        out.append(e.name)
        e = e.cpu_parent
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_superstep_spans_nest_and_count(tmp_path, name):
    cfg, metrics, params, events = _run(tmp_path, name, profiled=True)
    _, plain_metrics, plain_params, _ = _run(tmp_path, name, profiled=False)
    accum = CASES[name][2]
    spans = [e for e in events if e.name.startswith("zoo.")]
    count = {}
    for e in spans:
        count[e.name] = count.get(e.name, 0) + 1
    freq = {"d": int(cfg.optimisation.disc_freq),
            "g": int(cfg.optimisation.gen_freq)}
    want = {"zoo.superstep": 1}
    for net, f in freq.items():
        want.update({f"zoo.{net}.forward": f * accum,
                     f"zoo.{net}.backward": f * accum,
                     f"zoo.{net}.update": f})
    assert count == want
    for e in spans:
        if e.name != "zoo.superstep":
            assert _ancestors(e)[-1] == "zoo.superstep", e.name
            assert not any(a.startswith("zoo.") for a in _ancestors(e)[:-1])
    # the optimizer's own range opens inside the update span
    adam = [e for e in events if e.name.startswith("Optimizer.step#")]
    assert len(adam) == sum(freq.values())
    assert all(_ancestors(e)[0] in ("zoo.d.update", "zoo.g.update")
               for e in adam)
    assert metrics.keys() == plain_metrics.keys()
    assert all(torch.equal(metrics[k], plain_metrics[k]) for k in metrics)
    assert all(torch.equal(a, b) for a, b in zip(params, plain_params))


def test_spans_off_enter_no_record_function(tmp_path, monkeypatch):
    """With no profiler a span is the shared no-op context: a superstep
    runs with ``record_function`` broken. Under a profiler the same
    superstep reaches it."""
    def broken(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", broken)
    _, metrics, _, _ = _run(tmp_path, "dc_gan", profiled=False)
    assert metrics and all(torch.isfinite(v) for v in metrics.values())
    with pytest.raises(AssertionError, match="zoo.superstep"):
        _run(tmp_path, "dc_gan", profiled=True)
    assert not torch._C._autograd._profiler_enabled()
