"""runtime/graphs.py's rule for when the discriminator side of π-GAN's
losses may replay from CUDA graphs, and what runs where it may not, on the
CPU: off a CUDA device, at tp > 1, under fsdp and with gradients off every
call runs eagerly, under its eager span, and captures nothing. Also the
benchmark's reader of those spans, ``d_side_replay_share``, on hand-made
traces. (The replays themselves are held to the eager calls bit for bit in
tests/test_torch_cuda.py, on the card.)"""
import pytest
import torch

from tests.conftest import CONF_DIR
from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.config.registry import instantiate
from lightning_gan_zoo_tpu_torch.parallel import dist
from lightning_gan_zoo_tpu_torch.runtime import graphs
from perfbench import spec
from perfbench.trace import Context, Trace

#: (device, tp size, fsdp, gradients on) → may the call replay
RULE = {"cuda": (("cuda", 1, False, True), True),
        "cpu": (("cpu", 1, False, True), False),
        "tp2": (("cuda", 2, False, True), False),
        "fsdp": (("cuda", 1, True, True), False),
        "no_grad": (("cuda", 1, False, False), False)}


def _calls(monkeypatch, device, tp, fsdp):
    monkeypatch.setattr(dist, "tp_size", lambda: tp)
    return graphs.GraphedCalls("zoo.d_side", device, fsdp=fsdp)


@pytest.mark.parametrize("case", sorted(RULE))
def test_replay_rule(monkeypatch, case):
    (device, tp, fsdp, grad), want = RULE[case]
    calls = _calls(monkeypatch, device, tp, fsdp)
    with torch.set_grad_enabled(grad):
        assert calls.replayable() is want


@pytest.mark.parametrize("case", sorted(c for c in RULE if not RULE[c][1]))
def test_an_ineligible_call_runs_eagerly_and_captures_nothing(monkeypatch,
                                                              case):
    (device, tp, fsdp, grad), _ = RULE[case]
    calls = _calls(monkeypatch, device, tp, fsdp)

    def no_capture(*args):
        raise AssertionError("captured")

    monkeypatch.setattr(graphs, "_Graphed", no_capture)
    d = torch.nn.Linear(3, 1)
    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof, torch.set_grad_enabled(grad):
        (out,) = calls(lambda m, v: (m(v).mean(),), ("d", 16), d, x)
    assert torch.equal(out, d(x).mean())
    assert calls.graphs == {}
    names = [e.name for e in prof.events()]
    assert names.count("zoo.d_side.eager") == 1
    assert "zoo.d_side.replay" not in names


@pytest.mark.parametrize("fsdp", [False, True])
def test_pigan_task_reads_fsdp_and_runs_eagerly_on_the_cpu(tmp_path, fsdp):
    """The task's D side takes fsdp from the config; on the CPU a D and a
    G loss run eagerly and capture nothing."""
    cfg = compose(CONF_DIR, [
        "+expt=pigan", "machine=local", "dataset=synthetic",
        "calc_fid=False", "~figures", "save_ckpts=False",
        "model.noise_dim=16", "nerf.siren_dim_hidden=32",
        "nerf.siren_num_layers=2", "nerf.n_pts_per_ray=4",
        "nerf.n_pts_per_ray_fine=4", "train.features_disc=8",
        "train.img_size=16", "resolution_annealing.resolutions=[8,16]",
        "variable_batch_size.batch_sizes=[2,2]", "precision=32",
        f"fsdp={str(fsdp).lower()}"])
    task = instantiate(cfg.model.lm, cfg, str(tmp_path), device="cpu")
    assert task.d_side.fsdp is fsdp
    assert not task.d_side.replayable()
    extra = task.initial_extra()
    images = torch.rand(2, 3, 16, 16,
                        generator=torch.Generator().manual_seed(1)) * 2 - 1
    d_loss, d_metrics = task.disc_loss({"image": images}, task.sample_z(2),
                                       extra)
    g_loss, _ = task.gen_loss({"image": images}, task.sample_z(2), extra)
    (d_loss + g_loss).backward()
    assert torch.equal(d_metrics["d_loss"], d_loss.detach())
    assert d_loss.requires_grad and g_loss.requires_grad
    assert task.d_side.graphs == {}


def _share(host_names):
    read = spec.load_module(spec.HERE / "metrics" / "d_side_replay_share.py",
                            "reader_d_side_replay_share").read
    host = [(n, float(i), float(i) + 1.0, []) for i, n in
            enumerate(host_names)]
    return read(Context(Trace([("k", 0.0, 1.0)], host, 1e-3, 1),
                        untraced_s=1.0, untraced_supersteps=10,
                        flops_per_superstep=None))


@pytest.mark.parametrize("names,want", [
    (["zoo.superstep", "zoo.d_side.replay", "zoo.d_side.replay"], 100.0),
    (["zoo.d_side.replay"] * 3 + ["zoo.d_side.eager"], 75.0),
    (["zoo.d_side.eager", "zoo.d_side.eager"], 0.0),
    (["zoo.superstep", "zoo.d.forward"], None)])
def test_d_side_replay_share_reads_the_spans(names, want):
    assert _share(names) == want
