"""The process group's pieces (parallel/dist.py) on the CPU, over gloo:

  * BatchNorm2d over the global batch on 2 and 4 ranks against one device
    on the concatenated batch and against flax's nn.BatchNorm: the output,
    the biased running mean and variance (momentum 0.9), the first- and
    second-order input gradients, and frozen_stats (global statistics, no
    buffer update); within 1e-5 (flax: 1e-4 on the gradients' own scale);
  * the random draws: every training stream (z, WGAN-GP's α, HoloGAN's and
    π-GAN's views, π-GAN's stratified depths and fine samples, ANIGAN's
    deformation noise) drawn on 2 ranks concatenates to the one-device
    draw, and every stream is left where the one-device draw leaves it;
  * the loader: the Trainer's EpochLoader on each of 2 ranks, over one
    epoch, holds rows whose union per superstep is the global batch of the
    JAX package's EpochLoader at process_count 2, with the supersteps per
    epoch the schedule table counts; the ranks agree on the run version and
    only rank 0 logs;
  * no fallback: a NCCL group that cannot start raises and leaves no group;
    a rank that fails ends the launch with an error, its peers stopped;
  * bounded and clean: ``run_ranks`` leaves no rank file behind after a
    launch that passes or fails, and a rank that never returns makes a
    launch with a deadline raise, naming it, soon after the deadline.

One group of 2 ranks and one of 4 per module, each running every job in
the same workers.
"""
import errno
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.config.registry import instantiate
from lightning_gan_zoo_tpu_torch.models.layers import BatchNorm2d, frozen_stats
from lightning_gan_zoo_tpu_torch.parallel import dist
from tests.test_torch_dist_families import run_ranks

torch.set_num_threads(2)

CONF_DIR = Path(__file__).resolve().parent.parent / "conf"
BN_SHAPE = (8, 3, 4, 4)            # global batch 8
DRAW_BATCH = 4                     # global batch of the draws
NERF_TINY = ["machine=local", "model.noise_dim=16",
             "nerf.siren_dim_hidden=32", "nerf.siren_num_layers=2",
             "nerf.n_pts_per_ray=4", "nerf.n_pts_per_ray_fine=4",
             "train.features_disc=8", "precision=32",
             "resolution_annealing.resolutions=[8,16]"]
DRAW_CONFIGS = {
    "wgan_gp": ["+expt=wgan_gp", "train.img_size=16",
                "train.features_disc=4", "train.features_gen=4",
                "model.noise_dim=8"],
    "hologan": ["+expt=hologan", "precision=32", "generator.in_planes=4",
                "discriminator.out_planes=4", "model.noise_dim=8"],
    "pigan": ["+expt=pigan", *NERF_TINY],
    "anigan": ["+expt=anigan", *NERF_TINY]}
LOADER_ARGS = ["+expt=dc_gan", "dataset=synthetic", "calc_fid=False",
               "save_ckpts=False", "~figures", "train.img_size=8",
               "train.batch_size=4", "train.features_disc=4",
               "train.features_gen=4", "model.noise_dim=8", "dataset.n=37"]


def bn_inputs():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=BN_SHAPE) * 2 + 1).astype(np.float32)
    w_out = rng.normal(size=BN_SHAPE).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=BN_SHAPE[1])).astype(np.float32)
    bias = (0.1 * rng.normal(size=BN_SHAPE[1])).astype(np.float32)
    return x, w_out, scale, bias


def bn_job() -> dict:
    """Train-mode BatchNorm on this rank's rows: the output, the running
    statistics, the gradients of Σ y·w_out and of Σ (∂/∂x)², and a second
    call under frozen_stats."""
    x, w_out, scale, bias = (torch.from_numpy(a) for a in bn_inputs())
    x, w_out = dist.local_rows(x), dist.local_rows(w_out)
    bn = BatchNorm2d(BN_SHAPE[1])
    with torch.no_grad():
        bn.weight.copy_(scale)
        bn.bias.copy_(bias)
    x = x.clone().requires_grad_(True)
    y = bn(x)
    gx, = torch.autograd.grad((y * w_out).sum(), x, create_graph=True)
    g2, = torch.autograd.grad(gx.square().sum(), x)
    stats = (bn.running_mean.clone(), bn.running_var.clone())
    with frozen_stats(bn), torch.no_grad():
        y_frozen = bn(x)
    return {"y": y.detach(), "gx": gx.detach(), "g2": g2,
            "running_mean": stats[0], "running_var": stats[1],
            "y_frozen": y_frozen,
            "frozen_buffers_kept": bool(
                torch.equal(bn.running_mean, stats[0])
                and torch.equal(bn.running_var, stats[1]))}


def _task(name, tmp):
    cfg = compose(CONF_DIR, [*DRAW_CONFIGS[name], "dataset=synthetic"])
    return instantiate(cfg.model.lm, cfg, str(tmp), device="cpu")


def draws_job(tmp, n: int) -> dict:
    """Every training stream's draws for ``n`` rows of this rank (inside
    global_draws), and each stream's state after them."""
    out, states = {}, {}
    with dist.global_draws(), torch.no_grad():
        task = _task("wgan_gp", tmp)
        out["z"] = task.sample_z(n)
        out["gp_alpha"] = task.sample_gp_alpha(n)
        states["wgan_gp"] = task.generators()
        task = _task("hologan", tmp)
        out["hologan_views"] = task.generator(
            task.sample_z(n), generator=task.view_generator)
        states["hologan"] = task.generators()
        task = _task("pigan", tmp)            # views, depths, fine samples
        out["pigan_render"] = task.render_fake(task.sample_z(n))
        states["pigan"] = task.generators()
        task = _task("anigan", tmp)           # + the deformation noise
        out["anigan_render"] = task.generator(
            task.sample_z(n), sample_res=8,
            view_generator=task.view_generator,
            depth_generator=task.depth_generator,
            fine_generator=task.fine_generator,
            deform_generator=task.deform_generator)
        states["anigan"] = task.generators()
    out["states"] = {f"{fam}/{k}": g.get_state() for fam, gens
                     in states.items() for k, g in gens.items()}
    return out


def loader_job(tmp) -> dict:
    """The Trainer's loader over one epoch on this rank."""
    from lightning_gan_zoo_tpu_torch.runtime.loop import Trainer
    cfg = compose(CONF_DIR, [*LOADER_ARGS, f"output_root={tmp}"])
    trainer = Trainer(cfg, "cpu")
    loader = trainer._make_train_loader()
    return {"images": [b["image"] for b in loader.epoch(0)],
            "table": trainer._epoch_superstep_table(len(loader.dataset), 1),
            "version": trainer.version,
            "logs": trainer.logger.enabled,
            "process": (loader.process_index, loader.process_count)}


def fail_on_rank_1():
    if dist.rank() == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()          # rank 0 would wait here for ever
    return {}


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist2")
    return run_ranks([("bn", bn_job, ()),
                      ("draws", draws_job, (str(tmp), DRAW_BATCH // 2)),
                      ("loader", loader_job, (str(tmp / "loader"),))],
                     tmp / "out", n=2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist4")
    return run_ranks([("bn", bn_job, ())], tmp / "out", n=4)


def _cat(ranks, name, key):
    return torch.cat([r[name][key] for r in ranks]).numpy()


@pytest.mark.parametrize("world", [2, 4])
def test_batch_norm_over_the_global_batch(world, two, four):
    ranks = two if world == 2 else four
    assert len(ranks) == world
    want = bn_job()                        # no group: one device
    for key in ("y", "gx", "g2", "y_frozen"):
        np.testing.assert_allclose(_cat(ranks, "bn", key), want[key].numpy(),
                                   atol=1e-5, err_msg=key)
    for r in ranks:
        assert r["bn"]["frozen_buffers_kept"]
        for key in ("running_mean", "running_var"):
            assert torch.equal(r["bn"][key], ranks[0]["bn"][key])
            np.testing.assert_allclose(r["bn"][key].numpy(),
                                       want[key].numpy(), atol=1e-6,
                                       err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_batch_norm_over_the_global_batch_matches_flax(world, two, four):
    import jax
    import jax.numpy as jnp
    from flax import linen as fnn

    ranks = two if world == 2 else four
    x, w_out, scale, bias = bn_inputs()
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    nhwc = jnp.asarray(np.moveaxis(x, 1, -1))
    variables = bn.init(jax.random.PRNGKey(0), nhwc)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def loss(xh):
        y, _ = bn.apply({"params": params, **{k: v for k, v in
                                              variables.items()
                                              if k != "params"}},
                        xh, mutable=["batch_stats"])
        return jnp.sum(y * jnp.moveaxis(jnp.asarray(w_out), 1, -1))

    y, upd = bn.apply({"params": params, "batch_stats":
                       variables["batch_stats"]}, nhwc,
                      mutable=["batch_stats"])
    gx = jax.grad(loss)(nhwc)
    g2 = jax.grad(lambda xh: jnp.sum(jax.grad(loss)(xh) ** 2))(nhwc)
    for key, want in (("y", y), ("gx", gx), ("g2", g2)):
        want = np.moveaxis(np.asarray(want), -1, 1)
        np.testing.assert_allclose(
            _cat(ranks, "bn", key), want,
            atol=1e-4 * max(1.0, float(np.abs(want).max())), err_msg=key)
    for key, flax_key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            ranks[0]["bn"][key].numpy(),
            np.asarray(upd["batch_stats"][flax_key]), atol=1e-5,
            err_msg=key)


@pytest.mark.parametrize("stream", ["z", "gp_alpha", "hologan_views",
                                    "pigan_render", "anigan_render"])
def test_every_stream_draws_the_global_batch(stream, two, tmp_path):
    want = draws_job(tmp_path, DRAW_BATCH)     # no group: one device
    got = _cat(two, "draws", stream)
    if stream in ("z", "gp_alpha"):
        np.testing.assert_array_equal(got, want[stream].numpy())
    else:       # per-sample math on another batch size: rounding only
        np.testing.assert_allclose(got, want[stream].numpy(), atol=1e-5)
    for r in two:
        assert set(r["draws"]["states"]) == set(want["states"])
        for k, s in want["states"].items():
            assert torch.equal(r["draws"]["states"][k], s), k


def test_loader_rows_are_the_jax_global_batch(two):
    """dataset.n = 37 does not divide over 2 ranks: each stripe holds 18
    rows, four supersteps of 2 rows × 2 micro-batches, as the JAX loader
    counts them."""
    from lightning_gan_zoo_tpu.data.pipeline import EpochLoader as JaxLoader
    from lightning_gan_zoo_tpu_torch.runtime.loop import _dataset_kwargs
    cfg = compose(CONF_DIR, LOADER_ARGS)
    ds = instantiate(cfg.dataset.train, **_dataset_kwargs(cfg))
    jax_loaders = [JaxLoader(ds, 4, n_micro=2, seed=42, process_index=r,
                             process_count=2) for r in range(2)]
    want = [np.concatenate(parts, axis=1) for parts in
            zip(*[[b["image"] for b in jl.epoch(0)] for jl in jax_loaders])]
    got = [np.concatenate(parts, axis=1) for parts in
           zip(*[r["loader"]["images"] for r in two])]
    assert len(got) == len(want) == jax_loaders[0].steps_per_epoch() == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [r["loader"]["process"] for r in two] == [(0, 2), (1, 2)]
    assert [r["loader"]["table"] for r in two] == [[4], [4]]
    assert two[0]["loader"]["version"] == two[1]["loader"]["version"]
    assert [r["loader"]["logs"] for r in two] == [True, False]


def test_nccl_that_cannot_start_raises():
    """No CUDA here, so no NCCL: the group fails to start and nothing falls
    back to gloo."""
    assert dist.backend_for("cuda") == "nccl"
    assert dist.backend_for("cpu") == "gloo"
    with pytest.raises((RuntimeError, ValueError)):
        dist.init(0, 1, "cpu", backend="nccl",
                  init_method=f"tcp://127.0.0.1:{dist.free_port()}")
    assert not dist.is_initialized()


def test_a_failed_rank_fails_the_launch(tmp_path):
    import torch.multiprocessing as mp
    with pytest.raises(mp.ProcessRaisedException) as err:
        run_ranks([("fail", fail_on_rank_1, ())], tmp_path, n=2)
    # whichever rank the launcher saw end first: rank 1 with its error, or
    # rank 0, whose barrier lost its peer
    assert "rank 1 fails" in str(err.value) or err.value.error_index == 0


def shared_and_own_tensors() -> dict:
    """Tensors that every rank holds alike, twice over, and one of its
    own."""
    same = torch.arange(6.0).reshape(2, 3)
    return {"same": same, "again": same.clone(), "rows": [same.t()],
            "own": torch.full((2,), float(dist.rank())),
            "rank": dist.rank()}


class _Unsaveable:
    """Pickling it fails as a write to a full disk does, once rank 0's file
    is there (so that a rank file exists when the launch fails)."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir

    def __reduce__(self):
        t0 = time.monotonic()
        while (not (Path(self.out_dir) / "rank0.pt").exists()
               and time.monotonic() - t0 < 60):
            time.sleep(0.05)
        raise OSError(errno.ENOSPC, "No space left on device")


def unsaveable_on_rank_1(out_dir: str) -> dict:
    return {"t": torch.ones(3),
            "x": _Unsaveable(out_dir) if dist.rank() == 1 else None}


def test_run_ranks_leaves_no_rank_file(tmp_path):
    """A passing launch: every rank's results come back whole (what the
    ranks share and what each holds alone) and no rank file is left; a
    launch in which rank 1 cannot write its file fails and leaves none
    either."""
    ranks = run_ranks([("t", shared_and_own_tensors, ())], tmp_path, n=2)
    assert list(tmp_path.glob("rank*.pt")) == []
    for r, got in enumerate(x["t"] for x in ranks):
        assert got["rank"] == r
        torch.testing.assert_close(got["same"],
                                   torch.arange(6.0).reshape(2, 3),
                                   rtol=0, atol=0)
        assert torch.equal(got["again"], got["same"])
        assert torch.equal(got["rows"][0], got["same"].t())
        assert torch.equal(got["own"], torch.full((2,), float(r)))
    import torch.multiprocessing as mp
    out = tmp_path / "failed"
    with pytest.raises(mp.ProcessRaisedException) as err:
        run_ranks([("t", unsaveable_on_rank_1, (str(out),))], out, n=2)
    # rank 1's error, or rank 0's, whose barrier lost its peer
    assert ("No space left on device" in str(err.value)
            or err.value.error_index == 0)
    assert list(out.glob("rank*.pt")) == []


def _blocks_on_rank_1(device):
    if dist.rank() == 1:
        threading.Event().wait()
    return 0


def test_a_launch_past_its_deadline_names_the_stuck_rank():
    """Rank 1 never returns; rank 0 returns and waits for it. A 20 s
    deadline ends the launch within the deadline and the grace period,
    and the error names rank 1 as the rank still running."""
    t0 = time.monotonic()
    with pytest.raises(dist.LaunchDeadlineExceeded) as err:
        dist.launch(_blocks_on_rank_1, (), ["cpu"] * 2, backend="gloo",
                    deadline=20)
    elapsed = time.monotonic() - t0
    assert 20 <= elapsed < 20 + dist.GRACE + 5, elapsed
    assert err.value.running == [1], str(err.value)
    assert "rank(s) [1] still running" in str(err.value)
