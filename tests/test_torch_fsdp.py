"""ZeRO-1 and FSDP through the Trainer and against the JAX package, on the
CPU over gloo.

  * Against the JAX package: the port's two ranks under zero_opt and fsdp
    against the JAX superstep with ``state_shardings(zero=True|fsdp=True)``
    on ``make_mesh(2)``, for dc_gan and wgan_gp, with the inputs and the
    tolerances of tests/test_torch_dist_jax.py.
  * Checkpoints: a state.pt written by two fsdp ranks equals the one plain
    data parallelism writes, tensor for tensor; one fsdp epoch resumed for
    one more under zero_opt equals two straight epochs; the fsdp checkpoint
    restores exactly on one device without sharding and trains on.
"""
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lightning_gan_zoo_tpu.parallel import mesh as pmesh
from lightning_gan_zoo_tpu.runtime.state import create_train_state as jax_state
from lightning_gan_zoo_tpu.runtime.steps import build_superstep
from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.parallel import dist
from lightning_gan_zoo_tpu_torch.runtime.checkpoint import CheckpointManager
from lightning_gan_zoo_tpu_torch.runtime.loop import Trainer
from lightning_gan_zoo_tpu_torch.runtime.state import (create_train_state,
                                                       full_state)
from lightning_gan_zoo_tpu_torch.runtime.steps import superstep
from tests.test_torch_dist_families import make_task, rank_rows, run_ranks
from tests.test_torch_gan2d import CONVERT, LR, _args, _images, make_pair
from tests.test_torch_zero import assert_equal_trees

torch.set_num_threads(2)

CONF_DIR = Path(__file__).resolve().parent.parent / "conf"
B = 4
EXPTS = ("dc_gan", "wgan_gp")
SHARDED = ("zero_opt", "fsdp")


# ----------------------------------------------------- the JAX package
def _jax_sharded_superstep(expt, tmp, mode):
    """The JAX superstep on make_mesh(2) with its state sharded by
    state_shardings (zero, or fsdp), and the port's inputs."""
    jtask, task, g_vars, d_vars = make_pair(expt, tmp)
    cfg = task.cfg
    df, gf = int(cfg.optimisation.disc_freq), int(cfg.optimisation.gen_freq)
    n_micro, s = df + gf, int(cfg.train.img_size)
    d_tx, g_tx = jtask.configure_optimizers(steps_per_epoch=4)
    mesh = pmesh.make_mesh(2)
    flags = dict(zero=True, fsdp=mode == "fsdp")
    st0 = jax_state(g_vars, d_vars, g_tx, d_tx)
    step = pmesh.shard_superstep(
        build_superstep(jtask, g_tx, d_tx, df, gf), mesh,
        donate_state=False,
        state_sh=pmesh.state_shardings(st0, mesh, **flags))
    images = _images((n_micro, B, s, s, 3))
    rng = jax.random.PRNGKey(7)
    st1, metrics = step(
        pmesh.put_state(st0, mesh, **flags),
        jax.device_put({"image": images,
                        "label": np.zeros((n_micro, B), np.int32)},
                       pmesh.batch_sharding(mesh)), rng)
    assert any(not x.sharding.is_fully_replicated
               for x in jax.tree_util.tree_leaves(st1.d_opt) if x.ndim)
    keys = [jax.random.split(jax.random.fold_in(rng, i))
            for i in range(n_micro)]
    zs = [np.array(jtask.sample_z(k[0], B)) for k in keys]
    alphas = [np.array(jax.random.uniform(k[1], (B, 1, 1, 1))) for k in keys]
    to_g, to_d = CONVERT["dc"]
    job = (_args(expt), str(tmp), to_g(g_vars), to_d(d_vars), images, zs,
           alphas)
    st1 = pmesh.gather_tree(st1)
    after = {"G": to_g({"params": st1.g_params, **st1.g_state}),
             "D": to_d({"params": st1.d_params, **st1.d_state})}
    return job, {"metrics": {k: float(v) for k, v in metrics.items()},
                 "before": {"G": job[2], "D": job[3]}, "after": after,
                 "n_upd": {"G": gf, "D": df}}


def fed_sharded_job(mode, overrides, tmp, g_state, d_state, images, zs,
                    alphas) -> dict:
    """tests/test_torch_dist_families.py::fed_superstep_job with the state
    sharded by ``mode``: one superstep from given weights on given global
    images, z and WGAN-GP α (each rank its rows)."""
    cfg, task = make_task(overrides, tmp)
    task.generator.load_state_dict(g_state)
    task.discriminator.load_state_dict(d_state)
    z_iter, a_iter = iter(zs), iter(alphas)
    task.sample_z = lambda n, generator=None: dist.local_rows(
        torch.from_numpy(next(z_iter)))
    task.sample_gp_alpha = lambda n: dist.local_rows(
        torch.from_numpy(next(a_iter)))
    batches = rank_rows({"image": torch.from_numpy(images).permute(
        0, 1, 4, 2, 3).contiguous()})
    state = create_train_state(task, steps_per_epoch=4,
                               zero_opt=True, fsdp=mode == "fsdp")
    assert state.sharding is not None
    metrics = superstep(task, state, batches,
                        int(cfg.optimisation.disc_freq),
                        int(cfg.optimisation.gen_freq))
    full = full_state(task, state)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "G": full["generator"], "D": full["discriminator"]}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp_jax")
    jobs, want = [], {}
    for expt in EXPTS:
        for mode in SHARDED:
            job, want[expt, mode] = _jax_sharded_superstep(
                expt, tmp / f"{expt}_{mode}", mode)
            jobs.append((f"{expt}/{mode}", fed_sharded_job, (mode, *job)))
    return run_ranks(jobs, tmp / "out"), want


@pytest.mark.parametrize("mode", SHARDED)
@pytest.mark.parametrize("expt", EXPTS)
def test_sharded_ranks_match_the_jax_sharded_superstep(expt, mode,
                                                       jax_runs):
    ranks, want = jax_runs
    r0, r1 = (r[f"{expt}/{mode}"] for r in ranks)
    assert_equal_trees({k: r0[k] for k in ("G", "D")},
                       {k: r1[k] for k in ("G", "D")})
    want = want[expt, mode]
    assert set(r0["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=1e-4,
                                   err_msg=k)
    lr, step_max = LR[expt]
    upd_diffs = []
    for net in ("G", "D"):
        have, after, before = r0[net], want["after"][net], want["before"][net]
        assert set(have) == set(after)
        for k, w in after.items():
            if "running" in k:            # BatchNorm running statistics
                np.testing.assert_allclose(have[k].numpy(), w.numpy(),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=f"{net} {k}")
                continue
            np.testing.assert_allclose(
                have[k].numpy(), w.numpy(),
                atol=step_max * lr * want["n_upd"][net], err_msg=f"{net} {k}")
            upd_diffs.append(np.abs((have[k] - before[k]).numpy()
                                    - (w - before[k]).numpy()).ravel())
    assert np.mean(np.concatenate(upd_diffs) > 1e-6) <= 0.01


# ---------------------------------------------------------- checkpoints
def trainer_overrides(root, version, *extra):
    return ["+expt=dc_gan", "dataset=synthetic", "calc_fid=False",
            "~figures", "train.img_size=16", "train.batch_size=4",
            "train.features_disc=4", "train.features_gen=4",
            "model.noise_dim=8", "dataset.n=16", "train.ema_decay=0.9",
            "save_ckpts=True", "num_gpus=2", f"output_root={root}",
            f"version={version}", *extra]


def fit_job(root: str, version: str, *extra) -> int:
    """A Trainer on this rank of the group, fit."""
    trainer = Trainer(compose(CONF_DIR, trainer_overrides(root, version,
                                                          *extra)), "cpu")
    trainer.fit()
    return trainer.state.step


def ckpt_of(root: Path, version: str) -> Path:
    return CheckpointManager.find_ckpt(root / "dc_gan" / version / "ckpts")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """On two ranks: two epochs plain and under fsdp, and one fsdp epoch
    resumed for one more under zero_opt."""
    root = tmp_path_factory.mktemp("fsdp_ckpt")
    jobs = [("plain", fit_job, (str(root), "plain", "train.num_epochs=2")),
            ("fsdp", fit_job, (str(root), "fsdp", "train.num_epochs=2",
                               "fsdp=true")),
            ("fsdp1", fit_job, (str(root), "fsdp1", "train.num_epochs=1",
                                "fsdp=true")),
            ("resumed", fit_job, (
                str(root), "resumed", "train.num_epochs=2", "zero_opt=true",
                f"train.ckpt_dir={root / 'dc_gan' / 'fsdp1' / 'ckpts'}"))]
    return root, run_ranks(jobs, root / "out")


def _payload(path: Path) -> dict:
    return CheckpointManager.restore(path)[0]


def test_fsdp_checkpoint_equals_plain_data_parallelism(trained):
    root, ranks = trained
    assert ranks[0]["fsdp"] == ranks[0]["plain"] == 8
    plain, fsdp = (ckpt_of(root, v) for v in ("plain", "fsdp"))
    assert plain.name == fsdp.name == "model_epoch-1"
    assert_equal_trees(_payload(fsdp), _payload(plain))


def test_fsdp_epoch_resumed_under_zero_opt_equals_two_epochs(trained):
    root, ranks = trained
    assert ranks[0]["fsdp1"] == 4 and ranks[1]["resumed"] == 8
    assert_equal_trees(_payload(ckpt_of(root, "resumed")),
                       _payload(ckpt_of(root, "plain")))


def test_fsdp_checkpoint_resumes_on_one_device(trained, tmp_path):
    """No group, no sharding: the two-rank fsdp checkpoint restores
    exactly (its payload back, tensor for tensor) and trains on."""
    root, _ = trained
    src = ckpt_of(root, "fsdp1")
    ov = [o for o in trainer_overrides(tmp_path, "one", "train.num_epochs=2",
                                       f"train.ckpt_dir={src.parent}")
          if not o.startswith("num_gpus")]
    trainer = Trainer(compose(CONF_DIR, ov), "cpu")
    trainer.state = create_train_state(trainer.task, steps_per_epoch=2,
                                       ema=True)
    trainer.resume()
    assert trainer.state.sharding is None and trainer.epoch == 1
    assert_equal_trees(trainer.checkpoint_payload(), _payload(src))
    trainer = Trainer(compose(CONF_DIR, ov), "cpu")
    trainer.fit()
    assert trainer.state.step == 8           # 4 micro-steps an epoch
    assert ckpt_of(tmp_path, "one").name == "model_epoch-1"


# ------------------------------------------------------------- the CLI
def test_cli_two_fsdp_ranks_validate_draw_and_evaluate(tmp_path):
    """run_network_torch.py num_gpus=2 --device cpu fsdp=true with every
    place the full state leaves the superstep: validation with the
    SampleGrid figure, debug.verbose_shape, asynchronous checkpoints; then
    eval_only on that checkpoint and debug.fast_dev_run, both under fsdp on
    two ranks. Each ends 0 without a deadlock within its bounded wait."""
    from tests.test_torch_cli import SMALL_2D, _run_cli
    base = ["+expt=dc_gan", *[o for o in SMALL_2D if o != "~figures"],
            "~figures.interpolation", "figure_details.fid_callback=False",
            "num_gpus=2", "fsdp=true", f"output_root={tmp_path}",
            "--device", "cpu"]
    out = _run_cli(base + ["train.num_epochs=2", "save_ckpts=True",
                           "save_ckpts_async=true", "debug.verbose_shape=true",
                           "version=fit"])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[debug] generator output shapes (2 samples):" in out.stdout
    assert "verbose_shape failed" not in out.stdout
    run = tmp_path / "dc_gan" / "fit"
    assert (run / "figures" / "SampleGrid.png").is_file()
    ckpt = CheckpointManager.find_ckpt(run / "ckpts")
    assert ckpt.name == "model_epoch-1"
    payload = _payload(ckpt)
    _, task = make_task(["+expt=dc_gan", *SMALL_2D], tmp_path)
    for net in ("generator", "discriminator"):
        want = getattr(task, net).state_dict()
        assert {k: v.shape for k, v in payload[net].items()} == \
            {k: v.shape for k, v in want.items()}
    ev = _run_cli(base + ["eval_only=true", f"train.ckpt_dir={run / 'ckpts'}",
                          "version=eval"])
    assert ev.returncode == 0, ev.stderr[-3000:]
    assert f"Resuming from {ckpt}" in ev.stdout
    fd = _run_cli(base + ["debug.fast_dev_run=true", "version=fast"])
    assert fd.returncode == 0, fd.stderr[-3000:]
    assert re.search(r"^epoch 0 \[", fd.stdout, re.M)
