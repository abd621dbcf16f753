"""The port on two gloo ranks against the JAX package on its 2-device mesh
(``make_mesh(2)``, the batch sharded over 'data'), for dc_gan (BatchNorm
over the global batch in D and G) and wgan_gp (the penalty's gradient of a
gradient), on the CPU in float32 at small widths (features 4, 32 px, a
global batch of 4).

Both start from the same numpy weights (through convert.py), take the same
images and the z and α that the JAX superstep draws, recomputed from its
key derivation; each rank takes its rows. The tolerances are those of the
one-device comparison in tests/test_torch_gan2d.py: losses at rtol 1e-4,
BatchNorm running statistics at rtol 1e-4, parameters after the update at
atol n_updates × the optimizer's largest single step (2·lr for Adam), and
the updates themselves within 1e-6 on at least 99 % of the elements. The
two ranks end bit-identical.
"""
import jax
import numpy as np
import pytest
import torch

from lightning_gan_zoo_tpu.parallel import mesh as pmesh
from lightning_gan_zoo_tpu.runtime.state import create_train_state as jax_state
from lightning_gan_zoo_tpu.runtime.steps import build_superstep
from tests.test_torch_dist_families import fed_superstep_job, run_ranks
from tests.test_torch_gan2d import CONVERT, LR, _args, _images, make_pair

torch.set_num_threads(2)

B = 4
EXPTS = ("dc_gan", "wgan_gp")


def _jax_superstep(expt, tmp):
    """The JAX superstep on the 2-device mesh, and the port's inputs."""
    jtask, task, g_vars, d_vars = make_pair(expt, tmp)
    cfg = task.cfg
    df, gf = int(cfg.optimisation.disc_freq), int(cfg.optimisation.gen_freq)
    n_micro, s = df + gf, int(cfg.train.img_size)
    d_tx, g_tx = jtask.configure_optimizers(steps_per_epoch=4)
    mesh = pmesh.make_mesh(2)
    step = pmesh.shard_superstep(build_superstep(jtask, g_tx, d_tx, df, gf),
                                 mesh, donate_state=False)
    images = _images((n_micro, B, s, s, 3))
    rng = jax.random.PRNGKey(7)
    st1, metrics = step(
        pmesh.put_state(jax_state(g_vars, d_vars, g_tx, d_tx), mesh),
        jax.device_put({"image": images,
                        "label": np.zeros((n_micro, B), np.int32)},
                       pmesh.batch_sharding(mesh)), rng)
    # z and the GP α of micro-step i, derived as the JAX superstep does
    keys = [jax.random.split(jax.random.fold_in(rng, i))
            for i in range(n_micro)]
    zs = [np.array(jtask.sample_z(k[0], B)) for k in keys]
    alphas = [np.array(jax.random.uniform(k[1], (B, 1, 1, 1))) for k in keys]
    to_g, to_d = CONVERT["dc"]
    job = (_args(expt), str(tmp), to_g(g_vars), to_d(d_vars), images, zs,
           alphas)
    st1 = jax.device_get(st1)
    after = {"G": to_g({"params": st1.g_params, **st1.g_state}),
             "D": to_d({"params": st1.d_params, **st1.d_state})}
    return job, {"metrics": {k: float(v) for k, v in metrics.items()},
                 "before": {"G": job[2], "D": job[3]}, "after": after,
                 "n_upd": {"G": gf, "D": df}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_jax")
    jobs, want = [], {}
    for expt in EXPTS:
        job, want[expt] = _jax_superstep(expt, tmp / expt)
        jobs.append((expt, fed_superstep_job, job))
    return run_ranks(jobs, tmp / "out"), want


@pytest.mark.parametrize("expt", EXPTS)
def test_two_ranks_match_the_jax_two_device_mesh(expt, runs):
    ranks, want = runs
    r0, r1 = (r[expt] for r in ranks)
    for net in ("G", "D"):
        for k, v in r0[net].items():
            assert torch.equal(v, r1[net][k]), f"{expt} {net} {k}"
    want = want[expt]
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
