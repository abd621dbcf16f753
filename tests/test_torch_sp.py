"""Ray sharding (``num_sp``: parallel/dist.py's data × sp grid,
nerf/renderer.py's per-rank rays) on the CPU over gloo, at the JAX
package's parallel/family_runs.py shapes (tiny widths, global batch 4).

The reference is the port's one-device superstep on the global batch,
which tests/test_torch_dist_families.py, test_torch_pigan.py and
test_torch_anigan.py hold against the JAX package's one-device superstep;
the JAX package's own tests/test_sp_sharding.py pins its (data × sp)
superstep to its one device. Parity of the port's sp superstep with the
JAX sp superstep is therefore transitive.

  * The grid: rank → (data, sp) with sp the minor axis, the data and sp
    groups, the refusals (num_sp not dividing the ranks, nor torchrun's
    LOCAL_WORLD_SIZE), and num_sp = 1 giving the groups data parallelism
    had (the default group, no sp group).
  * The sp all-gather: its forward, its backward (this rank's slice) and a
    gradient of a gradient through it, on 2 ranks, against one process.
  * The per-ray draws: each rank's stratified and fine uniforms equal, bit
    for bit, its rows and rays of the one-device draws, with one chunk and
    with chunk_size < n_rays (the rank replays the one-device chunk grid).
  * π-GAN and ANIGAN on 1 × 2 and 2 × 2 grids against one device: the
    loss gradients at the initial parameters (losses at rtol 1e-4, each
    leaf within 1e-3 · max(1, max|g|)), one full superstep (metrics at
    rtol 2e-3, atol 1e-5: tests/test_sp_sharding.py's), every rank ending
    bit-identical, G's gradient marked ray-partial and D's not, and
    ANIGAN's deformation noise never drawn in training.
  * The idle sp axis: gan_stability_r1 and HoloGAN on 1 × 2 equal one
    device bit for bit.
  * zero_opt and fsdp on 2 × 2 for π-GAN equal plain data × sp bit for
    bit, and the gathered state resumes on one device.
  * Beside the transitive link, one direct case: π-GAN at
    test_torch_pigan.py's tiny widths (stratification off and the view
    pinned, so no random stream is shared) on 2 × 2 against the JAX
    package's (2 data × 2 sp) mesh, ``make_mesh(4, sp=2)``, from the same
    numpy weights, images and z: the loss gradients at those weights at
    tests/test_sp_sharding.py's tolerances, and one superstep (metrics at
    rtol 2e-3, atol 1e-5; parameters within 2·lr of JAX's and the updates
    within 1e-6 on at least 99 % of the elements, as
    tests/test_torch_dist_jax.py holds data parallelism).
"""

import numpy as np
import pytest
import torch

from lightning_gan_zoo_tpu_torch.nerf import sampling
from lightning_gan_zoo_tpu_torch.parallel import dist
from lightning_gan_zoo_tpu_torch.runtime.state import (create_train_state,
                                                       full_state)
from lightning_gan_zoo_tpu_torch.runtime.steps import map_batch, superstep
from tests.test_torch_dist_families import (BATCH, family_batches,
                                            fed_superstep_job, loss_grads,
                                            make_task, one_device,
                                            overrides_of, rank_rows,
                                            run_ranks)
from tests.test_torch_zero import assert_equal_trees

torch.set_num_threads(2)

NERF = ("pigan", "anigan")
IDLE = ("gan_stability_r1", "hologan")
MODES = ("plain", "zero_opt", "fsdp")
#: chunk sizes of the draw test: one chunk of the 256 rays at 16 px, and
#: chunks of 96 that do not line up with the ranks' 128 rays
CHUNKS = {"one": 8192, "several": 96}
TOL = dict(rtol=2e-3, atol=1e-5)


# ------------------------------------------------------------ rank jobs
def grid_job() -> dict:
    return {"rank": dist.rank(), "sp": (dist.sp_size(), dist.sp_rank()),
            "data": (dist.data_size(), dist.data_rank()),
            "default_data_group": dist._DATA_GROUP is None,
            "sp_group": dist._SP_GROUP is not None,
            "rows": dist.local_rows(torch.arange(8)).tolist(),
            "gathered": dist.all_gather_rays(
                torch.full((1, 2), float(dist.rank()))).tolist()}


def _gather_inputs():
    rng = np.random.default_rng(3)
    return (torch.from_numpy(rng.normal(size=(2, 8, 3))),
            torch.from_numpy(rng.normal(size=(2, 8, 3))))


def _gather_loss(y, w):
    """A replicated scalar with a dense Hessian in y."""
    return (torch.sin(y) * w).sum() ** 2


def gather_job() -> dict:
    """The gather's forward, the slice backward, and two gradients of a
    gradient: of a replicated quantity (|∂L/∂y|²) and of one made from
    this rank's own gradient (through the slice's differentiable op)."""
    full, w = _gather_inputs()
    rays = dist.ray_slice(full.shape[1])
    x = full[:, rays].clone().requires_grad_(True)
    y = dist.all_gather_rays(x)
    partial = dist.take_ray_partial()
    loss = _gather_loss(y, w)
    gy, gx = torch.autograd.grad(loss, (y, x), create_graph=True)
    rep, = torch.autograd.grad((gy ** 2).sum(), x, retain_graph=True)
    own, = torch.autograd.grad((gx ** 2 * w[:, rays]).sum(), x)
    with torch.no_grad():
        dist.all_gather_rays(x)
    return {"y": y.detach(), "gx": gx.detach(), "rep": rep, "own": own,
            "partial": partial, "no_grad_partial": dist.take_ray_partial()}


def draws_job(overrides, tmp) -> dict:
    """π-GAN's training render of this rank's rows at 16 px (256 rays), with
    every uniform that stratify_depths and sample_pdf use recorded in
    order: the jitter first, then the fine samples of each chunk."""
    cfg, task = make_task(overrides, tmp)
    used = []
    draw = sampling._uniform

    def recorded(*args):
        u = draw(*args)
        used.append(u.clone())
        return u

    sampling._uniform = recorded
    try:
        with torch.no_grad(), dist.global_draws():
            z = task.sample_z(BATCH // dist.data_size())
            image = task.render_fake(z)
    finally:
        sampling._uniform = draw
    return {"u": used, "image": image}


def sp_family_job(family: str, overrides, tmp, modes=("plain",)) -> dict:
    """The loss gradients at the initial parameters, then one superstep
    from the seed under each of ``modes``: its metrics, the full state
    (gathered to the one-device format) and whether ANIGAN's
    deformation-noise stream moved."""
    cfg, task = make_task(overrides, tmp)
    batches = rank_rows(family_batches(cfg, family, BATCH))
    out = loss_grads(task, map_batch(lambda v: v[0], batches))
    for mode in modes:
        cfg, task = make_task(overrides, tmp)
        noise = getattr(task, "deform_generator", None)
        before = None if noise is None else noise.get_state()
        state = create_train_state(task, steps_per_epoch=4,
                                   zero_opt=mode != "plain",
                                   fsdp=mode == "fsdp")
        metrics = superstep(task, state, batches,
                            int(cfg.optimisation.disc_freq),
                            int(cfg.optimisation.gen_freq))
        out[mode] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "sharded": state.sharding is not None,
            "noise_drawn": (noise is not None
                            and not torch.equal(before, noise.get_state())),
            "state": torch.utils._pytree.tree_map(
                lambda v: v.detach().clone() if torch.is_tensor(v) else v,
                full_state(task, state))}
    return out


def jax_fed_job(overrides, tmp, g_state, d_state, images, z, zs) -> dict:
    """π-GAN from given state dicts on the grid, on given global images:
    the loss gradients on micro-batch 0 with the global ``z``, then one
    superstep with the global ``zs`` (each rank takes its data rows)."""
    cfg, task = make_task(overrides, tmp)
    task.generator.load_state_dict(g_state)
    task.discriminator.load_state_dict(d_state)
    task.sample_z = lambda n, generator=None: dist.local_rows(
        torch.from_numpy(z))
    batches = rank_rows({"image": torch.from_numpy(images).permute(
        0, 1, 4, 2, 3)})
    out = loss_grads(task, map_batch(lambda v: v[0], batches))
    out.update(fed_superstep_job(overrides, tmp, g_state, d_state, images,
                                 zs, []))
    out["lr"] = {"G": float(cfg.gen_optimiser.lr),
                 "D": float(cfg.disc_optimiser.lr)}
    return out


def jax_sp_pigan(tmp: str):
    """The JAX π-GAN at test_torch_pigan.py's widths on make_mesh(4, sp=2):
    the loss gradients at numpy weights, then one superstep from them; the
    port's job arguments beside the results, in the port's keying. JAX
    is imported here alone: the ranks import this module."""
    import jax

    from lightning_gan_zoo_tpu.config import compose as jax_compose
    from lightning_gan_zoo_tpu.config.registry import instantiate as jax_inst
    from lightning_gan_zoo_tpu.parallel import mesh as pmesh
    from lightning_gan_zoo_tpu.runtime.state import (
        create_train_state as jax_state)
    from lightning_gan_zoo_tpu.runtime.steps import build_superstep
    from lightning_gan_zoo_tpu_torch import convert
    from tests.conftest import CONF_DIR
    from tests.test_torch_pigan import B, PIGAN_TINY, _random_variables
    jcfg = jax_compose(CONF_DIR, PIGAN_TINY)
    jtask = jax_inst(jcfg.model.lm, jcfg, tmp)
    g_vars, d_vars = _random_variables(jtask)
    mesh = pmesh.make_mesh(4, sp=2)
    rng = np.random.default_rng(5)
    images = (rng.normal(size=(2, B, 64, 64, 3)) * 0.3).astype(np.float32)
    z = rng.normal(size=(B, 16)).astype(np.float32)
    rows, rep = pmesh.batch_sharding(mesh, stacked=False), \
        pmesh.replicated(mesh)
    g_params, d_params, extra = jax.device_put(
        (g_vars["params"], d_vars["params"], jtask.initial_extra()), rep)
    micro = jax.device_put({"image": images[0]}, rows)
    jz = jax.device_put(z, rows)

    def grads(fn, own, other):
        (loss, _), g = jax.jit(pmesh.with_mesh_context(
            jax.value_and_grad(fn, has_aux=True), mesh))(
            own, other, {}, {}, micro, jz, jax.random.PRNGKey(0), extra)
        return float(loss), jax.device_get(g)
    d_loss, d_grads = grads(jtask.disc_loss, d_params, g_params)
    g_loss, g_grads = grads(jtask.gen_loss, g_params, d_params)

    d_tx, g_tx = jtask.configure_optimizers(4)
    step = pmesh.shard_superstep(build_superstep(jtask, g_tx, d_tx, 1, 1),
                                 mesh, donate_state=False)
    key = jax.random.PRNGKey(7)
    st1, metrics = step(
        pmesh.put_state(jax_state(g_vars, d_vars, g_tx, d_tx,
                                  extra=jtask.initial_extra()), mesh),
        jax.device_put({"image": images,
                        "label": np.zeros((2, B), np.int32)},
                       pmesh.batch_sharding(mesh)), key)
    zs = [np.array(jtask.sample_z(
        jax.random.split(jax.random.fold_in(key, i))[0], B))
        for i in range(2)]
    st1 = jax.device_get(st1)
    to_g = convert.pigan_generator_state_dict
    to_d = convert.pigan_discriminator_state_dict
    job = (PIGAN_TINY, tmp, to_g(g_vars), to_d(d_vars), images, z, zs)
    return job, {
        "d_loss": d_loss, "g_loss": g_loss,
        "d_grads": to_d({"params": d_grads}),
        "g_grads": to_g({"params": g_grads}),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "before": {"G": job[2], "D": job[3]},
        "after": {"G": to_g({"params": st1.g_params}),
                  "D": to_d({"params": st1.d_params})}}


def draw_overrides(chunk: str):
    return overrides_of("pigan") + [f"nerf.chunk_size={CHUNKS[chunk]}"]


def grid_jobs(tmp: str, four: bool, jax_job: tuple) -> list:
    jobs = [("grid", grid_job, ())]
    jobs += [(f"draws_{c}", draws_job, (draw_overrides(c), tmp))
             for c in CHUNKS]
    jobs += [(f, sp_family_job, (f, overrides_of(f), tmp,
                                 MODES if four and f == "pigan"
                                 else ("plain",)))
             for f in NERF]
    if four:
        jobs.append(("jax", jax_fed_job, jax_job))
    else:
        jobs.append(("gather", gather_job, ()))
        jobs += [(f, sp_family_job, (f, overrides_of(f), tmp))
                 for f in IDLE]
    return jobs


@pytest.fixture(scope="module")
def jax_sp(tmp_path_factory):
    """The JAX (2 data × 2 sp) mesh's π-GAN results, and the port's job
    on the same weights and inputs."""
    return jax_sp_pigan(str(tmp_path_factory.mktemp("sp_jax")))


@pytest.fixture(scope="module")
def grids(tmp_path_factory, jax_sp):
    """Every rank's results on 1 × 2 (key 2) and 2 × 2 (key 4)."""
    tmp = tmp_path_factory.mktemp("sp")
    return {n: run_ranks(grid_jobs(str(tmp), n == 4, jax_sp[0]),
                         tmp / f"out{n}", n, sp=2)
            for n in (2, 4)}


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    """The one-device loss gradients and superstep of each family, and the
    one-device draws, computed once."""
    tmp = tmp_path_factory.mktemp("sp_one")
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (draws_job(draw_overrides(name[6:]), str(tmp))
                           if name.startswith("draws_")
                           else one_device(name, tmp))
        return cache[name]
    return get


# ------------------------------------------------------------- the grid
def test_grid_positions_and_groups():
    assert [dist.grid_position(r, 2) for r in range(4)] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert dist.grid_groups(4, 2) == ([[0, 2], [1, 3]], [[0, 1], [2, 3]])
    assert dist.grid_groups(8, 4) == ([[0, 4], [1, 5], [2, 6], [3, 7]],
                                      [[0, 1, 2, 3], [4, 5, 6, 7]])
    # num_sp = 1: one data group of every rank, no sp neighbours
    assert dist.grid_groups(4, 1) == ([[0, 1, 2, 3]], [[0], [1], [2], [3]])
    assert not dist.is_initialized()
    assert (dist.sp_size(), dist.data_size(), dist.ray_slice(6)) == (
        1, 1, slice(0, 6))


@pytest.mark.parametrize("case", ["mesh", "launch", "local_world_size"])
def test_grid_refusals(case, monkeypatch):
    if case == "mesh":
        with pytest.raises(ValueError, match="num_sp=3 x num_tp=1 does not "
                           "divide the 2-device mesh"):
            dist.check_grid(2, 3)
    elif case == "launch":          # refused before any rank starts
        with pytest.raises(ValueError, match="does not divide"):
            dist.launch(grid_job, (), ["cpu"] * 2, backend="gloo", sp=3)
    else:
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "4")
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE"):
            dist.init_from_env("cpu", sp=4)
    assert not dist.is_initialized()


def test_sp_one_keeps_the_data_parallel_groups(tmp_path):
    ranks = run_ranks([("grid", grid_job, ())], tmp_path, 2)
    for r, got in enumerate(x["grid"] for x in ranks):
        assert got["sp"] == (1, 0) and got["data"] == (2, r)
        assert got["default_data_group"] and not got["sp_group"]
        assert got["rows"] == list(range(4 * r, 4 * r + 4))
        assert got["gathered"] == [[float(r)] * 2]     # no gather at sp 1


@pytest.mark.parametrize("n", [2, 4])
def test_grid_of_the_ranks(n, grids):
    for r, got in enumerate(x["grid"] for x in grids[n]):
        d, s = dist.grid_position(r, 2)
        assert got["sp"] == (2, s) and got["data"] == (n // 2, d)
        assert got["default_data_group"] == (n == 2)   # a one-rank axis
        assert got["sp_group"]
        b = 8 // (n // 2)
        assert got["rows"] == list(range(d * b, (d + 1) * b))
        assert got["gathered"] == [[float(2 * d), float(2 * d),
                                    float(2 * d + 1), float(2 * d + 1)]]


# ------------------------------------------------------------ the gather
def test_sp_gather_forward_backward_and_second_order(grids):
    full, w = _gather_inputs()
    x = full.clone().requires_grad_(True)
    loss = _gather_loss(x, w)
    g, = torch.autograd.grad(loss, x, create_graph=True)
    rep, = torch.autograd.grad((g ** 2).sum(), x, retain_graph=True)
    for s, got in enumerate(r["gather"] for r in grids[2]):
        rays = slice(4 * s, 4 * s + 4)
        own, = torch.autograd.grad((g[:, rays] ** 2 * w[:, rays]).sum(), x,
                                   retain_graph=True)
        assert torch.equal(got["y"], full)
        torch.testing.assert_close(got["gx"], g[:, rays].detach(),
                                   rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got["rep"], rep[:, rays], rtol=1e-12,
                                   atol=1e-12)
        torch.testing.assert_close(got["own"], own[:, rays], rtol=1e-12,
                                   atol=1e-12)
        assert got["partial"] and not got["no_grad_partial"]


# ------------------------------------------------------------- the draws
@pytest.mark.parametrize("chunk", list(CHUNKS))
@pytest.mark.parametrize("n", [2, 4])
def test_each_rank_draws_its_slice_of_the_one_device_draws(n, chunk, grids,
                                                           one):
    want = one(f"draws_{chunk}")
    n_chunks = 1 if chunk == "one" else 3
    assert len(want["u"]) == 1 + n_chunks
    fine = torch.cat(want["u"][1:], dim=1)
    per = fine.shape[1] // 2
    images = {}
    for r, got in enumerate(x[f"draws_{chunk}"] for x in grids[n]):
        d, s = dist.grid_position(r, 2)
        b = BATCH // (n // 2)
        rows, rays = slice(d * b, (d + 1) * b), slice(per * s, per * (s + 1))
        # the jitter, then the fine samples of the chunks the rays meet
        assert len(got["u"]) == 1 + (1 if chunk == "one" else 2)
        assert torch.equal(got["u"][0], want["u"][0][rows, rays])
        assert torch.equal(torch.cat(got["u"][1:], dim=1),
                           fine[rows, rays])
        torch.testing.assert_close(got["image"], want["image"][rows],
                                   rtol=1e-5, atol=1e-6)
        images.setdefault(d, []).append(got["image"])
    for same in images.values():
        assert torch.equal(same[0], same[1])


# ------------------------------------------------------- the families
def _assert_grads_match(got, want, where):
    for side in ("d", "g"):
        np.testing.assert_allclose(got[f"{side}_loss"], want[f"{side}_loss"],
                                   rtol=1e-4, err_msg=f"{where} {side}_loss")
        assert set(got[f"{side}_grads"]) == set(want[f"{side}_grads"])
        for k, a in want[f"{side}_grads"].items():
            tol = 1e-3 * max(1.0, float(a.abs().max()))
            np.testing.assert_allclose(got[f"{side}_grads"][k].numpy(),
                                       a.numpy(), atol=tol,
                                       err_msg=f"{where} {side} {k}")


@pytest.mark.parametrize("family", NERF)
@pytest.mark.parametrize("n", [2, 4])
def test_ray_sharded_loss_grads_match_one_device(family, n, grids, one):
    want = one(family)
    for got in (r[family] for r in grids[n]):
        assert got["g_partial"] and not got["d_partial"]
        _assert_grads_match(got, want, f"{family} {n // 2}x2")


@pytest.mark.parametrize("family", NERF)
@pytest.mark.parametrize("n", [2, 4])
def test_ray_sharded_superstep_matches_one_device(family, n, grids, one):
    ranks = [r[family]["plain"] for r in grids[n]]
    for r in ranks[1:]:                     # every rank, every sp group
        assert r["metrics"] == ranks[0]["metrics"]
        assert_equal_trees(r["state"], ranks[0]["state"])
    assert not any(r["noise_drawn"] for r in ranks)
    want = one(family)["metrics"]
    assert set(ranks[0]["metrics"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], v, **TOL,
                                   err_msg=f"{family} {n // 2}x2 {k}")


@pytest.mark.parametrize("family", IDLE)
def test_idle_sp_axis_equals_one_device(family, grids, one):
    """A family without a renderer leaves the axis idle: on 1 × 2 each
    rank runs the one-device superstep on the whole batch."""
    want = one(family)
    for got in (r[family] for r in grids[2]):
        assert not got["g_partial"] and not got["d_partial"]
        _assert_grads_match(got, want, family)
        assert got["plain"]["metrics"] == want["metrics"]
        assert_equal_trees(got["plain"]["state"]["generator"], want["G"])
        assert_equal_trees(got["plain"]["state"]["discriminator"],
                           want["D"])


@pytest.mark.parametrize("mode", ["zero_opt", "fsdp"])
def test_sharded_state_composes_with_ray_sharding(mode, grids):
    """π-GAN on 2 × 2: the state sharded over the two data ranks ends
    where plain data × sp ends, bit for bit, on every rank."""
    for r in grids[4]:
        got, plain = r["pigan"][mode], r["pigan"]["plain"]
        assert got["sharded"] and not plain["sharded"]
        assert got["metrics"] == plain["metrics"]
        assert_equal_trees(got["state"], plain["state"], mode)


def test_sharded_checkpoint_resumes_on_one_device(grids, tmp_path):
    """The fsdp state gathered on 2 × 2 is the one-device format: a
    one-device π-GAN takes it whole and trains on from it."""
    saved = grids[4][0]["pigan"]["fsdp"]["state"]
    ov = overrides_of("pigan")
    cfg, task = make_task(ov, tmp_path)
    state = create_train_state(task, steps_per_epoch=4)
    task.generator.load_state_dict(saved["generator"])
    task.discriminator.load_state_dict(saved["discriminator"])
    state.g_opt.load_state_dict(saved["g_opt"])
    state.d_opt.load_state_dict(saved["d_opt"])
    assert_equal_trees(full_state(task, state), saved)
    metrics = superstep(task, state, family_batches(cfg, "pigan", BATCH, 1),
                        int(cfg.optimisation.disc_freq),
                        int(cfg.optimisation.gen_freq))
    assert all(np.isfinite(float(v)) for v in metrics.values())


# ------------------------------------------------- the JAX (data × sp) mesh
def test_ray_sharded_grid_matches_the_jax_sp_mesh(grids, jax_sp):
    want = jax_sp[1]
    ranks = [r["jax"] for r in grids[4]]
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        assert_equal_trees({"G": r["G"], "D": r["D"]},
                           {"G": ranks[0]["G"], "D": ranks[0]["D"]})
    got = ranks[0]
    assert got["g_partial"] and not got["d_partial"]
    for side in ("d", "g"):
        np.testing.assert_allclose(got[f"{side}_loss"], want[f"{side}_loss"],
                                   rtol=1e-4, err_msg=f"{side}_loss")
        assert set(got[f"{side}_grads"]) <= set(want[f"{side}_grads"])
        for k, a in want[f"{side}_grads"].items():
            have = got[f"{side}_grads"].get(k, torch.zeros_like(a))
            tol = 1e-3 * max(1.0, float(a.abs().max()))
            np.testing.assert_allclose(have.numpy(), a.numpy(), atol=tol,
                                       err_msg=f"{side} {k}")
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, **TOL, err_msg=k)
    upd_diffs = []
    for net in ("G", "D"):
        have, after, before = got[net], want["after"][net], \
            want["before"][net]
        assert set(have) == set(after)
        for k, w in after.items():
            np.testing.assert_allclose(have[k].numpy(), w.numpy(),
                                       atol=2 * got["lr"][net],
                                       err_msg=f"{net} {k}")
            upd_diffs.append(np.abs((have[k] - before[k]).numpy()
                                    - (w - before[k]).numpy()).ravel())
    assert np.mean(np.concatenate(upd_diffs) > 1e-6) <= 0.01
