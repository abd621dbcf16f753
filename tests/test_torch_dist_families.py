"""Data parallelism (parallel/dist.py) for all seven families, on the CPU:
two gloo ranks, each holding half of one global batch, against one device
on the whole batch. The shapes are the JAX package's
parallel/family_runs.py tiny ones, at a global batch of 4.

One group of two ranks per module (``ranks``) runs every family in the
same workers. Per family:

  * the D and G loss gradients at the initial parameters on one global
    micro-batch, after the all-reduce, against one device: the losses at
    rtol 1e-4, each gradient leaf within 1e-3 · max(1, max|g|), the JAX
    package's tolerances (tests/test_sharding.py);
  * one full superstep: both ranks' parameters and buffers bit-identical,
    and the metrics within rtol 2e-3 (atol 1e-5) of one device.

``run_ranks`` is how every multi-rank test of the port starts its ranks:
under a deadline, each rank's results written once to a rank file that
the parent deletes as soon as it has read it (and on a failed launch),
each distinct tensor once, and one that equals a tensor of rank 0's, bit
for bit, as a reference to it.
"""
import hashlib
import math
import os
from collections import OrderedDict
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.config.registry import instantiate
from lightning_gan_zoo_tpu_torch.parallel import dist
from lightning_gan_zoo_tpu_torch.runtime.state import create_train_state
from lightning_gan_zoo_tpu_torch.runtime.steps import map_batch, superstep

#: the suite runs several files at once (pytest-xdist workers) on a few
#: cores: two torch threads per process (each rank too) keep them off each
#: other's cores
torch.set_num_threads(2)

CONF_DIR = Path(__file__).resolve().parent.parent / "conf"
FAMILIES = ("dc_gan", "wgan", "wgan_gp", "gan_stability_r1", "hologan",
            "pigan", "anigan")
BATCH = 4
RANKS = 2
#: seconds a launch of ``run_ranks`` (and a CLI test's ranks) may take:
#: about three times the slowest launch of the tier-1 suite under its six
#: workers on an 8-core host (75 s, test_torch_sp.py's 2 × 2 grid), and
#: below test_torch_cli.py's 300-s limit on a CLI subprocess
DEADLINE = 240


def family_batches(cfg, family: str, batch: int, seed: int = 0) -> dict:
    """The JAX package's family_runs.make_family_batches in numpy, as the
    port takes it: [n_micro, batch, C, H, W] images (and ANIGAN's shape
    analyses)."""
    n_micro = (int(cfg.optimisation.disc_freq)
               + int(cfg.optimisation.gen_freq))
    img, c = int(cfg.train.img_size), int(cfg.train.channels_img)
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n_micro, batch, img, img, c)).astype(
        np.float32) * 0.5
    out = {"image": torch.from_numpy(images).permute(0, 1, 4, 2, 3)
           .contiguous()}
    if family == "anigan":
        def sa(shape):
            return torch.from_numpy(rng.normal(
                size=(n_micro, batch) + shape).astype(np.float32))
        quat = np.tile([1.0, 0, 0, 0], (n_micro, batch, 1))
        cam = np.concatenate([np.ones((n_micro, batch, 1)),
                              np.zeros((n_micro, batch, 2)), quat], -1)
        out["shape_analysis"] = {
            "cam_pred": torch.from_numpy(cam.astype(np.float32)),
            "mean_shape": sa((40, 3)), "verts": sa((40, 3)),
            "kp_verts": sa((15, 3)),
            "mask_pred": torch.from_numpy(rng.uniform(
                size=(n_micro, batch, img, img)).astype(np.float32))}
    return out


def rank_rows(batches: dict) -> dict:
    """This rank's rows of stacked [n_micro, batch, ...] batches: its data
    group's (the sp ranks of a group hold the same rows)."""
    w, r = dist.data_size(), dist.data_rank()
    b = next(iter(batches.values())).shape[1] // w
    return map_batch(lambda v: v[:, r * b:(r + 1) * b], batches)


def make_task(overrides, tmp):
    cfg = compose(CONF_DIR, overrides)
    return cfg, instantiate(cfg.model.lm, cfg, str(tmp), device="cpu")


def loss_grads(task, micro: dict) -> dict:
    """D's then G's loss and parameter gradients at the task's current
    parameters on one micro-batch (the rank's rows of it), each reduced
    over the ranks by the superstep's rule (the ray-partial mark read
    after each backward and kept)."""
    out = {}
    extra = task.initial_extra()
    with dist.global_draws():
        for side, net, other, fn in (
                ("d", task.discriminator, task.generator, task.disc_loss),
                ("g", task.generator, task.discriminator, task.gen_loss)):
            net.requires_grad_(True)
            other.requires_grad_(False)
            net.zero_grad(set_to_none=True)
            dist.take_ray_partial()
            z = task.sample_z(micro["image"].shape[0])
            with task.autocast():
                loss, _ = fn(micro, z, extra)
            loss.backward()
            out[f"{side}_partial"] = dist.take_ray_partial()
            dist.average_grads(net.parameters(), out[f"{side}_partial"])
            out[f"{side}_loss"] = float(
                dist.average_metrics({"loss": loss.detach()})["loss"])
            out[f"{side}_grads"] = {n: p.grad.clone() for n, p
                                    in net.named_parameters()
                                    if p.grad is not None}
    return out


def run_superstep(task, cfg, batches: dict) -> dict:
    """One superstep from the task's parameters; (metrics, G's and D's
    state dicts)."""
    state = create_train_state(task, steps_per_epoch=4)
    metrics = superstep(task, state, batches,
                        int(cfg.optimisation.disc_freq),
                        int(cfg.optimisation.gen_freq))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "G": {k: v.clone() for k, v
                  in task.generator.state_dict().items()},
            "D": {k: v.clone() for k, v
                  in task.discriminator.state_dict().items()}}


def family_job(family: str, overrides, tmp) -> dict:
    cfg, task = make_task(overrides, tmp)
    batches = rank_rows(family_batches(cfg, family, BATCH))
    out = loss_grads(task, map_batch(lambda v: v[0], batches))
    cfg, task = make_task(overrides, tmp)
    out.update(run_superstep(task, cfg, batches))
    return out


def fed_superstep_job(overrides, tmp, g_state, d_state, images, zs,
                      alphas) -> dict:
    """One superstep from given state dicts, on given global images, with
    given global z and WGAN-GP α per micro-step (each rank takes its
    rows)."""
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
    return run_superstep(task, cfg, batches)


class _Ref:
    """A tensor of a rank's results in its rank file: its own blob ``index``
    or, with ``rank0``, rank 0's."""

    def __init__(self, index: int, rank0: bool = False):
        self.index, self.rank0 = index, rank0


def _map(tree, is_leaf, fn):
    """``tree`` with each leaf for which ``is_leaf`` holds replaced by
    ``fn(leaf)``: dicts (of their type, a state_dict's metadata kept),
    lists and tuples rebuilt, any other value kept as it is."""
    if is_leaf(tree):
        return fn(tree)
    if type(tree) in (dict, OrderedDict):
        out = type(tree)((k, _map(v, is_leaf, fn)) for k, v in tree.items())
        if hasattr(tree, "_metadata"):
            out._metadata = tree._metadata
        return out
    if type(tree) in (list, tuple):
        return type(tree)(_map(v, is_leaf, fn) for v in tree)
    return tree


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def _key(t: torch.Tensor):
    """What two tensors must share to be one: the digest of their bits,
    type, dtype, shape and requires_grad (None: a tensor that is kept as
    it is, with attributes of its own or not strided)."""
    if t.layout != torch.strided or vars(t):
        return None
    return (hashlib.blake2b(_bits(t).numpy(), digest_size=16).digest(),
            type(t), t.dtype, tuple(t.shape), t.requires_grad)


def _pack(results):
    """This rank's results as written to its file: each distinct tensor
    once in ``blobs``, and every tensor that equals one of rank 0's, bit
    for bit, a reference to it. Rank 0's tensors are received through the
    group's broadcast (those some rank may hold) and compared in place;
    every rank takes part in every collective, in one order."""
    blobs, keys, seen = [], [], {}

    def own(t):
        key = _key(t)
        for i in seen.get(key, []):
            if torch.equal(_bits(blobs[i]), _bits(t)):
                return _Ref(i)
        if key is not None:
            seen.setdefault(key, []).append(len(blobs))
        blobs.append(t)
        keys.append(key)
        return _Ref(len(blobs) - 1)
    skeleton = _map(results, torch.is_tensor, own)
    box = [keys if dist.rank() == 0 else None]
    tdist.broadcast_object_list(box, src=0)
    theirs = {k: j for j, k in enumerate(box[0]) if k is not None}
    mine = {} if dist.rank() == 0 else {
        i: theirs[k] for i, k in enumerate(keys) if k in theirs}
    wanted = [None] * dist.world_size()
    tdist.all_gather_object(wanted, sorted(set(mine.values())))
    same = {}
    for j in sorted(set().union(*wanted)):
        _, _, dtype, shape, _ = box[0][j]
        buf = (_bits(blobs[j]) if dist.rank() == 0 else
               torch.empty(math.prod(shape) * dtype.itemsize,
                           dtype=torch.uint8))
        tdist.broadcast(buf, src=0)
        for i in (i for i, jj in mine.items() if jj == j):
            if torch.equal(_bits(blobs[i]), buf):
                same[i] = j
    skeleton = _map(skeleton, lambda x: isinstance(x, _Ref),
                    lambda r: _Ref(same[r.index], rank0=True)
                    if r.index in same else r)
    return {"skeleton": skeleton,
            "blobs": [None if i in same else b for i, b in enumerate(blobs)]}


def _unpack(files) -> list:
    """Every rank's results from its file, rank 0's first; each file is
    deleted as soon as it has been read."""
    out, rank0 = [], None
    for path in files:
        packed = torch.load(path, weights_only=False)
        path.unlink()
        blobs = packed["blobs"]
        rank0 = blobs if rank0 is None else rank0
        out.append(_map(packed["skeleton"], lambda x: isinstance(x, _Ref),
                        lambda r: (rank0 if r.rank0 else blobs)[r.index]))
    return out


def _rank_worker(device, out_dir: str, jobs) -> int:
    torch.set_num_threads(2)
    results = {name: fn(*args) for name, fn, args in jobs}
    torch.save(_pack(results), Path(out_dir) / f"rank{dist.rank()}.pt")
    return 0


def run_ranks(jobs, out_dir: Path, n: int = RANKS, sp: int = 1,
              tp: int = 1, deadline: float = DEADLINE) -> list:
    """``jobs`` ((name, function, args) each, the functions at a module's
    top level) on ``n`` gloo ranks of one group, a grid of n/(sp·tp) data
    × ``sp`` ray ranks × ``tp`` tensor ranks, under ``dist.launch``'s
    ``deadline``; every rank's results, by name. No rank file is left in
    ``out_dir``, whether the launch passes or fails."""
    out_dir.mkdir(parents=True, exist_ok=True)
    files = [out_dir / f"rank{r}.pt" for r in range(n)]
    old = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",
                                          "MKL_NUM_THREADS")}
    os.environ.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    try:
        dist.launch(_rank_worker, (str(out_dir), jobs), ["cpu"] * n,
                    backend="gloo", sp=sp, tp=tp, deadline=deadline)
        return _unpack(files)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for path in files:
            path.unlink(missing_ok=True)


def overrides_of(family: str):
    from lightning_gan_zoo_tpu.parallel.family_runs import family_overrides
    return family_overrides(family, BATCH)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_families")
    jobs = [(f, family_job, (f, overrides_of(f), str(tmp)))
            for f in FAMILIES]
    return run_ranks(jobs, tmp / "out")


def one_device(family, tmp):
    """The same loss gradients and superstep on one device, no group."""
    ov = overrides_of(family)
    cfg, task = make_task(ov, tmp)
    batches = family_batches(cfg, family, BATCH)
    out = loss_grads(task, map_batch(lambda v: v[0], batches))
    cfg, task = make_task(ov, tmp)
    out.update(run_superstep(task, cfg, batches))
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_grads_match_one_device(family, ranks, tmp_path):
    want = one_device(family, tmp_path)
    for got in (r[family] for r in ranks):
        for side in ("d", "g"):
            np.testing.assert_allclose(got[f"{side}_loss"],
                                       want[f"{side}_loss"], rtol=1e-4,
                                       err_msg=f"{family} {side}_loss")
            assert set(got[f"{side}_grads"]) == set(want[f"{side}_grads"])
            for k, a in want[f"{side}_grads"].items():
                tol = 1e-3 * max(1.0, float(a.abs().max()))
                np.testing.assert_allclose(
                    got[f"{side}_grads"][k].numpy(), a.numpy(), atol=tol,
                    err_msg=f"{family} {side} {k}")


@pytest.mark.parametrize("family", FAMILIES)
def test_superstep_ranks_identical_and_match_one_device(family, ranks,
                                                        tmp_path):
    r0, r1 = (r[family] for r in ranks)
    for net in ("G", "D"):
        assert set(r0[net]) == set(r1[net])
        for k, v in r0[net].items():
            assert torch.equal(v, r1[net][k]), f"{family} {net} {k}"
    assert r0["metrics"] == r1["metrics"]
    want = one_device(family, tmp_path)["metrics"]
    assert set(r0["metrics"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=2e-3,
                                   atol=1e-5, err_msg=f"{family} {k}")
