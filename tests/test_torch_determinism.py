"""Determinism of the port (counterpart of tests/test_determinism.py): the
same seed gives the same training trajectory, bit for bit, and another seed
another one. Each family's task is built from its config at a tiny width on
the CPU, from ``seed``: the weights, the z stream and (HoloGAN) the view
stream all follow from it. Three supersteps run on one fixed batch; the
losses of each and the parameters after the last are compared.

On the card the kernels keep this property (no float atomics:
tests/test_torch_cuda.py replays a HoloGAN generator's gradients bit for
bit)."""
import numpy as np
import pytest
import torch

from tests.conftest import CONF_DIR
from lightning_gan_zoo_tpu_torch.config import compose
from lightning_gan_zoo_tpu_torch.config.registry import instantiate
from lightning_gan_zoo_tpu_torch.runtime.state import create_train_state
from lightning_gan_zoo_tpu_torch.runtime.steps import superstep

#: the suite runs several files at once (pytest-xdist workers) on a few
#: cores: two torch threads per worker keep them off each other's cores
torch.set_num_threads(2)

FAMILIES = {
    "dc_gan": ["+expt=dc_gan", "dataset=synthetic", "train.img_size=16",
               "train.batch_size=4", "train.features_disc=8",
               "train.features_gen=8", "model.noise_dim=16", "precision=32"],
    "hologan": ["+expt=hologan", "dataset=synthetic", "precision=32",
                "generator.in_planes=4", "discriminator.out_planes=4",
                "model.noise_dim=8", "train.batch_size=2"],
}


def _run(family, seed, tmp_path):
    cfg = compose(CONF_DIR, FAMILIES[family] + [
        f"seed={seed}", "calc_fid=False", "save_ckpts=False", "~figures"])
    task = instantiate(cfg.model.lm, cfg, str(tmp_path), device="cpu")
    state = create_train_state(task, steps_per_epoch=4)
    df, gf = int(cfg.optimisation.disc_freq), int(cfg.optimisation.gen_freq)
    shape = (df + gf, int(cfg.train.batch_size), int(cfg.train.channels_img),
             int(cfg.train.img_size), int(cfg.train.img_size))
    images = torch.from_numpy(np.random.default_rng(0).normal(
        size=shape).astype(np.float32) * 0.5)
    losses = []
    for _ in range(3):
        metrics = superstep(task, state, {"image": images}, df, gf)
        losses.append({k: float(v) for k, v in metrics.items()})
    params = [p.detach().clone() for net in (task.generator,
                                             task.discriminator)
              for p in net.parameters()]
    return losses, params


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_same_seed_same_trajectory(family, tmp_path):
    losses, params = _run(family, 7, tmp_path)
    losses2, params2 = _run(family, 7, tmp_path)
    assert losses == losses2
    assert all(torch.equal(a, b) for a, b in zip(params, params2))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_different_seed_differs(family, tmp_path):
    losses, params = _run(family, 7, tmp_path)
    losses2, params2 = _run(family, 8, tmp_path)
    assert losses != losses2
    assert not all(torch.equal(a, b) for a, b in zip(params, params2))
