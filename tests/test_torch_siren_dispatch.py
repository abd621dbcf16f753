"""SirenNet's choice between the fused trunk and the layer loop, against the
JAX SirenNet's rule: under the bf16 policy a (B, M, C) input with dim_out ==
dim_hidden fuses exactly when dim_hidden is a multiple of 128; any other
width runs the layer loop (lightning_gan_zoo_tpu/nerf/siren.py,
``use_fused``). A CPU tensor never reaches the kernels' width check, so
each side's fused call is replaced by a recorder and the two records are
compared. The JAX module runs its fused branch here through
``fused_interpret``, its stand-in for the accelerator."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightning_gan_zoo_tpu.ops.pallas.siren_trunk as jax_trunk
from lightning_gan_zoo_tpu.nerf.siren import SirenNet as JSirenNet
from lightning_gan_zoo_tpu_torch.nerf import siren

B, M, LAYERS = 2, 7, 2


def _inputs(h):
    rng = np.random.default_rng(h)
    return (rng.normal(size=(B, M, 3)).astype(np.float32),
            (rng.normal(size=(B, LAYERS, h)) * 0.1 + 1).astype(np.float32),
            (rng.normal(size=(B, LAYERS, h)) * 0.1).astype(np.float32))


def _jax_fuses(h, monkeypatch):
    taken = []

    def record(x, w0k, wmid, bs, g, b, w0s, interpret=False):
        taken.append(True)
        return jnp.zeros(x.shape[:2] + (w0k.shape[-1],), jnp.float32)
    monkeypatch.setattr(jax_trunk, "siren_trunk", record)
    net = JSirenNet(h, h, LAYERS, dtype=jnp.bfloat16, fused=True,
                    fused_interpret=True)
    x, g, b = map(jnp.asarray, _inputs(h))
    variables = net.init(jax.random.PRNGKey(0), x, g, b)
    taken.clear()
    net.apply(variables, x, g, b)
    return bool(taken)


def _port_fuses(h, monkeypatch):
    taken = []

    def record(x, w0k, wmid, bs, g, b, w0s):
        taken.append(True)
        return torch.zeros(x.shape[:2] + (w0k.shape[-1],),
                           dtype=torch.bfloat16)
    monkeypatch.setattr(siren.cuda_trunk, "siren_trunk", record)
    net = siren.SirenNet(3, h, h, LAYERS, bf16=True)
    x, g, b = map(torch.from_numpy, _inputs(h))
    with torch.no_grad():
        y = net(x, g, b)
    assert y.dtype == torch.bfloat16 and y.shape == (B, M, h)
    assert net.fuses(x) == bool(taken)
    return bool(taken)


@pytest.mark.parametrize("h", [32, 48, 64, 128, 256])
def test_port_fuses_exactly_where_jax_does(h, monkeypatch):
    jax_choice = _jax_fuses(h, monkeypatch)
    assert jax_choice == (h % 128 == 0)
    assert _port_fuses(h, monkeypatch) == jax_choice


def test_f32_policy_and_2d_input_run_the_loop(monkeypatch):
    """The other halves of the rule: precision 32, or points that are not
    (B, M, C), run the layer loop at a fusing width too."""
    taken = []
    monkeypatch.setattr(siren.cuda_trunk, "siren_trunk",
                        lambda *a: taken.append(True))
    x, g, b = map(torch.from_numpy, _inputs(128))
    with torch.no_grad():
        siren.SirenNet(3, 128, 128, LAYERS)(x, g, b)
        siren.SirenNet(3, 128, 128, LAYERS, bf16=True)(x[0])
    assert not taken
