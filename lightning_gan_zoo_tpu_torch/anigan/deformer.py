"""ANIGAN deformers (counterpart of lightning_gan_zoo_tpu/anigan/deformer.py).

A deformer maps ray sample points from the deformed (observation) space into
the canonical template space before the SIREN evaluates them. All six share
the JAX package's uniform signature

    transform(x, deformed_verts, mean_shape_verts, kp_verts,
              deformation_parameters)

and ``calculate_deformation(shape_analysis)``, which gives the
``deformation_parameters``. ``forward`` is ``calculate_deformation``, so
``torch.func.functional_call`` can run it with other parameters (the G
weight EMA). Both run in float32 with autocast off, as the JAX deformers
compute in float32 under either policy.

The JAX package's deviations from the reference are kept: one signature for
all, RBF as a working TPS warp, no 6,000-point chunking. The LSTM deformer is
``nn.LSTMCell`` in flax's gate order (i, f, g, o), its input projection
without a bias (``bias_ih`` held at 0) and a zero carry. flax infers the
width of the first offset layer from the first shape analysis it sees; here
it is built from ``n_verts``, the template's vertex count (642 by default,
the icosphere of CMR's bird meshes).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nerf.siren import MappingNetwork, SirenNet, dense
from ..parallel import tensor
from . import tps as tps_functions


def _float32(fn):
    """Run a deformer method in float32 with autocast off."""
    @functools.wraps(fn)
    def wrapped(self, *args):
        def f32(a):
            if isinstance(a, dict):
                return {k: f32(v) for k, v in a.items()}
            return a.float() if torch.is_tensor(a) else a
        args = [f32(a) for a in args]
        device = next(a for a in args if torch.is_tensor(a)
                      or isinstance(a, dict))
        if isinstance(device, dict):
            device = next(iter(device.values()))
        with torch.autocast(device.device.type, enabled=False):
            return fn(self, *args)
    return wrapped


def _sub(verts: torch.Tensor, step: int) -> torch.Tensor:
    return verts[:, ::step]


class Deformer(nn.Module):
    """Base: no deformation parameters; each deformer has its own
    transform."""

    #: the SIREN input channels the transform produces
    siren_input_channels = 3

    def __init__(self, template_subdivision: int = 1):
        super().__init__()
        self.template_subdivision = int(template_subdivision)

    def forward(self, shape_analysis):
        return self.calculate_deformation(shape_analysis)

    def calculate_deformation(self, shape_analysis):
        return None

    def transform(self, x, deformed_verts, mean_shape_verts, kp_verts,
                  deformation_parameters):
        raise NotImplementedError


class TPSDeformer(Deformer):
    """Thin-plate spline from the subsampled deformed verts to the template;
    the coefficients carry no gradient (the reference detaches them)."""

    def __init__(self, template_subdivision: int = 1, lambda_: float = 0.0,
                 **_ignored):
        super().__init__(template_subdivision)
        self.lambda_ = float(lambda_)

    def calculate_deformation(self, shape_analysis):
        sub = self.template_subdivision
        with torch.no_grad():
            return tps_functions.find_coefficients(
                _sub(shape_analysis["verts"], sub),
                _sub(shape_analysis["mean_shape"], sub), self.lambda_)

    def transform(self, x, deformed_verts, mean_shape_verts, kp_verts,
                  deformation_parameters):
        return tps_functions.transform(
            x, _sub(deformed_verts, self.template_subdivision),
            deformation_parameters)


class RBFDeformer(TPSDeformer):
    """The reference's RBF deformer is broken; as in the JAX package it is
    its evident intent, a radial-basis (TPS kernel) warp."""

    def __init__(self, template_subdivision: int = 8, lambda_: float = 0.0,
                 **_ignored):
        super().__init__(template_subdivision, lambda_)


class KernelDeformer(Deformer):
    """Exp-kernel weighted projection onto the template:
    out = Σᵥ template_v · exp(−|x − deformed_v| / σ²), optionally
    normalised; the kernel is elementwise per axis, as in the reference."""

    def __init__(self, template_subdivision: int = 8, sigma: float = 3.0,
                 normalised: bool = False, **_ignored):
        super().__init__(template_subdivision)
        self.sigma, self.normalised = float(sigma), bool(normalised)

    @_float32
    def transform(self, x, deformed_verts, mean_shape_verts, kp_verts,
                  deformation_parameters):
        dv = _sub(deformed_verts, self.template_subdivision)
        mv = _sub(mean_shape_verts, self.template_subdivision)
        # (B, V, M, 3) elementwise kernel between verts (V) and points (M)
        k = torch.exp(-torch.abs(x[:, None] - dv[:, :, None])
                      / (self.sigma ** 2))
        out = (mv[:, :, None] * k).sum(1)
        if self.normalised:
            out = out / torch.clamp(k.sum(1), min=1e-12)
        return out


class DisplacementDeformer(Deformer):
    """The points' displacements from each keypoint, flattened: 3 × 15 =
    45 SIREN input channels with the birds' keypoints."""

    def __init__(self, template_subdivision: int = 8, n_keypoints: int = 15,
                 **_ignored):
        super().__init__(template_subdivision)
        self.n_keypoints = int(n_keypoints)
        self.siren_input_channels = 3 * self.n_keypoints

    @_float32
    def transform(self, x, deformed_verts, mean_shape_verts, kp_verts,
                  deformation_parameters):
        disp = x[:, :, None] - kp_verts[:, None]            # (B, M, K, 3)
        return disp.reshape(disp.shape[0], disp.shape[1], -1)


def _offsets_in(n_verts: int, step: int) -> int:
    return 3 * len(range(0, int(n_verts), int(step)))


class LSTMDeformer(Deformer):
    """Offset-MLP latent and a 4-step LSTM emitting per-step affine warps of
    the points. Under ``num_tp`` the cell runs with its gate leaves gathered
    whole (``tensor.call_whole``), the denses column-parallel."""

    def __init__(self, template_subdivision: int = 8, latent_size: int = 128,
                 hidden_size: int = 128, steps: int = 4, n_verts: int = 642,
                 generator: Optional[torch.Generator] = None, **_ignored):
        super().__init__(template_subdivision)
        g = generator or torch.Generator().manual_seed(0)
        self.latent_size, self.steps = int(latent_size), int(steps)
        self.offset_dense1 = dense(_offsets_in(n_verts, template_subdivision),
                                   512, g)
        self.offset_dense2 = dense(512, self.latent_size, g)
        self.lstm = nn.LSTMCell(self.latent_size + 3, int(hidden_size))
        h = int(hidden_size)
        with torch.no_grad():
            for i in range(4):   # per gate: flax's LeCun normal, orthogonal
                rows = slice(i * h, (i + 1) * h)
                self.lstm.weight_ih[rows] = dense(
                    self.latent_size + 3, h, g).weight
                nn.init.orthogonal_(self.lstm.weight_hh[rows], generator=g)
            self.lstm.bias_ih.zero_()
            self.lstm.bias_hh.zero_()
        # flax's input projection has no bias
        self.lstm.bias_ih.requires_grad_(False)
        # near-zero affine head: kernel U[0, 1e-5), zero bias
        self.out_affine = nn.Linear(h, 6)
        with torch.no_grad():
            self.out_affine.weight.uniform_(0.0, 1e-5, generator=g)
            self.out_affine.bias.zero_()

    @_float32
    def calculate_deformation(self, shape_analysis):
        sub = self.template_subdivision
        verts = _sub(shape_analysis["verts"], sub)
        template = _sub(shape_analysis["mean_shape"], sub)
        b = verts.shape[0]
        offsets = verts.reshape(b, -1) - template.reshape(b, -1)
        return self.offset_dense2(F.relu(self.offset_dense1(offsets)))

    @_float32
    def transform(self, x, deformed_verts, mean_shape_verts, kp_verts,
                  deformation_parameters):
        b, m, _ = x.shape
        code = deformation_parameters[:, None].expand(
            b, m, self.latent_size).reshape(b * m, -1)
        xyz = x.reshape(b * m, 3)
        h = torch.zeros(b * m, self.lstm.hidden_size, device=x.device)
        c = torch.zeros_like(h)
        for _ in range(self.steps):
            h, c = tensor.call_whole(self.lstm, torch.cat([code, xyz], dim=1),
                                     (h, c))
            a = self.out_affine(h)
            xyz = a[:, 3:] + (1.0 + a[:, :3]) * xyz
        return xyz.reshape(b, m, 3)


class SirenDeformer(Deformer):
    """FiLM-SIREN offset field conditioned on a template latent: a 128-wide
    SirenNet with 3 outputs, float32 (its plain layer loop)."""

    def __init__(self, template_subdivision: int = 8, latent_size: int = 128,
                 num_layers: int = 5, n_verts: int = 642,
                 generator: Optional[torch.Generator] = None, **_ignored):
        super().__init__(template_subdivision)
        g = generator or torch.Generator().manual_seed(0)
        self.offset_mlp = nn.ModuleList([
            dense(_offsets_in(n_verts, template_subdivision), 256, g),
            dense(256, 256, g), dense(256, 256, g),
            dense(256, int(latent_size), g)])
        self.siren = SirenNet(3, 128, 3, int(num_layers), generator=g)
        self.mapping = MappingNetwork(int(latent_size), 128,
                                      n_heads=int(num_layers), generator=g)

    @_float32
    def calculate_deformation(self, shape_analysis):
        template = _sub(shape_analysis["mean_shape"], self.template_subdivision)
        h = template.reshape(template.shape[0], -1)
        for i, layer in enumerate(self.offset_mlp):
            h = layer(h)
            if i < len(self.offset_mlp) - 1:
                h = F.relu(h)
        return h

    @_float32
    def transform(self, x, deformed_verts, mean_shape_verts, kp_verts,
                  deformation_parameters):
        gammas, betas = self.mapping(deformation_parameters)
        return x + self.siren(x, gammas, betas)
