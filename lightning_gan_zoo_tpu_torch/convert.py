"""JAX → PyTorch weights for HoloGAN, π-GAN, the DCGAN family, the R1
ResNet and the FID Inception.

Turns the JAX package's flax variable trees ({"params": ..., "spectral":
...}, leaves as numpy arrays — ``jax.device_get`` gives that) into the port's
``state_dict``s, so both frameworks can run from the same weights. This
module needs numpy only; it never imports JAX.

Layout rules, each pinned by tests/test_torch_convert.py:
  * Dense (in, out) → Linear weight (out, in).
  * Conv HWIO → OIHW.
  * ConvTranspose (k..., in, out) → (in, out, k...) with the kernel flipped
    on every spatial axis: flax's transposed conv does not flip, torch's
    does. The padding that matches flax "SAME" is set by the modules
    (models/hologan.py: 3D k3 s2 crops the last plane; 2D k4 s2 pads 1).
  * The generator's constant volume NDHWC → NCDHW.
  * Spectral-norm ``u`` carries across from the "spectral" collection.
  * The discriminator flattens in NHWC order in both frameworks, so its
    Dense rows need no permutation.
  * π-GAN's SIREN layers keep flax's (in, out) kernel as it is.
  * CoordConv: the coordinate channels follow the image channels in both
    frameworks, so HWIO → OIHW is the whole conversion.
  * BatchNorm: params scale / bias → weight / bias, batch_stats mean / var
    → running_mean / running_var; InstanceNorm's scale / bias likewise.
  * The DCGAN G's stem (ConvT k4 s1 VALID from 1×1) and its k4 s2 "SAME"
    blocks take the same flip; D's head is a plain k4 s2 VALID conv.
  * The R1 ResNet: G reshapes its Dense output NHWC and D flattens NHWC in
    both frameworks (the modules permute), so Dense rows need no
    permutation either.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C", copy=True))


def _bias(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.bias": _t(p["bias"])} if "bias" in p else {}


def _dense(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(np.asarray(p["kernel"]).T),
            f"{prefix}.bias": _t(p["bias"])}


def _conv(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1)),
            **_bias(p, prefix)}


def _conv_transpose(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    k = np.asarray(p["kernel"])
    nsp = k.ndim - 2
    k = k[(slice(None, None, -1),) * nsp]
    k = k.transpose(nsp, nsp + 1, *range(nsp))
    return {f"{prefix}.weight": _t(k), **_bias(p, prefix)}


def generator_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax HoloGAN Generator variables → models.hologan.Generator
    state_dict."""
    p = variables["params"]
    sd = {"const": _t(np.asarray(p["const"]).transpose(0, 4, 1, 2, 3))}
    sd.update(_dense(p["ZMapping_0"]["Dense_0"], "zmap.dense"))
    for i in range(2):
        blk = p[f"GenBlock3D_{i}"]
        sd.update(_conv_transpose(blk["ConvTranspose_0"], f"block3d_{i}.convt"))
        sd.update(_dense(blk["ZMapping_0"]["Dense_0"], f"block3d_{i}.zmap.dense"))
        blk = p[f"GenBlock2D_{i}"]
        sd.update(_conv_transpose(blk["ConvTranspose_0"], f"block2d_{i}.convt"))
        sd.update(_dense(blk["ZMapping_0"]["Dense_0"], f"block2d_{i}.zmap.dense"))
    sd.update(_conv(p["Conv_0"], "proj_conv"))
    if "Conv_1" in p:                       # 64 px head
        sd.update(_conv(p["Conv_1"], "out_conv"))
    else:                                   # 128 px head
        sd.update(_conv_transpose(p["ConvTranspose_0"], "out_conv"))
    return sd


def discriminator_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax HoloGAN Discriminator variables (params + spectral) →
    models.hologan.Discriminator state_dict."""
    p, spectral = variables["params"], variables["spectral"]
    sd = _conv(p["Conv_0"], "conv0")
    for i in range(3):
        name = f"DiscBlock_{i}"
        sd.update(_conv(p[name]["SpectralNormConv_0"], f"block_{i}.conv"))
        sd[f"block_{i}.conv.u"] = _t(spectral[name]["SpectralNormConv_0"]["u"])
    sd.update(_dense(p["Dense_0"], "dense_logit"))
    sd.update(_dense(p["Dense_1"], "dense_enc"))
    sd.update(_dense(p["Dense_2"], "dense_z"))
    return sd


def _siren(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.kernel": _t(p["kernel"]), f"{prefix}.bias": _t(p["bias"])}


def _mapping(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """MappingNetwork Dense_0..2 (hidden), Dense_3 (γ), Dense_4 (β)."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(3):
        sd.update(_dense(p[f"Dense_{i}"], f"{prefix}.layers.{i}"))
    sd.update(_dense(p["Dense_3"], f"{prefix}.to_gamma"))
    sd.update(_dense(p["Dense_4"], f"{prefix}.to_beta"))
    return sd


def pigan_generator_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax π-GAN Generator variables → models.pigan.Generator state_dict."""
    p = variables["params"]["nerf_renderer"]["rad_field"]
    pre = "nerf_renderer.rad_field"
    sd = _mapping(p["MappingNetwork_0"], f"{pre}.mapping")
    sd.update(_mapping(p["rgb_mapping"], f"{pre}.rgb_mapping"))
    trunk = p["SirenNet_0"]
    for i in range(len(trunk)):
        sd.update(_siren(trunk[f"Siren_{i}"]["Dense_0"],
                         f"{pre}.siren.layers.{i}"))
    sd.update(_dense(p["to_alpha"], f"{pre}.to_alpha"))
    sd.update(_siren(p["to_rgb_siren"]["Dense_0"], f"{pre}.to_rgb_siren"))
    sd.update(_dense(p["to_rgb"], f"{pre}.to_rgb"))
    return sd


def pigan_discriminator_state_dict(variables: Mapping
                                   ) -> Dict[str, torch.Tensor]:
    """Flax π-GAN progressive Discriminator variables →
    models.pigan.Discriminator state_dict."""
    p = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for name, node in p.items():
        if name.startswith("block_"):
            for conv in ("res", "conv1", "conv2"):
                sd.update(_conv(node[conv]["Conv_0"], f"{name}.{conv}"))
        else:                               # from_rgb_<r>, final_conv
            sd.update(_conv(node["Conv_0"], name))
    return sd


def _norm(variables: Mapping, name: str, prefix: str
          ) -> Dict[str, torch.Tensor]:
    """BatchNorm or InstanceNorm ``name``: its affine, and BatchNorm's
    running statistics from the batch_stats collection."""
    p = variables["params"][name]
    sd = {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"])}
    stats = variables.get("batch_stats", {}).get(name)
    if stats is not None:
        sd[f"{prefix}.running_mean"] = _t(stats["mean"])
        sd[f"{prefix}.running_var"] = _t(stats["var"])
    return sd


def dcgan_generator_state_dict(variables: Mapping
                               ) -> Dict[str, torch.Tensor]:
    """Flax DCGAN Generator variables (params + batch_stats) →
    models.dcgan.Generator state_dict."""
    p = variables["params"]
    n = sum(k.startswith("ConvTranspose_") for k in p)
    sd: Dict[str, torch.Tensor] = {}
    for i in range(n - 1):
        sd.update(_conv_transpose(p[f"ConvTranspose_{i}"], f"blocks.{i}.convt"))
        sd.update(_norm(variables, f"BatchNorm_{i}", f"blocks.{i}.norm"))
    sd.update(_conv_transpose(p[f"ConvTranspose_{n - 1}"], "out"))
    return sd


def dcgan_discriminator_state_dict(variables: Mapping
                                   ) -> Dict[str, torch.Tensor]:
    """Flax DCGAN Discriminator variables (params + batch_stats, batch or
    instance norm) → models.dcgan.Discriminator state_dict."""
    p = variables["params"]
    n = sum(k.startswith("Conv_") for k in p)
    norm = "BatchNorm" if "BatchNorm_0" in p else "InstanceNorm"
    sd = _conv(p["Conv_0"], "stem")
    for i in range(1, n - 1):
        sd.update(_conv(p[f"Conv_{i}"], f"blocks.{i - 1}.conv"))
        sd.update(_norm(variables, f"{norm}_{i - 1}", f"blocks.{i - 1}.norm"))
    sd.update(_conv(p[f"Conv_{n - 1}"], "head"))
    return sd


def _resnet_block(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for conv in ("conv_s", "conv_0", "conv_1"):
        if conv in p:
            sd.update(_conv(p[conv], f"{prefix}.{conv}"))
    return sd


def resnet_generator_state_dict(variables: Mapping
                                ) -> Dict[str, torch.Tensor]:
    """Flax R1 ResNet Generator variables →
    models.resnet_stability.Generator state_dict."""
    p = variables["params"]
    n = sum(k.startswith("ResnetBlock_") for k in p)
    sd = _dense(p["Dense_0"], "fc")
    for i in range(n - 1):
        sd.update(_resnet_block(p[f"ResnetBlock_{i}"], f"blocks.{i}"))
    sd.update(_resnet_block(p[f"ResnetBlock_{n - 1}"], "block_out"))
    sd.update(_conv(p["conv_img"], "conv_img"))
    return sd


def inception_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax FID Inception variables (params + batch_stats) →
    eval.inception.InceptionV3FID state_dict: every ``…/conv/kernel`` HWIO
    → ``….conv.weight`` OIHW, ``…/bn/scale`` and ``bias`` → ``….bn.weight``
    and ``bias``, batch_stats ``mean`` / ``var`` → ``running_mean`` /
    ``running_var``. The module names are the same in both frameworks."""
    sd: Dict[str, torch.Tensor] = {}
    names = {"kernel": "weight", "scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}

    def walk(tree: Mapping, prefix: str):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}.")
            elif k == "kernel":
                sd[prefix + "weight"] = _t(np.asarray(v).transpose(3, 2, 0, 1))
            else:
                sd[prefix + names[k]] = _t(v)

    walk(variables["params"], "")
    walk(variables["batch_stats"], "")
    return sd


def resnet_discriminator_state_dict(variables: Mapping
                                    ) -> Dict[str, torch.Tensor]:
    """Flax R1 ResNet Discriminator variables →
    models.resnet_stability.Discriminator state_dict."""
    p = variables["params"]
    sd = _conv(p["conv_img"], "conv_img")
    for i in range(sum(k.startswith("ResnetBlock_") for k in p)):
        sd.update(_resnet_block(p[f"ResnetBlock_{i}"], f"blocks.{i}"))
    sd.update(_dense(p["Dense_0"], "fc"))
    return sd
