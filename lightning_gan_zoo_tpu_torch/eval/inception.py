"""The FID InceptionV3 up to pool3 (2048-d), counterpart of
lightning_gan_zoo_tpu/eval/inception.py.

The FID variant of InceptionV3 (the TF 2015 graph as pytorch_fid builds
it): torchvision's InceptionV3 with average pools that do not count the
padding inside the A, C and E blocks, and a max-pooled branch_pool in the
last E block. Module names are pytorch_fid's (``Conv2d_1a_3x3`` …
``Mixed_7c``, each ``BasicConv2d`` a bias-free ``conv`` and a ``bn`` with
eps 1e-3 on its running statistics), so the FID weights file
``pt_inception-2015-12-05-6726825d.pth`` loads with ``load_weights``. No
weights are downloaded: without the file the network runs from a seeded
random init and callers report ``fid_uncalibrated``.

Input is NHWC in [0, 1], as the JAX module takes it, resized to 299² by
bilinear interpolation with half-pixel centres (the zoo's images are at
most 128 px, so this only upsamples, where ``F.interpolate`` equals
``jax.image.resize``) and mapped to [−1, 1]. The network runs in float32
with autocast off, whatever the training precision.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

#: The drop-in location of the FID weights, the JAX package's: a file here
#: calibrates FID with ``val.inception_weights_path`` unset.
DEFAULT_WEIGHTS_PATH = (
    Path.home() / ".cache" / "lightning_gan_zoo_tpu"
    / "pt_inception-2015-12-05-6726825d.pth")
#: keys of the weights file the pool3 features do not use
_UNUSED = ("fc.", "AuxLogits.")


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size, stride=1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_nocount(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_nocount(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_nocount(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool_kind: str):
        super().__init__()
        self.pool_kind = pool_kind   # 'avg' (FIDInceptionE_1), 'max' (E_2)
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = (_avg_pool_nocount(x) if self.pool_kind == "avg"
              else F.max_pool2d(x, 3, 1, 1))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3FID(nn.Module):
    """Blocks 0–3 of the FID InceptionV3: NHWC images in [0, 1] → pool3
    features (N, 2048), float32."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.eval()   # BatchNorm on its running statistics
        self.requires_grad_(False)

    def forward(self, x01: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x01.device.type, enabled=False):
            x = x01.float().permute(0, 3, 1, 2)
            x = F.interpolate(x, size=(299, 299), mode="bilinear",
                              align_corners=False)
            x = 2.0 * x - 1.0
            x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
            x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
            x = _max_pool(x)
            for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e",
                         "7a", "7b", "7c"):
                x = getattr(self, f"Mixed_{name}")(x)
            return x.mean((2, 3))


def init_random(generator: Optional[torch.Generator] = None
                ) -> InceptionV3FID:
    """A network from a seeded random init, to run the FID pipeline without
    weights: conv kernels from flax's default (LeCun normal, truncated at 2
    σ) rescaled by √2 (He), BatchNorm as the identity. With LeCun's scale
    ~94 stacked conv + ReLU layers would shrink the features to nothing;
    He's keeps them O(1), as the JAX package's ``init_random`` does."""
    generator = generator or torch.Generator().manual_seed(0)
    model = InceptionV3FID()
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            # flax's truncated normal: std over the truncated variance
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                m.weight.mul_(math.sqrt(2.0))
    return model


def load_weights(path: str | Path) -> InceptionV3FID:
    """The network with the pytorch_fid FID weights at ``path``. Validated
    strictly: a key that maps onto no parameter, a parameter with no key
    and a shape that differs each raise a ValueError that names them
    (``fc.*``, ``AuxLogits.*`` and ``num_batches_tracked`` are skipped)."""
    state = torch.load(str(path), map_location="cpu", weights_only=True)
    state = {k: v for k, v in state.items()
             if not k.startswith(_UNUSED)
             and not k.endswith("num_batches_tracked")}
    model = InceptionV3FID()
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    problems = []
    unmapped = sorted(set(state) - set(want))
    missing = sorted(set(want) - set(state))
    bad = sorted(f"{k}: got {tuple(state[k].shape)}, want {want[k]}"
                 for k in set(want) & set(state)
                 if tuple(state[k].shape) != want[k])
    if unmapped:
        problems.append(f"unmapped keys: {unmapped[:8]}")
    if missing:
        problems.append(f"missing parameters: {missing[:8]}")
    if bad:
        problems.append(f"shape mismatches: {bad[:8]}")
    if problems:
        raise ValueError(f"Inception weights at {path} do not map onto the "
                         f"FID InceptionV3: " + "; ".join(problems))
    model.load_state_dict(state, strict=False)
    return model


def build(weights_path: Optional[str] = None
          ) -> Tuple[InceptionV3FID, bool]:
    """(network, calibrated): the configured weights file, else the one at
    ``DEFAULT_WEIGHTS_PATH`` when none is configured, else the random init
    with ``calibrated`` False, so that callers name their metrics
    ``fid_uncalibrated`` and never name a checkpoint by them."""
    if weights_path and Path(weights_path).exists():
        return load_weights(weights_path), True
    if not weights_path and DEFAULT_WEIGHTS_PATH.exists():
        print(f"[fid] using inception weights from the drop-in path "
              f"{DEFAULT_WEIGHTS_PATH}")
        return load_weights(DEFAULT_WEIGHTS_PATH), True
    if weights_path:
        print(f"[fid] WARNING: inception weights not found at "
              f"{weights_path}; using random init: FID/KID values are "
              f"self-consistent but not comparable to published numbers")
    else:
        print(f"[fid] WARNING: no inception weights configured; using "
              f"random init: drop pt_inception-2015-12-05 at "
              f"{DEFAULT_WEIGHTS_PATH} for comparable values")
    return init_random(), False
