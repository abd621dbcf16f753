"""Plain PyTorch pieces the configurations' references share.

Nothing here imports the program. Every function is written out from the
mathematics it stands for, in float32; ``Numerics`` can put every product
(matmul, convolution) through float8 instead (e4m3 operands forward, e5m2
cotangents backward), the lower-precision control that the comparison has
to reject.

  * ``epoch_order`` and ``superstep_indices``: the order in which one epoch
    visits the dataset (the loader's shuffle of each epoch), and the indices
    of one superstep's micro-batches;
  * ``superstep_batch``, the default batch of a superstep: the synthetic
    dataset's images (``synthetic_images``) at those indices, as the
    Trainer stacks them; a configuration whose batch carries more defines
    its own in its module, from ``folder_samples``, ``read_images``,
    ``read_arrays`` and ``stack_micro`` where its data are files;
  * ``Adam``: the optimizer's update rule, one tensor at a time;
  * ``leaf_norms``: per-parameter norms, the currency of the comparison.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under a per-tensor scale that
    puts its largest magnitude at ``top``; the gradient passes straight
    through the rounding."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = amax / top
    xq = (x.detach() / scale).to(dtype).to(x.dtype) * scale
    return x + (xq - x).detach()


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the backward rounds the incoming cotangent to
    e5m2 (differentiably, so a double backward passes through)."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, E5M2_MAX)


class Numerics:
    """Where the products compute: float32 (``quant=False``), or float8
    as fp8 training runs them (``quant=True``): both operands of every
    forward product rounded to e4m3, and the cotangent entering every
    product's backward rounded to e5m2, each under a per-tensor scale (the
    amax onto the format's largest value); the products' own arithmetic
    and everything between them stay float32."""

    def __init__(self, quant: bool = False):
        self.quant = bool(quant)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.quant:
            return x
        return _round8(x, torch.float8_e4m3fn, E4M3_MAX)

    def out(self, y: torch.Tensor) -> torch.Tensor:
        return _RoundGrad.apply(y) if self.quant else y

    def linear(self, x, weight, bias=None):
        return self.out(F.linear(self.q(x), self.q(weight), bias))

    def mm(self, a, b):
        return self.out(self.q(a) @ self.q(b))

    def conv2d(self, x, weight, bias=None, stride=1, padding=0):
        return self.out(F.conv2d(self.q(x), self.q(weight), bias, stride,
                                 padding))


def synthetic_images(indices: np.ndarray, size: int, channels: int,
                     mean: float, std: float) -> np.ndarray:
    """(N, size, size, channels) float32: per index a sine gradient and a
    gaussian blob, clipped to [0, 1], the green and blue channels scaled by
    0.8 and 0.6, then (x − mean) / std."""
    s = size
    idx = np.asarray(indices, np.int64)
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
    phase = (idx[:, None, None].astype(np.float32) * 0.61803) % 1.0
    base = 0.5 + 0.5 * np.sin(
        2 * np.pi * (xx[None] * (1 + idx[:, None, None] % 3) + yy[None]
                     + phase))
    cx = 0.25 + 0.5 * ((idx * 37 % 101) / 101.0)
    cy = 0.25 + 0.5 * ((idx * 57 % 89) / 89.0)
    blob = np.exp(-(((xx[None] - cx[:, None, None]) ** 2
                     + (yy[None] - cy[:, None, None]) ** 2) / 0.02))
    img = np.clip(0.6 * base + 0.4 * blob, 0.0, 1.0).astype(np.float32)
    img = np.repeat(img[..., None], channels, axis=-1)
    if channels >= 3:
        img[..., 1] *= 0.8
        img[..., 2] *= 0.6
    return (img - mean) / std


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The dataset indices in the order epoch ``epoch`` visits them: a
    permutation by numpy's default generator seeded with seed + epoch."""
    order = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(order)
    return order


def superstep_indices(n: int, seed: int, epoch: int, k: int, batch: int,
                      n_micro: int) -> np.ndarray:
    """The dataset indices of superstep ``k`` of epoch ``epoch``: micro-batch
    after micro-batch of ``batch`` consecutive entries of the epoch's
    order."""
    span = batch * n_micro
    idx = epoch_order(n, seed, epoch)[k * span:(k + 1) * span]
    if len(idx) < span:
        raise ValueError(f"epoch {epoch} has no superstep {k}")
    return idx


def superstep_batch(values: dict, seed: int, epoch: int, k: int, batch: int,
                    n_micro: int, device) -> Dict[str, object]:
    """The batch of superstep ``k`` of epoch ``epoch`` as the Trainer hands
    it to the superstep: a dict whose leaves (nested dicts allowed) have
    the leading shape (n_micro, B), the images NCHW at ``"image"``. This
    is the default, the synthetic dataset's images alone, float32; a
    configuration's module that defines ``superstep_batch`` with this
    signature is used in its place."""
    idx = superstep_indices(int(values["dataset.n"]), seed, epoch, k, batch,
                            n_micro)
    img = synthetic_images(idx, int(values["train.img_size"]),
                           int(values["dataset.n_channels"]),
                           float(values["train.data_mean"]),
                           float(values["train.data_std"]))
    return stack_micro({"image": img}, n_micro, batch, device)


def map_batch(fn, batch: dict) -> dict:
    """``fn`` on every leaf of a batch, nested dicts included."""
    return {k: map_batch(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in batch.items()}


def stack_micro(flat: dict, n_micro: int, batch: int, device) -> dict:
    """A dataset's rows in superstep order, (n_micro·B, ...) numpy arrays
    (nested dicts allowed), as (n_micro, B, ...) tensors on ``device``;
    the images NHWC at ``"image"`` become NCHW."""
    def stack(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device).reshape(
            (n_micro, batch) + a.shape[1:])
    out = map_batch(stack, flat)
    if "image" in out:
        out["image"] = out["image"].permute(0, 1, 4, 2, 3).contiguous()
    return out


IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm", ".tif",
                  ".tiff")


def folder_samples(root) -> List[Path]:
    """The image files of a class-per-subdirectory folder, in the order an
    image folder (torchvision's semantics) indexes them: the class
    directories sorted by name, each one's files found recursively and
    sorted by path."""
    root = Path(root)
    out: List[Path] = []
    for cdir in sorted(p for p in root.iterdir() if p.is_dir()):
        out += [f for f in sorted(cdir.rglob("*"))
                if f.suffix.lower() in IMAGE_SUFFIXES]
    if not out:
        raise FileNotFoundError(f"no images under {root}")
    return out


def read_images(paths: Sequence[Path], size: int, channels: int,
                mean: float, std: float) -> np.ndarray:
    """(N, size, size, channels) float32: each file decoded to 8 bits,
    x / 255, then (x − mean) / std. Files must already be ``size``² (a
    resize is the loader's business, and the reference has none)."""
    from PIL import Image
    out = np.empty((len(paths), size, size, channels), np.float32)
    for j, path in enumerate(paths):
        with Image.open(path) as im:
            if im.size != (size, size):
                raise ValueError(f"{path} is {im.size}, not {size}²")
            arr = np.asarray(im.convert("RGB" if channels == 3 else "L"),
                             np.float32) / 255.0
        out[j] = arr[..., None] if arr.ndim == 2 else arr
    return (out - mean) / std


def read_arrays(paths: Sequence[Path], root, keys: Sequence[str]
                ) -> Dict[str, np.ndarray]:
    """{key: (N, ...) float32}: each key of ``keys`` from the npz
    ``<root>/<image stem>.npz`` of every path, stacked in order."""
    out: Dict[str, list] = {k: [] for k in keys}
    for path in paths:
        with np.load(Path(root) / (Path(path).stem + ".npz")) as npz:
            for k in keys:
                out[k].append(np.asarray(npz[k], np.float32))
    return {k: np.stack(v) for k, v in out.items()}


def schedule_at(values: dict, epoch: int) -> Tuple[int, int, int]:
    """(batch size, accumulation, training resolution) of ``epoch`` under
    the configuration's variable batch size, epoch-scheduled accumulation
    and resolution annealing."""
    batch = int(values["train.batch_size"])
    res = int(values.get("train.training_resolution",
                         values["train.img_size"]))
    if "variable_batch_size.batch_sizes" in values:
        sizes = [int(v) for v in values["variable_batch_size.batch_sizes"]]
        ups = [int(v) for v in values["variable_batch_size.update_epochs"]]
        batch = sizes[0]
        for e, up in enumerate(ups):
            if up <= epoch and e + 1 < len(sizes):
                batch = sizes[e + 1]
    if values.get("use_resolution_annealing"):
        ress = [int(v) for v in values["resolution_annealing.resolutions"]]
        ups = [int(v) for v in values["resolution_annealing.update_epochs"]]
        res = ress[0]
        for e, up in enumerate(ups):
            if up <= epoch and e + 1 < len(ress):
                res = ress[e + 1]
    accum = 1
    if "accumulate_grad_batches.start_epoch" in values:
        if epoch >= int(values["accumulate_grad_batches.start_epoch"]):
            accum = int(values["accumulate_grad_batches.accumulation_factor"])
    return batch, accum, res


class Adam:
    """Adam with bias correction, ε outside the square root:
    p ← p − lr/(1 − β1ᵗ) · m / (√v / √(1 − β2ᵗ) + ε)."""

    def __init__(self, params: Sequence[torch.Tensor],
                 betas: Tuple[float, float], eps: float = 1e-8):
        self.params = list(params)
        (self.b1, self.b2), self.eps = betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: float):
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = v.sqrt() / math.sqrt(bc2) + self.eps
            p.sub_(lr / bc1 * m / denom)


def leaf_norms(named: Iterable[Tuple[str, torch.Tensor]]
               ) -> Dict[str, float]:
    """{name: ‖t‖₂} in float64 on the host."""
    names, tensors = zip(*[(n, t.detach()) for n, t in named])
    norms = torch.stack([t.double().norm() for t in tensors]).cpu().tolist()
    return dict(zip(names, norms))


def grads_of(params: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each parameter's gradient, a zero tensor where it has none (the
    optimizer still steps every parameter)."""
    return [p.grad if p.grad is not None else torch.zeros_like(p)
            for p in params]


class GANReference:
    """The superstep every configuration shares: ``disc_freq`` D updates,
    then ``gen_freq`` G updates (``optimisation.disc_freq`` and
    ``optimisation.gen_freq`` where the values give them, else 1), each
    over ``accum`` micro-batches whose losses are averaged into one
    gradient; each loss handed its micro-batch (the superstep batch's
    leaves at one index of their leading axis) and z drawn by the rows of
    its ``"image"``; the extra state (a fade-in) advanced after every
    micro-batch. A configuration supplies ``D`` and ``G`` (modules whose
    parameter names are the program's), ``disc_loss`` and ``gen_loss``
    (each ``(micro-batch, z) -> (loss, {name: metric})``), ``sample_z``, the
    optimizers (``opt_d``, ``opt_g``) and their learning rates by update
    count (``lr_d``, ``lr_g``)."""

    disc_freq = 1
    gen_freq = 1

    def __init__(self, values: dict, device, quant: bool = False):
        self.values = values
        self.disc_freq = int(values.get("optimisation.disc_freq",
                                        self.disc_freq))
        self.gen_freq = int(values.get("optimisation.gen_freq",
                                       self.gen_freq))
        self.device = torch.device(device)
        self.num = Numerics(quant)
        self.d_steps = self.g_steps = 0
        self.extra: dict = {}

    def update_extra(self):
        """After every micro-batch; nothing by default."""

    def superstep(self, batch: dict, accum: int
                  ) -> Tuple[Dict[str, float], Dict[str, Dict[str, float]]]:
        """One superstep on ``batch`` (``superstep_batch``'s: leaves of
        leading shape (n_micro, B), images at ``"image"``). Returns the
        losses averaged over the micro-batches that emitted them, and the
        per-leaf norms of each net's gradient as its optimizer took it at
        that net's first update of the superstep."""
        sums: Dict[str, List[torch.Tensor]] = {}
        grads: Dict[str, Dict[str, float]] = {}
        i = 0
        for is_disc, freq in ((True, self.disc_freq), (False, self.gen_freq)):
            net, other = (self.D, self.G) if is_disc else (self.G, self.D)
            loss_fn = self.disc_loss if is_disc else self.gen_loss
            net.requires_grad_(True)
            other.requires_grad_(False)
            params = list(net.parameters())
            for _ in range(freq):
                for p in params:
                    p.grad = None
                for _a in range(accum):
                    micro = map_batch(lambda v: v[i], batch)
                    z = self.sample_z(micro["image"].shape[0])
                    loss, metrics = loss_fn(micro, z)
                    (loss / accum).backward()
                    self.update_extra()
                    i += 1
                    for k, v in metrics.items():
                        sums.setdefault(k, []).append(v.detach())
                g = grads_of(params)
                name = "discriminator" if is_disc else "generator"
                if name not in grads:
                    grads[name] = leaf_norms(
                        zip([n for n, _ in net.named_parameters()], g))
                if is_disc:
                    self.opt_d.step(g, self.lr_d(self.d_steps))
                    self.d_steps += 1
                else:
                    self.opt_g.step(g, self.lr_g(self.g_steps))
                    self.g_steps += 1
        self.G.requires_grad_(True)
        self.D.requires_grad_(True)
        losses = {k: float(torch.stack(v).float().mean())
                  for k, v in sums.items()}
        return losses, grads

    def named_leaves(self) -> Dict[str, torch.Tensor]:
        """Every parameter, as ``discriminator.<name>`` and
        ``generator.<name>``."""
        out = {f"discriminator.{n}": p for n, p in self.D.named_parameters()}
        out.update({f"generator.{n}": p for n, p in self.G.named_parameters()})
        return out


def count_flops(fn) -> float:
    """The matmul and convolution operations ``fn()`` runs (forward,
    backward and any double backward), by ``torch.utils.flop_counter``'s
    formulas, counted in a dispatch mode of its own: FlopCounterMode's
    module tracking cannot follow a penalty's ``autograd.grad``."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Count(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            packet = func._overloadpacket
            if packet not in flop_registry:
                with self:
                    r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
            out = func(*args, **kwargs)
            if packet in flop_registry:
                Count.total += int(flop_registry[packet](*args, **kwargs,
                                                         out_val=out))
            return out

    with Count():
        fn()
    return float(Count.total)


def flops_of_superstep(ref: GANReference, batch: dict, accum: int) -> float:
    """``count_flops`` of one superstep of ``ref`` on ``batch``; its state
    steps."""
    return count_flops(lambda: ref.superstep(batch, accum))
