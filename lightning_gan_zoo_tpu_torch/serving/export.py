"""Serving export of the port (counterpart of
lightning_gan_zoo_tpu/serving/export.py): a task's eval-mode generator
frozen with ``torch.export`` into one ``.pt2`` file, weights included.

    python -m lightning_gan_zoo_tpu_torch.serving.export +expt=hologan \\
        dataset=synthetic serving.batch=8 serving.out=/tmp/g.pt2 \\
        [serving.ckpt=<run>/ckpts] [serving.pose=true] \\
        [serving.dynamic=true] [serving.dtype=bf16] [--device cuda]

    import torch
    import lightning_gan_zoo_tpu_torch.ops.cuda   # registers the kernels
    g = torch.export.load("/tmp/g.pt2").module()
    images = g(z, seed)      # z (B, z_dim) f32, seed int64[] → NCHW

The program calls the same kernels as training: HoloGAN's view warp is one
``lgzt::trilinear_fwd`` node, each π-GAN field evaluation one
``lgzt::siren_trunk_fwd`` node, so loading such a program needs
``import lightning_gan_zoo_tpu_torch.ops.cuda`` first (the sidecar's
``call`` line says so); a 2D family's program loads with plain torch. The
export runs on the card unless ``--device cpu`` is given.

Signatures:
  * ``(z, seed)`` (default): the randomness G consumes in eval mode (the
    view of HoloGAN, π-GAN and ANIGAN, and ANIGAN's noise in place of the
    deformed points) is drawn inside the program from ``seed`` by a
    counter-based 32-bit integer hash written in torch ops, a pure function
    of (seed, stream, row, draw), mapped to uniforms in [0, 1) and the
    views through the families' own ranges. Same (z, seed), same images;
    another seed, other views. The hash is not JAX's PRNG and cannot
    reproduce its draws; the two packages agree where the view is given.
  * ``(z, view_in, seed)`` (``serving.pose=true``, view families only):
    ``view_in`` (B, 6) rows [azimuth_rad, elevation_rad, scale, tx, ty,
    tz]; ``seed`` feeds only ANIGAN's noise, and is kept for the JAX
    signature.

``serving.dynamic=true`` exports with a symbolic batch; if that export
fails, the static batch ships and the reason is recorded in the sidecar.
``serving.dtype=bf16`` stores the float32 parameters in bf16 (half the
file) and the program computes with them promoted back to float32, as the
JAX package's bf16 export does. ``serving.ckpt`` restores the checkpoint
that ``CheckpointManager.find_ckpt`` picks there (or the directory given),
with the weight EMA in place of G's parameters when the run kept one.
Every file is written beside a ``.json`` sidecar (the JAX keys, with
``device`` in place of ``platforms``).
"""
from __future__ import annotations

import itertools
import json
import math
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..parallel import tensor

VIEW_DIM = 6   # [azimuth, elevation, scale, tx, ty, tz]
#: the largest batch a dynamic-batch program serves
MAX_BATCH = 1024
_M32 = 0xFFFFFFFF
#: odd multipliers below 2³¹, so a 32-bit value times one fits in int64
_MULS = (0x7FEB352D, 0x5BD1E995)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit finaliser (xor-shift, multiply) on int64 tensors holding
    32-bit values."""
    for mul in _MULS:
        x = x ^ (x >> 16)
        x = (x * mul) & _M32
    return x ^ (x >> 15)


def hash_uniforms(seed: torch.Tensor, rows: int, draws: int, device,
                  stream: int = 0) -> torch.Tensor:
    """(rows, draws) float32 uniforms in [0, 1), a pure function of
    (seed, stream, row, draw): each is the top 24 bits of a hash of the
    four. Stream 0 draws the views, streams 1, 2, … ANIGAN's noise."""
    seed = seed.reshape(()).to(torch.int64) & _M32
    row = torch.arange(rows, device=device, dtype=torch.int64)[:, None]
    draw = torch.arange(draws, device=device, dtype=torch.int64)[None, :]
    h = _mix32(_mix32(seed.to(device)) ^ stream)
    h = _mix32(_mix32(h ^ row) ^ (draw + 0x9E37))
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


class ServingGenerator(nn.Module):
    """The task's eval-mode ``generate`` as a module of (z, seed). G's
    parameters are frozen (``requires_grad`` off); with ``bf16`` its float32
    parameters are held in bf16 and promoted to float32 for each call. Both
    change the task's own G in place. ANIGAN's field, which reads noise in
    place of the deformed points, gets it from ``seed`` too: each field
    evaluation of a call its own draw."""

    def __init__(self, task, bf16: bool = False):
        super().__init__()
        self.task = task
        self.generator = task.generator.requires_grad_(False)
        self.bf16 = bf16
        if bf16:
            with torch.no_grad():
                for p in self.generator.parameters():
                    if p.dtype == torch.float32:
                        p.data = p.data.to(torch.bfloat16)

    def forward(self, z: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
        view_in = None
        if hasattr(self.task, "view_from_uniforms"):
            view_in = self.task.view_from_uniforms(hash_uniforms(
                seed, z.shape[0], VIEW_DIM, z.device))
        return self.generate(z, view_in, seed)

    def generate(self, z, view_in, seed):
        params = ({n: p.float() for n, p in self.generator.named_parameters()}
                  if self.bf16 else None)
        kw = {} if view_in is None else {"view_in": view_in}
        if getattr(self.task, "draws_deformation_noise", False):
            streams = itertools.count(1)

            def deform_noise(shape):
                return hash_uniforms(seed, math.prod(shape[:-1]), shape[-1],
                                     z.device, stream=next(streams)
                                     ).reshape(shape)
            kw["deform_noise"] = deform_noise
        return self.task.generate(z, params=params, **kw)


class PoseServingGenerator(ServingGenerator):
    """(z, view_in, seed): the view given; ``seed`` feeds only ANIGAN's
    deformation noise."""

    def forward(self, z: torch.Tensor, view_in: torch.Tensor,
                seed: torch.Tensor) -> torch.Tensor:
        return self.generate(z, view_in, seed)


def kernel_nodes(program) -> Dict[str, int]:
    """How many nodes of the exported program (its nested graphs included)
    call each of the port's custom ops, by op name."""
    counts: Dict[str, int] = {}
    for gm in program.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for n in gm.graph.nodes:
                name = str(n.target)
                if n.op == "call_function" and name.startswith("lgzt."):
                    counts[name] = counts.get(name, 0) + 1
    return counts


def build_exported_generator(task, batch: int, pose: bool = False,
                             dynamic_batch: bool = False, bf16: bool = False):
    """``torch.export`` of the task's eval-mode generate. Returns
    (ExportedProgram, info): ``info["dynamic"]`` says whether the symbolic
    batch shipped, ``info["fallback_reason"]`` every downgrade taken (or
    None). G must hold its whole parameters: a task cut for tensor
    parallelism exports inside its state's ``sharding.full()``, which
    gathers them (a program holds no tp collective)."""
    if any(tensor.is_block(p) for p in task.generator.parameters()):
        raise ValueError("G holds tp blocks: export it inside "
                         "sharding.full(), which gathers it whole")
    if pose and not hasattr(task, "view_from_uniforms"):
        raise ValueError(
            f"serving.pose=true needs a view-conditioned family; "
            f"{type(task).__name__} samples no views")
    module = (PoseServingGenerator if pose else ServingGenerator)(
        task, bf16=bf16).eval()
    dev = task.device

    def example(b):
        args = [torch.zeros(b, int(task.noise_dim), device=dev)]
        if pose:
            args.append(torch.zeros(b, VIEW_DIM, device=dev))
        return (*args, torch.zeros((), dtype=torch.int64, device=dev))

    # traced with gradients off: generate's own no_grad then records no
    # grad-mode region in the graph
    with torch.no_grad():
        reasons = []
        if dynamic_batch:
            dim = torch.export.Dim("batch", min=1, max=MAX_BATCH)
            shapes = ({0: dim}, {0: dim}, None) if pose else ({0: dim}, None)
            try:
                return (torch.export.export(module, example(max(batch, 2)),
                                            dynamic_shapes=shapes),
                        {"dynamic": True, "fallback_reason": None})
            except Exception as e:  # noqa: BLE001 — any refusal of the
                # symbolic batch ships the static one; the sidecar says why
                reasons.append(f"dynamic: {type(e).__name__}: {e}"[:2000])
        program = torch.export.export(module, example(batch))
    return program, {"dynamic": False,
                     "fallback_reason": "; ".join(reasons) or None}


def load_generator_weights(task, ckpt: str):
    """G's weights from the checkpoint ``find_ckpt`` picks in ``ckpt`` (or
    the checkpoint directory ``ckpt``), the EMA twin in place of its
    parameters where the run kept one. Returns (the checkpoint's path, its
    meta)."""
    from ..runtime.checkpoint import CheckpointManager
    path = CheckpointManager.find_ckpt(ckpt) or Path(ckpt)
    payload, meta = CheckpointManager.restore(path)
    task.generator.load_state_dict(payload["generator"])
    if payload.get("g_ema") is not None:
        with torch.no_grad():
            for name, p in task.generator.named_parameters():
                p.copy_(payload["g_ema"][name])
    return path, meta


def export_generator(conf_dir, overrides: Sequence[str], batch: int,
                     out_path, ckpt: Optional[str] = None, pose: bool = False,
                     dynamic_batch: bool = False, dtype: str = "f32",
                     device: str = "cuda"):
    """Compose the config, build the task on ``device`` (restoring
    ``ckpt`` if given), export G and write the ``.pt2`` and its sidecar.
    Returns (path, sidecar)."""
    from ..config import compose
    from ..config.registry import instantiate

    dtype = str(dtype or "f32").lower()
    if dtype not in ("f32", "float32", "bf16", "bfloat16"):
        raise ValueError(f"serving.dtype must be f32|bf16, got {dtype!r}")
    dtype = "bf16" if dtype in ("bf16", "bfloat16") else "f32"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: torch sees no CUDA device")
    out_path = Path(out_path)
    cfg = compose(conf_dir, list(overrides))
    task = instantiate(cfg.model.lm, cfg, str(out_path.parent),
                       device=device)
    if ckpt:
        load_generator_weights(task, ckpt)
    program, info = build_exported_generator(
        task, batch, pose=pose, dynamic_batch=dynamic_batch,
        bf16=dtype == "bf16")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, str(out_path))
    args = "z, view_in, seed" if pose else "z, seed"
    load = ("import lightning_gan_zoo_tpu_torch.ops.cuda; "
            if kernel_nodes(program) else "")
    sidecar = {
        "expt": str(cfg.name),
        "batch": "dynamic" if info["dynamic"] else batch,
        "weights_dtype": dtype,
        "z_dim": int(task.noise_dim),
        "img_size": int(cfg.train.img_size),
        "layout": "NCHW",
        "seed": "int64[]",
        "call": (f"{load}images = torch.export.load(path).module()"
                 f"({args})"),
        "device": str(device),
    }
    if pose:
        sidecar["pose"] = True
        sidecar["view_dim"] = VIEW_DIM
        sidecar["view_row"] = ("[azimuth_rad, elevation_rad, scale, "
                               "tx, ty, tz]")
    if info["fallback_reason"] is not None:
        sidecar["fallback_reason"] = info["fallback_reason"]
    out_path.with_suffix(out_path.suffix + ".json").write_text(
        json.dumps(sidecar, indent=2))
    return out_path, sidecar


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    serving = {"batch": 8, "out": "generator.pt2", "ckpt": None,
               "pose": False, "dynamic": False, "dtype": "f32"}
    overrides, device = [], "cuda"
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--device" and i + 1 < len(argv):
            device, i = argv[i + 1], i + 1
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("serving."):
            k, v = a[len("serving."):].split("=", 1)
            serving[k] = v
        else:
            overrides.append(a)
        i += 1
    conf_dir = Path(__file__).resolve().parents[2] / "conf"

    def flag(name):
        return str(serving[name]).lower() in ("1", "true", "yes")

    out, sidecar = export_generator(
        conf_dir, overrides, int(serving["batch"]), serving["out"],
        ckpt=serving["ckpt"], pose=flag("pose"),
        dynamic_batch=flag("dynamic"), dtype=str(serving["dtype"]),
        device=device)
    print(f"exported {sidecar['expt']} generator → {out} "
          f"({out.stat().st_size / 1e6:.1f} MB, batch={sidecar['batch']}, "
          f"device={sidecar['device']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
