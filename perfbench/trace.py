"""The yardstick of the traced run: the card's published peaks, the least
time of a trunk call, the kernel classes, and the reduction of a
``torch.profiler`` trace to what the per-layer readers read.

Frozen copies, so that a change to the program cannot move the yardstick:
``KINDS``/``kind_of`` of lightning_gan_zoo_tpu_torch/utils/
profile_superstep.py, ``union_us`` of utils/profiling.py, and ``bound`` and
``trunk_bound`` of utils/kernel_bench.py.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

#: NVIDIA H100 SXM, published dense peaks (data sheet, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12

KINDS = (("trunk forward", ("trunk_fwd",)),
         ("trunk backward", ("trunk_bwd",)),
         ("trilinear", ("trilinear",)),
         ("convolution", ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                          "implicit", "winograd", "fft")),
         ("matmul", ("gemm", "cutlass", "xmma", "sm90", "cublas")),
         ("sort / scan", ("sort", "scan", "cumprod", "cumsum", "radix")),
         ("linear solve", ("getrf", "getrs", "trsm", "lu_", "solve",
                           "magma", "laswp")),
         ("distances", ("cdist",)),
         ("reduction", ("reduce", "norm")),
         ("elementwise", ("elementwise", "vectorized", "unrolled", "fill",
                          "copy", "cat", "index", "gather", "where")))

#: gaps between kernels shorter than this are launch latency and are not
#: named by a host operator
SHORT_GAP_US = 10.0


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def bound_ms(flops: float, nbytes: float,
             flops_peak: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: the larger of the operations
    over their peak rate and the bytes over the HBM rate."""
    return max(flops / flops_peak, nbytes / PEAK_HBM_BYTES) * 1e3


def trunk_bound_ms(b: int, m: int, h: int, layers: int, cin: int = 3,
                   backward: bool = False) -> float:
    """The FiLM-SIREN trunk over b·m rows: L−1 bf16 H×H products on the
    tensor cores and layer 0's Cin×H in f32 beside them (the forward); the
    backward recomputes both, passes dh down and forms the weight
    gradients (3×). The busier unit bounds. Bytes, each input read once:
    x and the bf16 output (forward); x, the bf16 cotangent and dx
    (backward)."""
    rows, k = b * m, 3 if backward else 1
    nbytes = rows * (cin * 4 + h * 2 + (cin * 4 if backward else 0))
    return max(bound_ms(rows * (layers - 1) * 2.0 * h * h * k, nbytes),
               bound_ms(rows * 2.0 * cin * h * k, nbytes, PEAK_F32_FLOPS))


@dataclasses.dataclass
class Trace:
    """One profiled stretch of whole supersteps."""
    #: (name, start µs, end µs) of every kernel, copy and set on the card
    kernels: List[Tuple[str, float, float]]
    #: (name, start µs, end µs, input shapes) of every host operator
    host_ops: List[Tuple[str, float, float, list]]
    #: host seconds from the synchronised start to the synchronised end
    stretch_s: float
    supersteps: int

    def busy_s(self) -> float:
        return union_us((s, e) for _, s, e in self.kernels) / 1e6

    def ms_by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.kernels:
            k = kind_of(name)
            out[k] = out.get(k, 0.0) + (e - s) / 1e3
        return out

    def device_ms(self, key: str) -> float:
        return sum(e - s for name, s, e in self.kernels if key in name) / 1e3

    def calls(self, op_suffix: str) -> List[list]:
        """Input shapes of every host call of the operator whose name ends
        with ``op_suffix``."""
        return [shapes for name, _, _, shapes in self.host_ops
                if name.endswith(op_suffix)]

    def top_device_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.kernels:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], secs] for name, secs in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle seconds between the card's kernels, by the host operator
        that was running when each gap opened (the innermost open one;
        "python" where none was), the gaps under SHORT_GAP_US pooled."""
        spans = sorted((s, e) for _, s, e in self.kernels)
        gaps, end = [], None
        for s, e in spans:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        ops = sorted((s, e, name) for name, s, e, _ in self.host_ops)
        starts = [s for s, _, _ in ops]
        by: Dict[str, float] = {}
        for g0, g1 in gaps:
            if g1 - g0 < SHORT_GAP_US:
                key = f"(gaps under {SHORT_GAP_US:g} us)"
            else:
                key = "python"
                i = bisect.bisect_right(starts, g0) - 1
                for j in range(i, max(i - 4000, -1), -1):
                    if ops[j][1] > g0:
                        key = ops[j][2]
                        break
            by[key] = by.get(key, 0.0) + (g1 - g0) / 1e6
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], secs] for name, secs in top]


def from_profiler(prof, stretch_s: float, supersteps: int) -> Trace:
    """The kernels and host operators of a finished ``torch.profiler``
    run. The device timeline also carries user annotations (ranges such
    as ``Optimizer.step#Adam.step`` that span kernels and the gaps between
    them); they are not device work and are left out."""
    import torch
    kernels, host = [], []
    for ev in prof.events():
        start, end = ev.time_range.start, ev.time_range.end
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False):
                kernels.append((ev.name, float(start), float(end)))
        else:
            host.append((ev.name, float(start), float(end),
                         list(ev.input_shapes or [])))
    return Trace(kernels, host, stretch_s, supersteps)


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads."""
    trace: Trace
    #: the traced run's window less the profiled stretch (from the
    #: synchronisation before the profiler starts to its stop's return):
    #: its seconds and supersteps
    untraced_s: float
    untraced_supersteps: int
    #: the benchmark's count of a superstep's matmul and convolution
    #: operations, from the configuration's plain reference
    flops_per_superstep: Optional[float]


def trunk_roofline(trace: Trace, op: str, kernel: str,
                   backward: bool) -> Optional[float]:
    """100 · Σ trunk_bound_ms over the calls of ``op`` (their recorded
    shapes: x (B, M, Cin), the stacked middle weights (L−1, H, H)) / the
    card time of the kernels whose names hold ``kernel``; None where
    either is missing."""
    device_ms = trace.device_ms(kernel)
    calls = trace.calls(op)
    if device_ms <= 0 or not calls:
        return None
    least = 0.0
    for shapes in calls:
        (b, m, cin), wmid = shapes[0], shapes[2]
        least += trunk_bound_ms(b, m, wmid[-1], wmid[0] + 1, cin, backward)
    return 100.0 * least / device_ms
