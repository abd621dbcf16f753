"""Data parallelism over processes, one per card (counterpart of the
process-level helpers of lightning_gan_zoo_tpu/parallel/mesh.py:
``is_main_process``, ``broadcast_metrics``, ``any_process_flag`` and the
striping contract of ``put_batch``).

The contract is the JAX package's: the data-parallel superstep is the
one-device superstep on the global batch.

  * ``train.batch_size`` is global. Rank r holds rows [r·b, (r+1)·b) of it,
    b = batch / world (``local_rows``); the EpochLoader's stripes feed
    them.
  * Every random draw of a training step is the one-device draw for the
    global batch, of which each rank keeps its rows (``draw_rows`` inside
    ``global_draws``). The random streams then stay identical on every
    rank, and a checkpoint resumes at any world size.
  * BatchNorm statistics cover the global batch (models/layers.py, through
    ``all_reduce_sum``).
  * Gradients and metrics are averaged over the ranks (``average_grads``,
    ``average_metrics``): with equal rows per rank, the mean of the ranks'
    batch means is the global batch mean.

The group comes from torchrun's environment (``init_from_env``) or from
``launch``, which spawns one process per device. Its backend is NCCL for
CUDA devices and gloo for the CPU, unless the caller names one. A failed
NCCL initialisation raises: nothing falls back to gloo or to the CPU.
Without a group every helper is the one-process identity.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import signal
import socket
import sys
from typing import Callable, Dict, Iterable, List, Sequence

import torch
import torch.distributed as tdist

#: rank 0 validates (FID over val.fid_n_samples, the figures) while the
#: other ranks wait in the broadcast of its metrics, longer than the
#: default collective timeout allows
TIMEOUT = datetime.timedelta(minutes=60)


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def world_size() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return tdist.get_rank() if is_initialized() else 0


def is_main_process() -> bool:
    """Rank 0 writes the logs, images, figures, traces and checkpoints
    (the reference's rank_zero_only)."""
    return rank() == 0


def rank_devices(device, n: int) -> List[str]:
    """The devices of an ``n``-rank run on ``device``'s type: cuda:0 …
    cuda:k−1 with k = min(n, the cards there are), as the JAX Trainer
    takes min(num_gpus, devices); ``n`` processes on the CPU."""
    if torch.device(device).type == "cuda":
        return [f"cuda:{r}" for r in range(min(n, torch.cuda.device_count()))]
    return ["cpu"] * n


def init(rank_: int, world: int, device, backend: str | None = None,
         init_method: str = "env://") -> torch.device:
    """Join the default group as ``rank_`` of ``world`` on ``device`` (a
    CUDA device becomes the current one). Returns the device."""
    device = torch.device(device)
    backend = backend or backend_for(device)
    kwargs = {}
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        if backend == "nccl":
            # binds the communicator to the card now, so a NCCL that cannot
            # start fails here rather than at the first collective
            kwargs["device_id"] = device
    tdist.init_process_group(backend, init_method=init_method, rank=rank_,
                             world_size=world, timeout=TIMEOUT, **kwargs)
    return device


def init_from_env(device) -> torch.device:
    """Join the group torchrun describes (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT). A CUDA rank runs on cuda:LOCAL_RANK."""
    rank_, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         rank_)))
    return init(rank_, world, device)


def shutdown():
    if is_initialized():
        tdist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank_: int, fn: Callable, args: tuple, devices: Sequence[str],
               backend: str | None, port: int):
    """One spawned rank. After ``fn`` returns, a signal the launcher passes
    on late is ignored (the rank's work is done), and the process ends
    without the interpreter's finalization, which takes about a second
    with torch loaded and several under load (the rescue's SIGTERM-to-exit
    time)."""
    device = init(rank_, len(devices), devices[rank_], backend=backend,
                  init_method=f"tcp://127.0.0.1:{port}")
    try:
        rc = fn(device, *args)
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            signal.signal(sig, signal.SIG_IGN)
        barrier()
    finally:
        tdist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(int(rc or 0))


def launch(fn: Callable, args: tuple, devices: Sequence[str],
           backend: str | None = None):
    """``fn(device, *args)`` on ``len(devices)`` ranks of one group, rank r
    in a spawned process on ``devices[r]``; a non-zero return ends that
    rank with that exit code. SIGTERM and SIGUSR1 sent to this process are
    passed on to every rank. Raises torch.multiprocessing's
    ProcessExitedException or ProcessRaisedException when a rank fails,
    after the others have been terminated."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(
        _rank_main, args=(fn, args, [str(d) for d in devices], backend,
                          free_port()),
        nprocs=len(devices), join=False, start_method="spawn")

    def forward(signum, frame):
        for p in ctx.processes:
            if p.is_alive():
                os.kill(p.pid, signum)

    old = []
    for sig in (signal.SIGTERM, signal.SIGUSR1):
        try:
            old.append((sig, signal.signal(sig, forward)))
        except ValueError:          # not the main thread
            pass
    try:
        while not ctx.join():
            pass
    finally:
        for sig, handler in old:
            signal.signal(sig, handler)


# ------------------------------------------------------------ the batch
def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows [r·b, (r+1)·b) of a global-batch tensor."""
    w = world_size()
    if w == 1:
        return x
    if x.shape[0] % w:
        raise ValueError(f"a leading axis of {x.shape[0]} rows does not "
                         f"divide over {w} ranks")
    b = x.shape[0] // w
    r = rank()
    return x[r * b:(r + 1) * b]


#: Process-wide, not per thread: the autograd engine's device threads
#: read it too (a nerf.remat recompute draws inside the backward).
_GLOBAL_DRAWS = False


@contextlib.contextmanager
def global_draws():
    """Within the block, ``draw_rows`` makes the global batch's draws."""
    global _GLOBAL_DRAWS
    before, _GLOBAL_DRAWS = _GLOBAL_DRAWS, True
    try:
        yield
    finally:
        _GLOBAL_DRAWS = before


def draw_rows(draw: Callable[[int], torch.Tensor], n: int) -> torch.Tensor:
    """``draw(n)``: a random draw whose leading axis holds this rank's
    ``n`` rows. Inside ``global_draws`` on more than one rank, the draw for
    the global batch, ``draw(n · world)``, of which this rank keeps its
    rows: what the one-device run draws, and the stream left where it
    leaves it."""
    w = world_size()
    if not _GLOBAL_DRAWS or w == 1:
        return draw(n)
    return local_rows(draw(n * w))


# ---------------------------------------------------------- collectives
def _comm_device() -> torch.device:
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, differentiable to any order: its backward
    is the sum over the ranks of the incoming gradients, itself this
    function. This is torch.distributed.nn.functional.all_reduce's rule;
    that function warns at every call in recent torch, and the
    replacement it names has no double backward."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks (``x`` without a
    group)."""
    return _AllReduceSum.apply(x) if is_initialized() else x


def average_grads(params: Iterable[torch.nn.Parameter]) -> int:
    """Each gradient replaced by its mean over the ranks, in one flat
    all-reduce of every gradient there is (parameters left without one
    are the same on every rank). Returns the bytes reduced; 0 without a
    group."""
    if not is_initialized():
        return 0
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return 0
    flat = torch.cat([g.reshape(-1) for g in grads])
    tdist.all_reduce(flat)
    flat.div_(world_size())
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))
    return flat.numel() * flat.element_size()


def all_gather_flat(flat: torch.Tensor) -> torch.Tensor:
    """Every rank's 1-D ``flat`` (one length on every rank), concatenated
    in rank order (``flat`` itself without a group). The list form of the
    call: torch 2.11 and later take it on NCCL and on gloo, CUDA tensors
    included, where ``all_gather_into_tensor`` warns in recent torch and
    its replacement is not in 2.11."""
    w = world_size()
    if w == 1:
        return flat
    out = torch.empty(w * flat.numel(), dtype=flat.dtype, device=flat.device)
    tdist.all_gather(list(out.chunk(w)), flat)
    return out


def reduce_scatter_flat(flat: torch.Tensor) -> torch.Tensor:
    """This rank's block of the sum over the ranks of a 1-D ``flat`` made of
    ``world`` equal blocks (the list form, as in ``all_gather_flat``)."""
    w = world_size()
    if w == 1:
        return flat
    if flat.numel() % w:
        raise ValueError(f"{flat.numel()} elements do not split over {w} "
                         "ranks")
    out = torch.empty(flat.numel() // w, dtype=flat.dtype,
                      device=flat.device)
    tdist.reduce_scatter(out, list(flat.chunk(w)))
    return out


def average_metrics(metrics: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """0-d metric tensors averaged over the ranks, in one all-reduce (every
    rank emits the same keys in the same order)."""
    if not is_initialized() or not metrics:
        return metrics
    vals = torch.stack([v.float() for v in metrics.values()])
    tdist.all_reduce(vals)
    vals.div_(world_size())
    return dict(zip(metrics, vals.unbind()))


def any_process_flag(flag: bool) -> bool:
    """True on every rank when any rank's ``flag`` is (a MAX all-reduce);
    every rank must call it at the same point."""
    if not is_initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], device=_comm_device())
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_metrics(metrics: Dict[str, float]) -> Dict[str, float]:
    """Rank 0's metric dict on every rank (the others' argument is
    ignored), so that decisions made from it, such as the best-FID
    checkpoint, agree."""
    if not is_initialized():
        return metrics
    box = [metrics]
    tdist.broadcast_object_list(box, src=0)
    return box[0]


def broadcast_int(value: int) -> int:
    """Rank 0's ``value`` on every rank."""
    if not is_initialized():
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=_comm_device())
    tdist.broadcast(t, src=0)
    return int(t.item())


def barrier():
    if is_initialized():
        tdist.barrier()
