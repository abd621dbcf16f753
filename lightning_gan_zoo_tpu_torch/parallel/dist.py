"""Data parallelism over processes, one per card (counterpart of the
process-level helpers of lightning_gan_zoo_tpu/parallel/mesh.py:
``is_main_process``, ``broadcast_metrics``, ``any_process_flag`` and the
striping contract of ``put_batch``).

The contract is the JAX package's: the data-parallel superstep is the
one-device superstep on the global batch.

  * ``train.batch_size`` is global. Data rank d holds rows [d·b, (d+1)·b)
    of it, b = batch / data ranks (``local_rows``); the EpochLoader's
    stripes feed them.
  * Every random draw of a training step is the one-device draw for the
    global batch, of which each rank keeps its rows (``draw_rows`` inside
    ``global_draws``). The random streams then stay identical on every
    rank, and a checkpoint resumes at any world size.
  * BatchNorm statistics cover the global batch (models/layers.py, through
    ``all_reduce_sum``).
  * Gradients and metrics are averaged over the data ranks
    (``average_grads``, ``average_metrics``): with equal rows per rank, the
    mean of the ranks' batch means is the global batch mean.

Ray sharding (``num_sp``; the counterpart of ``make_mesh``'s 'sp' axis,
``sp_size``, ``shard_rays`` and ``unshard_rays``) makes the ranks a grid
of data × sp, sp the minor axis as in the JAX mesh: rank r has the data
index r // sp and the sp index r % sp. The batch contract above holds
over the data axis (``data_rank``, ``data_size``): the sp ranks of one
data group hold the same rows, draw the same numbers and run everything
outside the renderer's per-ray work replicated. Inside a training step
the NeRF renderer gives each of them 1/sp of every image's rays
(``shards_rays``, ``ray_slice``) and gathers the rendered rays back over
the sp group (``all_gather_rays``). With ``num_sp`` = 1 the data axis is
the world and every helper is what it was without ray sharding.

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
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

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


# ------------------------------------------------------------ the grid
#: the sp axis's size and this rank's groups (None: the default group for
#: the data axis at sp 1; no sp group at sp 1), set by ``init``
_SP = 1
_DATA_GROUP = None
_SP_GROUP = None


def check_grid(world: int, sp: int):
    """Raise ValueError unless ``sp`` divides ``world`` (mesh.py's
    make_mesh rule, in its words)."""
    if sp < 1 or world % sp:
        raise ValueError(f"num_sp={sp} x num_tp=1 does not divide the "
                         f"{world}-device mesh")


def grid_position(rank_: int, sp: int) -> Tuple[int, int]:
    """(data index, sp index) of ``rank_`` in a data × sp grid, sp the
    minor axis."""
    return rank_ // sp, rank_ % sp


def grid_groups(world: int, sp: int) -> Tuple[List[List[int]],
                                              List[List[int]]]:
    """The ranks of every data group (one per sp index: the ranks that
    share it) and of every sp group (one per data index), in the order
    ``init`` creates them."""
    data = world // sp
    return ([[d * sp + s for d in range(data)] for s in range(sp)],
            [list(range(d * sp, (d + 1) * sp)) for d in range(data)])


def _make_grid(sp: int):
    """This rank's data and sp groups. Every rank creates every group, in
    the same order (torch.distributed.new_group is a collective); a group
    of one rank is not made (its collectives are skipped)."""
    global _SP, _DATA_GROUP, _SP_GROUP
    world, me = tdist.get_world_size(), tdist.get_rank()
    check_grid(world, sp)
    _SP, _DATA_GROUP, _SP_GROUP = sp, None, None
    if sp == 1:
        return
    data_groups, sp_groups = grid_groups(world, sp)
    for ranks in data_groups:
        if len(ranks) > 1:
            group = tdist.new_group(ranks)
            if me in ranks:
                _DATA_GROUP = group
    for ranks in sp_groups:
        group = tdist.new_group(ranks)
        if me in ranks:
            _SP_GROUP = group


def sp_size() -> int:
    """The ray-sharding axis's size (1: off)."""
    return _SP if is_initialized() else 1


def sp_rank() -> int:
    return grid_position(rank(), sp_size())[1]


def data_size() -> int:
    """The data axis's size: the ranks that hold distinct rows."""
    return world_size() // sp_size()


def data_rank() -> int:
    return grid_position(rank(), sp_size())[0]


def shards_rays(n_rays: int) -> bool:
    """Whether a render of ``n_rays`` rays per image splits them over the
    sp ranks: inside a training step (``global_draws``) on a grid with
    sp > 1, when sp divides ``n_rays`` (the JAX renderer's rule: otherwise
    every sp rank renders every ray, as without the axis)."""
    sp = sp_size()
    return _GLOBAL_DRAWS and sp > 1 and n_rays % sp == 0


def ray_slice(n_rays: int) -> slice:
    """This rank's rays [s·n/sp, (s+1)·n/sp) of ``n_rays``."""
    sp = sp_size()
    if n_rays % sp:
        raise ValueError(f"{n_rays} rays do not split over {sp} sp ranks")
    n = n_rays // sp
    s = sp_rank()
    return slice(s * n, (s + 1) * n)


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
         init_method: str = "env://", sp: int = 1) -> torch.device:
    """Join the default group as ``rank_`` of ``world`` on ``device`` (a
    CUDA device becomes the current one), in a grid of world/sp data
    ranks × ``sp`` ray ranks. Returns the device."""
    check_grid(world, sp)
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
    _make_grid(sp)
    return device


def init_from_env(device, sp: int = 1) -> torch.device:
    """Join the group torchrun describes (RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) in a grid with ``sp`` ray
    ranks. A CUDA rank runs on cuda:LOCAL_RANK.

    ``sp`` must also divide LOCAL_WORLD_SIZE, so that an sp group, which
    gathers every rendered image, stays on one node. This is the JAX
    Trainer's host-local rule in this package's form: there ``num_sp``
    must divide the local devices of each process, which has no meaning
    with one process per card; the ranks torchrun starts on one node play
    their part."""
    rank_, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if sp > 1 and local % sp:
        raise ValueError(f"num_sp={sp} must divide the {local} ranks per "
                         "node (LOCAL_WORLD_SIZE): sp groups must be "
                         "node-local; scale across nodes via the data axis")
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         rank_)))
    return init(rank_, world, device, sp=sp)


def shutdown():
    global _SP, _DATA_GROUP, _SP_GROUP
    if is_initialized():
        tdist.destroy_process_group()
    _SP, _DATA_GROUP, _SP_GROUP = 1, None, None


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank_: int, fn: Callable, args: tuple, devices: Sequence[str],
               backend: str | None, port: int, sp: int):
    """One spawned rank. After ``fn`` returns, a signal the launcher passes
    on late is ignored (the rank's work is done), and the process ends
    without the interpreter's finalization, which takes about a second
    with torch loaded and several under load (the rescue's SIGTERM-to-exit
    time)."""
    device = init(rank_, len(devices), devices[rank_], backend=backend,
                  init_method=f"tcp://127.0.0.1:{port}", sp=sp)
    try:
        rc = fn(device, *args)
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            signal.signal(sig, signal.SIG_IGN)
        barrier()
    finally:
        shutdown()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(int(rc or 0))


def launch(fn: Callable, args: tuple, devices: Sequence[str],
           backend: str | None = None, sp: int = 1):
    """``fn(device, *args)`` on ``len(devices)`` ranks of one group, rank r
    in a spawned process on ``devices[r]``, the ranks a grid of data ×
    ``sp``; a non-zero return ends that rank with that exit code. SIGTERM
    and SIGUSR1 sent to this process are passed on to every rank. Raises
    ValueError before any rank starts when ``sp`` does not divide the
    ranks, and torch.multiprocessing's ProcessExitedException or
    ProcessRaisedException when a rank fails, after the others have been
    terminated."""
    import torch.multiprocessing as mp
    check_grid(len(devices), sp)
    ctx = mp.start_processes(
        _rank_main, args=(fn, args, [str(d) for d in devices], backend,
                          free_port(), sp),
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
    """This rank's rows [d·b, (d+1)·b) of a global-batch tensor, d its data
    index and b = rows / data ranks."""
    w = data_size()
    if w == 1:
        return x
    if x.shape[0] % w:
        raise ValueError(f"a leading axis of {x.shape[0]} rows does not "
                         f"divide over {w} ranks")
    b = x.shape[0] // w
    r = data_rank()
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
    ``n`` rows. Inside ``global_draws`` on more than one data rank, the
    draw for the global batch, ``draw(n · data ranks)``, of which this
    rank keeps its rows: what the one-device run draws, and the stream
    left where it leaves it."""
    w = data_size()
    if not _GLOBAL_DRAWS or w == 1:
        return draw(n)
    return local_rows(draw(n * w))


# ---------------------------------------------------------- collectives
def _comm_device() -> torch.device:
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    """The sum over the data ranks, differentiable to any order: its
    backward is the sum over the data ranks of the incoming gradients,
    itself this function. This is torch.distributed.nn.functional.
    all_reduce's rule; that function warns at every call in recent torch,
    and the replacement it names has no double backward."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(x, group=_DATA_GROUP)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the data ranks (``x`` without a
    group or on one data rank)."""
    return _AllReduceSum.apply(x) if data_size() > 1 else x


#: set when a ray gather ran with autograd recording, read and cleared by
#: ``take_ray_partial``; process-wide, as ``_GLOBAL_DRAWS``
_RAY_PARTIAL = False


class _GatherRays(torch.autograd.Function):
    """Every sp rank's rays of a (B, N/sp, ...) tensor along ``dim``, in sp
    order: the whole (B, N, ...) image on every rank of the sp group. The
    list form of all_gather (see ``all_gather_flat``).

    Its backward is this rank's slice of the incoming gradient, with no
    communication: everything downstream of the gather (D and the losses)
    runs replicated on every rank of the sp group, so every rank holds the
    same whole gradient, and the one-device gradient of this rank's rays
    is its slice. The slice is a differentiable op, so a gradient of a
    gradient passes it too (the derivative of a replicated quantity).
    Upstream, what depends on the rays (G's parameters) gets on each rank
    its partial sum over the rank's rays, which the optimizer step sums
    over the sp group (``average_grads(ray_partial=True)``)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(sp_size())]
        tdist.all_gather(parts, x, group=_SP_GROUP)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, sp_rank() * ctx.n, ctx.n), None


def all_gather_rays(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The whole ray axis ``dim`` of ``x`` from every rank of this rank's
    sp group (``_GatherRays``); ``x`` itself at sp 1."""
    global _RAY_PARTIAL
    if sp_size() == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        _RAY_PARTIAL = True
    return _GatherRays.apply(x, dim)


def take_ray_partial() -> bool:
    """Whether a ray gather recorded for autograd since the last call: the
    gradients then about to be reduced are partial sums over each rank's
    rays. Clears the mark."""
    global _RAY_PARTIAL
    was, _RAY_PARTIAL = _RAY_PARTIAL, False
    return was


def average_grads(params: Iterable[torch.nn.Parameter],
                  ray_partial: bool = False) -> int:
    """Each gradient replaced by the one-device gradient of the global
    batch, in one flat tensor of every gradient there is (parameters left
    without one are the same on every rank): summed over the sp group,
    then over the data group, and divided by ``grad_divisor``.
    With ``ray_partial`` each sp rank holds the partial sum over its rays,
    and the sp sum is the gradient of the data group's rows; otherwise
    every sp rank holds that gradient whole and the sum is sp times it.
    The sp sum of a whole gradient keeps the sp ranks' copies of the net
    identical where a kernel does not sum in a fixed order (cuDNN's
    defaults), which the data-group mean alone would not; it costs one
    more all-reduce of that gradient over the sp group. Dividing the sum
    of sp equal copies by sp gives the copy back exactly at sp = 2; at
    sp ≥ 3 the running sum can round, and the last bit may differ from
    one device. Two group
    reductions rather than one over every rank: the sums are then the
    ones ``parallel/sharding.py``'s reduce-scatter makes under fsdp, so a
    sharded state stays bit-identical to plain data × sp. Returns the
    bytes of the flat gradient; 0 without another rank."""
    if world_size() == 1:
        return 0
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return 0
    flat = torch.cat([g.reshape(-1) for g in grads])
    sum_over_sp(flat)
    if data_size() > 1:
        tdist.all_reduce(flat, group=_DATA_GROUP)
    flat.div_(grad_divisor(ray_partial))
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))
    return flat.numel() * flat.element_size()


def grad_divisor(ray_partial: bool) -> int:
    """What a gradient summed over every rank is divided by: the data
    ranks for a ray-partial gradient, every rank for a whole one."""
    return data_size() * (1 if ray_partial else sp_size())


def sum_over_sp(flat: torch.Tensor) -> torch.Tensor:
    """``flat`` summed in place over this rank's sp group (itself at sp
    1)."""
    if sp_size() > 1:
        tdist.all_reduce(flat, group=_SP_GROUP)
    return flat


def all_gather_flat(flat: torch.Tensor) -> torch.Tensor:
    """Every data rank's 1-D ``flat`` (one length on every rank),
    concatenated in data order (``flat`` itself on one data rank). The
    list form of the call: torch 2.11 and later take it on NCCL and on
    gloo, CUDA tensors included, where ``all_gather_into_tensor`` warns in
    recent torch and its replacement is not in 2.11."""
    w = data_size()
    if w == 1:
        return flat
    out = torch.empty(w * flat.numel(), dtype=flat.dtype, device=flat.device)
    tdist.all_gather(list(out.chunk(w)), flat, group=_DATA_GROUP)
    return out


def reduce_scatter_flat(flat: torch.Tensor) -> torch.Tensor:
    """This rank's block of the sum over the data ranks of a 1-D ``flat``
    made of ``data ranks`` equal blocks (the list form, as in
    ``all_gather_flat``)."""
    w = data_size()
    if w == 1:
        return flat
    if flat.numel() % w:
        raise ValueError(f"{flat.numel()} elements do not split over {w} "
                         "ranks")
    out = torch.empty(flat.numel() // w, dtype=flat.dtype,
                      device=flat.device)
    tdist.reduce_scatter(out, list(flat.chunk(w)), group=_DATA_GROUP)
    return out


def average_metrics(metrics: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """0-d metric tensors averaged over the data ranks, in one all-reduce
    (every rank emits the same keys in the same order; the sp ranks of a
    data group hold the same values)."""
    if data_size() == 1 or not metrics:
        return metrics
    vals = torch.stack([v.float() for v in metrics.values()])
    tdist.all_reduce(vals, group=_DATA_GROUP)
    vals.div_(data_size())
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
