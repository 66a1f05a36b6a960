"""Multi-process runtime of the port: one rank per GPU over ``torch.distributed``.

Counterpart of the JAX package's ``parallel/distributed.py``. The JAX package
drives every local device from one process and lets XLA place a global batch;
the port runs one process per GPU, PyTorch's idiom (and the original CM3P's:
HF Trainer under ``torchrun``). Two ways in:

* ``torchrun --nproc-per-node N -m cm3p_torch.train ...``: ``env://``
  rendezvous, the r-th rank of a host on ``cuda:r``;
* :func:`initialize_distributed` with the JAX keys ``coordinator_address``
  (``host:port`` or a ``tcp://`` / ``file://`` URL), ``num_processes`` and
  ``process_id`` (``training.multihost``).

The backend is chosen by rule (:func:`choose_backend`): NCCL when every rank
of the host has a GPU of its own, gloo on the CPU and when ranks share a GPU
(NCCL refuses two ranks on one device). The ranks learn their hosts over a
gloo default group first (which also carries barriers and flags), so the rule
reads no launcher variable; the data group then runs on the chosen backend.
Nothing falls back on a failure: a group that cannot form raises.
``heartbeat_timeout_seconds`` becomes the groups' ``timeout``, so a rank
whose peer died raises within that bound instead of hanging in a collective.

There is no global array in PyTorch: the "global batch" is the rank-ordered
concatenation of the ranks' local batches. :func:`gather_rows` and
:func:`all_reduce_sum` let a loss see it. Both are differentiable, and their
backward is the adjoint of the forward (the gradients of every rank's output
summed), so rank r receives the gradient of the sum of every rank's loss with
respect to its own inputs. A loss that every rank computes identically over
the gathered batch thus yields world x its true gradient on each rank, which
:func:`all_reduce_gradients` (the mean over the data group) divides back.

A process with no process group hits only no-op paths.
"""
from __future__ import annotations

import datetime
import logging
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# the process groups are the process's own: what initialize_distributed formed, until shutdown
_state: dict = {"backend": None, "data_group": None, "local_rank": 0}


def active() -> bool:
    """True when a default process group exists."""
    return dist.is_available() and dist.is_initialized()


def launched_by_torchrun() -> bool:
    """True in a process that ``torchrun`` (torch's elastic launcher) started."""
    return dist.is_available() and dist.is_torchelastic_launched()


def rank_device(device: torch.device, rank_on_host: int) -> torch.device:
    """The device a rank computes on: ``cuda:{rank_on_host mod visible GPUs}`` for CUDA, else ``device``."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank_on_host % max(torch.cuda.device_count(), 1))


def choose_backend(device: torch.device, ranks_on_host: int) -> str:
    """NCCL when the ranks compute on CUDA and each rank of the host has a GPU of its own; else gloo
    (the CPU, or ranks that share a GPU, which NCCL refuses)."""
    if device.type == "cuda" and ranks_on_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _init_method(coordinator_address: Optional[str]) -> str:
    if not coordinator_address:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    heartbeat_timeout_seconds: Optional[float] = None,
    device: Optional[torch.device] = None,
) -> str:
    """Form the process groups (idempotent); returns the backend of the data group.

    ``coordinator_address`` None is ``env://`` (``torchrun``, whose variables
    ``init_process_group`` reads); a ``host:port`` becomes ``tcp://host:port``;
    ``tcp://`` and ``file://`` URLs are taken as they are, with
    ``num_processes`` and ``process_id``. The default group is gloo (barriers,
    flags, gathers of host objects). Every rank then tells the others its host,
    which gives its place among the ranks of its host (:func:`local_device`)
    and their count; with ``device`` (the device type the ranks compute on)
    :func:`choose_backend` picks the data group's backend, and under NCCL a
    group of the same ranks is formed on it. A failure to form a group raises.
    """
    if active():
        return _state["backend"]
    device = torch.device("cpu") if device is None else torch.device(device)
    kwargs = {}
    if heartbeat_timeout_seconds is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(heartbeat_timeout_seconds))
    init_method = _init_method(coordinator_address)
    if init_method == "env://":
        dist.init_process_group("gloo", init_method=init_method, **kwargs)
    else:
        if num_processes is None or process_id is None:
            raise ValueError(f"{init_method} needs num_processes and process_id")
        dist.init_process_group("gloo", init_method=init_method, world_size=int(num_processes),
                                rank=int(process_id), **kwargs)
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    on_host = [r for r, h in enumerate(hosts) if h == hosts[dist.get_rank()]]
    _state["local_rank"] = on_host.index(dist.get_rank())
    device = local_device(device)
    backend = choose_backend(device, len(on_host))
    if backend == "nccl":
        torch.cuda.set_device(device)
        _state["data_group"] = dist.new_group(backend="nccl", **kwargs)
    else:
        _state["data_group"] = dist.group.WORLD
    _state["backend"] = backend
    logger.info(
        "torch.distributed initialized: rank %d/%d, backend %s (%s), device %s%s",
        dist.get_rank(), dist.get_world_size(), backend,
        "one GPU per rank" if backend == "nccl" else ("ranks share a GPU" if device.type == "cuda" else "CPU"),
        device, "" if heartbeat_timeout_seconds is None else f", timeout {heartbeat_timeout_seconds} s",
    )
    return backend


def local_device(device: torch.device) -> torch.device:
    """This rank's device of ``device``'s type: for CUDA, its place among the ranks of its host, modulo the
    visible GPUs (rank r of a host on ``cuda:r``)."""
    return rank_device(torch.device(device), _state["local_rank"])


def data_group():
    """The group the data-parallel collectives run over (the NCCL group, or the default gloo group); None
    with no process group."""
    return _state["data_group"] if active() else None


def log_single_process(module: str) -> None:
    """With more than one visible GPU and no process group, say that one GPU is used and how to use them all."""
    if not active() and torch.cuda.is_available() and torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        logger.info("%d GPUs visible, no process group: this run uses one; for all of them run "
                    "torchrun --nproc-per-node %d -m %s ...", n, n, module)


def shutdown() -> None:
    if active():
        dist.destroy_process_group()
    _state.update(backend=None, data_group=None, local_rank=0)


def process_index() -> int:
    return dist.get_rank() if active() else 0


def process_count() -> int:
    return dist.get_world_size() if active() else 1


def is_primary() -> bool:
    """True on the rank that owns logs and result files (rank 0, or a process with no group)."""
    return process_index() == 0


def _collective_device(group=None) -> torch.device:
    """Where a small host-made tensor must lie for a collective of ``group``: the current GPU under NCCL."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if active():
        dist.barrier()


def all_processes_have(local_have: bool, group=None) -> bool:
    """True iff every rank reports ``local_have`` truthy: one all-reduce MIN of an int.

    Ranks with unequal shards call it before each collective step (evaluation)
    and stop together at the shortest. A no-op with no group or one rank."""
    if not active() or dist.get_world_size(group) == 1:
        return bool(local_have)
    flag = torch.tensor([int(bool(local_have))], dtype=torch.int32, device=_collective_device(group))
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return bool(flag.item())


def all_gather_ints(values: Sequence[int], group=None) -> list[list[int]]:
    """Every rank's ``values`` (as many on every rank), in rank order (no gradient)."""
    if not active() or dist.get_world_size(group) == 1:
        return [[int(v) for v in values]]
    mine = torch.tensor([int(v) for v in values], dtype=torch.int64, device=_collective_device(group))
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    return [p.tolist() for p in parts]


def data_shard_group(grid, process: Optional[int] = None) -> tuple[int, int]:
    """This process's (group_index, num_groups) along the data axis of a (data, model) grid.

    ``grid`` is a :class:`~cm3p_torch.parallel.mesh.Mesh` or a 2-D array of
    process indices, one per device, rows along ``data``. Processes that cover
    the same rows of the data axis form one data group and must feed identical
    batch rows; each group is numbered by its first appearance. A process that
    covers more than one block of data rows raises: the data pipeline must shard
    by group, not by raw process index (the JAX package's rule).
    """
    grid = np.asarray(getattr(grid, "grid", grid))
    if grid.ndim != 2:
        raise ValueError(f"grid must be 2-D (data, model), got shape {grid.shape}")
    owners = [frozenset(int(p) for p in row) for row in grid]
    groups: list = []
    for s in owners:
        if s not in groups:
            groups.append(s)
    pid = process_index() if process is None else int(process)
    mine = [i for i, s in enumerate(groups) if pid in s]
    if len(mine) != 1:
        raise ValueError(
            f"process {pid} covers {len(mine)} data-axis blocks of the {grid.shape} grid; the data axis must map "
            "each process's devices to exactly one contiguous block for per-process batch feeding"
        )
    return mine[0], len(groups)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        world = dist.get_world_size(group)
        ctx.group, ctx.rank, ctx.rows = group, dist.get_rank(group), x.shape[0]
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)  # every rank's gradient of the gathered rows, summed
        return grad[ctx.rank * ctx.rows: (ctx.rank + 1) * ctx.rows], None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order (the same shape on every rank), with a
    gradient: rank r receives the sum over ranks of their output gradients at its rows."""
    if not active() or dist.get_world_size(group) == 1:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)
    return _GatherRows.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x``, with a gradient: rank r receives the sum of every rank's output gradient."""
    if not active() or dist.get_world_size(group) == 1:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def broadcast_parameters(module: torch.nn.Module, src: int = 0, group=None) -> None:
    """Every parameter and buffer of ``module`` set to rank ``src``'s (over the data group unless ``group``):
    one flat broadcast per dtype and device."""
    if not active():
        return
    group = data_group() if group is None else group
    if dist.get_world_size(group) == 1:
        return
    buckets: dict = {}
    for t in module.state_dict().values():
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for tensors in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.broadcast(flat, src=src, group=group)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_gradients(grads: Sequence[Optional[torch.Tensor]], group=None) -> list:
    """The mean over the data group of each gradient (None stays None): one flat all-reduce per dtype and
    device. Every rank must pass the same list of shapes with None in the same places. With one rank the
    gradients come back as they are; under a group of one the collective still runs (it changes no value)."""
    grads = list(grads)
    if not active():
        return grads
    world = dist.get_world_size(group)
    buckets: dict = {}
    for i, g in enumerate(grads):
        if g is not None:
            buckets.setdefault((g.dtype, g.device), []).append(i)
    for idx in buckets.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        if world > 1:
            flat.div_(world)
        offset = 0
        for i in idx:
            n = grads[i].numel()
            grads[i] = flat[offset: offset + n].view_as(grads[i])
            offset += n
    return grads
