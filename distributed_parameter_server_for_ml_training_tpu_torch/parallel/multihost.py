"""Multi-process sync data parallelism: one process per card, joined by
``torch.distributed`` (counterpart of the JAX package's
``parallel/multihost.py``).

In the reference every process joins one multi-controller JAX job and the
same compiled sync step runs on a mesh over every process's devices. The
port runs one process ("rank") per card. Each holds ``S`` worker slots of
its own card (``parallel/mesh.py``), and the global mesh has ``R*S``
slots, rank-major: global slot ``g = rank*S + s``. The step's operations
across slots become collectives between ranks, over a :class:`RankGroup`:

- BatchNorm's ``pmean`` of its batch statistics: the card's slots are
  averaged, then :func:`rank_mean` (all-reduce SUM / R, differentiable)
  averages the ranks (``models/resnet.py``);
- the int8 ring's ``ppermute``: the rows roll on the card, and the last
  row's payload hops to rank + 1 (:func:`ring_hop`);
- the gradient mean of bf16/fp16/none and the metrics:
  :func:`rank_reduce`;
- sequence parallelism's ring (``parallel/ring_attention.py``): the K/V
  blocks and their gradient accumulators roll over the card's slots, and
  the block leaving the last slot hops to rank + 1 (:func:`ring_roll`);
  the ViT's pooled mean over the ranks' tokens (:func:`shared_rank_mean`)
  and the sum of the per-token parameters' gradients
  (``rank_reduce(..., "sum")``);
- expert parallelism's two ``lax.all_to_all`` hops (``parallel/moe.py``):
  :func:`all_to_all_grad` moves each rank's token buffers to the ranks
  of their experts and back, and the routing statistics' ``pmean`` is
  :func:`rank_sum` of each rank's shard sums;
- a pipeline's hand-over from a rank's last stage to the next rank's
  first (``parallel/pipeline.py``): :func:`stage_hop`, forward to rank +
  1 and the gradients back to rank - 1, at the ticks the schedule names;
  the last stage's output reaches every rank by
  :func:`shared_broadcast`, and a checkpoint gathers the ranks' rows of
  the stacked leaves with :func:`rank_gather`.

Every collective adds the bytes it moves to the recorders of
``utils/collective_bytes.py`` that are open, from its tensors' shapes.

Env contract (as the JAX package's, ``server.py``/``worker.py`` env-first
config):

    DPS_COORDINATOR   host:port of process 0's rendezvous
    DPS_NUM_PROCESSES total process count
    DPS_PROCESS_ID    this process's rank

Nothing on a card's host tells a program of a cluster, so either all
three are given (arguments or env), or the process was started by
``torchrun``: with none of the three and no ``DPS_*`` variable,
``WORLD_SIZE`` and ``RANK`` (and ``LOCAL_RANK`` for the card) join with
``init_method="env://"``, which reads ``MASTER_ADDR`` and
``MASTER_PORT``. That is the port's form of the reference's
``jax.distributed.initialize()`` auto-detection. The collectives run on
NCCL when the device is a card and on gloo on the CPU. gloo on a card
runs only where the caller asks for it (``backend="gloo"``, for two ranks
on one card, which NCCL refuses); its collectives then copy each tensor to
the host and back explicitly (:meth:`RankGroup.staged`).
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils import collective_bytes
from ..utils.device import resolve_device
from .mesh import (AXES_OVER_RANKS, DATA_AXIS, Mesh, make_mesh,
                   worker_axis_size)


@dataclass(frozen=True, eq=False)
class RankGroup:
    """The ranks of a multi-process mesh and the process group that joins
    them: ``pg`` is a ``torch.distributed`` ``ProcessGroup`` (the world
    group), or a backend such as a ``ProcessGroupGloo`` built on a store;
    ``backend`` is ``"nccl"`` or ``"gloo"``."""
    pg: Any
    rank: int
    size: int
    backend: str

    def staged(self, device: torch.device) -> bool:
        """Whether collectives on ``device`` copy through the host: gloo
        on a card."""
        return self.backend == "gloo" and torch.device(device).type == "cuda"


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None,
               device: str | torch.device = "cuda") -> torch.device:
    """Join the multi-process job; returns this process's device
    (:func:`process_device`), made current when it is a card. Arguments
    default from env (DPS_COORDINATOR / DPS_NUM_PROCESSES /
    DPS_PROCESS_ID); with none of them, a process started by ``torchrun``
    (``WORLD_SIZE`` and ``RANK`` set) joins with ``env://`` at rank
    ``RANK`` on the card of ``LOCAL_RANK`` where it is set. ``backend``
    defaults to NCCL on a card and gloo on the CPU."""
    coordinator = coordinator or os.environ.get("DPS_COORDINATOR")
    if num_processes is None and "DPS_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["DPS_NUM_PROCESSES"])
    if process_id is None and "DPS_PROCESS_ID" in os.environ:
        process_id = int(os.environ["DPS_PROCESS_ID"])
    init_method, card_index = f"tcp://{coordinator}", process_id
    if coordinator is None and num_processes is None and process_id is None \
            and "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
        card_index = int(os.environ.get("LOCAL_RANK", process_id))
    elif coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process job needs the coordinator's host:port, the "
            "process count and this process's id (--coordinator, "
            "--num-processes, --process-id or DPS_COORDINATOR, "
            "DPS_NUM_PROCESSES, DPS_PROCESS_ID), or torchrun's WORLD_SIZE "
            "and RANK")
    dev = process_device(device, card_index)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a card; the CPU runs gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return dev


def process_device(device: str | torch.device = "cuda",
                   process_id: int | None = None) -> torch.device:
    """This process's device: ``cuda:{process_id % device_count}`` for a
    card named without an index, else ``device`` as given. Asking for a
    card on a host without one raises ``RuntimeError``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        pid = process_index() if process_id is None else process_id
        dev = torch.device("cuda", pid % torch.cuda.device_count())
    return dev


def world_group() -> RankGroup:
    """The joined job's world group (:func:`initialize` first)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call initialize() first")
    return RankGroup(dist.group.WORLD, dist.get_rank(),
                     dist.get_world_size(), dist.get_backend())


def process_index() -> int:
    return dist.get_rank() if dist.is_available() \
        and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


def make_global_mesh(num_workers: int,
                     device: str | torch.device | None = None,
                     axis_names: Sequence[str] = (DATA_AXIS,),
                     group: RankGroup | None = None) -> Mesh:
    """The mesh over every rank's slots: ``num_workers`` global slots,
    ``num_workers / R`` of them on this rank's card (``device``, by
    default :func:`process_device` of the rank). ``num_workers`` must
    divide evenly over the ranks. One axis only: the reference builds
    ``('data', 'model')`` over processes, which comes with
    :data:`~.mesh.AXES_OVER_RANKS`."""
    if len(axis_names) != 1:
        raise NotImplementedError(
            f"a mesh of axes {tuple(axis_names)} over ranks comes with "
            f"{AXES_OVER_RANKS}")
    group = group or world_group()
    if num_workers % group.size:
        raise ValueError(f"{num_workers} worker slots do not divide evenly "
                         f"over {group.size} processes")
    dev = process_device("cuda", group.rank) if device is None \
        else process_device(device, group.rank)
    local = make_mesh(num_workers // group.size, dev, axis_names)
    return Mesh(num_workers, local.device, local.axis_name, group)


def host_local_slice(x, group: RankGroup | None = None):
    """This rank's contiguous slice of a globally agreed batch (the
    reference's contiguous shard-by-worker-id, worker.py:166-179, at rank
    granularity); the whole batch outside a multi-process job."""
    if group is None:
        if not (dist.is_available() and dist.is_initialized()):
            return x
        group = world_group()
    per = x.shape[0] // group.size
    return x[group.rank * per:(group.rank + 1) * per]


def shard_batch_global(mesh: Mesh, batch: Sequence, axis: str = DATA_AXIS
                       ) -> tuple[torch.Tensor, ...]:
    """Multi-process ``shard_batch``: every rank passes the FULL global
    batch (the same on every rank, from the same seeded shuffle) and
    gets its own ``S`` slots ``[S, B, ...]``."""
    from .sync_dp import shard_batch
    n = worker_axis_size(mesh, axis)
    for x in batch:
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not split "
                             f"evenly over {n} worker slots")
    if mesh.group is not None:
        batch = [host_local_slice(x, mesh.group) for x in batch]
    return shard_batch(mesh, batch, axis)


def replicate_to_mesh(mesh: Mesh, state):
    """Make every rank hold rank 0's train state: its params and batch
    statistics are broadcast from rank 0 in place. Returns ``state``."""
    if mesh.group is not None:
        for t in [*state.params.values(), *state.batch_stats.values()]:
            _broadcast_(t, 0, mesh.group)
    return state


def fetch_replicated(tree):
    """Host-local NumPy copy of a replicated tree of tensors (every rank
    holds a whole copy, so this is local)."""
    if isinstance(tree, Mapping):
        return {k: fetch_replicated(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)


# -- the collectives -----------------------------------------------------

def _nbytes(tensors: Sequence[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _reduce(t: torch.Tensor, op, group: RankGroup) -> torch.Tensor:
    """All-reduce of a copy of ``t`` over the group's ranks."""
    collective_bytes.note("all-reduce", _nbytes([t]), group.size)
    opts = dist.AllreduceOptions()
    opts.reduceOp = op
    if group.staged(t.device):
        host = t.detach().to("cpu", copy=True).contiguous()
        group.pg.allreduce([host], opts).wait()
        return host.to(t.device)
    out = t.detach().clone(memory_format=torch.contiguous_format)
    group.pg.allreduce([out], opts).wait()
    return out


def _broadcast_(t: torch.Tensor, root: int, group: RankGroup) -> None:
    collective_bytes.note("broadcast", _nbytes([t]), group.size)
    opts = dist.BroadcastOptions()
    opts.rootRank = root
    if group.staged(t.device):
        host = t.detach().to("cpu", copy=True).contiguous()
        group.pg.broadcast([host], opts).wait()
        t.copy_(host)
    elif t.is_contiguous():
        group.pg.broadcast([t], opts).wait()
    else:
        buf = t.contiguous()
        group.pg.broadcast([buf], opts).wait()
        t.copy_(buf)


class _RankSum(torch.autograd.Function):
    """Sum (or mean) over ranks: forward all-reduce SUM of the value,
    backward all-reduce SUM of the incoming gradient (each rank's loss
    takes its part of the shared sum), both divided by R for a mean."""

    @staticmethod
    def forward(ctx, x, group, mean):
        ctx.group, ctx.mean = group, mean
        ctx.recorders = collective_bytes.open_recorders()
        out = _reduce(x, dist.ReduceOp.SUM, group)
        return out / group.size if mean else out

    @staticmethod
    def backward(ctx, grad):
        with collective_bytes.recording(ctx.recorders):
            out = _reduce(grad, dist.ReduceOp.SUM, ctx.group)
        return (out / ctx.group.size if ctx.mean else out), None, None


def rank_mean(x: torch.Tensor, group: RankGroup | None = None
              ) -> torch.Tensor:
    """``x`` averaged over the ranks, differentiably (:class:`_RankSum`).
    Every rank must call it, in the same order."""
    return _RankSum.apply(x, group or world_group(), True)


def rank_sum(x: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably: JAX's ``psum`` inside
    a differentiated ``shard_map`` (:class:`_RankSum`)."""
    return _RankSum.apply(x, group, False)


class _SharedRankMean(torch.autograd.Function):
    """Mean over ranks of each rank's part, where every rank then computes
    the same loss from the mean: forward all-reduce SUM / R; backward
    ``g / R`` with no collective, since every rank holds the same ``g``
    and ``d mean / d part = 1 / R`` (:func:`rank_mean` would hand each
    rank ``g``, right only where each rank's loss takes its own share)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.size = group.size
        return _reduce(x, dist.ReduceOp.SUM, group) / group.size

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.size, None


def shared_rank_mean(x: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """The mean over ranks of ``x``, each rank's part of a value that every
    rank's loss then uses alike (:class:`_SharedRankMean`)."""
    return _SharedRankMean.apply(x, group)


def rank_reduce(x: torch.Tensor, op: str = "mean",
                group: RankGroup | None = None) -> torch.Tensor:
    """``x`` reduced over the ranks, in ``x``'s dtype (not
    differentiable): ``sum``, ``mean`` (SUM / R) or ``min``."""
    group = group or world_group()
    if op == "mean":
        return _reduce(x, dist.ReduceOp.SUM, group) / group.size
    if op == "sum":
        return _reduce(x, dist.ReduceOp.SUM, group)
    if op == "min":
        return _reduce(x, dist.ReduceOp.MIN, group)
    raise ValueError(f"op must be sum, mean or min, got {op!r}")


def ring_hop(tensors: Sequence[torch.Tensor],
             group: RankGroup | None = None,
             shift: int = 1) -> list[torch.Tensor]:
    """One hop of a ring over the ranks: each tensor goes to rank +
    ``shift`` (1 or -1), and the tensors rank - ``shift`` sent come back
    (same shapes and dtypes). One rank hands its tensors to itself. NCCL
    sends and receives in one ``batch_isend_irecv``; gloo on a card
    copies through the host."""
    group = group or world_group()
    collective_bytes.note("collective-permute", _nbytes(tensors),
                          group.size)
    if group.size == 1:
        return list(tensors)
    dst, src = (group.rank + shift) % group.size, \
        (group.rank - shift) % group.size
    dev = tensors[0].device
    if group.backend == "nccl":
        send = [t.contiguous() for t in tensors]
        recv = [torch.empty_like(t) for t in send]
        ops = [dist.P2POp(dist.isend, t, dst, group.pg) for t in send] \
            + [dist.P2POp(dist.irecv, t, src, group.pg) for t in recv]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recv
    staged = group.staged(dev)
    send = [t.detach().to("cpu", copy=True).contiguous() if staged
            else t.contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    works = [group.pg.send([t], dst, tag) for tag, t in enumerate(send)] \
        + [group.pg.recv([t], src, tag) for tag, t in enumerate(recv)]
    for work in works:
        work.wait()
    return [t.to(dev) for t in recv] if staged else recv


def ring_roll(tensors: Sequence[torch.Tensor], rows: int = 1,
              group: RankGroup | None = None,
              reverse: bool = False) -> list[torch.Tensor]:
    """One step of a ring over global slots, each slot a block of ``rows``
    leading rows of every tensor: ``torch.roll(t, rows, dims=0)`` on the
    card, and the block that leaves the last slot hops to rank + 1
    (:func:`ring_hop`) and lands in slot 0 of the next rank. ``reverse``
    steps the other way (the block of slot 0 goes to rank - 1). Without a
    group, or over one rank, it is ``torch.roll``. Not differentiable
    (:func:`ring_roll_grad` is)."""
    step = -rows if reverse else rows
    rolled = [torch.roll(t, step, dims=0) for t in tensors]
    if group is not None and group.size > 1:
        leaving = [t[:rows] if reverse else t[-rows:] for t in tensors]
        for out, got in zip(rolled, ring_hop(leaving, group,
                                             -1 if reverse else 1)):
            if reverse:
                out[-rows:] = got
            else:
                out[:rows] = got
    return rolled


class _RingRoll(torch.autograd.Function):
    """:func:`ring_roll` whose backward rolls the gradients back."""

    @staticmethod
    def forward(ctx, rows, group, *tensors):
        ctx.rows, ctx.group = rows, group
        ctx.recorders = collective_bytes.open_recorders()
        return tuple(ring_roll(tensors, rows, group))

    @staticmethod
    def backward(ctx, *grads):
        with collective_bytes.recording(ctx.recorders):
            back = ring_roll(grads, ctx.rows, ctx.group, reverse=True)
        return (None, None, *back)


def ring_roll_grad(tensors: Sequence[torch.Tensor], rows: int,
                   group: RankGroup | None) -> list[torch.Tensor]:
    """Differentiable :func:`ring_roll` over ``group``'s ranks (or the
    card's slots alone): every rank must call it, and run its backward,
    in the same order."""
    return list(_RingRoll.apply(rows, group, *tensors))


def all_to_all(t: torch.Tensor, group: RankGroup | None = None
               ) -> torch.Tensor:
    """JAX's ``lax.all_to_all(split_axis=0, concat_axis=0)`` over the
    ranks: ``t``'s leading axis is R equal blocks, block j goes to rank j,
    and block i of the result is the one rank i sent here (same shape and
    dtype). Over one rank the identity. NCCL runs
    ``all_to_all_single``; gloo ``alltoall_base``, through the host on a
    card. Not differentiable (:func:`all_to_all_grad` is)."""
    group = group or world_group()
    if t.shape[0] % group.size:
        raise ValueError(f"a leading axis of {t.shape[0]} does not split "
                         f"into {group.size} blocks")
    collective_bytes.note("all-to-all", _nbytes([t]), group.size)
    if group.size == 1:
        return t
    if group.backend == "nccl":
        src = t.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group.pg)
        return out
    staged = group.staged(t.device)
    src = t.detach().to("cpu", copy=True).contiguous() if staged \
        else t.contiguous()
    out = torch.empty_like(src)
    group.pg.alltoall_base(out, src, [], [],
                           dist.AllToAllOptions()).wait()
    return out.to(t.device) if staged else out


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all` whose backward sends each block's gradient back
    to the rank it came from: the same exchange again."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        ctx.recorders = collective_bytes.open_recorders()
        return all_to_all(t, group)

    @staticmethod
    def backward(ctx, grad):
        with collective_bytes.recording(ctx.recorders):
            return all_to_all(grad, ctx.group), None


def all_to_all_grad(t: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """Differentiable :func:`all_to_all`: every rank must call it, and run
    its backward, in the same order."""
    return _AllToAll.apply(t, group)


def stage_hop(tensors: Sequence[torch.Tensor],
              group: RankGroup | None = None, to: int = 1, *,
              send: bool = True, recv: bool = True,
              tag: int = 0) -> list[torch.Tensor] | None:
    """The hand-over between neighbouring ranks of a pipeline: ``tensors``
    go to rank + ``to`` (1 or -1), and what rank - ``to`` sent comes back,
    shaped like ``tensors``. Not a ring: the rank at the far end (the last
    one for ``to=1``) sends nothing, the one at the near end receives
    nothing. ``send`` and ``recv`` say whether this rank sends and
    receives at this call (a bubble tick does neither), as the schedule
    that every rank knows says; ``tensors`` then only give the received
    ones' shapes and dtypes. Returns the received tensors, or None where
    nothing came. Over one rank the identity.

    NCCL pairs the sends and receives of a call in one
    ``batch_isend_irecv``, so both ends must make their calls in the
    same order; gloo tags each tensor with ``tag`` (unique per tick and
    direction) and its index, and copies through the host on a card."""
    group = group or world_group()
    if group.size == 1:
        return list(tensors)
    if to not in (1, -1):
        raise ValueError(f"a stage hop goes to rank + 1 or - 1, not {to}")
    dst, src = group.rank + to, group.rank - to
    send = send and 0 <= dst < group.size
    recv = recv and 0 <= src < group.size
    if send:
        collective_bytes.note("collective-permute", _nbytes(tensors),
                              group.size)
    if not (send or recv):
        return None
    dev = tensors[0].device
    staged = group.staged(dev)
    out = [torch.empty(t.shape, dtype=t.dtype,
                       device="cpu" if staged else dev)
           for t in tensors] if recv else []
    outgoing = [t.detach().to("cpu", copy=True).contiguous() if staged
                else t.contiguous() for t in tensors] if send else []
    if group.backend == "nccl":
        ops = [dist.P2POp(dist.isend, t, dst, group.pg) for t in outgoing] \
            + [dist.P2POp(dist.irecv, t, src, group.pg) for t in out]
        works = dist.batch_isend_irecv(ops)
    else:
        works = [group.pg.send([t], dst, (tag << 8) + i)
                 for i, t in enumerate(outgoing)] \
            + [group.pg.recv([t], src, (tag << 8) + i)
               for i, t in enumerate(out)]
    for work in works:
        work.wait()
    if not recv:
        return None
    return [t.to(dev) for t in out] if staged else out


class _StageHop(torch.autograd.Function):
    """:func:`stage_hop` whose backward sends the received tensors'
    gradients back to the rank that sent them."""

    @staticmethod
    def forward(ctx, group, to, send, recv, tag, *tensors):
        ctx.args = group, to, send, recv, tag
        ctx.recorders = collective_bytes.open_recorders()
        got = stage_hop(tensors, group, to, send=send, recv=recv, tag=tag)
        if got is None:         # a placeholder, so the backward runs here
            return tuple(torch.zeros_like(t) for t in tensors)
        return tuple(got)

    @staticmethod
    def backward(ctx, *grads):
        group, to, send, recv, tag = ctx.args
        with collective_bytes.recording(ctx.recorders):
            back = stage_hop(grads, group, -to, send=recv, recv=send,
                             tag=tag)
        if back is None:
            back = [torch.zeros_like(g) for g in grads]
        return (None,) * 5 + tuple(back)


def stage_hop_grad(tensors: Sequence[torch.Tensor], group: RankGroup,
                   to: int = 1, *, send: bool = True, recv: bool = True,
                   tag: int = 0) -> list[torch.Tensor]:
    """Differentiable :func:`stage_hop`, for a model cut at one point
    between ranks: a rank that receives nothing gets zeros in its place.
    Both ends run the backward of what the hop returned (the sender with
    zero gradients), so the receiver's gradients travel back; the
    pipelines of ``parallel/pipeline.py`` hop inside a schedule of their
    own instead, which orders every tick's hops explicitly."""
    return list(_StageHop.apply(group, to, send, recv, tag, *tensors))


class _SharedBroadcast(torch.autograd.Function):
    """Rank ``root``'s value on every rank, where every rank then computes
    the same loss from it: forward broadcast; backward the root keeps its
    gradient (every rank's, as the losses are the same) and the other
    ranks' inputs get zeros, with no collective."""

    @staticmethod
    def forward(ctx, x, root, group):
        ctx.own = group.rank == root
        out = x.detach().clone(memory_format=torch.contiguous_format)
        _broadcast_(out, root, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.own else torch.zeros_like(grad)), None, None


def shared_broadcast(x: torch.Tensor, root: int, group: RankGroup
                     ) -> torch.Tensor:
    """Rank ``root``'s ``x`` on every rank, differentiably for a loss that
    every rank computes alike (:class:`_SharedBroadcast`)."""
    return _SharedBroadcast.apply(x, root, group)


def rank_gather(t: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the leading axis in rank
    order, on every rank (an all-gather; not differentiable)."""
    collective_bytes.note("all-gather", _nbytes([t]) * group.size,
                          group.size)
    if group.size == 1:
        return t
    staged = group.staged(t.device)
    src = t.detach().to("cpu", copy=True).contiguous() if staged \
        else t.detach().contiguous()
    outs = [torch.empty_like(src) for _ in range(group.size)]
    group.pg.allgather([outs], [src]).wait()
    out = torch.cat(outs)
    return out.to(t.device) if staged else out


def ranks_identical(tensors: Sequence[torch.Tensor],
                    group: RankGroup | None = None) -> bool:
    """Whether every rank holds the same bits in ``tensors`` as rank 0:
    rank 0's are broadcast and compared bit for bit on every rank, and
    the verdicts reduced by min."""
    group = group or world_group()
    mine = torch.cat([t.detach().reshape(-1).view(torch.uint8)
                      for t in tensors])
    ref = mine.clone()
    _broadcast_(ref, 0, group)
    same = torch.tensor([int(torch.equal(mine, ref))], dtype=torch.int32,
                        device=mine.device)
    return bool(rank_reduce(same, "min", group).item())


def thread_ranks(size: int, fn: Callable, timeout: float = 120.0) -> list:
    """``fn(group)`` on ``size`` ranks that are threads of this process,
    each over its own ``ProcessGroupGloo`` on one ``HashStore`` (the CPU
    tests' and ``utils/collective_bytes.py``'s ranks); returns the
    results by rank. A rank's exception is raised here; a rank still
    running after ``timeout`` raises ``TimeoutError``."""
    store = dist.HashStore()
    results, errors = [None] * size, []

    def body(rank):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore("ranks", store),
                                       rank, size,
                                       datetime.timedelta(seconds=60))
            results[rank] = fn(RankGroup(pg, rank, size, "gloo"))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in range(size)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"a rank is still running after {timeout} s")
    if errors:
        raise errors[0]
    return results


# -- the rank group of the step being traced -----------------------------

_ACTIVE: contextvars.ContextVar[RankGroup | None] = contextvars.ContextVar(
    "dps_rank_group", default=None)


@contextlib.contextmanager
def rank_scope(group: RankGroup | None):
    """Within the block, cross-replica BatchNorm averages its statistics
    over ``group``'s ranks too (``None``: the card's slots only)."""
    token = _ACTIVE.set(group)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_rank_group() -> RankGroup | None:
    """The group of the enclosing :func:`rank_scope`, if any."""
    return _ACTIVE.get()
