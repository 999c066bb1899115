"""The bytes a rank's collectives move (counterpart of the JAX package's
``utils/hlo_bytes.py``).

The JAX package reads the collectives XLA emitted from a compiled
program's HLO and applies each one's per-device ring traffic model. The
port issues its collectives itself (``parallel/multihost.py``), so each
one adds the bytes it moves to the recorders that are open
(:func:`record_collectives`), from the shapes of its tensors: nothing is
read back from the device. The schema is JAX's, ``{"total", "by_op",
"count"}``, keyed by the HLO op names.

Traffic model (ring algorithms, the JAX module's):

- collective-permute: the bytes it sends (one neighbour send a rank);
- all-reduce:         2 x (R-1)/R x its bytes (reduce-scatter + all-gather);
- broadcast:          (R-1)/R x its bytes (R-1 ranks each receive it once;
                      XLA has no such op, the port's own key);
- all-gather:         (R-1)/R x result bytes (each rank receives the
                      others' blocks);
- all-to-all:         (R-1)/R x its bytes (each rank keeps its own block
                      and sends the other R-1).

Over one rank every collective counts 0 bytes. A recorder counts the
collectives its own thread issues, and the backward passes of the port's
autograd functions re-enter the recorders that were open in their forward
(:func:`open_recorders`, :func:`recording`), since autograd may run them
on a thread of its own.
"""

from __future__ import annotations

import contextlib
import contextvars
from collections import defaultdict
from typing import Iterator

_RECORDERS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "dps_collective_recorders", default=())


class CollectiveBytes:
    """Bytes moved by one rank, by op, and the number of each op."""

    def __init__(self):
        self.by_op: dict[str, int] = defaultdict(int)
        self.count: dict[str, int] = defaultdict(int)

    def add(self, op: str, nbytes: int) -> None:
        self.by_op[op] += int(nbytes)
        self.count[op] += 1

    def summary(self) -> dict:
        """``{"total": int, "by_op": {op: bytes}, "count": {op: int}}``."""
        return {"total": sum(self.by_op.values()), "by_op": dict(self.by_op),
                "count": dict(self.count)}


@contextlib.contextmanager
def record_collectives() -> Iterator[CollectiveBytes]:
    """Count the collectives issued within the block (recorders nest:
    every open one counts)."""
    rec = CollectiveBytes()
    token = _RECORDERS.set(_RECORDERS.get() + (rec,))
    try:
        yield rec
    finally:
        _RECORDERS.reset(token)


def open_recorders() -> tuple:
    """The recorders open here, for :func:`recording` elsewhere."""
    return _RECORDERS.get()


@contextlib.contextmanager
def recording(recorders: tuple) -> Iterator[None]:
    """Within the block, count into ``recorders`` (from
    :func:`open_recorders`) instead of the ones open here."""
    token = _RECORDERS.set(recorders)
    try:
        yield
    finally:
        _RECORDERS.reset(token)


def _frac(n_ranks: int) -> float:
    return (n_ranks - 1) / n_ranks


def note(op: str, nbytes: int, n_ranks: int) -> None:
    """One collective over ``n_ranks`` ranks on tensors of ``nbytes``:
    add the bytes it moves (the module's traffic model) to every open
    recorder."""
    recorders = _RECORDERS.get()
    if not recorders:
        return
    frac = _frac(n_ranks)
    if op == "all-reduce":
        moved = 2 * frac * nbytes
    elif op in ("broadcast", "all-gather", "all-to-all"):
        moved = frac * nbytes
    elif op == "collective-permute":
        moved = nbytes if n_ranks > 1 else 0
    else:
        raise ValueError(f"no traffic model for {op!r}")
    for rec in recorders:
        rec.add(op, int(moved))


def moe_step_bytes(n_ranks: int, n_experts: int, capacity: int,
                   width: int, layers: int, replicated_values: int,
                   value_bytes: int = 4) -> dict:
    """Bytes a rank moves in one ``MoETrainer(group=)`` step, from the
    shapes (the schema of :meth:`CollectiveBytes.summary`): per MoE layer
    the two all_to_alls of the dispatch buffer ``[E/R, E, C, D]`` forward
    and their two backward, the statistics' all-reduce of ``2E + 1``
    values forward and backward; then one all-reduce of the
    ``replicated_values`` gradients (fp32) and one of the step's loss and
    accuracy. ``value_bytes`` is the MoE's compute width (fp32 but for a
    float64 model)."""
    frac = _frac(n_ranks)
    buf = n_experts // n_ranks * n_experts * capacity * width * value_bytes
    a2a = 4 * layers * int(frac * buf)
    reduce = 2 * layers * int(2 * frac * (2 * n_experts + 1) * value_bytes) \
        + int(2 * frac * 4 * replicated_values) + int(2 * frac * 2 * 4)
    return {"total": a2a + reduce,
            "by_op": {"all-to-all": a2a, "all-reduce": reduce},
            "count": {"all-to-all": 4 * layers, "all-reduce": 2 * layers + 2}}


def pipeline_step_bytes(n_ranks: int, rank: int, microbatches: int,
                        activation_bytes: int, shared_bytes: int,
                        prologue_values: int) -> dict:
    """Bytes rank ``rank`` moves in one ``PipelineTrainer(group=)`` step,
    from the shapes: a microbatch's activation (``activation_bytes``) to
    the next rank for each microbatch but on the last rank, and its
    gradient back to the previous one but on rank 0; the broadcasts of
    the last rank's CLS tokens (``shared_bytes``) and of rank 0's
    prologue gradients (``prologue_values``, fp32)."""
    frac = _frac(n_ranks)
    hops = microbatches * ((rank < n_ranks - 1) + (rank > 0)) \
        if n_ranks > 1 else 0
    bcast = int(frac * shared_bytes) + int(frac * 4 * prologue_values)
    out = {"total": hops * activation_bytes + bcast,
           "by_op": {"broadcast": bcast}, "count": {"broadcast": 2}}
    if hops:
        out["by_op"]["collective-permute"] = hops * activation_bytes
        out["count"]["collective-permute"] = hops
    return out


def sync_grad_mean_bytes(n_ranks: int, size: int,
                         modes=("none", "bf16", "int8")) -> dict:
    """Bytes a rank moves for the sync data-parallel gradient mean of a
    ``size``-value fp32 gradient, per compression mode: each mode's mean
    runs over ``n_ranks`` thread-ranks on gloo on the CPU, one slot a
    rank, and the rank's recorder is read. The JAX module compiles the
    same three means on ``n_ranks`` devices and reads the HLO.

    Unlike XLA's CPU backend, which widens a bf16 all-reduce to f32 (the
    JAX module's ``bf16_widened_on_cpu`` branch), gloo all-reduces the
    bf16 tensor as it is, 2 bytes a value, so the bf16 number here is
    measured and has no such branch."""
    import torch

    from ..ops.compression import (compress_for_allreduce,
                                   decompress_from_allreduce)
    from ..parallel.multihost import rank_reduce, thread_ranks
    from ..parallel.sync_dp import _int8_ring_allreduce_mean

    def mean_none(g, group):
        return rank_reduce(g, "mean", group)

    def mean_bf16(g, group):
        c = compress_for_allreduce({"g": g}, "bf16")["g"]
        return decompress_from_allreduce(
            {"g": rank_reduce(c, "mean", group)}, "bf16")["g"]

    def mean_int8(g, group):
        return _int8_ring_allreduce_mean(g[None], 0, group=group)[0]

    fns = {"none": mean_none, "bf16": mean_bf16, "int8": mean_int8}

    def rank(group):
        out = {}
        for name in modes:
            with record_collectives() as rec:
                fns[name](torch.ones(size), group)
            out[name] = rec.summary()
        return out

    per_rank = thread_ranks(n_ranks, rank)
    if any(r != per_rank[0] for r in per_rank):
        raise RuntimeError(f"ranks counted different bytes: {per_rank}")
    return per_rank[0]
