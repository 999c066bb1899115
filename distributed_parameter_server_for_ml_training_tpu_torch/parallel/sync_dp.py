"""Synchronous data parallelism over the worker slots of one card
(counterpart of the JAX package's ``parallel/sync_dp.py``).

The reference runs one SPMD program per step under ``shard_map``: each
mesh slot ("worker") takes its contiguous shard of the global batch,
augments it with its own draws, computes the gradient of its own mean
loss through cross-replica BatchNorm, all-reduces the gradients (a cast
``pmean``, or the int8 reduce-scatter + all-gather ring) and applies the
same SGD update everywhere. The port runs the same step for all N slots
of a :class:`~.mesh.Mesh` in one program on one card:

- one forward and backward over the N slots (the model's
  ``forward_slots``: ``ResNet``'s or ``ViT``'s, so every registry model):
  each parameter enters as an ``[N, ...]`` leaf made from the replicated
  value, so autograd returns slot w's gradient ``g_w``, the part from
  slot w's samples of the backward of ``sum_v L_v`` — the gradient each
  JAX device computes (through the BatchNorm ``pmean`` for a ResNet; a
  ViT's slots share no statistic);
- the per-slot gradients are flattened as ``ravel_pytree`` flattens the
  flax tree (sorted path order, flax layouts) into ``[N, S]``, one row
  per slot;
- ``compression`` none/fp32/bf16/fp16 casts the rows for the wire
  (``ops/compression.py``) and averages them; ``int8`` runs
  :func:`_int8_ring_allreduce_mean` on kernels K3 and K4;
- the SGD update runs once on the single copy of the params: every JAX
  replica applies the same update to the same values.

The ring keeps the reference's hop schedule and chunk ownership exactly
(sync_dp.py:88-105). The ``ppermute`` to slot + 1 becomes
``torch.roll(..., 1, dims=0)`` over the slot rows, and every quantize or
dequantize is ONE launch over all N rows. Hop seeds come from integer
mixing (splitmix64) of (seed, step, slot, hop); JAX's threefry
``fold_in`` chain is not reproduced, so the stochastic bits differ from
the TPU's (both are unbiased).

On a mesh over several processes (``parallel/multihost.py``) each rank
runs the same step over its own ``S`` of the ``N = R*S`` global slots:
BatchNorm averages its statistics over the ranks too; the ring's rows
are global slots (hop seeds and chunk indices by global slot) and each
hop's last row travels to the next rank, so every row equals the
one-process ring's row bit for bit; the bf16/fp16/none mean averages the
card's rows, then the ranks, in the wire dtype (JAX's reduced-precision
``pmean``), and the bytes its all-reduce moved, as the recorder of
``utils/collective_bytes.py`` counts them, are its ``wire_bytes_per_slot``;
the augmentation draws for the whole global batch and keeps this rank's
slice; ``loss`` and ``accuracy`` are means over the ranks. Each rank's
kernel launches cover its own rows only.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import torch
import torch.nn.functional as F

from ..data.cifar import (augment_draws, augment_with_draws, standardize,
                          to_float)
from ..ops.compression import (compress_for_allreduce,
                               decompress_from_allreduce)
from ..ops.quantize import (LANES, block_dequantize, block_layout,
                            block_quantize, block_quantize_stochastic)
from ..train.train_state import TrainState
from ..utils.collective_bytes import record_collectives
from ..utils.pytree import flax_names, to_torch_layout
from .mesh import DATA_AXIS, Mesh, worker_axis_size
from .multihost import RankGroup, rank_reduce, rank_scope, ring_roll

COMPRESSIONS = ("none", "fp32", "bf16", "fp16", "int8")
#: Tag that branches the ring's seeds off the augmentation stream (the
#: reference folds the same constant into its key, sync_dp.py:170).
RING_TAG = 0x7FFFFFFF

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def mix_seed(*values: int) -> int:
    """A 64-bit seed mixed from integers (splitmix64 chained over them)."""
    h = 0
    for v in values:
        h = _splitmix64(h ^ (int(v) & _M64))
    return h


def ring_payload_bytes(chunk: int) -> int:
    """Bytes of one slot's int8 payload for a chunk: codes + scales."""
    rows_padded, _, n_blocks = block_layout(chunk)
    return rows_padded * LANES + 4 * n_blocks


def _int8_ring_allreduce_mean(flat: torch.Tensor, seed: int = 0, *,
                              stochastic: bool = True,
                              wire: dict | None = None,
                              group: RankGroup | None = None
                              ) -> torch.Tensor:
    """Quantized all-reduce mean of ``flat`` ``[N, S]`` (row w = slot w's
    contribution) as a reduce-scatter ring + an all-gather ring with int8
    payloads on every hop; returns ``[N, S]``, row w = slot w's result.

    - reduce-scatter: N-1 hops; each quantizes the running partial sum of
      one 1/N chunk (K3, or K2 without ``stochastic``, seeded per slot and
      hop), hands codes and scales to slot + 1, dequantizes them (K4) and
      adds them to the slot's own next chunk: ``part = own[(my - s - 1)
      % n] + recv``. Slot w ends with the full sum of chunk (w + 1) % n.
    - all-gather: the mean chunk ``part / n`` (a division by a device
      tensor) is quantized once; its payload travels N-1 hops and every
      slot dequantizes it where it lands, so every row holds the same
      bits.

    With a ``group`` of R ranks, ``flat`` holds this rank's rows, global
    slots ``rank*S_local ...``, of a ring of ``N = R*S_local`` slots: each
    hop's last row goes to the next rank (``multihost.ring_roll``) and
    row 0 takes the previous rank's.

    ``wire``, if given, gets ``bytes_per_slot`` increased by the bytes each
    slot hands to its neighbour (codes + scales, 2 (N-1) payloads).
    """
    rows, size = flat.shape
    if size == 0:
        return flat.clone()
    dev = flat.device
    first = group.rank * rows if group is not None else 0
    n = rows * (group.size if group is not None else 1)
    chunk = -(-size // n)
    own = F.pad(flat, (0, n * chunk - size)).view(rows, n, chunk)
    local = torch.arange(rows, device=dev)
    slots = local + first

    def quant(x, hop):
        if stochastic:
            return block_quantize_stochastic(
                x, [mix_seed(seed, first + r, hop) for r in range(rows)])
        return block_quantize(x)

    def hand_over(v, sc):
        if wire is not None:
            wire["bytes_per_slot"] = wire.get("bytes_per_slot", 0) \
                + ring_payload_bytes(chunk)
        return ring_roll([v, sc], group=group)

    # -- reduce-scatter ring: partial sums travel int8 -----------------------
    part = own[local, slots]
    for s in range(n - 1):
        v, sc = hand_over(*quant(part, s))
        recv = block_dequantize(v, sc, chunk)
        part = own[local, (slots - s - 1) % n] + recv

    # -- all-gather ring: the mean chunk quantized once, rotated N-1 hops ----
    v, sc = quant(part / torch.tensor(float(n), device=dev), n - 1)
    out = torch.empty((rows, n, chunk), dtype=torch.float32, device=dev)
    idx = (slots + 1) % n
    out[local, idx] = block_dequantize(v, sc, chunk)
    for _ in range(n - 1):
        v, sc = hand_over(v, sc)
        idx = (idx - 1) % n
        out[local, idx] = block_dequantize(v, sc, chunk)
    return out.view(rows, n * chunk)[:, :size]


def shard_batch(mesh: Mesh, batch: Sequence, axis: str = DATA_AXIS
                ) -> tuple[torch.Tensor, ...]:
    """Host arrays -> tensors on the mesh's device with a leading slot
    axis: ``[B, ...]`` -> ``[N, B/N, ...]``, contiguous equal slices per
    slot (the reference's data sharding, worker.py:166-179). On a mesh
    over several processes the arrays are this rank's part and split over
    its own slots (``multihost.shard_batch_global`` takes the global
    batch). A batch that does not split evenly raises ``ValueError``."""
    n = worker_axis_size(mesh, axis) // mesh.num_ranks
    out = []
    for a in batch:
        t = torch.as_tensor(a)
        if t.shape[0] % n:
            raise ValueError(f"a batch of {t.shape[0]} does not split "
                             f"evenly over {n} worker slots")
        out.append(t.to(mesh.device).reshape(n, t.shape[0] // n,
                                             *t.shape[1:]))
    return tuple(out)


def _slot_to_flax(g: torch.Tensor) -> torch.Tensor:
    """``[N, *torch_shape]`` -> ``[N, *flax_shape]`` (a view), by rank as
    ``utils/pytree.to_flax_layout``: 5-D leaves are conv kernels, 3-D ones
    Dense kernels; the rest keep their layout (vectors, and a ViT's
    ``cls_token`` and ``pos_embed``, 4-D with the slot axis)."""
    if g.dim() == 5:
        return g.permute(0, 3, 4, 2, 1)     # [N, O, I, H, W] -> HWIO
    if g.dim() == 3:
        return g.transpose(1, 2)            # [N, out, in] -> [in, out]
    return g


def make_slot_grad_fn(model: torch.nn.Module) -> Callable:
    """``slot_grads(params, batch_stats, images, labels) -> (grads, losses,
    logits, new_batch_stats)`` over all slots at once, for any model with
    a ``forward_slots`` (every registry model).

    ``params``/``batch_stats`` are flat flax-named dicts (flax layouts);
    ``images`` are standardized float NHWC ``[N, B, H, W, C]`` and
    ``labels`` ``[N, B]``. ``grads`` maps each flax name to the per-slot
    gradients ``[N, *flax_shape]``; ``losses`` ``[N]`` are each slot's mean
    cross-entropy; ``logits`` ``[N, B, classes]``. The model's running
    statistics are loaded from ``batch_stats`` and updated in place; the
    new values are returned as copies (none for a ViT)."""
    pnames, snames = flax_names(model)
    buffers = dict(model.named_buffers())
    order = list(pnames)

    def slot_grads(params: Mapping, batch_stats: Mapping,
                   images: torch.Tensor, labels: torch.Tensor):
        n, b = labels.shape
        leaves = {}
        for t, f in pnames.items():
            p = params[f]
            leaves[t] = to_torch_layout(p).unsqueeze(0).repeat(
                n, *([1] * p.dim())).requires_grad_()
        with torch.no_grad():
            for t, f in snames.items():
                buffers[t].copy_(batch_stats[f])
        model.train()
        logits = model.forward_slots(images, leaves)
        losses = F.cross_entropy(logits.reshape(n * b, -1),
                                 labels.reshape(-1).long(),
                                 reduction="none").view(n, b).mean(1)
        gs = torch.autograd.grad(losses.sum(), [leaves[t] for t in order])
        grads = {pnames[t]: _slot_to_flax(g) for t, g in zip(order, gs)}
        new_stats = {f: buffers[t].detach().clone()
                     for t, f in snames.items()}
        return grads, losses.detach(), logits.detach(), new_stats

    return slot_grads


def ravel_slots(grads: Mapping[str, torch.Tensor]
                ) -> tuple[torch.Tensor, Callable]:
    """Per-slot gradients ``{name: [N, *shape]}`` -> ``([N, S], unravel)``
    in ``ravel_pytree``'s order: the nested flax tree's keys sorted level
    by level, each leaf flattened in its flax layout. ``unravel(vec)``
    maps an ``[S]`` vector back to ``{name: view of shape}``."""
    names = sorted(grads, key=lambda k: tuple(k.split("/")))
    first = grads[names[0]]
    n = first.shape[0]
    sizes = [grads[k][0].numel() for k in names]
    flat = torch.empty((n, sum(sizes)), dtype=torch.float32,
                       device=first.device)
    off = 0
    for k, size in zip(names, sizes):
        flat[:, off:off + size].view(grads[k].shape).copy_(grads[k])
        off += size
    shapes = [grads[k].shape[1:] for k in names]

    def unravel(vec: torch.Tensor) -> dict[str, torch.Tensor]:
        out, off = {}, 0
        for k, size, shape in zip(names, sizes, shapes):
            out[k] = vec[off:off + size].view(shape)
            off += size
        return out

    return flat, unravel


def augment_slots(x: torch.Tensor, generator: torch.Generator,
                  num_slots: int, first: int = 0) -> torch.Tensor:
    """RandomCrop + flip of the slots ``first .. first + S - 1`` (``x``
    ``[S, B, H, W, C]``) of a global batch of ``num_slots`` slots: the
    draws are made for the whole global batch from ``generator``, in the
    order one process over every slot makes them, and this card's part is
    applied, so its images equal that process's for the same slots."""
    s, b = x.shape[:2]
    offsets, flip = augment_draws(num_slots * b, generator, x.device)
    lo, hi = first * b, (first + s) * b
    return augment_with_draws(x.reshape(-1, *x.shape[2:]), offsets[lo:hi],
                              flip[lo:hi]).view(x.shape)


def make_sync_dp_step(mesh: Mesh, model: torch.nn.Module, *,
                      axis: str = DATA_AXIS, compression: str = "bf16",
                      augment: bool = True) -> Callable:
    """Build the sync data-parallel ``step(state, images_u8, labels, seed)
    -> (state, metrics)`` over ``model``'s slots.

    A model with BatchNorm must be built with ``axis_name=axis``
    (cross-replica BatchNorm), as the JAX step requires; a ViT has no
    statistic to sync. ``images_u8``/``labels`` come
    from :func:`shard_batch` (``[S, B, ...]``, the card's slots); ``seed``
    is the run's seed, folded with ``state.step`` for the augmentation
    draws and the ring's hop seeds; the ring rounds stochastically, as the
    reference's does. Metrics: ``loss`` and ``accuracy`` averaged over
    every slot of the mesh, per-slot ``worker_loss`` and
    ``worker_accuracy`` ``[S]`` of the card's slots (0-dim and ``[S]``
    tensors: no host sync), and for int8 ``ring_replicas_identical`` (the
    ring's rows are bit-equal on every rank) and ``wire_bytes_per_slot``
    (the bytes each slot handed across hops). On a mesh over several
    processes every rank must call the step, in the same order, and the
    bf16/fp16/none step reports ``wire_bytes_per_slot`` too: the bytes
    the rank's all-reduce of the card's mean moved (recorded, the ring
    model; a slot's own with one slot a rank)."""
    if compression not in COMPRESSIONS:
        raise ValueError(f"compression must be one of {COMPRESSIONS}, got "
                         f"{compression!r}")
    if any(True for _ in model.buffers()) \
            and getattr(model, "axis_name", None) != axis:
        raise ValueError(f"the sync step needs a model built with "
                         f"axis_name={axis!r} (cross-replica BatchNorm)")
    n = worker_axis_size(mesh, axis)
    rows, first, group = mesh.local_slots, mesh.slot_offset, mesh.group
    device = mesh.device
    slot_grads = make_slot_grad_fn(model)

    def step(state: TrainState, images_u8: torch.Tensor,
             labels: torch.Tensor, seed: int = 0):
        if images_u8.shape[0] != rows or labels.shape[0] != rows:
            raise ValueError(f"expected a leading axis of {rows} slots, got "
                             f"{tuple(images_u8.shape)}")
        rng = mix_seed(seed, state.step)
        x = images_u8.to(device)
        if augment:
            gen = torch.Generator(device=device).manual_seed(
                rng & ((1 << 63) - 1))
            x = augment_slots(x, gen, n, first)
        x = standardize(to_float(x))
        y = labels.to(device).long()

        with rank_scope(group):
            grads, losses, logits, new_stats = slot_grads(
                state.params, state.batch_stats, x, y)
        flat, unravel = ravel_slots(grads)
        metrics = {}
        if compression == "int8":
            wire = {}
            ring = _int8_ring_allreduce_mean(flat, mix_seed(rng, RING_TAG),
                                             wire=wire, group=group)
            mean = ring[0]
            same = (ring == ring[:1]).all()
            if group is not None:
                same = rank_reduce(same.to(torch.int32), "min", group).bool()
            metrics["ring_replicas_identical"] = same
            metrics["wire_bytes_per_slot"] = wire.get("bytes_per_slot", 0)
        else:
            cast = compress_for_allreduce({"g": flat}, compression)["g"]
            mean = cast.mean(0)
            if group is not None:
                # The reduced dtype stays on the wire between ranks.
                with record_collectives() as wire:
                    mean = rank_reduce(mean, "mean", group)
                metrics["wire_bytes_per_slot"] = wire.by_op["all-reduce"]
            mean = decompress_from_allreduce({"g": mean}, compression)["g"]

        state = state.apply_gradients(unravel(mean)).replace(
            batch_stats=new_stats)
        acc = (logits.argmax(-1) == y).float().mean(1)
        loss, accuracy = losses.mean(), acc.mean()
        if group is not None:
            loss, accuracy = rank_reduce(torch.stack([loss, accuracy]),
                                         "mean", group)
        metrics.update({"loss": loss, "accuracy": accuracy,
                        "worker_loss": losses, "worker_accuracy": acc})
        return state, metrics

    return step
