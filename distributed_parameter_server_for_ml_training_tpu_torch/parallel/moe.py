"""Expert parallelism: Switch-style top-1 MoE FFN over the ``expert``
slots of a mesh (counterpart of the JAX package's ``parallel/moe.py``).

In the reference each device of an ``expert`` mesh axis holds one expert
and ``n/E`` of the tokens (``P("expert")`` over the batch-major
flattened tokens); it routes its own tokens, packs them into
capacity-limited per-expert buffers, and two ``lax.all_to_all`` hops move
them to their expert and back. The port runs the E slots on one card in
one program: the tokens ``[n, D]`` are viewed as E shards ``[E, n/E, D]``
(shard k holds rows ``[k n/E, (k+1) n/E)``), every shard routes at once,
and each ``all_to_all`` becomes a transpose of the slot axis with the
expert axis of the dispatch buffer ``[E_shard, E_expert, C, D]``. The two
transposes are the only place the slots meet.

    route (per shard) -> dispatch [E, E, C, D] -> transpose -> every
    expert's FFN on [E, E*C, D] (one batched product) -> transpose back
    -> gate * combine (dropped tokens -> 0)

dp x ep (``data_axis``, a ``(data, expert)`` mesh of dp x E slots): the
tokens split into ``dp * E`` shards ordered ``g * E + k`` (the
reference's ``P(("data", "expert"))``); data group g routes its E shards
over its own E expert slots, so the transposes stay inside the group
(dispatch ``[dp, E, E, C, D]``), while every group's rows for expert e go
through the one copy of e's weights (``[E, dp*E*C, D]``), so their
gradients sum over the groups as the reference's data-axis ``psum``
does. The statistics average over every shard of every group.

Over ranks (a one-axis ``expert`` mesh with a ``group``, one process a
card, ``train/model_parallel.py:MoETrainer(group=)``): the E slots spread
over R ranks, ``E % R == 0``. Rank r holds the tokens of its ``E/R``
slots (global shards ``[r E/R, (r+1) E/R)``, the rank's contiguous rows
of the batch) and the rows of its ``E/R`` experts of ``w1/b1/w2/b2``;
the router is replicated. Each transpose becomes the rank-local one plus
an all_to_all over the ranks (``multihost.all_to_all_grad``): the rank's
buffer ``[E/R, E, C, D]`` is laid out by the rank of the expert
(``[R, E/R, E/R, C, D]``), each rank receives the blocks of its experts
from every rank, and ``[E/R, E*C, D]`` holds every shard's rows for each
of its experts in global shard order, as one process's ``[E, E*C, D]``
holds them; the way back is the reverse. The statistics sum the rank's
shards in order, then over the ranks (``multihost.rank_sum``, whose
backward is the sum of the incoming gradients: the ``pmean``'s transpose
in JAX), and divide by the global shard count.

Capacity C bounds the buffers; a token beyond its expert's capacity
within its own shard is dropped (its output row is 0; in a transformer the
residual carries it). Positions are a cumsum within each shard, as each
reference device counts only its own tokens. The routing work (fp32
router product, softmax, argmax, a scatter-add and a gather) and the
expert products (``bmm`` over the expert axis) are plain PyTorch: the
reference leaves all of it to XLA, outside any Pallas kernel.

Dropped tokens add exact zeros at slot ``C - 1`` of their expert's
buffer (``index_put`` with accumulation), so the scatter's result does
not depend on the order of the adds.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from .mesh import EXPERT_AXIS, Mesh
from .multihost import RankGroup, all_to_all_grad, rank_sum

_KEYS = ("router", "w1", "b1", "w2", "b2")


def init_moe_params(generator: torch.Generator | None, d_model: int,
                    d_hidden: int, n_experts: int,
                    device: str | torch.device = "cpu") -> dict:
    """Router + stacked per-expert FFN params ``[E, ...]`` (fp32, flax
    layouts): normal(1/sqrt(d_model)) router and ``w1``,
    normal(1/sqrt(d_hidden)) ``w2``, zero biases, as the reference's (the
    draws differ: a ``torch.Generator`` is not a ``jax.random`` key)."""
    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    return {k: v.to(device) for k, v in {
        "router": normal((d_model, n_experts), 1.0 / math.sqrt(d_model)),
        "w1": normal((n_experts, d_model, d_hidden),
                     1.0 / math.sqrt(d_model)),
        "b1": torch.zeros(n_experts, d_hidden),
        "w2": normal((n_experts, d_hidden, d_model),
                     1.0 / math.sqrt(d_hidden)),
        "b2": torch.zeros(n_experts, d_model),
    }.items()}


def _route(tokens: torch.Tensor, router: torch.Tensor):
    """``[..., D]`` -> (probs ``[..., E]`` in at least fp32, expert_idx,
    gate): softmax of the router logits, top-1 with the first index on
    ties (``jnp.argmax``'s rule, and ``torch.argmax``'s)."""
    logits = tokens @ router
    probs = torch.softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    expert_idx = probs.argmax(dim=-1)
    gate = probs.gather(-1, expert_idx[..., None])[..., 0]
    return probs, expert_idx, gate


def _positions(expert_idx: torch.Tensor, n_experts: int, capacity: int):
    """``[S, n_s]`` expert indices -> (one-hot ``[S, n_s, E]``, each
    token's position in its expert's buffer, counted within its own
    shard, and ``keep = pos < capacity``)."""
    onehot = F.one_hot(expert_idx, n_experts)
    pos = (torch.cumsum(onehot, dim=1) * onehot - 1).amax(dim=2)
    return onehot, pos, pos < capacity


def _shard_means(parts: list, n_total: int,
                 group: RankGroup | None) -> list:
    """Means over every shard of per-shard statistics ``[S, ...]``: each
    summed shard by shard in order, summed over the ranks where there are
    several (one all-reduce of them all, differentiable), and divided by a
    tensor (a CUDA division by a Python scalar multiplies by its
    reciprocal): the same rounding on the card as on the CPU."""
    sums = []
    for t in parts:
        total = t[0]
        for k in range(1, t.shape[0]):
            total = total + t[k]
        sums.append(total)
    if group is not None:
        flat = rank_sum(torch.cat([t.reshape(-1) for t in sums]), group)
        sums = [v.view_as(t) for v, t in
                zip(flat.split([t.numel() for t in sums]), sums)]
    return [t / t.new_full((), n_total) for t in sums]


def _expert_ffn(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Every expert's FFN at once: ``[E, R, D]`` -> ``[E, R, D]``,
    ``gelu(x @ w1 + b1) @ w2 + b2`` with the tanh GELU (``jax.nn.gelu``'s
    default)."""
    h = F.gelu(torch.bmm(x, params["w1"]) + params["b1"][:, None],
               approximate="tanh")
    return torch.bmm(h, params["w2"]) + params["b2"][:, None]


def _moe_body(params: dict, tokens: torch.Tensor, *, n_shards: int,
              capacity: int, dp: int = 1, group: RankGroup | None = None):
    """All ``n_shards`` shards of ``tokens`` ``[n, D]`` at once (the
    reference's per-device body for every device), ``dp`` data groups of
    E shards each, or, over the ranks of ``group``, this rank's
    ``n_shards`` of them and its experts (module notes). Returns ``([n,
    D], stats)`` with the routing statistics averaged over every shard
    (the reference's ``pmean`` over the whole mesh):

    - ``aux_loss``: the Switch load-balance loss ``E * sum_e f_e * P_e``
      (``f_e`` the fraction of tokens routed to e, ``P_e`` the mean router
      probability; differentiable through ``P_e`` only);
    - ``load``: ``[E]`` f_e, ``importance``: ``[E]`` P_e;
    - ``drop_frac``: the fraction of tokens dropped by the capacity.
    """
    n, d = tokens.shape
    e = params["router"].shape[1]
    ranks = 1 if group is None else group.size
    if n % n_shards:
        raise ValueError(f"{n} tokens do not split into {n_shards} expert "
                         f"slots")
    if e * dp != n_shards * ranks:
        raise ValueError(f"{e} experts x dp {dp} for {n_shards * ranks} "
                         f"token shards: one expert a slot")
    params = {k: params[k].to(tokens.dtype) for k in _KEYS}
    x = tokens.view(n_shards, n // n_shards, d)              # [S, n_s, D]

    # -- route each shard (top-1 / Switch) ----------------------------------
    probs, expert_idx, gate = _route(x, params["router"])    # [S, n_s, ..]
    onehot, pos, keep = _positions(expert_idx, e, capacity)

    # -- routing stats + Switch auxiliary load-balance loss -----------------
    # Per shard, then averaged over the shards (the reference's pmean).
    # The counts are integers and each shard's fraction one true
    # division, so load and drop_frac are the same numbers on any device.
    n_s = probs.new_full((), n // n_shards)
    load, importance, drop_frac = _shard_means(
        [onehot.sum(dim=1).to(n_s.dtype) / n_s,             # [E] f_e
         probs.mean(dim=1),                                  # [E] P_e
         1.0 - keep.sum(dim=1).to(n_s.dtype) / n_s], n_shards * ranks, group)
    aux_loss = e * torch.sum(load.detach() * importance)
    stats = {"aux_loss": aux_loss, "load": load, "importance": importance,
             "drop_frac": drop_frac}

    # -- dispatch [S, E, C, D] ----------------------------------------------
    safe_pos = pos.clamp(0, capacity - 1)
    shard = torch.arange(n_shards, device=tokens.device)[:, None] \
        .expand_as(expert_idx)
    dispatch = tokens.new_zeros(n_shards, e, capacity, d).index_put(
        (shard, expert_idx, safe_pos), x * keep[..., None].to(x.dtype),
        accumulate=True)

    # -- to the experts (all_to_all within each group), compute, back -------
    if group is None:
        recv = dispatch.view(dp, e, e, capacity, d).permute(2, 0, 1, 3, 4) \
            .reshape(e, n_shards * capacity, d)             # [E, S*C, D]
        out = _expert_ffn(recv, params)
        back = out.view(e, dp, e, capacity, d).permute(1, 2, 0, 3, 4) \
            .reshape(n_shards, e, capacity, d)              # [S, E, C, D]
    else:
        el, sl = e // ranks, n_shards
        send = dispatch.view(sl, ranks, el, capacity, d) \
            .permute(1, 2, 0, 3, 4)                          # [R, El, Sl, ..]
        recv = all_to_all_grad(send, group).permute(1, 0, 2, 3, 4) \
            .reshape(el, ranks * sl * capacity, d)          # [El, S*C, D]
        out = _expert_ffn(recv, params)
        back = all_to_all_grad(
            out.view(el, ranks, sl, capacity, d).permute(1, 0, 2, 3, 4),
            group).permute(2, 0, 1, 3, 4).reshape(sl, e, capacity, d)

    # -- combine -------------------------------------------------------------
    gathered = back[shard, expert_idx, safe_pos]             # [S, n_s, D]
    mask = (keep.to(x.dtype) * gate.to(x.dtype))[..., None]
    return (gathered * mask).reshape(n, d), stats


def make_moe_ffn(mesh: Mesh, capacity: int, axis: str = EXPERT_AXIS,
                 data_axis: str | None = None) -> Callable:
    """Build ``fn(params, tokens[B, D]) -> ([B, D], stats)``: the tokens
    split over the mesh's ``axis`` slots, one expert a slot, ``capacity``
    tokens a shard an expert. Differentiable by autograd; ``stats`` holds
    the Switch aux loss and the routing statistics (:func:`_moe_body`) as
    device tensors. ``params``: ``router`` ``[D, E]``, ``w1`` ``[E, D,
    H]``, ``b1`` ``[E, H]``, ``w2`` ``[E, H, D]``, ``b2`` ``[E, D]``; cast
    to the tokens' dtype. ``data_axis`` (dp x ep): the mesh's data groups
    each route their own ``n / dp`` tokens over the E experts (module
    notes). Over the ranks of ``mesh.group`` (one axis): ``tokens`` are
    this rank's rows, ``w1/b1/w2/b2`` the rows of its experts (module
    notes); the function's ``group`` attribute names the group."""
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    group = mesh.group
    dp = 1 if data_axis is None else mesh.shape[data_axis]
    n_shards = mesh.shape[axis] * dp
    if group is not None and n_shards % group.size:
        raise ValueError(f"{n_shards} experts do not divide evenly over "
                         f"{group.size} ranks")
    local = n_shards // (1 if group is None else group.size)

    def moe(params: dict, tokens: torch.Tensor):
        return _moe_body(params, tokens, n_shards=local,
                         capacity=capacity, dp=dp, group=group)

    moe.group = group           # the ranks whose experts it spreads over
    return moe


def dense_reference(params: dict, tokens: torch.Tensor,
                    capacity: int | None = None) -> torch.Tensor:
    """Every token through its top-1 expert, no capacity (``capacity`` is
    not modelled, as in the reference: compare at a generous capacity).
    Every expert runs on every token and each token keeps its own
    expert's row: E times the products, but no ``[n, D, H]`` gather of
    per-token weights, so it runs at full width."""
    params = {k: params[k].to(tokens.dtype) for k in _KEYS}
    _, expert_idx, gate = _route(tokens, params["router"])
    n, e = tokens.shape[0], params["router"].shape[1]
    every = _expert_ffn(tokens.expand(e, *tokens.shape), params)  # [E,n,D]
    out = every[expert_idx, torch.arange(n, device=tokens.device)]
    return out * gate[:, None].to(tokens.dtype)
