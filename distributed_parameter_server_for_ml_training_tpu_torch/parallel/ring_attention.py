"""Ring attention: sequence parallelism over the ``seq`` slots of a mesh
(counterpart of the JAX package's ``parallel/ring_attention.py``).

In the reference each device of a ``seq`` mesh axis holds a ``[B, T/N,
H, D]`` slice of q/k/v under ``shard_map``; K/V blocks rotate around the
ring with ``lax.ppermute`` while each device accumulates attention for
its resident queries with the online-softmax merge. The port runs the N
slots on one card in one program: q/k/v ``[B, T, H, D]`` are viewed as N
slices of T/N stacked on a leading slot axis, and ``ppermute`` to slot
+ 1 becomes ``torch.roll(..., 1, dims=0)`` over it, as the sync ring does
(``parallel/sync_dp.py``). Slot ``my`` holds, after ``step`` rotations,
the block that started on slot ``(my - step) mod N``.

- :func:`make_ring_attention`: the dense ring (fp32 einsums per hop,
  autograd through it);
- :func:`make_ring_flash_attention`: the flash kernels K5-K7 as each
  hop's block core, with the reference's custom gradient as a
  ``torch.autograd.Function``. **Each hop is one launch over all slots**
  (BH' = N B H rows, per-slot (q_offset, k_offset)), so a hop costs one
  K5, or one K6 and one K7, not N.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..ops.flash_attention import (_flash_bwd_impl, _flash_fwd_impl,
                                   pick_block)
from .mesh import SEQ_AXIS, Mesh

_NEG_INF = -1e30


def _to_slots(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, T, H, D] -> [N, B, T/N, H, D]."""
    b, t, h, d = x.shape
    if t % n:
        raise ValueError(f"{t} tokens do not split into {n} sequence slots")
    return x.view(b, n, t // n, h, d).transpose(0, 1)


def _from_slots(x: torch.Tensor) -> torch.Tensor:
    """[N, B, T/N, H, D] -> [B, T, H, D]."""
    n, b, tl, h, d = x.shape
    return x.transpose(0, 1).reshape(b, n * tl, h, d)


def _merge(m, l, o, logits, v_blk):
    """Online-softmax merge of one K/V block into the running (m, l, o)."""
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum("nbhqk,nbkhd->nbhqd", p,
                                                v_blk)
    return m_new, l_new, o_new


def ring_attention_local(q, k, v, *, axis_size: int, causal: bool = False):
    """The dense ring over slot-stacked ``[N, B, T_local, H, D]`` q/k/v
    (the reference's per-shard body, for every slot at once). Returns
    ``[N, B, T_local, H, D]`` in q's dtype."""
    n, b, tl, h, d = q.shape
    if n != axis_size:
        raise ValueError(f"{n} slots for a ring of {axis_size}")
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    qf = q.float()
    m = torch.full((n, b, h, tl), _NEG_INF, device=dev)
    l = torch.zeros((n, b, h, tl), device=dev)
    o = torch.zeros((n, b, h, tl, d), device=dev)
    kk, vv = k.float(), v.float()
    my = torch.arange(n, device=dev)
    pos = torch.arange(tl, device=dev)
    for step in range(n):
        src = (my - step) % n
        logits = torch.einsum("nbqhd,nbkhd->nbhqk", qf, kk) * scale
        if causal:
            q_pos = my[:, None] * tl + pos[None, :]           # [N, Tq]
            k_pos = src[:, None] * tl + pos[None, :]          # [N, Tk]
            mask = q_pos[:, :, None] >= k_pos[:, None, :]     # [N, Tq, Tk]
            logits = torch.where(mask[:, None, None], logits, _NEG_INF)
        m, l, o = _merge(m, l, o, logits, vv)
        if step != n - 1:
            kk = torch.roll(kk, 1, dims=0)
            vv = torch.roll(vv, 1, dims=0)
    out = o / l.clamp_min(1e-30)[..., None]                   # [N,B,H,Tq,D]
    return out.permute(0, 1, 3, 2, 4).to(q.dtype)


def make_ring_attention(mesh: Mesh, axis: str = SEQ_AXIS,
                        causal: bool = False) -> Callable:
    """``fn(q, k, v) -> out`` over ``[B, T, H, D]``, the sequence split
    over the mesh's ``axis`` slots; differentiable by autograd."""
    n = mesh.shape[axis]

    def fn(q, k, v):
        out = ring_attention_local(_to_slots(q, n), _to_slots(k, n),
                                   _to_slots(v, n), axis_size=n,
                                   causal=causal)
        return _from_slots(out)

    return fn


# ---------------------------------------------------------------------------
# Ring x flash: the flash kernels as the per-hop block core
# ---------------------------------------------------------------------------

def _to3(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, T, H, D] -> contiguous [N*B*H, T/N, D]: N slots of B*H rows, the
    flash kernels' layout with the slot outermost, as their per-slot
    offsets expect."""
    b, t, h, d = x.shape
    if t % n:
        raise ValueError(f"{t} tokens do not split into {n} sequence slots")
    return x.view(b, n, t // n, h, d).permute(1, 0, 3, 2, 4) \
        .reshape(n * b * h, t // n, d).contiguous()


def _to4(x3: torch.Tensor, n: int, b: int, h: int) -> torch.Tensor:
    """[N*B*H, T/N, D] -> [B, T, H, D] (inverse of _to3)."""
    _, tl, d = x3.shape
    return x3.view(n, b, h, tl, d).permute(1, 0, 3, 2, 4) \
        .reshape(b, n * tl, h, d)


def _hop_fwd(q3, k3, v3, use_kernel: bool, causal=False, q_offset=0,
             k_offset=0):
    """One hop's flash forward of ``[BH', Tq, D]`` q against a ``[BH', Tk,
    D]`` K/V block -> (normalized fp32 partial out ``[BH', Tq, D]``, LSE
    ``[BH', Tq, 1]``). BH' = N B H with per-slot offsets in the ring.
    Partials stay fp32: the ring merges N of them."""
    tk = k3.shape[1]
    for t in (q3.shape[1], tk):     # the reference's 128 rule
        pick_block(t)
    return _flash_fwd_impl(q3, k3, v3, tk, use_kernel=use_kernel,
                           out_dtype=torch.float32, causal=causal,
                           q_offset=q_offset, k_offset=k_offset)


def _hop_bwd(q3, k3, v3, do3, lse_tot, delta, use_kernel: bool,
             causal=False, q_offset=0, k_offset=0):
    """One hop's flash backward: fp32 (dq partial, dk block, dv block)
    ``[BH', T, D]`` given the TOTAL LSE and delta; the merge is never
    differentiated (p = exp(s - lse_total) directly)."""
    return _flash_bwd_impl(q3, k3, v3, do3, lse_tot, delta, k3.shape[1],
                           use_kernel=use_kernel, out_dtype=torch.float32,
                           causal=causal, q_offset=q_offset,
                           k_offset=k_offset)


def _hop_offsets(n: int, tl: int, step: int) -> tuple[list, list]:
    """Per-slot (q_offset, k_offset) at ``step``: slot my's queries start at
    my * tl, its resident block came from slot (my - step) mod N."""
    return ([my * tl for my in range(n)],
            [((my - step) % n) * tl for my in range(n)])


class _RingFlash(torch.autograd.Function):
    """The ring over q/k/v in the kernels' layout ``[N*B*H, T_local, D]``
    (:func:`_to3`): rolling a slot's B*H rows along dim 0 is the
    ``ppermute`` to the next slot, so no hop changes the layout."""

    @staticmethod
    def forward(ctx, q, k, v, n: int, causal: bool, use_kernel: bool):
        rows, tl, d = q.shape
        per_slot = rows // n
        m = torch.full((rows, tl, 1), _NEG_INF, device=q.device)
        l = torch.zeros((rows, tl, 1), device=q.device)
        acc = torch.zeros((rows, tl, d), device=q.device)
        kk, vv = k, v
        for step in range(n):
            q_offs, k_offs = _hop_offsets(n, tl, step)
            # Under causal masking the JAX ring skips a wholly-future block
            # with lax.cond, giving (O = 0, LSE = -1e30). Here one launch
            # covers every slot, and for a slot whose block is wholly in
            # the future the kernel's loop bound is 0: it leaves O = 0 and
            # LSE = -1e30 + log(1e-30) = -1e30 in fp32, the cond branch's
            # values, which the merge weights by exp(-1e30 - m) = 0. (The
            # plain version computes such a hop densely: its O is the mean
            # of V and its LSE -1e30 + log(Tk), also -1e30 in fp32, so the
            # merge discards it the same way.)
            o_i, lse_i = _hop_fwd(q, kk, vv, use_kernel, causal, q_offs,
                                  k_offs)
            m_new = torch.maximum(m, lse_i)
            w_prev = torch.exp(m - m_new)
            w_i = torch.exp(lse_i - m_new)
            l = l * w_prev + w_i
            acc = acc * w_prev + o_i * w_i
            m = m_new
            if step != n - 1:
                kk = torch.roll(kk, per_slot, dims=0)
                vv = torch.roll(vv, per_slot, dims=0)
        l = l.clamp_min(1e-30)
        lse_tot = m + torch.log(l)
        out = (acc / l).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse_tot)
        ctx.n, ctx.causal, ctx.use_kernel = n, causal, use_kernel
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse_tot = ctx.saved_tensors
        n = ctx.n
        rows, tl, _ = q.shape
        per_slot = rows // n
        do = do.to(q.dtype).contiguous()
        delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
        dq = torch.zeros(q.shape, device=q.device)
        dkk = torch.zeros(k.shape, device=k.device)
        dvv = torch.zeros(v.shape, device=v.device)
        kk, vv = k, v
        for step in range(n):
            q_offs, k_offs = _hop_offsets(n, tl, step)
            # A wholly-future block: K6's loop bound and K7's query range
            # are empty, so its gradients are 0, the cond branch's zeros.
            dq_i, dk_i, dv_i = _hop_bwd(q, kk, vv, do, lse_tot, delta,
                                        ctx.use_kernel, ctx.causal, q_offs,
                                        k_offs)
            dq = dq + dq_i
            dkk = dkk + dk_i
            dvv = dvv + dv_i
            # The gradient accumulators rotate with their blocks every hop
            # (N hops bring each home); K/V skip the last rotation.
            if step != n - 1:
                kk = torch.roll(kk, per_slot, dims=0)
                vv = torch.roll(vv, per_slot, dims=0)
            dkk = torch.roll(dkk, per_slot, dims=0)
            dvv = torch.roll(dvv, per_slot, dims=0)
        return (dq.to(q.dtype), dkk.to(k.dtype), dvv.to(v.dtype), None, None,
                None)


def make_ring_flash_attention(mesh: Mesh, axis: str = SEQ_AXIS,
                              causal: bool = False,
                              use_kernel: bool | None = None) -> Callable:
    """Ring attention whose per-hop block core is the flash kernel:
    ``fn(q, k, v) -> out`` over ``[B, T, H, D]``, T split over the mesh's
    ``axis`` slots; T/N must be a multiple of 128.

    Forward: each hop's flash forward gives a normalized fp32 partial
    (o_i, lse_i), merged associatively. Backward: with the TOTAL LSE and
    delta = rowsum(dO * O), each hop's dq/dk/dv come from the flash
    backward kernels, the dK/dV accumulators rotating with their blocks.
    q/k/v enter the kernels' layout once and leave it once.
    ``use_kernel=None`` or True runs the kernel wrappers (K5-K7 on CUDA
    tensors, their plain versions on CPU ones); False runs the plain
    versions on any device (the reference's ``use_pallas=False``).
    ``causal`` masks in global positions."""
    n = mesh.shape[axis]
    use = True if use_kernel is None else bool(use_kernel)

    def fn(q, k, v):
        b, t, h, _ = q.shape
        pick_block(t // n)
        out = _RingFlash.apply(_to3(q, n), _to3(k, n), _to3(v, n), n,
                               bool(causal), use)
        return _to4(out, n, b, h)

    return fn


def dense_attention(q, k, v, causal: bool = False):
    """Reference dense softmax attention in fp32 (for tests and one slot)."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(d)
    if causal:
        t = q.shape[1]
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
