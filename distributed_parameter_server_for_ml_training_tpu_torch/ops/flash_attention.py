"""Fused (flash) attention: kernels K5-K7 and their custom gradient.

Counterpart of the JAX package's ``ops/pallas/flash_attention.py``. The
core op works on ``[BH, T, D]`` q/k/v (T padded to a multiple of 128):

- :func:`flash_fwd_wgmma` (K5 on bf16 inputs) and :func:`flash_fwd` (the
  first version of K5, which the forward runs on fp32 inputs):
  online-softmax forward, writing O in ``out_dtype`` (default q's) and
  LSE ``[BH, T, 1]`` fp32;
- :func:`flash_bwd` (K6 and K7 in one kernel, bf16 inputs): dQ, dK and
  dV from the saved LSE and delta = rowsum(dO * O), with dQ reduced in
  fp32 into a buffer the caller may pass (``dq_acc``);
- :func:`flash_bwd_dq` (K6) and :func:`flash_bwd_dkv` (K7): the first
  version's dQ and dK/dV kernels, which the backward runs on fp32 inputs.

Each takes ``kv_len`` (keys at or beyond it are masked), ``causal`` with
global positions ``(q_offset, k_offset)``, and returns results in
``out_dtype``. An offset may be a sequence of N per-slot values: the BH
rows are then N slots of BH / N rows, each with its own offsets, and one
launch serves one ring hop over all sequence slots
(``parallel/ring_attention.py``).

Every kernel wrapper dispatches on the tensors' device, as
``ops/quantize.py``'s do:

- a CUDA tensor launches the hand-written Hopper kernel
  (``ops/csrc/flash_attention.cu``; built by nvcc at first use, bound with
  ctypes) on PyTorch's current stream. bf16 and fp32 inputs, D of 64 or
  128; anything else raises, and a failed build or launch raises: there
  is no fallback to the plain version;
- a CPU tensor takes the plain PyTorch version (:func:`flash_fwd_plain`,
  :func:`flash_bwd_plain`): the JAX package's masked dense formulation
  in fp32, which the CPU tests hold against the JAX functions. The one
  exception is :func:`flash_fwd_wgmma`, which takes bf16 CUDA tensors
  only: its route (:func:`_fwd_route`) sends CPU tensors to the plain
  version before it.

Each wrapper has a ``launches`` count of kernel launches (never plain
calls). :func:`flash_attention` is the public ``[B, T, H, D]`` op with
the reference's dispatch: below the crossover (:func:`flash_preferred`)
it is :func:`~.attention.dense_core`; above it, :class:`_FlashCore`.

The crossover: the JAX package reads ``attn_crossover.json``, measured
on a TPU; the port never reads it. It reads ``attn_crossover_cuda.json``
beside this module when one exists (none does yet), else
``DEFAULT_CROSSOVER_T``; flash is preferred only for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import threading
from functools import lru_cache

import torch

from .attention import dense_core

KERNEL_SOURCE = "distributed_parameter_server_for_ml_training_tpu_torch/" \
    "ops/csrc/flash_attention.cu"
_PALLAS_FLASH = "distributed_parameter_server_for_ml_training_tpu/" \
    "ops/pallas/flash_attention.py"
#: The TPU kernel each wrapper replaces (file:line of its function).
REPLACES = {
    "flash_fwd": f"{_PALLAS_FLASH}:168",
    "flash_fwd_wgmma": f"{_PALLAS_FLASH}:168",
    "flash_bwd": f"{_PALLAS_FLASH}:218, {_PALLAS_FLASH}:259",
    "flash_bwd_dq": f"{_PALLAS_FLASH}:218",
    "flash_bwd_dkv": f"{_PALLAS_FLASH}:259",
}

_NEG_INF = -1e30
MAX_BLOCK = 512
DEFAULT_CROSSOVER_T = 2048
FLASH_TIE_THRESHOLD = 0.95
_CROSSOVER_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "attn_crossover_cuda.json")
#: Head dims the kernels take; rows of a launch are tiled by KERNEL_TILE.
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_TILE = 64
MAX_SLOTS = 32

_count_lock = threading.Lock()


# -- dispatch predicate ----------------------------------------------------------

def _on_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


@lru_cache(maxsize=1)
def _crossover_record() -> dict:
    try:
        with open(_CROSSOVER_FILE) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def flash_crossover() -> int:
    """Dense -> flash crossover length: the port's own measured record, or
    ``DEFAULT_CROSSOVER_T`` when there is none."""
    try:
        return int(_crossover_record()["crossover_t"])
    except (KeyError, ValueError, TypeError):
        return DEFAULT_CROSSOVER_T


def _measured_speedup(tp: int) -> float:
    """Flash fwd+bwd speedup vs dense at padded length ``tp``, linearly
    interpolated over the record's table (clamped to its ends); 1.0 with
    no table."""
    table = _crossover_record().get("measured_speedups_fwd_bwd") or {}
    try:
        pts = sorted((int(k), float(v)) for k, v in table.items())
    except (ValueError, TypeError):
        pts = []
    if not pts:
        return 1.0
    if tp <= pts[0][0]:
        return pts[0][1]
    if tp >= pts[-1][0]:
        return pts[-1][1]
    for (t0, s0), (t1, s1) in zip(pts, pts[1:]):
        if t0 <= tp <= t1:
            return s0 + (tp - t0) / (t1 - t0) * (s1 - s0)
    return 1.0


def flash_preferred(t: int, device) -> bool:
    """True when the flash kernels are expected to beat dense attention at
    sequence length ``t`` for tensors on ``device``: never off CUDA, never
    below the crossover, and the speedup at the 128-padded length, taxed
    by (t / t_padded)^2, must reach ``FLASH_TIE_THRESHOLD``."""
    if not _on_cuda(device) or t < flash_crossover():
        return False
    tp = -(-t // 128) * 128
    return _measured_speedup(tp) * (t / tp) ** 2 >= FLASH_TIE_THRESHOLD


def pick_block(t: int) -> int:
    """Largest 128-multiple <= MAX_BLOCK dividing ``t``. The 128 rule fixes
    the padded length and the ring's per-shard length, as in the
    reference; the kernels tile by KERNEL_TILE internally."""
    if t % 128:
        raise ValueError(
            f"sequence block length {t} must be a multiple of 128; pad the "
            f"sequence or pick a shard count that divides it into "
            f"128-multiples")
    return max(b for b in range(128, MAX_BLOCK + 1, 128) if t % b == 0)


# -- plain versions (the JAX package's masked dense math) ----------------------

def _offsets(q_offset, k_offset) -> tuple[list[int], list[int]]:
    """Per-slot (q, k) offsets as two equal-length lists."""
    qs = [int(q_offset)] if isinstance(q_offset, int) else \
        [int(x) for x in q_offset]
    ks = [int(k_offset)] if isinstance(k_offset, int) else \
        [int(x) for x in k_offset]
    if len(qs) == 1 and len(ks) > 1:
        qs = qs * len(ks)
    if len(ks) == 1 and len(qs) > 1:
        ks = ks * len(qs)
    if len(qs) != len(ks) or not qs:
        raise ValueError(f"q and k offsets per slot differ in number: "
                         f"{q_offset!r} vs {k_offset!r}")
    return qs, ks


def _position_mask(tq: int, tk: int, kv_len: int, causal: bool, q_offset,
                   k_offset, device=None) -> torch.Tensor:
    """``[N, 1, Tq, Tk]`` keep-mask, one per slot: the kv_len bound and,
    under causal masking, key (k_off + j) kept for query (q_off + i) iff
    k_off + j <= q_off + i (global positions)."""
    qs, ks = _offsets(q_offset, k_offset)
    keep = (torch.arange(tk, device=device) < kv_len)[None, None, None, :]
    if causal:
        rows = torch.tensor(qs, device=device)[:, None] \
            + torch.arange(tq, device=device)[None, :]
        cols = torch.tensor(ks, device=device)[:, None] \
            + torch.arange(tk, device=device)[None, :]
        keep = keep & (cols[:, None, None, :] <= rows[:, None, :, None])
    return keep.expand(len(qs), 1, tq, tk)


def _slots(x: torch.Tensor, n: int) -> torch.Tensor:
    """[BH, ...] -> [N, BH / N, ...]."""
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split into {n} slots")
    return x.view(n, x.shape[0] // n, *x.shape[1:])


def flash_fwd_plain(q, k, v, kv_len: int, *, out_dtype=None,
                    causal: bool = False, q_offset=0, k_offset=0):
    """K5's plain version: masked dense softmax in fp32 -> (O in
    ``out_dtype`` or q's dtype, LSE ``[BH, Tq, 1]`` fp32)."""
    bh, tq, d = q.shape
    scale = 1.0 / math.sqrt(d)
    n = len(_offsets(q_offset, k_offset)[0])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    mask = _position_mask(tq, k.shape[1], kv_len, causal, q_offset,
                          k_offset, q.device)
    s = torch.where(mask, _slots(s, n), _NEG_INF).view(bh, tq, -1)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bqk,bkd->bqd", p / l, v.float())
    return o.to(out_dtype or q.dtype), m + torch.log(l)


def flash_bwd_plain(q, k, v, do, lse, delta, kv_len: int, *,
                    out_dtype=None, causal: bool = False, q_offset=0,
                    k_offset=0):
    """K6's and K7's plain version: (dQ, dK, dV) in ``out_dtype`` or the
    inputs' dtypes, from the given LSE and delta ``[BH, Tq, 1]``."""
    bh, tq, d = q.shape
    scale = 1.0 / math.sqrt(d)
    n = len(_offsets(q_offset, k_offset)[0])
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    mask = _position_mask(tq, k.shape[1], kv_len, causal, q_offset,
                          k_offset, q.device)
    p = torch.where(mask, _slots(torch.exp(s - lse), n), 0.0).view(
        bh, tq, -1)
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    return (dq.to(out_dtype or q.dtype), dk.to(out_dtype or k.dtype),
            dv.to(out_dtype or v.dtype))


# -- kernels K5-K7 ---------------------------------------------------------------

_KERNEL_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn(name: str):
    from ._build import load

    fn = getattr(load("flash_attention"), name)
    if fn.argtypes is None:     # first use: declare the C signature once
        p, i32 = ctypes.c_void_p, ctypes.c_int
        ints = ctypes.POINTER(ctypes.c_int)
        head = {"dps_flash_fwd": [p] * 5,
                "dps_flash_fwd_wgmma": [p] * 5,
                "dps_flash_bwd": [p] * 9,
                "dps_flash_bwd_dq": [p] * 7,
                "dps_flash_bwd_dkv": [p] * 8}[name]
        # bh, tq, tk, d, kv_len, [q_len,] causal, [in_bf16,] out_bf16
        n_int = {"dps_flash_bwd_dkv": 9,
                 "dps_flash_fwd_wgmma": 7}.get(name, 8)
        fn.argtypes = head + [i32] * n_int + [i32, ints, ints, p]
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(what: str, q, k, v, out_dtype, *extra) -> None:
    tensors = (q, k, v) + extra
    if any(x.device != q.device for x in tensors):
        raise ValueError(f"{what}: tensors on different devices")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"{what}: q [BH, Tq, D] and k, v [BH, Tk, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    d = q.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: the kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got D={d}")
    if q.dtype not in _KERNEL_TYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{what}: the kernel takes float32 or bfloat16 "
                         f"q/k/v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if out_dtype not in (torch.float32, q.dtype):
        raise ValueError(f"{what}: output dtype must be float32 or the "
                         f"inputs', got {out_dtype}")
    for name, t in (("Tq", q.shape[1]), ("Tk", k.shape[1])):
        if t == 0 or t % KERNEL_TILE:
            raise ValueError(f"{what}: {name}={t} must be a positive "
                             f"multiple of {KERNEL_TILE}")
    if q.shape[0] > 65535:
        raise ValueError(f"{what}: at most 65535 rows a launch, got "
                         f"{q.shape[0]}")
    for x in tensors:
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must be contiguous and "
                             f"16-byte aligned")


def _slot_args(bh: int, q_offset, k_offset):
    qs, ks = _offsets(q_offset, k_offset)
    if len(qs) > MAX_SLOTS or bh % len(qs):
        raise ValueError(f"{len(qs)} slots: at most {MAX_SLOTS}, and they "
                         f"must divide the {bh} rows")
    arr = ctypes.c_int * len(qs)
    return len(qs), arr(*qs), arr(*ks)


def _launch(name: str, wrapper, args: list, device) -> None:
    fn = _fn(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    with _count_lock:
        wrapper.launches += 1


def _row_vec(x: torch.Tensor, bh: int, t: int, what: str) -> torch.Tensor:
    if x.dtype != torch.float32 or x.numel() != bh * t:
        raise ValueError(f"{what} must be float32 [BH, T, 1], got {x.dtype} "
                         f"{tuple(x.shape)}")
    return x.contiguous()


def flash_fwd(q, k, v, kv_len: int, *, out_dtype=None, causal: bool = False,
              q_offset=0, k_offset=0):
    """K5: ``[BH, Tq, D]`` q against ``[BH, Tk, D]`` k/v -> (O
    ``[BH, Tq, D]`` in ``out_dtype`` or q's dtype, LSE ``[BH, Tq, 1]``
    fp32). One launch on CUDA tensors; the plain version on CPU ones."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, kv_len, out_dtype=out_dtype,
                               causal=causal, q_offset=q_offset,
                               k_offset=k_offset)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash forward: no kernel for device {q.device}")
    out_dtype = out_dtype or q.dtype
    _check_kernel_inputs("flash forward", q, k, v, out_dtype)
    bh, tq, d = q.shape
    o = torch.empty((bh, tq, d), dtype=out_dtype, device=q.device)
    lse = torch.empty((bh, tq, 1), dtype=torch.float32, device=q.device)
    n, qs, ks = _slot_args(bh, q_offset, k_offset)
    _launch("dps_flash_fwd", flash_fwd,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), bh, tq, k.shape[1], d, int(kv_len),
             int(causal), _KERNEL_TYPES[q.dtype],
             _KERNEL_TYPES[out_dtype], n, qs, ks], q.device)
    return o, lse


def _check_wgmma_inputs(what: str, q, k, v, out_dtype, *extra) -> None:
    """The wgmma kernels' checks (the wgmma forward, the fused backward):
    :func:`_check_kernel_inputs`, and bf16 q/k/v."""
    _check_kernel_inputs(what, q, k, v, out_dtype, *extra)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the wgmma kernel takes bfloat16 q/k/v, "
                         f"got {q.dtype}; float32 runs the first version")


def flash_fwd_wgmma(q, k, v, kv_len: int, *, out_dtype=None,
                    causal: bool = False, q_offset=0, k_offset=0):
    """K5 on bf16 inputs, the Hopper ``wgmma`` kernel: the contract of
    :func:`flash_fwd` (O in ``out_dtype`` or bf16, LSE ``[BH, Tq, 1]``
    fp32) in one launch. CUDA tensors only: on the CPU
    :func:`_flash_fwd_impl` routes to the plain version, and this wrapper
    raises on any other device and on float32 inputs."""
    if q.device.type != "cuda":
        raise RuntimeError(f"flash forward (wgmma): no kernel for device "
                           f"{q.device}")
    out_dtype = out_dtype or q.dtype
    _check_wgmma_inputs("flash forward (wgmma)", q, k, v, out_dtype)
    bh, tq, d = q.shape
    o = torch.empty((bh, tq, d), dtype=out_dtype, device=q.device)
    lse = torch.empty((bh, tq, 1), dtype=torch.float32, device=q.device)
    n, qs, ks = _slot_args(bh, q_offset, k_offset)
    _launch("dps_flash_fwd_wgmma", flash_fwd_wgmma,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), bh, tq, k.shape[1], d, int(kv_len),
             int(causal), _KERNEL_TYPES[out_dtype], n, qs, ks], q.device)
    return o, lse


def _bwd_plain_into(q, k, v, do, lse, delta, kv_len: int, dq_acc, *,
                    out_dtype=None, **kw):
    """The plain backward with the fused kernel's contract: dQ is computed
    in fp32 and added into ``dq_acc`` when one is given (and returned),
    else cast to ``out_dtype``."""
    dq, dk, dv = flash_bwd_plain(q, k, v, do, lse, delta, kv_len,
                                 out_dtype=torch.float32, **kw)
    od = out_dtype or q.dtype
    dq = dq.to(od) if dq_acc is None else dq_acc.add_(dq)
    return dq, dk.to(od), dv.to(od)


def flash_bwd(q, k, v, do, lse, delta, kv_len: int, *, dq_acc=None,
              out_dtype=None, causal: bool = False, q_offset=0, k_offset=0,
              q_len: int | None = None):
    """K6 and K7 fused (bf16 inputs): (dQ, dK, dV) in one launch.

    dQ is summed over the key tiles in fp32 in device memory: into
    ``dq_acc`` (fp32, q's shape, contiguous), which is added to and
    returned as dQ, or, without it, into zeros cast to ``out_dtype`` at the
    end. dK and dV come back in ``out_dtype`` (default q's). ``q_len`` is
    the unpadded query length, as for :func:`flash_bwd_dkv`. On CPU tensors
    the plain version, with the same contract."""
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset)
    if q.device.type == "cpu":
        return _bwd_plain_into(q, k, v, do, lse, delta, kv_len, dq_acc,
                               out_dtype=out_dtype, **kw)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash backward: no kernel for device {q.device}")
    out_dtype = out_dtype or q.dtype
    bh, tq, d = q.shape
    q_len = tq if q_len is None else q_len
    lse, delta = _row_vec(lse, bh, tq, "lse"), _row_vec(delta, bh, tq, "delta")
    _check_wgmma_inputs("flash backward", q, k, v, out_dtype, do, lse, delta)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("flash backward: dO must match q's shape and dtype")
    if dq_acc is None:
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    else:
        if dq_acc.dtype != torch.float32 or dq_acc.shape != q.shape \
                or dq_acc.device != q.device or not dq_acc.is_contiguous() \
                or dq_acc.data_ptr() % 16:
            raise ValueError(f"flash backward: dq_acc must be a contiguous, "
                             f"16-byte aligned float32 tensor of q's shape "
                             f"and device, got {dq_acc.dtype} "
                             f"{tuple(dq_acc.shape)} on {dq_acc.device}")
        acc = dq_acc
    dk = torch.empty(k.shape, dtype=out_dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=out_dtype, device=q.device)
    n, qs, ks = _slot_args(bh, q_offset, k_offset)
    _launch("dps_flash_bwd", flash_bwd,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), acc.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), bh, tq, k.shape[1], d, int(kv_len), int(q_len),
             int(causal), _KERNEL_TYPES[out_dtype], n, qs, ks], q.device)
    return (acc.to(out_dtype) if dq_acc is None else acc), dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, kv_len: int, *, out_dtype=None,
                 causal: bool = False, q_offset=0, k_offset=0):
    """K6: dQ ``[BH, Tq, D]`` in ``out_dtype`` or q's dtype."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, kv_len,
                               out_dtype=out_dtype, causal=causal,
                               q_offset=q_offset, k_offset=k_offset)[0]
    if q.device.type != "cuda":
        raise RuntimeError(f"flash backward: no kernel for device {q.device}")
    out_dtype = out_dtype or q.dtype
    bh, tq, d = q.shape
    lse, delta = _row_vec(lse, bh, tq, "lse"), _row_vec(delta, bh, tq, "delta")
    _check_kernel_inputs("flash dQ", q, k, v, out_dtype, do, lse, delta)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("flash dQ: dO must match q's shape and dtype")
    dq = torch.empty((bh, tq, d), dtype=out_dtype, device=q.device)
    n, qs, ks = _slot_args(bh, q_offset, k_offset)
    _launch("dps_flash_bwd_dq", flash_bwd_dq,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, tq,
             k.shape[1], d, int(kv_len), int(causal),
             _KERNEL_TYPES[q.dtype], _KERNEL_TYPES[out_dtype], n, qs, ks],
            q.device)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, kv_len: int, *, out_dtype=None,
                  causal: bool = False, q_offset=0, k_offset=0,
                  q_len: int | None = None):
    """K7: (dK, dV) ``[BH, Tk, D]`` in ``out_dtype`` or k's and v's dtypes.
    ``q_len`` is the unpadded query length: query tiles beyond it carry
    zero dO and delta, and the kernel skips them."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, kv_len,
                               out_dtype=out_dtype, causal=causal,
                               q_offset=q_offset, k_offset=k_offset)[1:]
    if q.device.type != "cuda":
        raise RuntimeError(f"flash backward: no kernel for device {q.device}")
    out_dtype = out_dtype or q.dtype
    bh, tq, d = q.shape
    q_len = tq if q_len is None else q_len
    lse, delta = _row_vec(lse, bh, tq, "lse"), _row_vec(delta, bh, tq, "delta")
    _check_kernel_inputs("flash dK/dV", q, k, v, out_dtype, do, lse, delta)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("flash dK/dV: dO must match q's shape and dtype")
    dk = torch.empty(k.shape, dtype=out_dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=out_dtype, device=q.device)
    n, qs, ks = _slot_args(bh, q_offset, k_offset)
    _launch("dps_flash_bwd_dkv", flash_bwd_dkv,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             bh, tq, k.shape[1], d, int(kv_len), int(q_len), int(causal),
             _KERNEL_TYPES[q.dtype], _KERNEL_TYPES[out_dtype], n, qs, ks],
            q.device)
    return dk, dv


#: Kernel launches since the last reset (set to 0 to start a count).
flash_fwd.launches = 0
flash_fwd_wgmma.launches = 0
flash_bwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


# -- the core op and its gradient ------------------------------------------------

def _fwd_route(device_type: str, dtype, use_kernel: bool) -> str:
    """Which forward :func:`_flash_fwd_impl` runs: ``"wgmma"``
    (:func:`flash_fwd_wgmma`) for bf16 CUDA inputs, ``"k5"`` (the first
    version, :func:`flash_fwd`) for other CUDA inputs, ``"plain"`` on the
    CPU or with ``use_kernel=False``. A dispatch on dtype, not a fallback:
    each kernel raises on what it does not take."""
    if not use_kernel or device_type == "cpu":
        return "plain"
    return "wgmma" if dtype == torch.bfloat16 else "k5"


def _flash_fwd_impl(q, k, v, kv_len: int, *, use_kernel: bool = True,
                    out_dtype=None, causal: bool = False, q_offset=0,
                    k_offset=0):
    """Flash forward on ``[BH, T, D]``, routed by :func:`_fwd_route`.
    ``out_dtype`` reaches only the final cast, so fp32 partials of a ring
    hop are never rounded to q's dtype."""
    kw = dict(out_dtype=out_dtype, causal=causal, q_offset=q_offset,
              k_offset=k_offset)
    route = _fwd_route(q.device.type, q.dtype, use_kernel)
    if route == "wgmma":
        return flash_fwd_wgmma(q, k, v, kv_len, **kw)
    if route == "k5":
        return flash_fwd(q, k, v, kv_len, **kw)
    return flash_fwd_plain(q, k, v, kv_len, **kw)


def _bwd_route(device_type: str, dtype, use_kernel: bool) -> str:
    """Which backward :func:`_flash_bwd_impl` runs: ``"fused"``
    (:func:`flash_bwd`) for bf16 CUDA inputs, ``"k6_k7"``
    (:func:`flash_bwd_dq` then :func:`flash_bwd_dkv`) for other CUDA
    inputs, ``"plain"`` on the CPU or with ``use_kernel=False``. A dispatch
    on dtype, not a fallback: each kernel raises on what it does not take."""
    if not use_kernel or device_type == "cpu":
        return "plain"
    return "fused" if dtype == torch.bfloat16 else "k6_k7"


def _flash_bwd_impl(q, k, v, do, lse, delta, kv_len: int, *,
                    use_kernel: bool = True, out_dtype=None,
                    causal: bool = False, q_offset=0, k_offset=0,
                    q_len: int | None = None, dq_acc=None):
    """Flash backward given external (LSE, delta), shared by
    :class:`_FlashCore` and ring attention's per-hop backward (where they
    come from the merged softmax over the whole ring); routes by
    :func:`_bwd_route`. Returns (dQ, dK, dV); with ``dq_acc`` (fp32, q's
    shape) dQ is added into it in fp32 and dQ is ``dq_acc``."""
    kw = dict(out_dtype=out_dtype, causal=causal, q_offset=q_offset,
              k_offset=k_offset)
    route = _bwd_route(q.device.type, q.dtype, use_kernel)
    if route == "fused":
        return flash_bwd(q, k, v, do, lse, delta, kv_len, dq_acc=dq_acc,
                         q_len=q_len, **kw)
    if route == "plain":
        return _bwd_plain_into(q, k, v, do, lse, delta, kv_len, dq_acc, **kw)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, kv_len, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, kv_len, q_len=q_len,
                           **kw)
    return (dq if dq_acc is None else dq_acc.add_(dq)), dk, dv


class _FlashCore(torch.autograd.Function):
    """Flash attention on ``[BH, T_pad, D]`` with the flash backward (the
    reference's ``_flash_core`` custom VJP): saves (q, k, v, O, LSE);
    delta = rowsum(dO * O) in fp32."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len: int, use_kernel: bool, causal: bool):
        o, lse = _flash_fwd_impl(q, k, v, kv_len, use_kernel=use_kernel,
                                 causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kv_len, ctx.use_kernel, ctx.causal = kv_len, use_kernel, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        # Self-attention: q and k share the unpadded length, q_len=kv_len.
        dq, dk, dv = _flash_bwd_impl(
            q, k, v, do.to(q.dtype).contiguous(), lse, delta, ctx.kv_len,
            use_kernel=ctx.use_kernel, causal=ctx.causal, q_len=ctx.kv_len)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    use_kernel: bool | None = None) -> torch.Tensor:
    """Fused attention over ``[B, T, H, D]`` q/k/v (causal optional), the
    contract of ``models/vit.py``'s ``attention_fn``. Differentiable.

    ``use_kernel=None`` dispatches on :func:`flash_preferred`: below it
    the result is :func:`~.attention.dense_core` under autograd; above it
    the flash kernels. ``True`` forces the kernel wrappers (the plain
    version on CPU tensors), ``False`` the plain version with the flash
    backward. T is padded to the next multiple of 128, the length the
    reference's default blocks (:func:`pick_block`) pad to."""
    b, t, h, d = q.shape
    if use_kernel is None:
        if not flash_preferred(t, q.device):
            return dense_core(q, k, v, causal=causal)
        use_kernel = True
    tp = -(-t // 128) * 128

    def to3(x):
        x = x.permute(0, 2, 1, 3).reshape(b * h, t, d)
        return torch.nn.functional.pad(x, (0, 0, 0, tp - t)) if tp != t \
            else x.contiguous()

    o3 = _FlashCore.apply(to3(q), to3(k), to3(v), t, bool(use_kernel),
                          bool(causal))
    o = o3[:, :t].reshape(b, h, t, d)
    return o.permute(0, 2, 1, 3).to(q.dtype)
