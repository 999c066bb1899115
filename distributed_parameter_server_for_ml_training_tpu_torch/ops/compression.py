"""Gradient compression: the host-side wire codecs of the async store.

The reference's "compression" is an fp32->fp16 cast before pickling
(src/workers/worker.py:264-268) and a cast back on the server
(src/parameter_server/server.py:232-237) — ~50% wire bytes, logged at
worker.py:292.

This is the NumPy codec family of the JAX package's ``ops/compression.py``,
carried over unchanged apart from its tree maps (flat dicts here, so dict
comprehensions): fp16/bf16 casts, per-tensor int8, packed int4, top-k
triples, error feedback and the compressed-domain mean. Payloads are the
same named-tensor dicts byte for byte, so a store of either package
decodes a worker of either package. The one torch function is the
reduced-precision cast for a collective, kept for the sync slice.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .packed import PackedInt4, as_packed_int4, pack_nibbles, unpack_nibbles

#: The push/fetch wire-codec vocabulary (docs/WIRE_PROTOCOL.md's codec
#: table); the same keys as the JAX package's catalog.
#: 'bf16' is fetch-side only; 'adaptive' is a worker-side per-layer
#: CHOICE among int8/int4/topk, not a wire form of its own.
CODEC_CATALOG = {
    "none": "fp32 tensors, reference parity",
    "fp16": "fp32->fp16 cast (the reference's push codec)",
    "bf16": "fp32->bfloat16 cast (fetch-side parameter codec)",
    "int8": "per-tensor symmetric int8 + ::int8scale companion",
    "int4": "packed-nibble int4 (wire dtype) + ::int4scale companion",
    "topk": "top-k sparsification: (indices, int8 values, scale) triple",
    "adaptive": "per-layer int8/int4/topk chosen from link pressure",
}

#: Push codecs whose payloads are quantized named-tensor dicts the server
#: can hold (and, in sync mode, accumulate) without decoding to fp32.
QUANTIZED_PUSH_CODECS = ("int8", "int4", "topk", "adaptive")

#: Every valid push codec (CODEC_CATALOG minus the fetch-only bf16) —
#: the store validates against THIS, so a catalog change propagates.
PUSH_CODECS = tuple(k for k in CODEC_CATALOG if k != "bf16")

_ALLREDUCE_DTYPES = {
    "none": None,
    "fp32": None,
    "bf16": torch.bfloat16,
    "fp16": torch.float16,
}


def compress_for_allreduce(grads: dict, mode: str = "bf16") -> dict:
    """Cast gradients for the wire (the collective). No-op for 'none'."""
    dtype = _ALLREDUCE_DTYPES[mode]
    if dtype is None:
        return grads
    return {k: g.to(dtype) for k, g in grads.items()}


def decompress_from_allreduce(grads: dict, mode: str = "bf16") -> dict:
    """Restore fp32 after the collective (server.py:232-237 analogue)."""
    if _ALLREDUCE_DTYPES[mode] is None:
        return grads
    return {k: g.to(torch.float32) for k, g in grads.items()}


# ---------------------------------------------------------------------------
# Host-side wire codecs for the async parameter store.
# ---------------------------------------------------------------------------

def _stage_f32(a) -> np.ndarray:
    """Zero-copy fp32 staging for the cast codecs: an array that is
    already fp32 is returned AS ITSELF (``astype(copy=False)``), so the
    narrowing cast is the push's only allocation — the old
    ``np.asarray(a, np.float32)`` staging materialized an intermediate
    fp32 copy for non-f32 inputs before the real cast."""
    return np.asarray(a).astype(np.float32, copy=False)


# The four casts below return their keys SORTED, as the JAX package's
# ``jax.tree_util.tree_map`` over a dict does: a bf16/fp16 fetch reply and
# an fp16 push frame carry the tensors in that order on the wire.

# dpslint: hot-path
def fp16_compress(tree: Mapping) -> dict:
    """fp32 -> fp16 cast, exactly the reference's compress_gradients
    (worker.py:264-268)."""
    return {k: _stage_f32(tree[k]).astype(np.float16, copy=False)
            for k in sorted(tree)}


def fp16_decompress(tree: Mapping) -> dict:
    """fp16 -> fp32, exactly decompress_gradients (server.py:232-237)."""
    return {k: np.asarray(tree[k]).astype(np.float32) for k in sorted(tree)}


# dpslint: hot-path
def bf16_compress(tree: Mapping) -> dict:
    """fp32 -> bfloat16 cast (round-to-nearest-even via ml_dtypes).

    The FETCH-side codec the reference never had: its dominant server cost
    was re-pickling ~45 MB of fp32 parameters per fetch (server.py:222,
    SURVEY §3.1). bf16 halves those bytes while keeping fp32's full
    exponent range — for PARAMETERS (which span many orders of magnitude
    across layers) that matters more than fp16's extra mantissa bits."""
    import ml_dtypes

    return {k: _stage_f32(tree[k]).astype(ml_dtypes.bfloat16, copy=False)
            for k in sorted(tree)}


def bf16_decompress(tree: Mapping) -> dict:
    """bfloat16 -> fp32 (exact: bf16 values are representable in fp32)."""
    return {k: np.asarray(tree[k]).astype(np.float32) for k in sorted(tree)}


def int8_quantize(a: np.ndarray) -> tuple[np.ndarray, np.float32]:
    """Per-tensor symmetric int8 quantization: returns (q, scale).

    Non-finite inputs raise: quantizing inf/NaN would cast undefined
    int8 garbage the server then applies as plausible-looking gradients
    — the fp16 codec propagates the non-finite values visibly, and this
    codec must not silently corrupt where fp16 would surface the
    blow-up."""
    a = np.asarray(a, np.float32)
    amax = float(np.max(np.abs(a))) if a.size else 0.0
    if not np.isfinite(amax):
        raise ValueError("int8_quantize: non-finite values in input "
                         "(diverging gradients?)")
    scale = np.float32(amax / 127.0) if amax > 0 else np.float32(1.0)
    q = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
    return q, scale


def int8_dequantize(q: np.ndarray, scale: np.float32) -> np.ndarray:
    return q.astype(np.float32) * np.float32(scale)


# int8 WIRE codec over named-tensor dicts: each fp32 tensor rides as int8
# values plus a scale entry under ``name + _SCALE_SUFFIX``. The suffix
# convention keeps the existing no-pickle wire format (comms/wire.py)
# unchanged — scales are just more named tensors.
_SCALE_SUFFIX = "::int8scale"


def int8_wire_compress(tensors: dict) -> dict:
    """{name: fp32 array} -> {name: int8 array, name::int8scale: fp32[1]}
    (~1/4 of fp32's wire bytes; half of the fp16 codec's)."""
    out: dict = {}
    for name, a in tensors.items():
        q, scale = int8_quantize(a)
        out[name] = q
        out[name + _SCALE_SUFFIX] = np.asarray([scale], np.float32)
    return out


def int8_wire_decompress(tensors: dict) -> dict:
    """Inverse of :func:`int8_wire_compress`; tolerates already-fp32
    entries (mixed payloads) by passing them through WITHOUT copying
    (``astype(..., copy=False)`` — an unconditional ``astype`` re-copied
    the whole zero-copy wire view per push for nothing)."""
    out: dict = {}
    for name, a in tensors.items():
        if name.endswith(_SCALE_SUFFIX):
            continue
        a = np.asarray(a)
        if a.dtype == np.int8:
            scale = tensors.get(name + _SCALE_SUFFIX)
            if scale is None:
                raise ValueError(f"int8 wire entry {name!r} missing its "
                                 f"{_SCALE_SUFFIX} companion")
            out[name] = int8_dequantize(a, np.float32(np.asarray(scale)[0]))
        else:
            out[name] = a.astype(np.float32, copy=False)
    return out


# ---------------------------------------------------------------------------
# Compressed-domain push codecs (docs/WIRE_PROTOCOL.md):
#
#   int4  — packed-nibble symmetric quantization (the wire's "int4" dtype;
#           ~1/8 of fp32's bytes),
#   topk  — top-k sparsification, riding the named-tensor wire as an
#           (indices, int8 values, scale) triple per tensor,
#   shared-scale int8/int4 — quantize against the SERVER's per-layer scale
#           so the aggregator can sum payloads in the integer domain (THC,
#           PAPERS.md) and dequantize once per round,
#   ErrorFeedback — worker-side residual carry that makes the aggressive
#           codecs accuracy-safe,
#   homomorphic_mean — the server-side compressed-domain aggregation.
#
# All payloads stay self-describing named-tensor dicts: scales and sparse
# companions are just more named tensors under reserved suffixes, so the
# wire format (comms/wire.py) and the exactly-once/envelope machinery are
# untouched.
# ---------------------------------------------------------------------------

_INT4_SCALE_SUFFIX = "::int4scale"
_TOPK_IDX_SUFFIX = "::topk_idx"
_TOPK_VAL_SUFFIX = "::topk_val"
_TOPK_SCALE_SUFFIX = "::topk_scale"
_TOPK_SHAPE_SUFFIX = "::topk_shape"

_COMPANION_SUFFIXES = (
    _SCALE_SUFFIX, _INT4_SCALE_SUFFIX, _TOPK_IDX_SUFFIX, _TOPK_VAL_SUFFIX,
    _TOPK_SCALE_SUFFIX, _TOPK_SHAPE_SUFFIX,
)


def _require_finite(a: np.ndarray, who: str) -> None:
    """Every quantization path must surface NaN/Inf gradients instead of
    casting them to plausible-looking int garbage — and a NaN that slipped
    into an ErrorFeedback residual would poison every later push of that
    layer (same rationale as int8_quantize's guard)."""
    if a.size and not np.isfinite(float(np.max(np.abs(a)))):
        raise ValueError(f"{who}: non-finite values in input "
                         f"(diverging gradients?)")


def int8_quantize_with_scale(a: np.ndarray,
                             scale: float) -> np.ndarray:
    """Symmetric int8 quantization against a GIVEN scale (the shared-scale
    path): values beyond ±127·scale clip — error feedback carries the
    clipped mass into the next step."""
    a = np.asarray(a, np.float32)
    _require_finite(a, "int8_quantize_with_scale")
    return np.clip(np.rint(a / np.float32(scale)), -127, 127).astype(np.int8)


def int4_quantize(a: np.ndarray, scale: float | None = None
                  ) -> tuple[PackedInt4, np.float32]:
    """Per-tensor symmetric int4 quantization -> (packed nibbles, scale).

    Levels are [-7, 7] (the -8 code is unused so the scheme stays
    symmetric). Like :func:`int8_quantize`, non-finite inputs raise —
    with or without a caller-given shared scale."""
    a = np.asarray(a, np.float32)
    if scale is None:
        amax = float(np.max(np.abs(a))) if a.size else 0.0
        if not np.isfinite(amax):
            raise ValueError("int4_quantize: non-finite values in input "
                             "(diverging gradients?)")
        scale = np.float32(amax / 7.0) if amax > 0 else np.float32(1.0)
    else:
        _require_finite(a, "int4_quantize")
    scale = np.float32(scale)
    q = np.clip(np.rint(a / scale), -7, 7).astype(np.int8)
    return as_packed_int4(pack_nibbles(q), a.shape), scale


def int4_dequantize(packed: PackedInt4, scale) -> np.ndarray:
    shape = packed.logical_shape
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    q = unpack_nibbles(np.asarray(packed, np.uint8), n)
    return (q.astype(np.float32) * np.float32(scale)).reshape(shape)


def topk_compress_tensor(a: np.ndarray, frac: float = 0.01,
                         min_k: int = 1) -> dict:
    """One tensor -> its sparse wire triple (+ shape companion):
    ``{name::topk_idx: int32[k], name::topk_val: int8[k],
    name::topk_scale: fp32[1], name::topk_shape: int64[ndim]}`` — the
    largest-magnitude ``k = max(min_k, frac·n)`` entries, int8-quantized.
    Returns the dict of companion arrays WITHOUT the name prefixes; the
    caller attaches them."""
    a = np.asarray(a, np.float32)
    flat = a.reshape(-1)
    k = min(flat.size, max(min_k, int(round(frac * flat.size))))
    if not np.all(np.isfinite(flat)):
        raise ValueError("topk_compress_tensor: non-finite values in input")
    idx = np.argpartition(np.abs(flat), flat.size - k)[flat.size - k:]
    idx = np.sort(idx).astype(np.int32)
    vals = flat[idx]
    amax = float(np.max(np.abs(vals))) if k else 0.0
    scale = np.float32(amax / 127.0) if amax > 0 else np.float32(1.0)
    q = np.clip(np.rint(vals / scale), -127, 127).astype(np.int8)
    return {
        _TOPK_IDX_SUFFIX: idx,
        _TOPK_VAL_SUFFIX: q,
        _TOPK_SCALE_SUFFIX: np.asarray([scale], np.float32),
        _TOPK_SHAPE_SUFFIX: np.asarray(a.shape, np.int64),
    }


def topk_dense(idx: np.ndarray, q: np.ndarray, scale, shape) -> np.ndarray:
    """Scatter a sparse triple back to a dense fp32 tensor."""
    out = np.zeros(int(np.prod(shape, dtype=np.int64)), np.float32)
    out[np.asarray(idx, np.int64)] = \
        np.asarray(q, np.float32) * np.float32(scale)
    return out.reshape(tuple(int(s) for s in shape))


class ErrorFeedback:
    """Worker-side error-feedback residual (1-bit SGD / EF-SGD lineage;
    PAPERS.md "Utility of Gradient Compression"): the quantization error of
    each push is kept and added to the next step's gradient, so the
    compressed updates sum to the true gradient over time — the property
    that makes int4 and top-k sparsification accuracy-safe."""

    def __init__(self):
        self._residual: dict[str, np.ndarray] = {}

    def add_to(self, name: str, grad: np.ndarray) -> np.ndarray:
        r = self._residual.get(name)
        g = np.asarray(grad, np.float32)
        return g if r is None else g + r

    def store(self, name: str, total: np.ndarray,
              decoded: np.ndarray) -> None:
        self._residual[name] = np.asarray(total, np.float32) \
            - np.asarray(decoded, np.float32)

    def reset(self) -> None:
        self._residual.clear()


def compress_push(tensors: Mapping[str, np.ndarray],
                  plan: Mapping[str, str] | None = None,
                  scales: Mapping[str, float] | None = None,
                  ef: ErrorFeedback | None = None,
                  topk_frac: float = 0.01) -> dict:
    """Encode a push payload per-layer: ``plan[name]`` picks
    ``'int8' | 'int4' | 'topk' | 'none'`` (default int8). ``scales`` is the
    server-published per-layer ABSMAX table (shared-scale quantization —
    when present for a layer, int8/int4 quantize against it so the server
    can accumulate in the integer domain); ``ef`` threads the
    error-feedback residual through every quantized layer."""
    plan = plan or {}
    scales = scales or {}
    out: dict = {}
    for name, a in tensors.items():
        kind = plan.get(name, "int8")
        a32 = np.asarray(a, np.float32)
        if kind == "none":
            out[name] = a32
            continue
        total = ef.add_to(name, a32) if ef is not None else a32
        absmax = scales.get(name)
        if kind == "topk":
            triple = topk_compress_tensor(total, frac=topk_frac)
            for suffix, arr in triple.items():
                out[name + suffix] = arr
            if ef is not None:
                ef.store(name, total, topk_dense(
                    triple[_TOPK_IDX_SUFFIX], triple[_TOPK_VAL_SUFFIX],
                    triple[_TOPK_SCALE_SUFFIX][0], total.shape))
        elif kind == "int4":
            scale = np.float32(absmax / 7.0) \
                if absmax and absmax > 0 else None
            packed, scale = int4_quantize(total, scale)
            out[name] = packed
            out[name + _INT4_SCALE_SUFFIX] = \
                np.asarray([scale], np.float32)
            if ef is not None:
                ef.store(name, total, int4_dequantize(packed, scale))
        else:  # int8
            if absmax and absmax > 0:
                scale = np.float32(absmax / 127.0)
                q = int8_quantize_with_scale(total, scale)
            else:
                q, scale = int8_quantize(total)
            out[name] = q
            out[name + _SCALE_SUFFIX] = np.asarray([scale], np.float32)
            if ef is not None:
                ef.store(name, total, int8_dequantize(q, scale))
    return out


def _iter_logical(tensors: Mapping[str, np.ndarray]):
    """Yield ``(name, kind, payload)`` logical entries of a (possibly
    quantized) named-tensor payload. ``payload``: int8 -> (q, scale);
    int4 -> (packed, scale); topk -> (idx, q, scale, shape);
    dense -> the array."""
    for name, a in tensors.items():
        if any(name.endswith(s) for s in _COMPANION_SUFFIXES):
            if name.endswith(_TOPK_IDX_SUFFIX):
                base = name[:-len(_TOPK_IDX_SUFFIX)]
                scale = tensors.get(base + _TOPK_SCALE_SUFFIX)
                shape = tensors.get(base + _TOPK_SHAPE_SUFFIX)
                q = tensors.get(base + _TOPK_VAL_SUFFIX)
                if scale is None or shape is None or q is None:
                    raise ValueError(
                        f"topk entry {base!r} missing companions")
                idx = np.asarray(a)
                q = np.asarray(q)
                lshape = tuple(int(s) for s in np.asarray(shape))
                # Validate HERE, not at consumption time: a malformed
                # sparse push must be refused at the push that carried it
                # — an out-of-range index surfacing later, inside the
                # round-completing scatter, would fail a DIFFERENT
                # worker's RPC and throw away the whole round.
                n = int(np.prod(lshape, dtype=np.int64))
                if idx.size != q.size:
                    raise ValueError(
                        f"topk entry {base!r}: {idx.size} indices vs "
                        f"{q.size} values")
                if idx.size and not np.issubdtype(idx.dtype, np.integer):
                    raise ValueError(
                        f"topk entry {base!r}: non-integer indices "
                        f"({idx.dtype})")
                if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= n):
                    raise ValueError(
                        f"topk entry {base!r}: index out of range for "
                        f"shape {lshape}")
                yield base, "topk", (idx, q,
                                     np.float32(np.asarray(scale)[0]),
                                     lshape)
            continue
        if isinstance(a, PackedInt4):
            scale = tensors.get(name + _INT4_SCALE_SUFFIX)
            if scale is None:
                raise ValueError(f"int4 wire entry {name!r} missing its "
                                 f"{_INT4_SCALE_SUFFIX} companion")
            yield name, "int4", (a, np.float32(np.asarray(scale)[0]))
            continue
        a = np.asarray(a)
        if a.dtype == np.int8:
            scale = tensors.get(name + _SCALE_SUFFIX)
            if scale is None:
                raise ValueError(f"int8 wire entry {name!r} missing its "
                                 f"{_SCALE_SUFFIX} companion")
            yield name, "int8", (a, np.float32(np.asarray(scale)[0]))
            continue
        yield name, "dense", a


def is_quantized_payload(tensors: Mapping[str, np.ndarray]) -> bool:
    """True when the payload carries any quantized (int8/int4/topk)
    entries — cheap key/dtype scan, no decode."""
    for name, a in tensors.items():
        if any(name.endswith(s) for s in _COMPANION_SUFFIXES):
            return True
        if isinstance(a, PackedInt4):
            return True
        if isinstance(a, np.ndarray) and a.dtype == np.int8:
            return True
    return False


def payload_logical_shapes(tensors: Mapping[str, np.ndarray]
                           ) -> dict[str, tuple]:
    """Logical (dequantized) tensor shapes of a payload, WITHOUT decoding
    — the store's shape guard runs on these for quantized pushes."""
    return {name: (payload[0].logical_shape if kind == "int4"
                   else payload[3] if kind == "topk"
                   else np.asarray(payload[0] if kind == "int8"
                                   else payload).shape)
            for name, kind, payload in _iter_logical(tensors)}


def wire_decompress(tensors: Mapping[str, np.ndarray]) -> dict:
    """Decode ANY push payload to dense fp32: int8/int4/topk entries
    dequantize with their carried scales, fp16/bf16 cast up, fp32 passes
    through without copying. The async apply path uses this (one incoming
    tensor dict, dequantized at apply time with its carried scale)."""
    out: dict = {}
    for name, kind, payload in _iter_logical(tensors):
        if kind == "int8":
            out[name] = int8_dequantize(*payload)
        elif kind == "int4":
            out[name] = int4_dequantize(*payload)
        elif kind == "topk":
            out[name] = topk_dense(*payload)
        else:
            out[name] = np.asarray(payload).astype(np.float32, copy=False)
    return out


def homomorphic_mean(grad_dicts: list) -> dict:
    """Compressed-domain sync aggregation (THC-style; PAPERS.md
    arXiv:2302.08545): the per-worker mean of possibly-quantized payloads
    WITHOUT a per-push fp32 decode.

    int8 and int4 entries accumulate in per-layer **int32** accumulators,
    grouped by their carried scale (shared-scale pushes all land in one
    group — one dequantize per layer per ROUND); entries that don't share
    a scale, plus top-k and dense entries, fold into an fp32 side
    accumulator. Semantics mirror :func:`...ps.semantics.mean_gradients`:
    parameter names come from the first worker's push, each averaged over
    only the workers that supplied it."""
    if not grad_dicts:
        return {}
    parsed = []
    for d in grad_dicts:
        parsed.append({name: (kind, payload)
                       for name, kind, payload in _iter_logical(d)})
    out: dict = {}
    for name in parsed[0]:
        int_groups: dict[float, np.ndarray] = {}
        f32_acc = None
        shape = None
        valid = 0
        for p in parsed:
            entry = p.get(name)
            if entry is None:
                continue
            kind, payload = entry
            valid += 1
            if kind in ("int8", "int4"):
                if kind == "int8":
                    q, scale = payload
                    if shape is None:
                        shape = q.shape
                    q = q.reshape(-1)
                else:
                    packed, scale = payload
                    if shape is None:
                        shape = packed.logical_shape
                    q = unpack_nibbles(
                        np.asarray(packed, np.uint8),
                        int(np.prod(packed.logical_shape,
                                    dtype=np.int64)))
                key = float(scale)
                acc = int_groups.get(key)
                if acc is None:
                    int_groups[key] = q.astype(np.int32)
                else:
                    acc += q  # int8 adds into the int32 accumulator
            else:
                if kind == "topk":
                    dense = topk_dense(*payload)
                else:
                    dense = np.asarray(payload, np.float32)
                if shape is None:
                    shape = dense.shape
                f32_acc = dense.reshape(-1).astype(np.float32, copy=True) \
                    if f32_acc is None else f32_acc + dense.reshape(-1)
        if valid == 0:
            continue
        total = f32_acc
        for scale, acc in int_groups.items():
            part = acc.astype(np.float32) * np.float32(scale)
            total = part if total is None else total + part
        out[name] = (total / np.float32(valid)).reshape(shape)
    return out
