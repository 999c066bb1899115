"""Device-resident push codec: quantize + pack on the card.

Counterpart of the JAX package's ``ops/device_codec.py``. The NumPy codec
family (:mod:`.compression`) is the host reference: a quantized push there
starts with a full fp32 device->host copy of the gradients (~45 MB for
ResNet-18, ~102 MB for ResNet-50). This codec keeps the error-feedback
carry, the quantize (kernel K1, :mod:`.quantize`), the int4 nibble pack
and the top-k select on the device, and copies only the wire buffers to
the host.

Bit-identity contract: the payload :meth:`DeviceCodec.encode` produces is
byte-for-byte what :func:`.compression.compress_push` produces for the
same gradients, plan, shared-scale table, error-feedback history and
``topk_frac``. What makes that hold:

- scales are computed ON THE HOST from device-reduced absmax values with
  the reference's exact expression (``np.float32(float(amax) / 127.0)``:
  a float64 divide then one fp32 round);
- quantization is a true division + round-half-even + the same clamp
  (K1 and its plain version);
- nibble packing matches ops/packed.py bit for bit;
- top-k selection matches the NumPy selection whenever the k-th
  magnitude is unique;
- error-feedback residuals are ``total - decoded`` in fp32, where
  ``decoded = q * scale`` is materialized first, so the subtraction
  rounds separately, exactly like ``ErrorFeedback.store``.

Encode runs three phases like the reference: stats (EF totals, absmax,
top-k selects), one host pull of every absmax scalar stacked together,
then encode (one K1 launch over every quantized tensor of the push, the
int4 pack) and, under EF, the residual. ``encode()`` starts non-blocking
copies of the wire buffers into pinned host memory — the int8 codes of
every int8 and top-k entry as one copy of K1's flat buffer — and records
an event; ``finalize()`` waits on that event and assembles the NumPy wire
dict.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch

from ..utils.device import resolve_device
from .compression import (
    _INT4_SCALE_SUFFIX,
    _SCALE_SUFFIX,
    _TOPK_IDX_SUFFIX,
    _TOPK_SCALE_SUFFIX,
    _TOPK_SHAPE_SUFFIX,
    _TOPK_VAL_SUFFIX,
)
from .packed import as_packed_int4
from .quantize import pack_nibbles_device, topk_select_flat, \
    wire_quantize_multi

__all__ = ["DeviceCodec", "DevicePayload", "is_device_tree"]


def is_device_tree(tree: Mapping[str, Any]) -> bool:
    """True when every leaf of a flat dict is a torch tensor — the
    precondition for running the device codec. NumPy trees take the
    NumPy reference path."""
    leaves = list(tree.values())
    return bool(leaves) and all(isinstance(a, torch.Tensor) for a in leaves)


# -- phases ---------------------------------------------------------------

def _phase_stats(flat, residuals, plan, ks, use_ef):
    """Phase 1: EF-carried totals, per-tensor absmax, top-k selects (and
    the absmax of each top-k selection, whose scale comes from it)."""
    totals, amax, topk = {}, {}, {}
    for name, kind in plan:
        g = flat[name].to(torch.float32)
        r = residuals.get(name) if use_ef else None
        t = g if (r is None or kind == "none") else g + r
        totals[name] = t
        if kind == "none":
            continue
        # Whole-tensor absmax doubles as the finite guard: NaN propagates
        # through max and inf survives it, so isfinite(amax) on the host
        # is exactly the reference's _require_finite.
        amax[name] = t.abs().max() if t.numel() else t.new_zeros(())
        if kind == "topk":
            idx, vals = topk_select_flat(t, ks[name])
            topk[name] = (idx, vals)
            amax[name + _TOPK_VAL_SUFFIX] = vals.abs().max() \
                if vals.numel() else vals.new_zeros(())
    return totals, amax, topk


def _phase_encode(totals, topk, scales, plan, use_ef):
    """Phase 2: quantize every quantized entry in one call of K1 against
    the host-computed scales, int8 entries and top-k values first, then
    int4; pack the int4 codes. Returns the wire buffers other than int8
    codes, K1's flat code buffer, each int8 wire entry's ``(offset,
    shape)`` in it, the byte length of its int8 part (which those entries
    fill) and, under EF, the decoded dequantizations."""
    wire, decoded, code_at = {}, {}, {}
    jobs = [(name, kind) for name, kind in plan if kind in ("int8", "topk")]
    jobs += [(name, kind) for name, kind in plan if kind == "int4"]
    xs = [(topk[name][1] if kind == "topk" else totals[name]).contiguous()
          for name, kind in jobs]
    codes, views, offsets = wire_quantize_multi(
        xs, [scales[name] for name, _ in jobs],
        [7 if kind == "int4" else 127 for _, kind in jobs])
    n_int8 = sum(kind != "int4" for _, kind in jobs)
    int8_bytes = offsets[n_int8] if n_int8 < len(jobs) else codes.numel()
    for (name, kind), q, off in zip(jobs, views, offsets):
        t, s = totals[name], scales[name]
        if kind == "topk":
            idx = topk[name][0]
            wire[name + _TOPK_IDX_SUFFIX] = idx
            code_at[name + _TOPK_VAL_SUFFIX] = (off, tuple(q.shape))
            if use_ef:
                dense = torch.zeros(t.numel(), dtype=torch.float32,
                                    device=t.device)
                dense[idx.long()] = q.to(torch.float32) * float(s)
                decoded[name] = dense.reshape(t.shape)
            continue
        if kind == "int4":
            wire[name] = pack_nibbles_device(q)
        else:
            code_at[name] = (off, tuple(q.shape))
        if use_ef:
            decoded[name] = q.to(torch.float32) * float(s)
    for name, kind in plan:
        if kind == "none":
            wire[name] = totals[name]
    return wire, codes, code_at, int8_bytes, decoded


def _phase_residual(totals, decoded):
    """Phase 3 (EF only): next residuals = total - decoded."""
    return {name: totals[name] - d for name, d in decoded.items()}


# -- host orchestration -------------------------------------------------------

@dataclass
class DevicePayload:
    """An in-flight device-encoded push.

    ``device_entries`` are the wire buffers other than int8 codes, being
    copied to (pinned) host memory behind ``ready``; ``codes`` is K1's
    int8 code buffer (its int8 part, on the host for a CUDA codec), which
    holds each int8 entry at ``code_at[name] = (offset, shape)``;
    ``host_entries`` are the tiny host-built companions (fp32 scales,
    int64 shapes). ``order`` is the exact wire dict key order the NumPy
    reference emits — frame bytes depend on it."""
    order: list
    device_entries: dict
    codes: Any
    code_at: dict
    host_entries: dict
    int4_shapes: dict
    pre_bytes: int
    encode_seconds: float
    ready: Any = None


class DeviceCodec:
    """Stateful device-side equivalent of ``compress_push`` + its
    ``ErrorFeedback`` — residuals live as device tensors between pushes."""

    def __init__(self, *, error_feedback: bool = True,
                 topk_frac: float = 0.01,
                 device: str | torch.device = "cuda"):
        self.error_feedback = bool(error_feedback)
        self.topk_frac = float(topk_frac)
        self.device = resolve_device(device)
        self._residual: dict[str, torch.Tensor] = {}

    def reset(self) -> None:
        """Drop EF residuals (parity with ``ErrorFeedback.reset``)."""
        self._residual.clear()

    # The reference's top-k sizing, verbatim (Python round half-even).
    @staticmethod
    def _topk_k(n: int, frac: float, min_k: int = 1) -> int:
        return min(n, max(min_k, int(round(frac * n))))

    def encode(self, flat: Mapping[str, Any],
               plan: Mapping[str, str] | None = None,
               scales: Mapping[str, float] | None = None) -> DevicePayload:
        """Run the device encode for one push; returns with the wire
        copies in flight. Argument semantics (plan kinds, shared-scale
        table, non-finite ValueError) match
        :func:`.compression.compress_push`."""
        t0 = time.perf_counter()
        plan = plan or {}
        scales = scales or {}
        flat = {k: torch.as_tensor(v, device=self.device)
                for k, v in flat.items()}
        plan_t = tuple((name, plan.get(name, "int8")) for name in flat)
        ks = {name: self._topk_k(a.numel(), self.topk_frac)
              for name, a in flat.items()
              if plan.get(name, "int8") == "topk"}

        totals, amax_dev, topk = _phase_stats(
            flat, self._residual, plan_t, ks, self.error_feedback)
        # The one sync point: every absmax scalar in one pull.
        amax = dict(zip(amax_dev, torch.stack(list(amax_dev.values()))
                        .tolist())) if amax_dev else {}

        scale_host: dict[str, np.float32] = {}
        for name, kind in plan_t:
            if kind == "none":
                continue
            a = amax[name]
            if not np.isfinite(a):
                raise ValueError(f"device codec [{kind}] '{name}': "
                                 "non-finite values in input "
                                 "(diverging gradients?)")
            absmax = scales.get(name)
            if kind == "topk":
                # The scale comes from the SELECTED values' absmax.
                amax_v = amax[name + _TOPK_VAL_SUFFIX]
                scale_host[name] = np.float32(amax_v / 127.0) \
                    if amax_v > 0 else np.float32(1.0)
            elif kind == "int4":
                scale_host[name] = np.float32(absmax / 7.0) \
                    if absmax and absmax > 0 \
                    else (np.float32(a / 7.0) if a > 0 else np.float32(1.0))
            else:
                scale_host[name] = np.float32(absmax / 127.0) \
                    if absmax and absmax > 0 \
                    else (np.float32(a / 127.0) if a > 0 else np.float32(1.0))

        wire_dev, codes, code_at, int8_bytes, decoded = _phase_encode(
            totals, topk, scale_host, plan_t, self.error_feedback)
        if self.error_feedback:
            self._residual = _phase_residual(totals, decoded)

        order, host_entries, int4_shapes = [], {}, {}
        for name, kind in plan_t:
            shape = tuple(flat[name].shape)
            if kind == "none":
                order.append(name)
                continue
            if kind == "topk":
                order += [name + _TOPK_IDX_SUFFIX, name + _TOPK_VAL_SUFFIX,
                          name + _TOPK_SCALE_SUFFIX, name + _TOPK_SHAPE_SUFFIX]
                host_entries[name + _TOPK_SCALE_SUFFIX] = \
                    np.asarray([scale_host[name]], np.float32)
                host_entries[name + _TOPK_SHAPE_SUFFIX] = \
                    np.asarray(shape, np.int64)
                continue
            suffix = _INT4_SCALE_SUFFIX if kind == "int4" else _SCALE_SUFFIX
            order += [name, name + suffix]
            host_entries[name + suffix] = \
                np.asarray([scale_host[name]], np.float32)
            if kind == "int4":
                int4_shapes[name] = shape

        ready = None
        if self.device.type == "cuda":
            # The int8 codes of every int8 and top-k entry come over as one
            # copy of the int8 part of K1's buffer, into a pinned buffer of
            # this push's own: the payload's NumPy views outlive the push.
            host_codes = torch.empty(int8_bytes, dtype=torch.int8,
                                     pin_memory=True)
            host_codes.copy_(codes[:int8_bytes], non_blocking=True)
            codes = host_codes
            pinned = {}
            for name, arr in wire_dev.items():
                host = torch.empty(arr.shape, dtype=arr.dtype,
                                   pin_memory=True)
                host.copy_(arr, non_blocking=True)
                pinned[name] = host
            wire_dev = pinned
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        pre_bytes = sum(4 * a.numel() for a in flat.values())
        return DevicePayload(
            order=order,
            device_entries=wire_dev,
            codes=codes,
            code_at=code_at,
            host_entries=host_entries,
            int4_shapes=int4_shapes,
            pre_bytes=pre_bytes,
            encode_seconds=time.perf_counter() - t0,
            ready=ready)

    def finalize(self, payload: DevicePayload) -> dict:
        """Assemble the NumPy wire dict from an in-flight payload, waiting
        for its host copies first."""
        if payload.ready is not None:
            payload.ready.synchronize()
        host = {k: v.numpy() for k, v in payload.device_entries.items()}
        codes = payload.codes.numpy()
        out: dict = {}
        for name in payload.order:
            if name in payload.host_entries:
                out[name] = payload.host_entries[name]
            elif name in payload.code_at:
                off, shape = payload.code_at[name]
                out[name] = codes[off:off + math.prod(shape)].reshape(shape)
            elif name in payload.int4_shapes:
                out[name] = as_packed_int4(
                    np.ascontiguousarray(host[name]),
                    payload.int4_shapes[name])
            else:
                out[name] = host[name]
        return out

    def encode_now(self, flat: Mapping[str, Any],
                   plan: Mapping[str, str] | None = None,
                   scales: Mapping[str, float] | None = None) -> dict:
        """Blocking encode (serial push path / tests)."""
        return self.finalize(self.encode(flat, plan=plan, scales=scales))
