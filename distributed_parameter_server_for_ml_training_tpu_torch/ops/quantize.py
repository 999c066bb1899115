"""Wire quantize (kernel K1) and the device codec's other per-tensor ops.

Counterpart of the JAX package's ``ops/pallas/quantize.py`` wire-codec
section. :func:`wire_quantize_flat` turns fp32 values and one scale into
the int8 wire codes ``clamp(rint(x / scale), -levels, levels)`` — levels
127 for int8 codes, 7 for int4 nibble codes:

- a CUDA tensor launches the hand-written Hopper kernel
  ``ops/csrc/wire_quantize.cu`` (built by nvcc at first use, bound with
  ctypes) on PyTorch's current stream. A failed build or launch raises;
  there is no fallback to the plain version;
- a CPU tensor takes :func:`wire_quantize_plain`, the same arithmetic in
  plain PyTorch: an IEEE division by a tensor, ``torch.round`` (round half
  to even) and the clamp. The CPU tests hold it bit-equal to the JAX
  package, and ``chip_smoke.py`` holds the kernel bit-equal to it.

``wire_quantize.launches`` counts kernel launches (never plain calls), so
a run can show that its pushes went through the kernel. The reference's
TPU rule of keeping tensors under 64k elements off the kernel
(``PALLAS_WIRE_MIN_SIZE``) was a launch-cost rule for the TPU and does
not carry over: on the card every quantized tensor goes through K1.

:func:`pack_nibbles_device` and :func:`topk_select_flat` are plain torch
ops, as they are plain jnp in the reference.
"""

from __future__ import annotations

import ctypes
import threading

import torch

KERNEL_SOURCE = "distributed_parameter_server_for_ml_training_tpu_torch/" \
    "ops/csrc/wire_quantize.cu"
REPLACES = "distributed_parameter_server_for_ml_training_tpu/" \
    "ops/pallas/quantize.py:241"

_count_lock = threading.Lock()


def wire_quantize_plain(x: torch.Tensor, scale: float,
                        levels: int) -> torch.Tensor:
    """K1's plain version: ``clamp(round(x / scale), ±levels)`` as int8.

    The divisor is a tensor on ``x``'s device, never a Python scalar: a
    division by a host scalar may be computed as a multiply by its
    reciprocal, which rounds twice."""
    s = torch.tensor(scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x / s), -levels, levels).to(torch.int8)


def _wire_quantize_cuda(x: torch.Tensor, scale: float,
                        levels: int) -> torch.Tensor:
    from ._build import load

    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"wire quantize kernel takes a contiguous float32 "
                         f"tensor, got {x.dtype} contiguous="
                         f"{x.is_contiguous()}")
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    n = x.numel()
    if n == 0:
        return out
    fn = load("wire_quantize").dps_wire_quantize
    if fn.argtypes is None:     # first use: declare the C signature once
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # The C entry point launches on the calling thread's current device:
    # make that x's device for the launch.
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), n, float(scale), int(levels),
                 stream)
    if err != 0:
        raise RuntimeError(f"wire quantize kernel launch failed: CUDA "
                           f"error {err}")
    with _count_lock:
        wire_quantize.launches += 1
    return out


def wire_quantize_flat(x: torch.Tensor, scale: float,
                       levels: int) -> torch.Tensor:
    """fp32 tensor + scale -> int8 codes of the same shape.

    The kernel on a CUDA tensor, the plain version on a CPU tensor; any
    other device raises. ``scale`` is the host-computed fp32 scale
    (``np.float32``), passed to the kernel exactly."""
    if x.device.type == "cuda":
        return _wire_quantize_cuda(x, scale, levels)
    if x.device.type == "cpu":
        return wire_quantize_plain(x, scale, levels)
    raise RuntimeError(f"wire quantize: no kernel for device {x.device}")


def wire_quantize(x: torch.Tensor, scale, *, levels: int = 127
                  ) -> torch.Tensor:
    """Tensor + scalar scale -> int8 wire codes with the tensor's shape
    (the reference's per-tensor surface, quantize.py:309)."""
    x = x.to(torch.float32).contiguous()
    return wire_quantize_flat(x, float(scale), levels)


#: Kernel launches since the last reset (set to 0 to start a count).
wire_quantize.launches = 0


def pack_nibbles_device(q: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7] (any shape) -> packed uint8, flat ceil(n/2).

    Bit-identical to ops/packed.py:pack_nibbles: low nibble = even flat
    index, odd length padded with a zero code."""
    flat = q.reshape(-1)
    if flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    pairs = flat.view(-1, 2).to(torch.uint8)
    return (pairs[:, 0] & 0x0F) | ((pairs[:, 1] & 0x0F) << 4)


def topk_select_flat(x: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat top-k by |value|: (ascending int32 indices, fp32 values).

    Identical to the NumPy reference's argpartition+sort selection
    whenever the k-th magnitude is unique (boundary ties are unspecified
    there, as in the reference's ``jax.lax.top_k``)."""
    flat = x.reshape(-1).to(torch.float32)
    _, idx = torch.topk(flat.abs(), k, sorted=False)
    idx = torch.sort(idx).values
    return idx.to(torch.int32), flat[idx]
