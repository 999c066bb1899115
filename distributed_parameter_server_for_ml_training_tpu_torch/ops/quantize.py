"""Wire quantize (kernel K1), block-wise int8 (kernels K2-K4) and the
device codec's other per-tensor ops.

Counterpart of the JAX package's ``ops/pallas/quantize.py``.

**Wire codec (K1).** :func:`wire_quantize_multi` turns a push's fp32
tensors, each with its own scale and levels, into the int8 wire codes
``clamp(rint(x / scale), -levels, levels)`` — levels 127 for int8 codes, 7
for int4 nibble codes — in one launch per :data:`WIRE_MAX_ENTRIES`
tensors, into one flat buffer (:func:`wire_multi_layout`) with a view per
tensor. :func:`wire_quantize_flat` is the first version, one launch per
tensor, kept as the reference's one-tensor surface.

**Block-wise int8 (K2-K4)**, the codec of the sync int8 ring
(``parallel/sync_dp.py``). A row of n fp32 values is viewed as
``[rows_padded, 128]`` (:func:`block_layout`) and cut into blocks of
:func:`block_rows_for` rows, one fp32 scale ``absmax / 127`` per block
(a multiply by the fp32 reciprocal, as XLA computes the reference's):
:func:`block_quantize` (K2, round half to even), :func:`block_quantize_stochastic`
(K3, ``floor(x / scale + u)`` with Philox4x32-10 bits, one seed per row)
and :func:`block_dequantize` (K4). Each takes a batch of rows — the
ring's N slots — in one launch. K4's first version,
:func:`block_dequantize_v1`, is on no path: ``chip_smoke.py`` times K4
against it. :func:`quantize_int8`,
:func:`dequantize_int8` and :func:`quantize_dequantize_int8` are the
reference's one-tensor surfaces over them.

Every kernel wrapper dispatches on the tensor's device:

- a CUDA tensor launches the hand-written Hopper kernel (``ops/csrc/
  wire_quantize.cu``, ``ops/csrc/block_quantize.cu``; built by nvcc at
  first use, bound with ctypes) on PyTorch's current stream. A failed
  build or launch raises; there is no fallback to the plain version;
- a CPU tensor takes the plain PyTorch version (:func:`wire_quantize_plain`,
  :func:`wire_quantize_multi_plain`, :func:`quantize_int8_plain`,
  :func:`dequantize_int8_plain`): the same
  arithmetic with IEEE divisions by tensors, ``torch.round`` (half to
  even), one fp32 add before ``floor`` and the clamps. The CPU tests hold
  the plain versions bit-equal to the JAX package (K3's bits to
  Philox's published answers), and ``chip_smoke.py`` holds each kernel
  bit-equal to its plain version.

Each wrapper has a ``launches`` count of kernel launches (never plain
calls), so a run can show that its path went through the kernel. The
reference's TPU rule of keeping tensors under 64k elements off K1
(``PALLAS_WIRE_MIN_SIZE``) was a launch-cost rule for the TPU and does not
carry over: on the card every quantized tensor goes through K1. The
reference's CPU fallback of ``quantize_int8`` ignores ``stochastic``; the
port's plain version offers both modes.

:func:`pack_nibbles_device` and :func:`topk_select_flat` are plain torch
ops, as they are plain jnp in the reference.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Sequence

import numpy as np
import torch

KERNEL_SOURCE = "distributed_parameter_server_for_ml_training_tpu_torch/" \
    "ops/csrc/wire_quantize.cu"
_PALLAS_QUANTIZE = "distributed_parameter_server_for_ml_training_tpu/" \
    "ops/pallas/quantize.py"
#: The TPU kernel each wire wrapper replaces (file:line of its function):
#: both kernels of wire_quantize.cu compute K1.
REPLACES = {"wire_quantize_multi": f"{_PALLAS_QUANTIZE}:241",
            "wire_quantize": f"{_PALLAS_QUANTIZE}:241"}
#: Entries of one multi-tensor launch: the kernel takes its table by value.
WIRE_MAX_ENTRIES = 64
#: Each entry's offset in the flat output is a multiple of this many bytes.
WIRE_ALIGN = 16

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


def wire_multi_layout(sizes: Sequence[int]
                      ) -> tuple[np.ndarray, int, list[range]]:
    """The flat buffer of a multi-tensor quantize: each entry's byte offset
    (rounded up to WIRE_ALIGN, so every entry starts 16-byte aligned), the
    buffer's length, and the entries of each launch (at most
    WIRE_MAX_ENTRIES a launch)."""
    padded = (np.asarray(sizes, np.int64).reshape(-1) + WIRE_ALIGN - 1) \
        // WIRE_ALIGN * WIRE_ALIGN
    ends = np.cumsum(padded)
    offsets = ends - padded
    groups = [range(i, min(i + WIRE_MAX_ENTRIES, len(offsets)))
              for i in range(0, len(offsets), WIRE_MAX_ENTRIES)]
    return offsets, int(ends[-1]) if len(ends) else 0, groups


def _views(flat: torch.Tensor, xs, offsets: list[int]
           ) -> list[torch.Tensor]:
    """One view of the flat buffer per entry, in the entry's shape, at its
    offset. The entries are contiguous, so their strides serve the view:
    one ``as_strided`` an entry costs less than half the host time of a
    split of the buffer followed by a ``view`` an entry."""
    return [flat.as_strided(x.shape, x.stride(), o)
            for x, o in zip(xs, offsets)]


def wire_quantize_multi_plain(xs: Sequence[torch.Tensor],
                              scales: Sequence[float], levels: Sequence[int]
                              ) -> tuple[torch.Tensor, list[torch.Tensor],
                                         list[int]]:
    """The multi-tensor kernel's plain version: :func:`wire_quantize_plain`
    per entry into the flat layout of :func:`wire_multi_layout`, padding
    bytes 0. Returns what :func:`wire_quantize_multi` returns."""
    xs = [x.contiguous() for x in xs]
    offsets, total, _ = wire_multi_layout([x.numel() for x in xs])
    offsets = offsets.tolist()
    dev = xs[0].device if xs else torch.device("cpu")
    flat = torch.zeros(total, dtype=torch.int8, device=dev)
    for x, s, lv, o in zip(xs, scales, levels, offsets):
        flat[o:o + x.numel()] = wire_quantize_plain(x.reshape(-1), s, lv)
    return flat, _views(flat, xs, offsets), offsets


def _wire_multi_fn():
    from ._build import load

    fn = load("wire_quantize").dps_wire_quantize_multi
    if fn.argtypes is None:     # first use: declare the C signature once
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


# The CUDA route of wire_quantize_multi, in the steps that chip_smoke.py
# times one by one for the wrapper's host time.

def _check_wire_inputs(xs) -> torch.device:
    """The device of a push whose tensors the kernel can take, else
    ValueError."""
    dev, index = xs[0].device, xs[0].get_device()
    for x in xs:
        if x.dtype != torch.float32 or not x.is_contiguous() \
                or x.get_device() != index:
            raise ValueError(f"wire quantize kernel takes contiguous float32 "
                             f"tensors on {dev}, got {x.dtype} on {x.device} "
                             f"contiguous={x.is_contiguous()}")
    return dev


def _wire_table(xs, ns, offsets, scales, levels) -> list[np.ndarray]:
    """The kernel's table as five arrays: input pointers, output offsets,
    sizes, fp32 scales and levels."""
    return [np.array([x.data_ptr() for x in xs], np.int64), offsets,
            np.array(ns, np.int64), np.array(scales, np.float32),
            np.array(levels, np.int32)]


def _wire_launch(table, groups, ns, flat: torch.Tensor) -> None:
    """One launch per group of table rows that holds values, on the
    current stream of ``flat``'s device; counts each launch."""
    fn = _wire_multi_fn()
    launched = 0
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        for g in groups:
            if not any(ns[i] for i in g):
                continue        # the C entry launches nothing for no values
            err = fn(len(g), *[a.ctypes.data + a.itemsize * g.start
                               for a in table], flat.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"wire quantize kernel launch failed: "
                                   f"CUDA error {err}")
            launched += 1
    with _count_lock:
        wire_quantize_multi.launches += launched


def _wire_quantize_multi_cuda(xs, scales, levels
                              ) -> tuple[torch.Tensor, list[torch.Tensor],
                                         list[int]]:
    dev = _check_wire_inputs(xs)
    ns = [x.numel() for x in xs]
    offsets, total, groups = wire_multi_layout(ns)
    flat = torch.empty(total, dtype=torch.int8, device=dev)
    _wire_launch(_wire_table(xs, ns, offsets, scales, levels), groups, ns,
                 flat)
    offsets = offsets.tolist()
    return flat, _views(flat, xs, offsets), offsets


def wire_quantize_multi(xs: Sequence[torch.Tensor], scales: Sequence[float],
                        levels: Sequence[int]
                        ) -> tuple[torch.Tensor, list[torch.Tensor],
                                   list[int]]:
    """K1 over a whole push: fp32 tensors, each with its fp32 scale and its
    levels (127 or 7) -> the flat int8 buffer of :func:`wire_multi_layout`,
    one view of it per tensor in its shape, and each tensor's byte offset
    in it.

    On CUDA tensors one launch per WIRE_MAX_ENTRIES tensors that hold
    values; on CPU tensors the plain version; any other device raises.
    Scales are the host-computed fp32 scales, passed to the kernel
    exactly."""
    xs = list(xs)
    if not len(scales) == len(levels) == len(xs):
        raise ValueError(f"need one scale and one levels value per tensor "
                         f"({len(xs)}), got {len(scales)} and {len(levels)}")
    if not xs or xs[0].device.type == "cpu":
        return wire_quantize_multi_plain(xs, scales, levels)
    if xs[0].device.type == "cuda":
        return _wire_quantize_multi_cuda(xs, scales, levels)
    raise RuntimeError(f"wire quantize: no kernel for device {xs[0].device}")


wire_quantize_multi.launches = 0


# -- block-wise int8: kernels K2, K3 and K4 ------------------------------------

BLOCK_KERNEL_SOURCE = "distributed_parameter_server_for_ml_training_tpu_torch/" \
    "ops/csrc/block_quantize.cu"
#: The TPU kernel each block wrapper replaces (file:line of its function).
BLOCK_REPLACES = {
    "block_quantize": f"{_PALLAS_QUANTIZE}:71",
    "block_quantize_stochastic": f"{_PALLAS_QUANTIZE}:98",
    "block_dequantize": f"{_PALLAS_QUANTIZE}:105",
    "block_dequantize_v1": f"{_PALLAS_QUANTIZE}:105",
}

LANES = 128
BLOCK_ROWS = 256        # 256 x 128 fp32 values per quantization block
#: Rows of one stochastic launch: the kernel takes its seeds by value.
MAX_SEEDED_ROWS = 64

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


def block_rows_for(rows_padded: int) -> int:
    """Quantization block height for a ``[rows_padded, 128]`` view: inputs
    above one block tile in BLOCK_ROWS blocks, smaller ones are a single
    block of their own (32-row aligned), and an empty input gets the
    32-row minimum so ``rows // block_rows`` is 0 blocks (the reference's
    rule, quantize.py:34-48)."""
    if rows_padded == 0:
        return 32
    return rows_padded if rows_padded <= BLOCK_ROWS else BLOCK_ROWS


def block_layout(n: int) -> tuple[int, int, int]:
    """``(rows_padded, block_rows, n_blocks)`` for n values: rows of 128,
    32-aligned for a single block, a BLOCK_ROWS multiple otherwise (the
    padding rule of the reference's ``_pad_to_blocks``, quantize.py:51-62).
    """
    rows = -(-n // LANES)
    if rows <= BLOCK_ROWS:
        rows_padded = -(-rows // 32) * 32
    else:
        rows_padded = -(-rows // BLOCK_ROWS) * BLOCK_ROWS
    br = block_rows_for(rows_padded)
    return rows_padded, br, rows_padded // br


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(low, high) 32-bit words of ``a * m`` for 32-bit ``a`` held in int64
    and a 32-bit constant ``m``, in int64 arithmetic that never overflows:
    ``a`` is split in 16-bit halves, each product below 2^48."""
    p1 = (a & 0xFFFF) * m
    p2 = (a >> 16) * m
    t = ((p2 & 0xFFFF) << 16) + p1
    return t & _M32, (p2 >> 16) + (t >> 32)


def philox4x32_10(counter: Sequence[torch.Tensor],
                  key: Sequence[torch.Tensor | int]) -> list[torch.Tensor]:
    """Philox4x32-10 (Salmon et al., SC'11) over int64 tensors holding
    32-bit words: four counter words and two key words (broadcastable)
    -> four output words. The plain version of the generator that K3
    runs per group of four values."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _M32
            k1 = (k1 + 0xBB67AE85) & _M32
        lo0, hi0 = _mulhilo(c0, 0xD2511F53)
        lo1, hi1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return [c0, c1, c2, c3]


def uniform24_plain(seeds: Sequence[int], length: int,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """``[len(seeds), length]`` fp32 draws in [0, 1), exactly K3's: row r
    keys Philox with its 64-bit seed, element e takes word ``e % 4`` of the
    group counter ``e // 4`` and keeps its top 24 bits times 2^-24.
    ``length`` is a multiple of 4."""
    # int64 holds the seed's 64 bits (two's complement); split into two
    # unsigned 32-bit words.
    bits64 = [int(v) & _M64 for v in seeds]
    s = torch.tensor([v - (1 << 64) if v >> 63 else v for v in bits64],
                     dtype=torch.int64, device=device)
    k0 = (s & _M32)[:, None]
    k1 = ((s >> 32) & _M32)[:, None]
    g = torch.arange(length // 4, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros_like(g)
    words = philox4x32_10((g & _M32, g >> 32, zero, zero), (k0, k1))
    bits = torch.stack(words, dim=-1).reshape(len(seeds), length)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def quantize_int8_plain(x2d: torch.Tensor, seeds: Sequence[int] | None = None,
                        *, stochastic: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's and K3's plain version over a batch of rows.

    ``x2d`` is ``[n_rows, n]`` fp32; returns int8 ``values [n_rows,
    rows_padded, 128]`` and fp32 ``scales [n_rows, n_blocks]``. Rounding is
    half to even, or with ``stochastic`` ``floor(x / scale + u)`` with
    ``u`` from :func:`uniform24_plain` keyed by ``seeds`` (one per row).
    Divisions are by tensors on ``x2d``'s device, never by host scalars.
    The scale is ``absmax`` times the fp32 reciprocal of 127: the
    reference's ``abs_max / 127.0`` is a division by a constant, which XLA
    computes as that multiply, so this is its scale bit for bit.
    """
    n_rows, n = x2d.shape
    rows_padded, br, n_blocks = block_layout(n)
    dev = x2d.device
    flat = torch.zeros((n_rows, rows_padded * LANES), dtype=torch.float32,
                       device=dev)
    flat[:, :n] = x2d
    blocks = flat.view(n_rows, n_blocks, br * LANES)
    absmax = blocks.abs().amax(dim=2) if n_blocks else \
        torch.zeros((n_rows, 0), device=dev)
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=dev)
    scales = torch.where(absmax > 0, absmax * inv127,
                         torch.ones((), device=dev))
    scaled = blocks / scales[..., None]
    if stochastic:
        if seeds is None or len(seeds) != n_rows:
            raise ValueError(f"stochastic rounding needs one seed per row "
                             f"({n_rows}), got {seeds!r}")
        u = uniform24_plain(seeds, rows_padded * LANES, dev)
        q = torch.floor(scaled + u.view_as(scaled))
    else:
        q = torch.round(scaled)
    q = torch.clamp(q, -127, 127).to(torch.int8)
    return q.view(n_rows, rows_padded, LANES), scales


def dequantize_int8_plain(values: torch.Tensor, scales: torch.Tensor,
                          n: int) -> torch.Tensor:
    """K4's plain version: ``[n_rows, rows_padded, 128]`` int8 codes times
    their block's scale, cropped to ``[n_rows, n]`` fp32."""
    n_rows, rows_padded = values.shape[:2]
    br = block_rows_for(rows_padded)
    out = values.reshape(n_rows, rows_padded // br, br * LANES).to(
        torch.float32) * scales[..., None]
    return out.reshape(n_rows, rows_padded * LANES)[:, :n].contiguous()


def _block_fn(name: str):
    from ._build import load

    lib = load("block_quantize")
    fn = getattr(lib, name)
    if fn.argtypes is None:     # first use: declare the C signature once
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([p, i64, i64, i32, p, p, i32, i32, i32,
                        ctypes.POINTER(ctypes.c_ulonglong), p]
                       if name == "dps_block_quantize" else
                       [p, p, p, i64, i64, i32, i32, i32, p])
        fn.restype = ctypes.c_int
    return fn


def _check_rows(x2d: torch.Tensor) -> None:
    if x2d.dtype != torch.float32 or x2d.dim() != 2 \
            or (x2d.shape[1] > 1 and x2d.stride(1) != 1):
        raise ValueError(f"block quantize takes [rows, n] float32 rows with "
                         f"unit element stride, got {x2d.dtype} "
                         f"{tuple(x2d.shape)} strides {x2d.stride()}")


def _block_quantize_cuda(x2d: torch.Tensor, seeds: Sequence[int] | None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    n_rows, n = x2d.shape
    rows_padded, br, n_blocks = block_layout(n)
    values = torch.empty((n_rows, rows_padded, LANES), dtype=torch.int8,
                         device=x2d.device)
    scales = torch.empty((n_rows, n_blocks), dtype=torch.float32,
                         device=x2d.device)
    if n == 0 or n_rows == 0:
        return values, scales
    stochastic = seeds is not None
    table = (ctypes.c_ulonglong * n_rows)(
        *[int(s) & _M64 for s in seeds]) if stochastic else None
    fn = _block_fn("dps_block_quantize")
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = fn(x2d.data_ptr(), n, x2d.stride(0), n_rows,
                 values.data_ptr(), scales.data_ptr(), br * LANES, n_blocks,
                 int(stochastic), table, stream)
    if err != 0:
        raise RuntimeError(f"block quantize kernel launch failed: CUDA "
                           f"error {err}")
    wrapper = block_quantize_stochastic if stochastic else block_quantize
    with _count_lock:
        wrapper.launches += 1
    return values, scales


def block_quantize(x2d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: ``[n_rows, n]`` fp32 -> (int8 ``[n_rows, rows_padded, 128]``,
    fp32 scales ``[n_rows, n_blocks]``), rounding half to even. One launch
    for all rows on a CUDA tensor; the plain version on a CPU tensor."""
    _check_rows(x2d)
    if x2d.device.type == "cuda":
        return _block_quantize_cuda(x2d, None)
    if x2d.device.type == "cpu":
        return quantize_int8_plain(x2d)
    raise RuntimeError(f"block quantize: no kernel for device {x2d.device}")


def block_quantize_stochastic(x2d: torch.Tensor, seeds: Sequence[int]
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: as :func:`block_quantize` with stochastic rounding, row r drawing
    from Philox keyed by ``seeds[r]`` (64-bit; at most MAX_SEEDED_ROWS rows
    a launch)."""
    _check_rows(x2d)
    if len(seeds) != x2d.shape[0]:
        raise ValueError(f"need one seed per row ({x2d.shape[0]}), got "
                         f"{len(seeds)}")
    if x2d.device.type == "cuda":
        if x2d.shape[0] > MAX_SEEDED_ROWS:
            raise ValueError(f"stochastic block quantize takes at most "
                             f"{MAX_SEEDED_ROWS} rows a launch, got "
                             f"{x2d.shape[0]}")
        return _block_quantize_cuda(x2d, seeds)
    if x2d.device.type == "cpu":
        return quantize_int8_plain(x2d, seeds, stochastic=True)
    raise RuntimeError(f"block quantize: no kernel for device {x2d.device}")


def _check_payload(values: torch.Tensor, scales: torch.Tensor,
                   n: int) -> int:
    """Raises on a payload K4 cannot take; returns its block height."""
    n_rows, rows_padded, lanes = values.shape
    br = block_rows_for(rows_padded)
    if values.dtype != torch.int8 or lanes != LANES \
            or scales.dtype != torch.float32 \
            or tuple(scales.shape) != (n_rows, rows_padded // br) \
            or not 0 <= n <= rows_padded * LANES:
        raise ValueError(f"block dequantize: bad payload {values.dtype}"
                         f"{tuple(values.shape)} scales {scales.dtype}"
                         f"{tuple(scales.shape)} for n={n}")
    return br


def _block_dequantize_cuda(entry: str, values: torch.Tensor,
                           scales: torch.Tensor, n: int, br: int
                           ) -> tuple[torch.Tensor, bool]:
    """Launches the C entry ``entry`` (K4 or its first version) on CUDA
    tensors: (the output, whether a kernel was launched)."""
    n_rows, rows_padded = values.shape[:2]
    values, scales = values.contiguous(), scales.contiguous()
    out = torch.empty((n_rows, n), dtype=torch.float32, device=values.device)
    if n == 0 or n_rows == 0:
        return out, False
    fn = _block_fn(entry)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(values.data_ptr(), scales.data_ptr(), out.data_ptr(), n, n,
                 n_rows, br * LANES, rows_padded // br, stream)
    if err != 0:
        raise RuntimeError(f"block dequantize kernel launch failed: CUDA "
                           f"error {err}")
    return out, True


def block_dequantize(values: torch.Tensor, scales: torch.Tensor,
                     n: int) -> torch.Tensor:
    """K4: int8 ``[n_rows, rows_padded, 128]`` and scales ``[n_rows,
    n_blocks]`` -> fp32 ``[n_rows, n]``. One launch for all rows on CUDA
    tensors; the plain version on CPU tensors."""
    br = _check_payload(values, scales, n)
    if values.device.type == "cpu":
        return dequantize_int8_plain(values, scales, n)
    if values.device.type != "cuda":
        raise RuntimeError(f"block dequantize: no kernel for device "
                           f"{values.device}")
    out, launched = _block_dequantize_cuda("dps_block_dequantize", values,
                                           scales, n, br)
    if launched:
        with _count_lock:
            block_dequantize.launches += 1
    return out


def block_dequantize_v1(values: torch.Tensor, scales: torch.Tensor,
                        n: int) -> torch.Tensor:
    """K4's first version, on CUDA tensors only: the yardstick that
    ``chip_smoke.py`` times K4 against. No path calls it."""
    br = _check_payload(values, scales, n)
    if values.device.type != "cuda":
        raise RuntimeError(f"block dequantize (first version): no kernel "
                           f"for device {values.device}")
    out, launched = _block_dequantize_cuda("dps_block_dequantize_v1", values,
                                           scales, n, br)
    if launched:
        with _count_lock:
            block_dequantize_v1.launches += 1
    return out


block_quantize.launches = 0
block_quantize_stochastic.launches = 0
block_dequantize.launches = 0
block_dequantize_v1.launches = 0


def quantize_int8(x: torch.Tensor, seed: int = 0, *,
                  stochastic: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (int8 values ``[rows, 128]``, fp32 scales
    ``[n_blocks]``), the reference's one-tensor surface (quantize.py:115);
    the caller keeps ``x.shape`` for :func:`dequantize_int8`."""
    x2d = x.reshape(1, -1).to(torch.float32)
    if stochastic:
        v, s = block_quantize_stochastic(x2d, [seed])
    else:
        v, s = block_quantize(x2d)
    return v[0], s[0]


def dequantize_int8(values: torch.Tensor, scales: torch.Tensor,
                    shape: tuple) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`; ``shape`` is the original shape."""
    n = math.prod(shape)
    return block_dequantize(values[None], scales[None], n)[0].view(shape)


def quantize_dequantize_int8(x: torch.Tensor, *, stochastic: bool = False,
                             seed: int = 0) -> torch.Tensor:
    """Round trip: the quantization error a gradient would incur."""
    v, s = quantize_int8(x, seed, stochastic=stochastic)
    return dequantize_int8(v, s, tuple(x.shape))


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
