"""Tensor-dict wire format: versioned, zero-copy, chunkable.

The port's own copy of the JAX package's ``comms/wire.py``: the format is
framework-neutral (NumPy buffers), so the code is the reference's line
for line and both packages write the same bytes for the same tensors;
only the imports are the port's (``PackedInt4`` from its
``ops/packed.py``). Each package decodes the other's frames.

The reference pickles ``{name: np.ndarray}`` dicts onto the wire
(worker.py:289, server.py:222) — simple but unsafe (pickle executes code) and
Python-bound. This codec keeps the same logical payload with a safe,
language-neutral layout, so a future C++/other-host peer can speak it.

Frame v2 (current)::

    [u8 0xD5 magic][u8 version=2][u8 flags][u8 reserved]
    [u32 header_len LE][header JSON utf-8][raw buffer 0][raw buffer 1]...

header: {"tensors": [{"name": str, "dtype": str, "shape": [int...]}...]}
Buffers are C-contiguous little-endian, concatenated in header order.
flags bit 0 marks a CHUNK frame (see *Chunked framing* below); flags
bit 1 marks a CHECKSUMMED frame carrying a 4-byte CRC-32 trailer over
everything before it (preamble + header + buffers) — corruption anywhere
in the frame, header included, fails decode with ``ValueError`` instead
of applying garbled tensors (docs/WIRE_PROTOCOL.md "Checksum trailer").
The trailer is capability-gated by the caller: legacy decoders that
predate it would mistake the 4 extra bytes for buffer slack, so encoders
only set it for peers that advertised ``checksum`` at registration.

Frame v1 (legacy, still decoded)::

    [u32 header_len LE][header JSON utf-8][raw buffer 0]...

Copy discipline — the host-side cost THC and the gradient-compression
studies (PAPERS.md) identify as the post-codec bottleneck:

- **encode**: exactly ONE copy per tensor — each buffer is memcpy'd once
  into the output frame by ``bytes.join`` over buffer views (the previous
  codec paid ``tobytes()`` + ``join`` = two copies). A non-contiguous
  input costs one extra copy to make it contiguous. The
  :func:`set_copy_count_hook` test hook counts every buffer copy so the
  single-copy invariant is pinned by a tier-1 test.
- **decode**: ZERO copies — tensors are ``np.frombuffer`` views into
  memoryview slices of the payload (read-only when the payload is
  ``bytes``; the payload stays alive via the arrays' ``.base``). Callers
  that must mutate in place pass ``copy=True``.

Chunked framing: payloads near the gRPC message ceiling (500 MB here,
GRPC_OPTIONS) can be encoded as N self-describing chunk frames
(:func:`encode_tensor_dict_chunks`) carried as separate messages by a
streaming transport and reassembled by
:func:`decode_tensor_dict_chunks`. Chunk boundaries prefer tensor
boundaries, so reassembly stays zero-copy unless a single tensor is
bigger than the chunk budget (only the spanning tensors are copied).

fp16 gradient compression (worker.py:264-268) composes naturally: cast the
arrays before encoding and the wire carries half the bytes.
"""

from __future__ import annotations

import json
import math
import struct
import zlib
from typing import Callable, Mapping

import ml_dtypes  # provides the numpy bfloat16 dtype
import numpy as np

from ..ops.packed import PackedInt4, as_packed_int4, packed_int4_nbytes

#: First byte of every v2+ frame. v1 frames start with the low byte of
#: their u32 header length instead; decode disambiguates by checking that
#: a v1 header begins with '{' at offset 4.
WIRE_MAGIC = 0xD5
WIRE_VERSION = 2
FLAG_CHUNK = 0x01
#: Frame carries a 4-byte CRC-32 trailer (zlib.crc32 — the stdlib
#: checksum; the container ships no crc32c wheel, and the repo already
#: keys its slot space on the same polynomial, ps/sharding.py:key_slot).
FLAG_CRC = 0x02

_PREAMBLE = 4  # magic + version + flags + reserved
_CRC_TRAILER = 4  # u32 LE crc32 appended after the last buffer

#: Upper bound on the JSON tensor table. A real table is ~100 bytes per
#: tensor; 16 MiB is orders of magnitude past any real model and small
#: enough that a corrupt/hostile length field can't trigger a giant
#: allocation before validation.
MAX_HEADER_BYTES = 16 << 20

_ALLOWED_DTYPES = {
    "float16", "float32", "float64", "bfloat16",
    "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64", "bool",
    # Packed-nibble wire dtype (two signed 4-bit values per byte): the
    # header shape is the LOGICAL element shape, the buffer holds
    # ceil(n/2) bytes. numpy has no packed int4, so these tensors travel
    # as ops/packed.py's PackedInt4 (a uint8 array remembering its logical
    # shape); the quantization math lives in ops/compression.py.
    "int4",
}

# -- copy accounting (tier-1 zero-copy guard) --------------------------------

_copy_hook: Callable[[str, str], None] | None = None


def set_copy_count_hook(hook: Callable[[str, str], None] | None):
    """Install ``hook(tensor_name, reason)`` called once per buffer copy the
    encode path performs (reasons: ``'make_contiguous'``, ``'frame_write'``).
    Returns the previous hook. Tests use this to pin the at-most-one-copy
    invariant; pass ``None`` to uninstall."""
    global _copy_hook
    prev, _copy_hook = _copy_hook, hook
    return prev


def _note_copy(name: str, reason: str) -> None:
    if _copy_hook is not None:
        _copy_hook(name, reason)


# -- encode ------------------------------------------------------------------

# dpslint: hot-path — the zero-copy primitive everything else leans on
def _buffer_view(arr: np.ndarray) -> memoryview:
    """Raw little-endian bytes of a C-contiguous array, WITHOUT copying.

    Routed through a uint8 view because custom dtypes (bfloat16) don't
    export a standard buffer format; reshape(-1) first so 0-d arrays view
    cleanly."""
    return memoryview(arr.reshape(-1).view(np.uint8))


# dpslint: hot-path — per-tensor, every push and fetch
def _prepare(tensors: Mapping[str, np.ndarray]) -> tuple[list, list]:
    """Validate + normalize to (metas, contiguous arrays)."""
    metas, arrays = [], []
    for name, arr in tensors.items():
        if isinstance(arr, PackedInt4):
            # Wire dtype "int4": header shape is the LOGICAL shape, buffer
            # is the packed nibbles (as_packed_int4 validated the length).
            a = arr if arr.flags.c_contiguous else np.ascontiguousarray(arr)
            if a is not arr:
                _note_copy(str(name), "make_contiguous")
            metas.append({"name": str(name), "dtype": "int4",
                          "shape": list(arr.logical_shape)})
            arrays.append(np.asarray(a, np.uint8))
            continue
        a = np.asarray(arr)
        if not a.flags.c_contiguous:
            a = np.ascontiguousarray(a)
            _note_copy(str(name), "make_contiguous")
        dtype = a.dtype.name
        if dtype not in _ALLOWED_DTYPES:
            raise ValueError(f"unsupported dtype {dtype} for {name!r}")
        metas.append({"name": str(name), "dtype": dtype,
                      "shape": list(a.shape)})
        arrays.append(a)
    return metas, arrays


# dpslint: hot-path — the ONE sanctioned copy is the final join
def _frame(header_obj: dict, bodies: list, flags: int = 0,
           checksum: bool = False) -> bytes:
    """Assemble one v2 frame. ``bodies`` are buffer-protocol objects; each
    is copied exactly once by the final join. ``checksum`` sets FLAG_CRC
    and appends the CRC-32 trailer; the CRC is accumulated incrementally
    over the pieces BEFORE the join, so the one-copy-per-tensor
    discipline holds for checksummed frames too."""
    if checksum:
        flags |= FLAG_CRC
    header = json.dumps(header_obj).encode("utf-8")
    preamble = struct.pack("<BBBBI", WIRE_MAGIC, WIRE_VERSION, flags, 0,
                           len(header))
    if not checksum:
        return b"".join([preamble, header, *bodies])
    crc = zlib.crc32(header, zlib.crc32(preamble))
    for b in bodies:
        crc = zlib.crc32(b, crc)
    return b"".join([preamble, header, *bodies, struct.pack("<I", crc)])


# dpslint: hot-path — one buffer copy per tensor, enforced statically
def encode_tensor_dict(tensors: Mapping[str, np.ndarray],
                       trace: dict | None = None,
                       checksum: bool = False) -> bytes:
    """Encode to a single v2 frame (one buffer copy per tensor).

    ``trace`` (optional, capability-gated by the caller —
    docs/WIRE_PROTOCOL.md) adds a ``"trace"`` field to the v2 frame
    header: ``{"trace_id": str, "span_id": str}``, the distributed-tracing
    context of the worker operation that produced this payload. Decoders
    that don't know the field ignore it (the tensor table is keyed), and
    legacy v1 frames simply never carry one — mixed versions degrade to
    untraced, never break.

    ``checksum`` (capability-gated by the caller exactly like ``trace``)
    appends the CRC-32 integrity trailer — only send it to peers that
    advertised ``checksum`` at registration."""
    metas, arrays = _prepare(tensors)
    for m, a in zip(metas, arrays):
        if a.nbytes:
            _note_copy(m["name"], "frame_write")
    header: dict = {"tensors": metas}
    if trace is not None:
        header["trace"] = trace
    return _frame(header, [_buffer_view(a) for a in arrays],
                  checksum=checksum)


def encode_tensor_dict_chunks(tensors: Mapping[str, np.ndarray],
                              max_chunk_bytes: int,
                              checksum: bool = False) -> list[bytes]:
    """Encode as N chunk frames, each body at most ``max_chunk_bytes``.

    Chunk 0's header carries the tensor table + total payload length; every
    chunk's header carries ``{"chunk": {"index", "total", "offset"}}``.
    Splits land on tensor boundaries when possible (zero-copy reassembly);
    a tensor larger than the budget is hard-split mid-buffer.

    ``checksum`` appends the CRC-32 trailer to EVERY chunk frame — each
    chunk is verified independently at parse, so reassembly only ever
    sees clean segments.
    """
    if max_chunk_bytes < 1:
        raise ValueError(f"max_chunk_bytes must be >= 1, got "
                         f"{max_chunk_bytes}")
    metas, arrays = _prepare(tensors)
    # Cut the logical buffer section into per-chunk segment lists.
    chunks: list[list] = [[]]
    sizes = [0]
    for m, a in zip(metas, arrays):
        if not a.nbytes:
            continue  # zero-element tensors occupy no buffer bytes
        _note_copy(m["name"], "frame_write")
        view = _buffer_view(a)
        pos = 0
        while pos < a.nbytes:
            room = max_chunk_bytes - sizes[-1]
            if room == 0:
                chunks.append([])
                sizes.append(0)
                continue
            take = min(room, a.nbytes - pos)
            # Prefer starting a fresh chunk over splitting a tensor that
            # would fit whole in an empty one.
            if pos == 0 and take < a.nbytes and a.nbytes <= max_chunk_bytes:
                chunks.append([])
                sizes.append(0)
                continue
            chunks[-1].append(view[pos:pos + take])
            sizes[-1] += take
            pos += take
    total_payload = sum(sizes)
    frames = []
    offset = 0
    for i, (bodies, size) in enumerate(zip(chunks, sizes)):
        header: dict = {"chunk": {"index": i, "total": len(chunks),
                                  "offset": offset}}
        if i == 0:
            header["tensors"] = metas
            header["payload_len"] = total_payload
        frames.append(_frame(header, bodies, flags=FLAG_CHUNK,
                             checksum=checksum))
        offset += size
    return frames


# -- decode ------------------------------------------------------------------

# dpslint: hot-path — header parse only; bodies stay views
def _parse_frame(payload) -> tuple[dict, memoryview, int]:
    """-> (header dict, body memoryview, flags). Accepts v2 and legacy v1
    frames; validates the header length BEFORE any allocation sized by it."""
    mv = memoryview(payload)
    if len(mv) < 4:
        raise ValueError("truncated payload")
    # Disambiguation order matters: a LEGACY v1 frame whose u32 header_len
    # happens to be 0x...02D5 (e.g. exactly 725 — a realistic JSON table
    # size) also starts with [0xD5, 0x02]. A v2 frame's header JSON always
    # begins '{' at offset 8; a v1 frame's always begins '{' at offset 4 —
    # and a v1 header can't have '{' at BOTH (offset 8 is char 4 of
    # '{"tensors...', i.e. 'n'), so checking the v2 position first is
    # unambiguous for every frame either encoder ever produced.
    if (mv[0] == WIRE_MAGIC and mv[1] == WIRE_VERSION
            and len(mv) >= _PREAMBLE + 5 and mv[_PREAMBLE + 4] == 0x7B):
        flags, header_off = mv[2], _PREAMBLE
    elif len(mv) >= 5 and mv[4] == 0x7B:  # '{' at offset 4 => legacy v1
        flags, header_off = 0, 0
    elif mv[0] == WIRE_MAGIC and mv[1] != WIRE_VERSION:
        raise ValueError(f"unsupported wire version {mv[1]}")
    else:
        flags, header_off = 0, 0  # let the v1 length checks reject it
    if flags & FLAG_CRC:
        # Verify BEFORE trusting anything length-prefixed: the CRC covers
        # the whole frame (header included), so a flipped header byte
        # fails here rather than steering the tensor-table parse.
        if len(mv) < header_off + 4 + _CRC_TRAILER:
            raise ValueError("truncated payload")
        (want,) = struct.unpack_from("<I", mv, len(mv) - _CRC_TRAILER)
        if zlib.crc32(mv[:len(mv) - _CRC_TRAILER]) != want:
            raise ValueError("wire checksum mismatch (corrupt frame)")
        mv = mv[:len(mv) - _CRC_TRAILER]
    if len(mv) < header_off + 4:
        raise ValueError("truncated payload")
    (hlen,) = struct.unpack_from("<I", payload, header_off)
    if hlen > MAX_HEADER_BYTES:
        raise ValueError(f"header_len {hlen} exceeds cap {MAX_HEADER_BYTES}")
    header_end = header_off + 4 + hlen
    if header_end > len(mv):
        raise ValueError("truncated header")
    try:
        header = json.loads(bytes(mv[header_off + 4:header_end])
                            .decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"bad frame header: {e}") from e
    if not isinstance(header, dict):
        raise ValueError("bad frame header: not an object")
    return header, mv[header_end:], flags


def _tensor_extent(meta: dict) -> tuple[np.dtype, tuple, int, bool]:
    """Validated (dtype, shape, nbytes, packed) from one header entry.
    Rejects NaN/float/negative/bool dims and unknown dtypes before any
    allocation; the size product is computed in unbounded Python ints, so
    it cannot overflow into a small bogus value. ``packed`` marks the
    "int4" wire dtype: ``shape`` is the LOGICAL shape, the buffer holds
    ``ceil(prod(shape)/2)`` uint8s of packed nibbles."""
    dtype = meta.get("dtype")
    if dtype not in _ALLOWED_DTYPES:
        raise ValueError(f"unsupported dtype {dtype}")
    packed = dtype == "int4"
    if packed:
        dt = np.dtype(np.uint8)
    elif dtype == "bfloat16":
        dt = np.dtype(ml_dtypes.bfloat16)
    else:
        dt = np.dtype(dtype)
    raw_shape = meta.get("shape", [])
    if not isinstance(raw_shape, list):
        raise ValueError(f"bad shape {raw_shape!r} for {meta.get('name')!r}")
    for s in raw_shape:
        if isinstance(s, bool) or not isinstance(s, int) or s < 0:
            raise ValueError(
                f"bad shape dim {s!r} for {meta.get('name')!r}")
    shape = tuple(raw_shape)
    nbytes = packed_int4_nbytes(shape) if packed \
        else dt.itemsize * math.prod(shape)
    return dt, shape, nbytes, packed


# dpslint: hot-path — frombuffer views; copy only on explicit opt-in
def _tensors_from_body(header: dict, body: memoryview,
                       copy: bool) -> dict[str, np.ndarray]:
    metas = header.get("tensors")
    if not isinstance(metas, list):
        raise ValueError("bad frame header: missing tensor table")
    out: dict[str, np.ndarray] = {}
    offset = 0
    for meta in metas:
        dt, shape, nbytes, packed = _tensor_extent(meta)
        end = offset + nbytes
        if end > len(body):
            raise ValueError(f"truncated buffer for {meta.get('name')!r}")
        arr = np.frombuffer(body[offset:end], dtype=dt)
        if packed:
            out[str(meta.get("name"))] = as_packed_int4(
                arr.copy() if copy else arr, shape)
        else:
            arr = arr.reshape(shape)
            out[str(meta.get("name"))] = arr.copy() if copy else arr
        offset = end
    return out


# dpslint: hot-path — zero-copy decode is the whole point of v2 frames
def decode_tensor_dict(payload, *, copy: bool = False
                       ) -> dict[str, np.ndarray]:
    """Decode one frame (v2 or legacy v1) to ``{name: ndarray}``.

    Default is ZERO-COPY: arrays are read-only views into ``payload``
    (which stays alive via ``.base``). ``copy=True`` returns owned,
    writable arrays instead."""
    header, body, flags = _parse_frame(payload)
    if flags & FLAG_CHUNK:
        raise ValueError("chunk frame: use decode_tensor_dict_chunks")
    return _tensors_from_body(header, body, copy)


def peek_trace(payload) -> dict | None:
    """Trace context from a frame header, or None (absent field, legacy v1
    frame, malformed/empty payload — never raises: a garbled trace field
    must degrade to untraced, not fail the RPC). Parses only the JSON
    header; the tensor buffers are untouched."""
    try:
        header, _, _ = _parse_frame(payload)
    except (ValueError, struct.error):
        return None
    trace = header.get("trace")
    return trace if isinstance(trace, dict) else None


def frame_checksum_ok(payload) -> bool | None:
    """Cheap integrity verdict for one frame: ``True`` (CRC trailer
    present and valid), ``False`` (present but wrong — corrupt or
    truncated), ``None`` (frame carries no trailer: legacy v1, or a v2
    peer that never negotiated the capability — nothing to verify).

    The push handler calls this BEFORE the dedupe lifecycle
    (comms/service.py): a corrupt push must be refused without recording
    a token entry, so the client's clean retry of the same token can
    still apply."""
    mv = memoryview(payload)
    if (len(mv) < _PREAMBLE or mv[0] != WIRE_MAGIC
            or mv[1] != WIRE_VERSION or not mv[2] & FLAG_CRC):
        return None
    if len(mv) < _PREAMBLE + 4 + _CRC_TRAILER:
        return False
    (want,) = struct.unpack_from("<I", mv, len(mv) - _CRC_TRAILER)
    return zlib.crc32(mv[:len(mv) - _CRC_TRAILER]) == want


def is_chunk_frame(payload) -> bool:
    """True iff ``payload`` is a v2 chunk frame (cheap preamble check)."""
    mv = memoryview(payload)
    return (len(mv) >= _PREAMBLE and mv[0] == WIRE_MAGIC
            and mv[1] == WIRE_VERSION and bool(mv[2] & FLAG_CHUNK))


def decode_tensor_dict_chunks(frames, *, copy: bool = False
                              ) -> dict[str, np.ndarray]:
    """Reassemble chunk frames (any order) and decode.

    Tensors contained within a single chunk decode as zero-copy views of
    that chunk; only tensors spanning a chunk boundary are stitched into
    fresh buffers."""
    parsed: dict[int, tuple[dict, memoryview]] = {}
    total = None
    for frame in frames:
        header, body, flags = _parse_frame(frame)
        if not flags & FLAG_CHUNK:
            raise ValueError("not a chunk frame; use decode_tensor_dict")
        info = header.get("chunk")
        if not isinstance(info, dict):
            raise ValueError("chunk frame missing chunk descriptor")
        idx, n = int(info["index"]), int(info["total"])
        if total is None:
            total = n
        elif n != total:
            raise ValueError(f"inconsistent chunk totals ({n} vs {total})")
        if idx in parsed:
            raise ValueError(f"duplicate chunk {idx}")
        parsed[idx] = (header, body)
    if total is None or sorted(parsed) != list(range(total)):
        raise ValueError(
            f"incomplete chunk set: have {sorted(parsed)} of {total}")
    head = parsed[0][0]
    metas = head.get("tensors")
    if not isinstance(metas, list):
        raise ValueError("chunk 0 missing tensor table")
    payload_len = head.get("payload_len")
    # Segment table: (logical start, body) in order, offsets contiguous.
    segments = []
    offset = 0
    for i in range(total):
        header, body = parsed[i]
        if int(header["chunk"].get("offset", -1)) != offset:
            raise ValueError(f"chunk {i} offset mismatch")
        segments.append((offset, body))
        offset += len(body)
    if payload_len is not None and offset != int(payload_len):
        raise ValueError(
            f"chunk payload length {offset} != declared {payload_len}")

    out: dict[str, np.ndarray] = {}
    pos = 0
    seg_i = 0
    for meta in metas:
        dt, shape, nbytes, packed = _tensor_extent(meta)
        end = pos + nbytes
        if end > offset:
            raise ValueError(f"truncated buffer for {meta.get('name')!r}")
        # Advance to the segment containing pos.
        while seg_i + 1 < len(segments) and segments[seg_i + 1][0] <= pos:
            seg_i += 1
        seg_start, seg_body = segments[seg_i]
        if end <= seg_start + len(seg_body) or nbytes == 0:
            raw = seg_body[pos - seg_start:end - seg_start]
            arr = np.frombuffer(raw, dtype=dt)
            if packed:
                arr = as_packed_int4(arr.copy() if copy else arr, shape)
            else:
                arr = arr.reshape(shape)
                arr = arr.copy() if copy else arr
        else:  # spans chunks: stitch (the only copying reassembly path)
            buf = bytearray(nbytes)
            filled = 0
            j = seg_i
            while filled < nbytes:
                s_start, s_body = segments[j]
                lo = pos + filled - s_start
                take = min(len(s_body) - lo, nbytes - filled)
                buf[filled:filled + take] = s_body[lo:lo + take]
                filled += take
                j += 1
            arr = np.frombuffer(bytes(buf), dtype=dt)
            arr = as_packed_int4(arr, shape) if packed \
                else arr.reshape(shape)
        out[str(meta.get("name"))] = arr
        pos = end
    return out
