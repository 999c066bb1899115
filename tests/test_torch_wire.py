"""The port's wire codec (``…_torch/comms/wire.py``) against the JAX
package's: frames equal byte for byte on the same tensor dicts (every wire
dtype, 0-d, zero-element and non-contiguous tensors, with and without the
CRC-32 trailer, chunked at a small budget), each package decoding the
other's frames, legacy v1 frames, the CRC refusing a flipped byte, the
guards of the frame parser, and the one-copy-per-tensor hook."""

import json
import struct

import ml_dtypes
import numpy as np
import pytest

from distributed_parameter_server_for_ml_training_tpu.comms import wire as JW
from distributed_parameter_server_for_ml_training_tpu.ops import \
    packed as JP
from distributed_parameter_server_for_ml_training_tpu_torch.comms import \
    wire as PW
from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
    packed as PP

PACKAGES = {"jax": (JW, JP), "port": (PW, PP)}


def tensors(pkg: str, seed: int = 0) -> dict:
    """One dict of every kind the wire carries, built with ``pkg``'s own
    ``PackedInt4`` (each package's wire recognizes its own class)."""
    packed = PACKAGES[pkg][1]
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((6, 5)).astype(np.float32)
    return {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "f16": rng.standard_normal(7).astype(np.float16),
        "bf16": rng.standard_normal((2, 3)).astype(ml_dtypes.bfloat16),
        "i8": rng.integers(-127, 128, (5, 2), dtype=np.int8),
        "i32": rng.integers(-2**31, 2**31 - 1, 9, dtype=np.int32),
        "int4": packed.as_packed_int4(
            packed.pack_nibbles(rng.integers(-8, 8, 11, dtype=np.int8)),
            (11,)),
        "scalar": np.float32(0.125),
        "zero_d": np.array(3, np.int64),
        "empty": np.zeros((0, 4), np.float32),
        "strided": base[::2, 1:4],          # a non-contiguous view
        "transposed": base.T,
    }


def _assert_same(got: dict, want: dict):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert (g.dtype, g.shape) == (np.asarray(w).dtype,
                                      np.asarray(w).shape), k
        assert g.tobytes() == np.ascontiguousarray(w).tobytes(), k
        assert getattr(g, "logical_shape", None) == \
            getattr(w, "logical_shape", None), k


@pytest.mark.parametrize("trace", [None, {"trace_id": "ab" * 8,
                                          "span_id": "cd" * 4}],
                         ids=["untraced", "traced"])
@pytest.mark.parametrize("checksum", [False, True],
                         ids=["plain", "checksum"])
def test_encode_is_the_jax_frame_byte_for_byte(checksum, trace):
    want = JW.encode_tensor_dict(tensors("jax"), trace=trace,
                                 checksum=checksum)
    got = PW.encode_tensor_dict(tensors("port"), trace=trace,
                                checksum=checksum)
    assert got == want
    assert PW.frame_checksum_ok(got) is (True if checksum else None)
    assert PW.peek_trace(got) == JW.peek_trace(want) == trace


@pytest.mark.parametrize("budget", [1, 16, 40, 1 << 20])
@pytest.mark.parametrize("checksum", [False, True],
                         ids=["plain", "checksum"])
def test_chunks_are_the_jax_chunks(budget, checksum):
    want = JW.encode_tensor_dict_chunks(tensors("jax"), budget,
                                        checksum=checksum)
    got = PW.encode_tensor_dict_chunks(tensors("port"), budget,
                                       checksum=checksum)
    assert got == want
    assert all(PW.is_chunk_frame(f) for f in got)
    assert not PW.is_chunk_frame(PW.encode_tensor_dict(tensors("port")))
    # Any order reassembles; both packages read both packages' chunks.
    for decode in (PW.decode_tensor_dict_chunks,
                   JW.decode_tensor_dict_chunks):
        _assert_same(decode(list(reversed(got))), tensors("jax"))
    with pytest.raises(ValueError):
        PW.decode_tensor_dict_chunks(got[1:] or [b""])


@pytest.mark.parametrize("copy", [False, True], ids=["views", "copies"])
@pytest.mark.parametrize("checksum", [False, True],
                         ids=["plain", "checksum"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax"),
                                           ("port", "port")])
def test_each_package_decodes_the_others_frames(writer, reader, checksum,
                                                copy):
    frame = PACKAGES[writer][0].encode_tensor_dict(tensors(writer),
                                                   checksum=checksum)
    out = PACKAGES[reader][0].decode_tensor_dict(frame, copy=copy)
    _assert_same(out, tensors(writer))
    packed_cls = PACKAGES[reader][1].PackedInt4
    assert isinstance(out["int4"], packed_cls)
    # Zero-copy views are read-only over the frame's bytes; copies own
    # writable memory.
    assert all(a.flags.writeable is copy for a in out.values()
               if a.size)


def _v1_frame(arrays: dict) -> bytes:
    """A legacy v1 frame: [u32 header_len][header JSON][buffers]."""
    metas = [{"name": k, "dtype": a.dtype.name, "shape": list(a.shape)}
             for k, a in arrays.items()]
    header = json.dumps({"tensors": metas}).encode()
    return struct.pack("<I", len(header)) + header + b"".join(
        np.ascontiguousarray(a).tobytes() for a in arrays.values())


@pytest.mark.parametrize("pad", [1, 40, 300])
def test_legacy_v1_frame_decodes(pad):
    arrays = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
              "b": np.arange(4, dtype=np.int8),
              # Pads the JSON so header_len's low bytes take other values
              # (0x02D5-like lengths start with the v2 magic).
              "n" * pad: np.zeros(0, np.float32)}
    frame = _v1_frame(arrays)
    for w in (PW, JW):
        _assert_same(w.decode_tensor_dict(frame), arrays)
    assert PW.peek_trace(frame) is None
    assert PW.frame_checksum_ok(frame) is None


def test_v1_header_length_of_725_is_not_taken_for_v2():
    """A v1 frame whose u32 header length is 725 starts [0xD5, 0x02],
    the v2 magic and version: the '{' position tells them apart."""
    name = "x" * 10
    for extra in range(1000):
        meta = [{"name": name + "y" * extra, "dtype": "float32",
                 "shape": [1]}]
        header = json.dumps({"tensors": meta}).encode()
        if len(header) == 725:
            break
    frame = struct.pack("<I", 725) + header + np.float32(2).tobytes()
    assert frame[:2] == bytes([0xD5, 0x02])
    for w in (PW, JW):
        out = w.decode_tensor_dict(frame)
        assert list(out) == [meta[0]["name"]]
        assert out[meta[0]["name"]].tolist() == [2.0]


@pytest.mark.parametrize("where", ["preamble", "header", "body", "trailer"])
def test_flipped_byte_fails_the_crc_in_both(where):
    frame = bytearray(PW.encode_tensor_dict(tensors("port"), checksum=True))
    hlen = struct.unpack_from("<I", frame, 4)[0]
    pos = {"preamble": 3, "header": 8 + hlen // 2,
           "body": 8 + hlen + 5, "trailer": len(frame) - 2}[where]
    frame[pos] ^= 0x10
    bad = bytes(frame)
    for w in (PW, JW):
        assert w.frame_checksum_ok(bad) is False
        with pytest.raises(ValueError):
            w.decode_tensor_dict(bad)


def _header_frame(header: dict, body: bytes = b"") -> bytes:
    h = json.dumps(header).encode()
    return struct.pack("<BBBBI", 0xD5, 2, 0, 0, len(h)) + h + body


@pytest.mark.parametrize("frame", [
    b"", b"\xd5\x02", _header_frame({"tensors": [{"name": "x",
                                                 "dtype": "complex64",
                                                 "shape": [1]}]}),
    _header_frame({"tensors": [{"name": "x", "dtype": "float32",
                                "shape": [-1]}]}),
    _header_frame({"tensors": [{"name": "x", "dtype": "float32",
                                "shape": [True]}]}),
    _header_frame({"tensors": [{"name": "x", "dtype": "float32",
                                "shape": [2.0]}]}),
    _header_frame({"tensors": [{"name": "x", "dtype": "float32",
                                "shape": [4]}]}, b"\0" * 15),
    _header_frame({"no_tensors": []}),
    struct.pack("<BBBBI", 0xD5, 2, 0, 0, PW.MAX_HEADER_BYTES + 1) + b"{" * 8,
    struct.pack("<BBBBI", 0xD5, 3, 0, 0, 2) + b"{}",
    struct.pack("<BBBBI", 0xD5, 2, 0, 0, 10) + b"{" + b"\xff" * 9,
], ids=["empty", "short", "dtype", "negative_dim", "bool_dim", "float_dim",
        "truncated_buffer", "no_table", "header_cap", "version",
        "bad_utf8"])
def test_parser_guards_refuse_what_the_jax_parser_refuses(frame):
    for w in (PW, JW):
        with pytest.raises(ValueError):
            w.decode_tensor_dict(frame)
    assert PW.peek_trace(frame) is None


def test_chunk_frame_refused_by_the_single_frame_decoder():
    chunks = PW.encode_tensor_dict_chunks(tensors("port"), 64)
    with pytest.raises(ValueError, match="chunk frame"):
        PW.decode_tensor_dict(chunks[0])
    with pytest.raises(ValueError, match="not a chunk frame"):
        PW.decode_tensor_dict_chunks([PW.encode_tensor_dict(
            tensors("port"))])
    with pytest.raises(ValueError, match="max_chunk_bytes"):
        PW.encode_tensor_dict_chunks(tensors("port"), 0)


@pytest.mark.parametrize("chunked", [False, True], ids=["frame", "chunks"])
def test_copy_hook_counts_one_copy_per_tensor(chunked):
    """One frame write per tensor with bytes, plus one make_contiguous
    per non-contiguous input — the JAX package's counts exactly."""
    counts = {}
    for name, (w, _) in PACKAGES.items():
        seen = []
        prev = w.set_copy_count_hook(lambda n, r: seen.append((n, r)))
        try:
            if chunked:
                w.encode_tensor_dict_chunks(tensors(name), 32)
            else:
                w.encode_tensor_dict(tensors(name), checksum=True)
        finally:
            w.set_copy_count_hook(prev)
        counts[name] = seen
    assert counts["port"] == counts["jax"]
    writes = [n for n, r in counts["port"] if r == "frame_write"]
    assert sorted(writes) == sorted(k for k, a in tensors("port").items()
                                    if np.asarray(a).nbytes)
    assert sorted(n for n, r in counts["port"]
                  if r == "make_contiguous") == ["strided", "transposed"]


def test_unsupported_dtype_is_refused_at_encode():
    for w in (PW, JW):
        with pytest.raises(ValueError, match="unsupported dtype"):
            w.encode_tensor_dict({"c": np.zeros(2, np.complex64)})
