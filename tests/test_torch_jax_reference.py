"""The JAX-reference fixture ``tests/torch_port_jax_reference.npz``: the JAX
package's outputs for the inputs of the port's card tests.

The GPU host has no jax. So the ``cuda`` tests that hold the card to the
JAX package read the JAX package's outputs from this file: K1's codes
(``test_torch_quantize.py``: ``SIZES`` x levels x kinds, and one
multi-tensor push), K2's codes and scales and K4's round trip for
``BLOCK_CASES``, ``compress_push`` over 3 plans x 3 pushes with error
feedback (``test_torch_device_codec.py``), and the checksummed wire frame
(``comms/wire.py:encode_tensor_dict``) of each int8 push, as uint8 bytes.
The tests here recompute every entry with the JAX package on the CPU and
assert that the file holds exactly those bytes, so the file cannot drift
from the reference.

Regenerate it after changing one of those inputs, on a host with jax:

    JAX_PLATFORMS=cpu python tests/test_torch_jax_reference.py
"""

from __future__ import annotations

import functools
import os
import sys
from pathlib import Path

import numpy as np
import pytest

FIXTURE = Path(__file__).with_name("torch_port_jax_reference.npz")
#: The device codec's plans held on the card, 3 pushes each with EF.
CODEC_PLANS = ("int8", "int4", "mixed")
CODEC_PUSHES = 3
SECTIONS = ("k1/", "k1_multi/", "block/", "codec/", "wire/")
#: The plan whose pushes' frames the fixture holds.
WIRE_PLAN = "int8"


def k1_key(n: int, levels: int, kind: str) -> str:
    return f"k1/{n}/{levels}/{kind}"


def k1_multi_key(i: int) -> str:
    return f"k1_multi/{i}"


def block_key(case: str, what: str) -> str:
    """``what``: values, scales or dequantized."""
    return f"block/{case}/{what}"


def _codec_base(plan: str, push: int) -> str:
    return f"codec/{plan}/{push}"


def wire_key(push: int) -> str:
    return f"wire/{WIRE_PLAN}/{push}"


def wire_frame(push: int) -> bytes:
    """The JAX package's checksummed frame of push ``push`` of the int8
    plan, from the fixture."""
    return jax_reference()[wire_key(push)].tobytes()


@functools.lru_cache(maxsize=None)
def jax_reference() -> dict:
    """Every array of the fixture, by key."""
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def codec_payload(plan: str, push: int) -> dict:
    """``compress_push``'s payload for push ``push`` of ``plan``, from the
    fixture: its key order, dtypes, bytes and int4 logical shapes."""
    from distributed_parameter_server_for_ml_training_tpu_torch.ops.packed \
        import as_packed_int4

    ref, base = jax_reference(), _codec_base(plan, push)
    out = {}
    for key in ref[f"{base}/::order"]:
        key = str(key)
        arr = ref[f"{base}/{key}"]
        shape = ref.get(f"{base}/::logical/{key}")
        out[key] = arr if shape is None else as_packed_int4(arr, shape)
    return out


def reference_arrays() -> dict:
    """Every fixture entry, computed with the JAX package."""
    import jax.numpy as jnp
    import test_torch_device_codec as TC
    import test_torch_quantize as TQ

    from distributed_parameter_server_for_ml_training_tpu.comms.wire import \
        encode_tensor_dict
    from distributed_parameter_server_for_ml_training_tpu.ops.compression \
        import ErrorFeedback, compress_push
    from distributed_parameter_server_for_ml_training_tpu.ops.pallas import \
        quantize as JQ

    def k1(x, scale, levels):
        return np.asarray(JQ.wire_quantize(jnp.asarray(x), scale,
                                           levels=levels, use_pallas=False))

    out = {}
    for n in TQ.SIZES:
        for levels in (127, 7):
            for kind in TQ.KINDS:
                out[k1_key(n, levels, kind)] = k1(
                    *TQ._inputs(n, levels, kind), levels)
    for i, case in enumerate(zip(*TQ.multi_case())):
        out[k1_multi_key(i)] = k1(*case)
    for case in sorted(TQ.BLOCK_CASES):
        x = TQ._block_input(case)
        v, s = JQ.quantize_int8(jnp.asarray(x))
        out[block_key(case, "values")] = np.asarray(v)
        out[block_key(case, "scales")] = np.asarray(s)
        out[block_key(case, "dequantized")] = np.asarray(
            JQ.dequantize_int8(v, s, x.shape))
    for plan_name in CODEC_PLANS:
        rng = np.random.default_rng(list(TC.PLANS).index(plan_name))
        ef = ErrorFeedback()
        for push in range(CODEC_PUSHES):
            payload = compress_push(TC._grads(rng), TC.PLANS[plan_name],
                                    ef=ef)
            base = _codec_base(plan_name, push)
            if plan_name == WIRE_PLAN:
                out[wire_key(push)] = np.frombuffer(
                    encode_tensor_dict(payload, checksum=True), np.uint8)
            out[f"{base}/::order"] = np.array(list(payload))
            for key, arr in payload.items():
                out[f"{base}/{key}"] = np.asarray(arr)
                if hasattr(arr, "logical_shape"):
                    out[f"{base}/::logical/{key}"] = np.asarray(
                        arr.logical_shape, np.int64)
    return out


@functools.lru_cache(maxsize=None)
def _fresh() -> dict:
    return reference_arrays()


@pytest.mark.parametrize("section", SECTIONS)
def test_fixture_matches_the_jax_package(section):
    want = {k: v for k, v in _fresh().items() if k.startswith(section)}
    got = {k: v for k, v in jax_reference().items() if k.startswith(section)}
    assert want and sorted(got) == sorted(want)
    for k, a in want.items():
        b = got[k]
        assert (b.dtype, b.shape) == (a.dtype, a.shape), k
        assert b.tobytes() == a.tobytes(), k


def test_codec_payload_rebuilds_compress_push():
    """The fixture's payloads carry compress_push's key order and int4
    logical shapes, which the wire's bytes depend on."""
    import test_torch_device_codec as TC

    from distributed_parameter_server_for_ml_training_tpu.ops.compression \
        import ErrorFeedback, compress_push

    rng = np.random.default_rng(list(TC.PLANS).index("mixed"))
    want = compress_push(TC._grads(rng), TC.PLANS["mixed"],
                         ef=ErrorFeedback())
    got = codec_payload("mixed", 0)
    TC._assert_same(got, want, "fixture mixed push 0")
    assert any(getattr(a, "logical_shape", None) for a in got.values())


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                    str(Path(__file__).resolve().parent)]
    np.savez_compressed(FIXTURE, **reference_arrays())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")
