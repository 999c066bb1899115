"""The port's DeviceCodec against the JAX package's ``compress_push`` and
JAX ``DeviceCodec``: payloads byte-for-byte equal (key order, dtypes,
bytes, int4 logical shapes), with error feedback over three pushes. On
the card the reference's payloads come from the fixture of
``test_torch_jax_reference.py`` (the GPU host has no jax)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_jax_reference import CODEC_PLANS, CODEC_PUSHES, \
    WIRE_PLAN, codec_payload, wire_frame

from distributed_parameter_server_for_ml_training_tpu.ops.compression \
    import ErrorFeedback as JaxErrorFeedback, compress_push as jax_compress
from distributed_parameter_server_for_ml_training_tpu.ops.device_codec \
    import DeviceCodec as JaxDeviceCodec
from distributed_parameter_server_for_ml_training_tpu_torch.comms.wire \
    import encode_tensor_dict
from distributed_parameter_server_for_ml_training_tpu_torch.ops.compression \
    import ErrorFeedback, compress_push, wire_decompress
from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
    device_codec as DC, quantize as Q
from distributed_parameter_server_for_ml_training_tpu_torch.ops.device_codec \
    import DeviceCodec, is_device_tree

SHAPES = {"stem/kernel": (3, 3, 3, 8), "stem/bias": (8,),
          "blk/Conv_0/kernel": (3, 3, 8, 16), "odd": (1001,),
          "head/kernel": (64, 100), "head/bias": (100,)}

PLANS = {
    "int8": {n: "int8" for n in SHAPES},
    "int4": {n: "int4" for n in SHAPES},
    "topk": {n: "topk" for n in SHAPES},
    "mixed": {"stem/kernel": "int4", "stem/bias": "none",
              "blk/Conv_0/kernel": "topk", "odd": "int4",
              "head/kernel": "topk", "head/bias": "int8"},
}


def _grads(rng):
    return {n: (rng.standard_normal(s) * 1e-2).astype(np.float32)
            for n, s in SHAPES.items()}


def _assert_same(got: dict, want: dict, where: str):
    assert list(got) == list(want), where
    for k in want:
        a, b = got[k], want[k]
        assert np.asarray(a).dtype == np.asarray(b).dtype, (where, k)
        assert np.asarray(a).shape == np.asarray(b).shape, (where, k)
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), (where, k)
        assert getattr(a, "logical_shape", None) == \
            getattr(b, "logical_shape", None), (where, k)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("plan_name", list(PLANS))
def test_device_codec_bytes_equal_reference_with_ef(plan_name, shared):
    plan = PLANS[plan_name]
    rng = np.random.default_rng(list(PLANS).index(plan_name) * 2 + shared)
    port = DeviceCodec(error_feedback=True, device="cpu")
    jax_dev = JaxDeviceCodec(error_feedback=True, use_pallas=False)
    jax_ef, port_ef = JaxErrorFeedback(), ErrorFeedback()
    for push in range(3):
        g = _grads(rng)
        scales = ({n: float(np.abs(a).max()) * 0.8 for n, a in g.items()
                   if n != "odd"} if shared else None)
        want = jax_compress(g, plan, scales=scales, ef=jax_ef)
        got = port.encode_now({n: torch.from_numpy(a) for n, a in g.items()},
                              plan, scales=scales)
        _assert_same(got, want, f"{plan_name} push {push} vs compress_push")
        _assert_same(got, jax_dev.encode_now(
            {n: jnp.asarray(a) for n, a in g.items()}, plan, scales=scales),
            f"{plan_name} push {push} vs JAX DeviceCodec")
        # The port's own NumPy codec is the same code as the reference's.
        _assert_same(compress_push(g, plan, scales=scales, ef=port_ef), want,
                     f"{plan_name} push {push} port compress_push")


def test_device_codec_without_ef_and_default_plan():
    g = _grads(np.random.default_rng(0))
    got = DeviceCodec(error_feedback=False, device="cpu").encode_now(
        {n: torch.from_numpy(a) for n, a in g.items()})
    _assert_same(got, jax_compress(g), "default int8 plan")
    dec = wire_decompress(got)
    for n, a in g.items():
        scale = float(np.abs(a).max()) / 127
        np.testing.assert_allclose(dec[n], a, atol=scale * 0.5 + 1e-9)


@pytest.mark.parametrize("kind", ["int8", "int4", "topk"])
@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_non_finite_raises(kind, bad):
    g = _grads(np.random.default_rng(1))
    g["odd"][17] = bad
    codec = DeviceCodec(device="cpu")
    with pytest.raises(ValueError, match="non-finite"):
        codec.encode_now({n: torch.from_numpy(a) for n, a in g.items()},
                         {n: kind for n in g})


def test_reset_drops_residuals():
    g = _grads(np.random.default_rng(2))
    t = {n: torch.from_numpy(a) for n, a in g.items()}
    codec = DeviceCodec(device="cpu")
    first = codec.encode_now(t)
    codec.encode_now(t)
    codec.reset()
    _assert_same(codec.encode_now(t), first, "after reset")


def test_is_device_tree():
    assert is_device_tree({"a": torch.zeros(2)})
    assert not is_device_tree({"a": np.zeros(2)})
    assert not is_device_tree({})


@pytest.mark.parametrize("plan_name", list(PLANS))
def test_one_quantize_call_per_push(plan_name, monkeypatch):
    """Every quantized tensor of a push goes through one call of K1's
    multi-tensor wrapper: int8 entries and top-k values first (their
    codes fill the front of the flat buffer, copied to the host at once),
    then int4."""
    plan = PLANS[plan_name]
    calls = []

    def spy(xs, scales, levels):
        calls.append(list(levels))
        return Q.wire_quantize_multi(xs, scales, levels)

    monkeypatch.setattr(DC, "wire_quantize_multi", spy)
    g = _grads(np.random.default_rng(5))
    codec = DeviceCodec(device="cpu")
    for _ in range(2):
        payload = codec.encode({n: torch.from_numpy(a) for n, a in g.items()},
                               plan)
    assert len(calls) == 2
    kinds = [plan[n] for n in SHAPES if plan[n] != "none"]
    assert calls[0] == sorted((7 if k == "int4" else 127 for k in kinds),
                              reverse=True)
    int8_keys = [k for k in payload.order if k in payload.code_at]
    assert len(int8_keys) == sum(k in ("int8", "topk") for k in kinds)
    offsets, _, _ = Q.wire_multi_layout(
        [int(np.prod(payload.code_at[k][1])) for k in int8_keys])
    assert [payload.code_at[k][0] for k in int8_keys] == offsets.tolist()


@pytest.mark.cuda
def test_cuda_device_codec_bytes_equal_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the codec's kernel runs only on "
                    "the card")
    before = (Q.wire_quantize_multi.launches, Q.wire_quantize.launches)
    for plan_name in CODEC_PLANS:
        plan = PLANS[plan_name]
        rng = np.random.default_rng(list(PLANS).index(plan_name))
        port = DeviceCodec(error_feedback=True, device="cuda")
        for push in range(CODEC_PUSHES):
            g = _grads(rng)
            got = port.encode_now(
                {n: torch.from_numpy(a).cuda() for n, a in g.items()}, plan)
            _assert_same(got, codec_payload(plan_name, push),
                         f"cuda {plan_name} push {push}")
    # One launch of the multi-tensor K1 a push; the per-tensor K1 never.
    assert (Q.wire_quantize_multi.launches - before[0],
            Q.wire_quantize.launches - before[1]) == (
                len(CODEC_PLANS) * CODEC_PUSHES, 0)


def _wire_frames(device: str) -> list:
    """The port's checksummed frames of the device codec's int8 pushes,
    the inputs and error feedback of the fixture's int8 plan."""
    rng = np.random.default_rng(list(PLANS).index(WIRE_PLAN))
    codec = DeviceCodec(error_feedback=True, device=device)
    frames = []
    for _ in range(CODEC_PUSHES):
        g = {n: torch.from_numpy(a).to(device) for n, a in _grads(rng).items()}
        frames.append(encode_tensor_dict(
            codec.encode_now(g, PLANS[WIRE_PLAN]), checksum=True))
    return frames


def test_device_codec_frames_equal_the_jax_frames():
    """What a RemoteStore sends for an int8 push on the CPU: the JAX
    package's frame of ``compress_push``'s payload, byte for byte."""
    assert _wire_frames("cpu") == [wire_frame(p)
                                   for p in range(CODEC_PUSHES)]


@pytest.mark.cuda
def test_cuda_device_codec_frames_equal_the_jax_frames():
    """The same on the card: K1's payload, framed by the port's wire
    codec, is the fixture's JAX frame byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the codec's kernel runs only on "
                    "the card")
    before = Q.wire_quantize_multi.launches
    assert _wire_frames("cuda") == [wire_frame(p)
                                    for p in range(CODEC_PUSHES)]
    assert Q.wire_quantize_multi.launches - before == CODEC_PUSHES
