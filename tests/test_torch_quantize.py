"""K1's plain version and the codec's per-tensor ops against the JAX
package, bit for bit; the kernel against its plain version on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.ops.packed import \
    pack_nibbles
from distributed_parameter_server_for_ml_training_tpu.ops.pallas.quantize \
    import topk_select_flat as jax_topk_select_flat, \
    wire_quantize as jax_wire_quantize
from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
    quantize as Q

SIZES = [0, 1, 3, 5, 127, 129, 1000, 4097]


def _inputs(n, levels, kind, seed=0):
    r = np.random.default_rng(seed + n)
    x = (r.standard_normal(n) * 0.3).astype(np.float32)
    amax = float(np.abs(x).max()) if n else 0.0
    scale = np.float32(amax / levels) if amax > 0 else np.float32(1.0)
    if kind == "zeros":
        x = np.zeros(n, np.float32)
    elif kind == "half":
        # exact half-steps: round-half-to-even decides every element
        x = ((r.integers(-levels, levels, n) + 0.5) * scale).astype(
            np.float32)
    elif kind == "clip":
        x = (x * 4 * levels).astype(np.float32)
    return x, scale


@pytest.mark.parametrize("levels", [127, 7])
@pytest.mark.parametrize("kind", ["random", "zeros", "half", "clip"])
@pytest.mark.parametrize("n", SIZES)
def test_plain_wire_quantize_bit_equal_to_jax(n, kind, levels):
    x, scale = _inputs(n, levels, kind)
    want = np.asarray(jax_wire_quantize(jnp.asarray(x), scale,
                                        levels=levels, use_pallas=False))
    got = Q.wire_quantize(torch.from_numpy(x), scale, levels=levels)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    assert got.numpy().tobytes() == want.tobytes()


def test_half_steps_round_to_even():
    s = np.float32(0.25)
    x = torch.tensor([0.125, 0.375, -0.125, -0.375, 0.625], dtype=torch.float32)
    # 0.5 -> 0, 1.5 -> 2, -0.5 -> -0, -1.5 -> -2, 2.5 -> 2
    assert Q.wire_quantize(x, s).tolist() == [0, 2, 0, -2, 2]


def test_wire_quantize_keeps_shape():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 3, 4, 5)).astype(np.float32))
    q = Q.wire_quantize(x, 0.01, levels=7)
    assert q.shape == x.shape and int(q.abs().max()) == 7


@pytest.mark.parametrize("n", [1, 2, 7, 8, 1001])
def test_pack_nibbles_device_matches_numpy(n):
    q = np.random.default_rng(n).integers(-8, 8, n).astype(np.int8)
    got = Q.pack_nibbles_device(torch.from_numpy(q)).numpy()
    assert got.dtype == np.uint8
    assert got.tobytes() == pack_nibbles(q).tobytes()


@pytest.mark.parametrize("n,k", [(10, 1), (1000, 10), (4097, 41),
                                 (64, 64)])
def test_topk_select_matches_jax(n, k):
    # unique magnitudes (boundary ties are unspecified in the reference)
    r = np.random.default_rng(n)
    x = ((r.permutation(n) + 1) * np.where(r.random(n) < 0.5, -1, 1)
         ).astype(np.float32) / 64
    ji, jv = jax_topk_select_flat(jnp.asarray(x), k)
    ti, tv = Q.topk_select_flat(torch.from_numpy(x), k)
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs only on the card")
    before = Q.wire_quantize.launches
    for n in SIZES:
        for levels in (127, 7):
            for kind in ("random", "zeros", "half", "clip"):
                x, scale = _inputs(n, levels, kind)
                xd = torch.from_numpy(x).cuda()
                got = Q.wire_quantize_flat(xd, float(scale), levels)
                want = Q.wire_quantize_plain(xd, float(scale), levels)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (n, levels, kind)
                ref = np.asarray(jax_wire_quantize(
                    jnp.asarray(x), scale, levels=levels, use_pallas=False))
                assert got.cpu().numpy().tobytes() == ref.tobytes()
    assert Q.wire_quantize.launches - before == 2 * 4 * (len(SIZES) - 1)


@pytest.mark.cuda
def test_kernel_launches_on_the_tensors_device():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: a tensor on a card that is not "
                    "the current device")
    x, scale = _inputs(1000, 127, "half")
    with torch.cuda.device(0):
        xd = torch.from_numpy(x).to("cuda:1")
        got = Q.wire_quantize_flat(xd, float(scale), 127)
        want = Q.wire_quantize_plain(xd, float(scale), 127)
        torch.cuda.synchronize(1)
        assert torch.cuda.current_device() == 0
    assert got.device == xd.device
    assert torch.equal(got, want)
