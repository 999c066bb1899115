"""K1's plain version and the codec's per-tensor ops against the JAX
package, bit for bit; the kernel against its plain version on a card, and
against the JAX package through the fixture of
``test_torch_jax_reference.py`` (the GPU host has no jax)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_jax_reference import block_key, jax_reference, k1_key, \
    k1_multi_key

from distributed_parameter_server_for_ml_training_tpu.ops.packed import \
    pack_nibbles
from distributed_parameter_server_for_ml_training_tpu.ops.pallas.quantize \
    import topk_select_flat as jax_topk_select_flat, \
    wire_quantize as jax_wire_quantize
from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
    quantize as Q

SIZES = [0, 1, 3, 5, 127, 129, 1000, 4097]
KINDS = ("random", "zeros", "half", "clip")


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
@pytest.mark.parametrize("kind", KINDS)
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


# -- K1 over a whole push: one launch per 64 tensors --------------------------

#: The multi-tensor case: 70 entries (two launches of at most 64), mixed
#: levels, sizes 0, 1, 3, 4,097 and 65,539, two shaped tensors and short
#: tails; entry MISALIGNED is passed as a view x[1:] of a longer tensor,
#: off 16-byte alignment.
MULTI_SHAPES = [(0,), (1,), (3,), (4097,), (65539,), (3, 3, 8, 16),
                (64, 100)] + [(5 + 31 * (i % 7),) for i in range(63)]
MISALIGNED = 4


def multi_case(seed=11):
    """(inputs, scales, levels) of the multi-tensor case, from numpy: a
    quarter of each input at exact half-steps, a quarter far beyond the
    clamp."""
    r = np.random.default_rng(seed)
    xs, scales, levels = [], [], []
    for i, shape in enumerate(MULTI_SHAPES):
        lv = 7 if i % 3 == 1 else 127
        n = math.prod(shape)
        x = (r.standard_normal(n) * 0.3).astype(np.float32)
        amax = float(np.abs(x).max()) if n else 0.0
        scale = np.float32(amax / lv) if amax > 0 else np.float32(1.0)
        k = n // 4
        x[:k] = ((r.integers(-lv, lv, k) + 0.5) * scale).astype(np.float32)
        x[n - k:] *= 4 * lv
        xs.append(x.reshape(shape))
        scales.append(scale)
        levels.append(lv)
    return xs, scales, levels


def multi_tensors(xs, device):
    """The case's inputs as tensors on ``device``; entry MISALIGNED is the
    view x[1:] of a tensor one value longer."""
    out = []
    for i, x in enumerate(xs):
        t = torch.from_numpy(x).to(device)
        if i == MISALIGNED:
            base = torch.zeros(x.size + 1, dtype=torch.float32,
                               device=device)
            base[1:] = t.reshape(-1)
            t = base[1:].view(x.shape)
        out.append(t)
    return out


def test_wire_multi_layout():
    offsets, total, groups = Q.wire_multi_layout([0, 1, 16, 17, 3])
    assert offsets.tolist() == [0, 0, 16, 32, 64] and total == 80
    assert groups == [range(0, 5)]
    offsets, total, groups = Q.wire_multi_layout(
        [math.prod(s) for s in MULTI_SHAPES])
    assert all(o % Q.WIRE_ALIGN == 0 for o in offsets)
    assert groups == [range(0, 64), range(64, 70)]
    assert all(len(g) <= Q.WIRE_MAX_ENTRIES for g in groups)
    assert total == sum(-(-math.prod(s) // 16) * 16 for s in MULTI_SHAPES)
    offsets, total, groups = Q.wire_multi_layout([])
    assert offsets.tolist() == [] and total == 0 and groups == []


def test_multi_plain_bit_equal_to_jax_per_entry():
    xs, scales, levels = multi_case()
    before = Q.wire_quantize_multi.launches
    flat, views, got_offsets = Q.wire_quantize_multi(
        multi_tensors(xs, "cpu"), scales, levels)
    assert Q.wire_quantize_multi.launches == before
    offsets, total, _ = Q.wire_multi_layout([x.size for x in xs])
    assert got_offsets == offsets.tolist()
    assert flat.dtype == torch.int8 and tuple(flat.shape) == (total,)
    covered = torch.zeros(total, dtype=torch.bool)
    for x, s, lv, o, v in zip(xs, scales, levels, offsets, views):
        want = np.asarray(jax_wire_quantize(jnp.asarray(x), s, levels=lv,
                                            use_pallas=False))
        assert tuple(v.shape) == x.shape and v.dtype == torch.int8
        assert v.numpy().tobytes() == want.tobytes()
        assert v.numel() == 0 or v.reshape(-1).data_ptr() \
            == flat.data_ptr() + o
        covered[o:o + x.size] = True
    assert int(flat[~covered].abs().max()) == 0   # padding is code 0
    assert {int(v.abs().max()) for v in views if v.numel()} == {7, 127}


@pytest.mark.parametrize("levels", [127, 7])
def test_multi_entries_equal_one_tensor_at_a_time(levels):
    xs = [torch.randn(n, generator=torch.Generator().manual_seed(n))
          for n in (5, 0, 300)]
    scales = [np.float32(0.01)] * 3
    flat, views, offsets = Q.wire_quantize_multi(xs, scales, [levels] * 3)
    assert offsets == [0, 16, 16]
    for x, v in zip(xs, views):
        assert torch.equal(v, Q.wire_quantize_plain(x, 0.01, levels))


def test_multi_rejects_bad_arguments():
    x = torch.ones(4)
    with pytest.raises(ValueError, match="one scale and one levels value"):
        Q.wire_quantize_multi([x, x], [0.5], [127, 127])
    with pytest.raises(ValueError, match="one scale and one levels value"):
        Q.wire_quantize_multi([x, x], [0.5, 0.5], [127])
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        Q.wire_quantize_multi([torch.ones(4, device="meta")], [0.5], [127])
    flat, views, offsets = Q.wire_quantize_multi([], [], [])
    assert flat.numel() == 0 and views == [] and offsets == []


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs only on the card")
    ref = jax_reference()
    before = Q.wire_quantize_multi.launches
    for n in SIZES:
        for levels in (127, 7):
            for kind in KINDS:
                x, scale = _inputs(n, levels, kind)
                xd = torch.from_numpy(x).cuda()
                got = Q.wire_quantize_flat(xd, float(scale), levels)
                want = Q.wire_quantize_plain(xd, float(scale), levels)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (n, levels, kind)
                assert got.cpu().numpy().tobytes() == ref[
                    k1_key(n, levels, kind)].tobytes()
    # A push of one tensor: one launch of the multi-tensor K1 for each
    # input that holds values.
    assert Q.wire_quantize_multi.launches - before == \
        2 * 4 * (len(SIZES) - 1)


@pytest.mark.cuda
def test_multi_kernel_matches_plain_and_jax_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs only on the card")
    ref = jax_reference()
    xs, scales, levels = multi_case()
    xd = multi_tensors(xs, "cuda")
    assert xd[MISALIGNED].data_ptr() % 16 != 0
    before = Q.wire_quantize_multi.launches
    flat, views, offsets = Q.wire_quantize_multi(xd, scales, levels)
    want, _, want_offsets = Q.wire_quantize_multi_plain(xd, scales, levels)
    first, _, _ = Q.wire_quantize_multi(xd[:64], scales[:64], levels[:64])
    torch.cuda.synchronize()
    assert Q.wire_quantize_multi.launches - before == 2 + 1
    assert torch.equal(flat, want) and offsets == want_offsets
    assert torch.equal(first, want[:first.numel()])
    for i, v in enumerate(views):
        assert tuple(v.shape) == xs[i].shape
        assert v.numel() == 0 or v.data_ptr() == flat.data_ptr() \
            + offsets[i], i
        assert v.cpu().numpy().tobytes() == ref[k1_multi_key(i)].tobytes(), i


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


# -- block-wise int8: K2, K3, K4 -------------------------------------------

from distributed_parameter_server_for_ml_training_tpu.ops.pallas import \
    quantize as JQ  # noqa: E402

# The shapes of test_quantize.py:13-68 (padding, one 32-row block, tiles
# of 256 rows, zeros, empty, extremes, an outlier in block 0).
BLOCK_CASES = {
    "normal_1000x37": lambda r: r.normal(size=(1000, 37)),
    "ones_513": lambda r: np.ones(513),
    "ones_3_blocks_plus_5": lambda r: np.ones(3 * 256 * 128 + 5),
    "zeros_256": lambda r: np.zeros(256),
    "empty": lambda r: np.zeros(0),
    "empty_0x3": lambda r: np.zeros((0, 3)),
    "extremes": lambda r: np.array([127.0, -127.0, 0.0, 1.0]),
    "outlier_2_blocks": lambda r: np.where(np.arange(2 * 256 * 128) == 0,
                                           1000.0, 0.01),
    "half_steps": lambda r: (r.integers(-127, 127, 4097) + 0.5) / 127.0,
}


def _block_input(case, seed=0):
    return BLOCK_CASES[case](np.random.default_rng(seed)).astype(np.float32)


@pytest.mark.parametrize("rows", [0, 1, 31, 32, 33, 255, 256, 257, 512, 22016])
def test_block_rows_for_matches_jax(rows):
    assert Q.block_rows_for(rows) == JQ.block_rows_for(rows)
    n = rows * 128 - 5 if rows else 0
    _, jn, jrows = JQ._pad_to_blocks(np.zeros(n, np.float32))
    rows_padded, br, n_blocks = Q.block_layout(n)
    assert rows_padded == jrows and br == JQ.block_rows_for(jrows)
    assert n_blocks == jrows // br


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_plain_quantize_bit_equal_to_jax(case):
    x = _block_input(case)
    jv, js = JQ.quantize_int8(jnp.asarray(x))
    tv, ts = Q.quantize_int8(torch.from_numpy(x))
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(tv.shape) == jv.shape and tuple(ts.shape) == js.shape
    assert tv.numpy().tobytes() == np.asarray(jv).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_plain_dequantize_bit_equal_to_jax(case):
    x = _block_input(case)
    jv, js = JQ.quantize_int8(jnp.asarray(x))
    want = np.asarray(JQ.dequantize_int8(jv, js, x.shape))
    got = Q.dequantize_int8(torch.from_numpy(np.asarray(jv)),
                            torch.from_numpy(np.asarray(js)), x.shape)
    assert tuple(got.shape) == want.shape
    assert got.numpy().tobytes() == want.tobytes()


def test_scale_is_the_reference_reciprocal_multiply():
    """XLA computes the reference's ``abs_max / 127.0`` as a multiply by
    the fp32 reciprocal; the two differ in one ulp for some values, and
    the port's scale is the multiply's, bit for bit."""
    amax = np.float32(8.011322)
    x = np.zeros(300, np.float32)
    x[7] = amax
    _, js = JQ.quantize_int8(jnp.asarray(x))
    _, ts = Q.quantize_int8(torch.from_numpy(x))
    want = amax * np.float32(1 / 127)
    assert want != amax / np.float32(127)
    assert float(ts[0]) == float(js[0]) == float(want)


def test_quantize_dequantize_error_bound():
    x = torch.from_numpy(_block_input("normal_1000x37"))
    err = (Q.quantize_dequantize_int8(x) - x).abs()
    assert float(err.max()) <= float(x.abs().max()) / 127.0
    assert tuple(Q.quantize_dequantize_int8(torch.zeros(0, 3)).shape) == (0,
                                                                         3)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """Philox4x32-10's published known-answer vectors (Random123)."""
    words = Q.philox4x32_10([torch.tensor(c) for c in counter],
                            [torch.tensor(k) for k in key])
    assert tuple(int(w) for w in words) == want


def test_uniform24_layout():
    """Element e of a row takes word e % 4 of Philox at counter e // 4,
    keyed by the row's 64-bit seed split into two 32-bit words."""
    seed = 0x0123456789ABCDEF
    u = Q.uniform24_plain([seed, 7], 16)
    w = Q.philox4x32_10([torch.tensor(2), torch.tensor(0), torch.tensor(0),
                         torch.tensor(0)],
                        [torch.tensor(0x89ABCDEF), torch.tensor(0x01234567)])
    assert float(u[0, 9]) == (int(w[1]) >> 8) / 2 ** 24
    assert u.dtype == torch.float32 and tuple(u.shape) == (2, 16)
    assert float(u.min()) >= 0 and float(u.max()) < 1
    assert not torch.equal(u[0], u[1])
    # a seed with the top bit set is the same 64 bits as its negative
    assert torch.equal(Q.uniform24_plain([2 ** 64 - 3], 8),
                       Q.uniform24_plain([-3], 8))


def _stochastic_codes(x, seed):
    v, s = Q.quantize_int8(torch.from_numpy(x), seed, stochastic=True)
    br = Q.block_layout(x.size)[1] * 128
    scale = np.repeat(s.numpy(), br)[:x.size]
    return v.numpy().reshape(-1)[:x.size].astype(np.float64), scale, v


def test_plain_stochastic_codes_are_floor_or_floor_plus_one():
    x = _block_input("outlier_2_blocks") * np.random.default_rng(1).normal(
        size=2 * 256 * 128).astype(np.float32)
    q, scale, v = _stochastic_codes(x, 3)
    fl = np.floor(x / scale)
    assert np.all((q == np.clip(fl, -127, 127)) | (q == np.clip(fl + 1, -127,
                                                                127)))
    assert np.abs(q).max() <= 127
    # padding quantizes to code 0 in both modes
    v1, _ = Q.quantize_int8(torch.ones(513), 9, stochastic=True)
    assert int(v1.reshape(-1)[513:].abs().max()) == 0


def test_plain_stochastic_rounding_is_unbiased():
    x = np.random.default_rng(4).normal(size=4096).astype(np.float32)
    total = np.zeros(4096)
    for seed in range(200):
        q, scale, _ = _stochastic_codes(x, seed)
        total += q * scale
    err = total / 200 - x
    scale = float(np.abs(x).max()) / 127
    # per element: mean of 200 draws, sd <= scale / (2 sqrt(200))
    assert abs(float(err.mean())) < 0.01 * scale
    assert float(np.abs(err).max()) < 0.3 * scale


def test_plain_stochastic_seeds():
    x = torch.from_numpy(_block_input("normal_1000x37"))
    a = Q.quantize_int8(x, 5, stochastic=True)[0]
    b = Q.quantize_int8(x, 5, stochastic=True)[0]
    c = Q.quantize_int8(x, 6, stochastic=True)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_batch_of_rows_equals_one_row_at_a_time():
    """One launch over N rows (row stride odd, a strided view) gives each
    row's own quantization; row r draws from seeds[r]."""
    full = torch.from_numpy(np.random.default_rng(5).normal(
        size=(3, 40_001)).astype(np.float32))
    rows = full[:, :40_000]         # stride 40,001: not 16-byte aligned
    v, s = Q.block_quantize(rows)
    vs, ss = Q.block_quantize_stochastic(rows, [1, 2, 3])
    for r in range(3):
        v1, s1 = Q.quantize_int8(rows[r].contiguous())
        assert torch.equal(v[r], v1) and torch.equal(s[r], s1)
        w1, t1 = Q.quantize_int8(rows[r].contiguous(), r + 1, stochastic=True)
        assert torch.equal(vs[r], w1) and torch.equal(ss[r], t1)
    d = Q.block_dequantize(v, s, 40_000)
    assert tuple(d.shape) == (3, 40_000)
    assert torch.equal(d[1], Q.dequantize_int8(v[1], s[1], (40_000,)))


def test_block_wrappers_count_only_kernel_launches():
    counts = (Q.block_quantize.launches, Q.block_quantize_stochastic.launches,
              Q.block_dequantize.launches)
    Q.quantize_dequantize_int8(torch.ones(300))
    Q.quantize_dequantize_int8(torch.ones(300), stochastic=True, seed=1)
    assert (Q.block_quantize.launches, Q.block_quantize_stochastic.launches,
            Q.block_dequantize.launches) == counts
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        Q.block_quantize(torch.ones(2, 4, device="meta"))
    with pytest.raises(ValueError, match="one seed per row"):
        Q.block_quantize_stochastic(torch.ones(2, 4), [1])
    with pytest.raises(ValueError):
        Q.block_quantize(torch.ones(2, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        Q.block_dequantize(torch.zeros(1, 32, 128, dtype=torch.int8),
                           torch.ones(1, 2), 100)


@pytest.mark.cuda
def test_block_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    ref = jax_reference()
    before = (Q.block_quantize.launches, Q.block_quantize_stochastic.launches,
              Q.block_dequantize.launches)
    for case in sorted(BLOCK_CASES):
        x = torch.from_numpy(_block_input(case)).reshape(1, -1)
        xd = x.cuda()
        got = Q.block_quantize(xd)
        want = Q.quantize_int8_plain(xd)
        gots = Q.block_quantize_stochastic(xd, [17])
        wants = Q.quantize_int8_plain(xd, [17], stochastic=True)
        back = Q.block_dequantize(*got, x.shape[1])
        torch.cuda.synchronize()
        for a, b in zip(got + gots, want + wants):
            assert torch.equal(a, b), case
        assert torch.equal(back, Q.dequantize_int8_plain(*want, x.shape[1]))
        for (dev, what) in ((got[0][0], "values"), (got[1][0], "scales"),
                            (back[0], "dequantized")):
            assert dev.cpu().numpy().tobytes() == ref[
                block_key(case, what)].tobytes(), (case, what)
    n_nonempty = sum(_block_input(c).size > 0 for c in BLOCK_CASES)
    assert (Q.block_quantize.launches - before[0],
            Q.block_quantize_stochastic.launches - before[1],
            Q.block_dequantize.launches - before[2]) == (n_nonempty,) * 3


@pytest.mark.parametrize("wrapper", ["block_quantize",
                                     "block_quantize_stochastic",
                                     "block_dequantize"])
def test_block_wrappers_raise_on_meta_tensors(wrapper):
    """A tensor on neither the CPU nor a card gets no kernel and no plain
    version: the wrapper raises."""
    args = {"block_quantize": (torch.ones(2, 4, device="meta"),),
            "block_quantize_stochastic": (torch.ones(2, 4, device="meta"),
                                          [1, 2]),
            "block_dequantize": (torch.zeros(2, 32, 128, dtype=torch.int8,
                                             device="meta"),
                                 torch.ones(2, 1, device="meta"), 100)}
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        getattr(Q, wrapper)(*args[wrapper])


@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["nearest", "stochastic"])
def test_plain_quantize_reads_strided_rows(stochastic):
    """Rows of a view whose row stride is odd (each row starts at another
    4-byte offset from a 16-byte boundary, the layout the kernels read on
    the card) quantize as the same rows made contiguous."""
    full = torch.from_numpy(np.random.default_rng(11).normal(
        size=(4, 9_001)).astype(np.float32))
    rows = full[:, 3:8_196]         # stride 9,001, n 8,193: two 4096 slices
    seeds = [3, 5, 7, 9] if stochastic else None
    v, s = Q.quantize_int8_plain(rows, seeds, stochastic=stochastic)
    w, t = Q.quantize_int8_plain(rows.contiguous(), seeds,
                                 stochastic=stochastic)
    assert rows.stride(0) % 2 == 1 and not rows.is_contiguous()
    assert torch.equal(v, w) and torch.equal(s, t)
    assert tuple(v.shape) == (4, 96, 128) and tuple(s.shape) == (4, 1)


# Inputs for the cluster kernel on the card. Each n's single block spans
# block_elems / 4096 = 1..8 CTAs of one cluster; 32,769 and 3 x 32,768 + 5
# leave a last block whose cluster is almost wholly past n.
CLUSTER_NS = [513, 5_000, 10_000, 15_000, 20_000, 24_000, 28_000, 32_768]
EDGE_NS = [32_769, 3 * 32_768 + 5]


def _card_rows(case):
    """(rows on the card, description): contiguous [rows, n], or a view
    with an odd row stride."""
    kind, rows, n = case
    r = np.random.default_rng(rows * 7919 + n)
    if kind == "strided":
        full = r.normal(size=(rows, n + 3)).astype(np.float32)
        return torch.from_numpy(full).cuda()[:, 1:n + 1]
    x = r.normal(size=(rows, n))
    if kind == "exact":
        x[:, :32_768] *= 1e-20           # a block scale below 2^-40
        x[:, 32_768:65_536] *= 1e15      # and one above 2^40
        x[:, 65_536::97] = 1e-30 * np.sign(x[:, 65_536::97])  # < scale 2^-60
    return torch.from_numpy(x.astype(np.float32)).cuda()


CARD_CASES = ([("rows", 1, n) for n in CLUSTER_NS]
              + [("rows", 4, 4_097), ("rows", 4, 20_001),
                 ("strided", 4, 8_190), ("strided", 3, 40_000)]
              + [("rows", 2, n) for n in EDGE_NS]
              + [("exact", 2, 3 * 32_768 + 1)]
              + [("rows", 4, 2_805_033)])


def test_card_cases_cover_every_cluster_size_and_alignment():
    """The card cases reach cluster sizes 1..8 and rows that start 0, 4, 8
    and 12 bytes past a 16-byte boundary (computed from the layout)."""
    sizes = {Q.block_layout(n)[1] * Q.LANES // 4096 for _, _, n in CARD_CASES}
    assert sizes == set(range(1, 9))
    offsets = set()
    for kind, rows, n in CARD_CASES:
        stride = n + 3 if kind == "strided" else n
        start = 1 if kind == "strided" else 0
        offsets |= {4 * (start + r * stride) % 16 for r in range(rows)}
    assert offsets == {0, 4, 8, 12}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=lambda c: f"{c[0]}{c[1]}x{c[2]}")
def test_block_quantize_kernels_match_plain_on_card(case):
    """K2 and K3 (3 seeds) bit-equal to their plain versions, one launch a
    call, on every cluster size, row alignment and strided layout, a last
    block mostly past n, blocks that take the exact-division path, and the
    ring chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    x = _card_rows(case)
    rows = x.shape[0]
    before = Q.block_quantize.launches
    got = Q.block_quantize(x)
    want = Q.quantize_int8_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert Q.block_quantize.launches - before == 1
    for k in range(3):
        seeds = [0x5EED0000 + 64 * k + r for r in range(rows)]
        before = Q.block_quantize_stochastic.launches
        got = Q.block_quantize_stochastic(x, seeds)
        want = Q.quantize_int8_plain(x, seeds, stochastic=True)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert Q.block_quantize_stochastic.launches - before == 1


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(3, 513), (4, 40_001), (2, 1),
                                    (5, 4097), (2, 3 * 32768 + 5),
                                    (4, 2_805_033)])
def test_block_dequantize_kernels_match_plain_on_card(rows, n):
    """K4 against the plain version, on rows whose starts are off 16-byte
    alignment (odd n) and on the ring chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    x = torch.from_numpy(np.random.default_rng(n).normal(
        size=(rows, n)).astype(np.float32)).cuda()
    v, s = Q.quantize_int8_plain(x)
    before = Q.block_dequantize.launches
    got = Q.block_dequantize(v, s, n)
    want = Q.dequantize_int8_plain(v, s, n)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert Q.block_dequantize.launches - before == 1
