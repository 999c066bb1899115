"""The port's flash attention (``ops/flash_attention.py``) against the JAX
package's ``ops/pallas/flash_attention.py``.

On the CPU the port's wrappers run their plain versions: held against
the JAX plain math in fp32 within 1e-5, and against the JAX Pallas
kernels in interpret mode within 2e-3 (forward) and 5e-3 (gradients),
the tolerances the JAX package's own interpret-mode test uses. Tests
marked ``cuda`` hold kernels K5-K7, the wgmma forward and the fused
backward against their plain versions on a card and skip here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.ops import \
    attention as jatt
from distributed_parameter_server_for_ml_training_tpu.ops.pallas import \
    flash_attention as jfa
from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
    attention as att
from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
    flash_attention as fa

BH, D = 4, 64


def _padded(t: int) -> int:
    return -(-t // 128) * 128


def _inputs(t, bh=BH, d=D, seed=0):
    """q, k, v, dO ``[bh, t_pad, d]`` fp32 with the padded rows zeroed, as
    ``flash_attention`` pads them."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        x = r.standard_normal((bh, _padded(t), d)).astype(np.float32)
        x[:, t:] = 0
        out.append(x)
    return out


def _jax_fwd(q, k, v, t, use_pallas, **kw):
    blk = jfa.pick_block(q.shape[1])
    o, lse = jfa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), t, blk, blk, use_pallas,
                                 **kw)
    return np.asarray(o), np.asarray(lse)


def _jax_bwd(q, k, v, do, lse, delta, t, use_pallas, **kw):
    blk = jfa.pick_block(q.shape[1])
    return [np.asarray(g) for g in jfa._flash_bwd_impl(
        *(jnp.asarray(x) for x in (q, k, v, do, lse, delta)), t, blk, blk,
        use_pallas, q_len=t, **kw)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol,
                               rtol=tol, err_msg=what)


MASKS = [(False, 0, 0), (True, 0, 0), (True, 128, 0), (True, 0, 128)]


@pytest.mark.parametrize("causal,q_off,k_off", MASKS,
                         ids=["full", "causal", "causal_q128", "causal_k128"])
@pytest.mark.parametrize("t", [197, 256, 300])
def test_plain_fwd_bwd_match_jax_plain(t, causal, q_off, k_off):
    q, k, v, do = _inputs(t, seed=t)
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    o_j, lse_j = _jax_fwd(q, k, v, t, False, **kw)
    o, lse = fa._flash_fwd_impl(_t(q), _t(k), _t(v), t, use_kernel=False,
                                **kw)
    assert o.dtype == torch.float32 and lse.shape == (BH, _padded(t), 1)
    _close(o, o_j, 1e-5, "O")
    _close(lse, lse_j, 1e-5, "LSE")
    delta = (do * o_j).sum(-1, keepdims=True)
    want = _jax_bwd(q, k, v, do, lse_j, delta, t, False, **kw)
    got = fa._flash_bwd_impl(_t(q), _t(k), _t(v), _t(do), _t(lse_j),
                             _t(delta), t, use_kernel=False, q_len=t, **kw)
    for g, w, name in zip(got, want, ("dQ", "dK", "dV")):
        _close(g, w, 1e-5, name)


@pytest.mark.parametrize("t,causal,q_off", [(197, False, 0),
                                            (256, True, 128),
                                            (300, True, 0)])
def test_plain_matches_jax_kernels_in_interpret_mode(monkeypatch, t, causal,
                                                     q_off):
    """The JAX Pallas kernels (loop bounds, SMEM offsets, padding) emulated
    on the CPU, against the wrappers' CPU route."""
    monkeypatch.setattr(jfa, "INTERPRET", True)
    q, k, v, do = _inputs(t, seed=7 + t)
    kw = dict(causal=causal, q_offset=q_off, k_offset=0)
    o_j, lse_j = _jax_fwd(q, k, v, t, True, out_dtype=jnp.float32, **kw)
    o, lse = fa.flash_fwd(_t(q), _t(k), _t(v), t, out_dtype=torch.float32,
                          **kw)
    rows = slice(0, t)
    _close(o[:, rows], o_j[:, rows], 2e-3, "O")
    _close(lse[:, rows], lse_j[:, rows], 2e-3, "LSE")
    delta = (do * o_j).sum(-1, keepdims=True)
    want = _jax_bwd(q, k, v, do, lse_j, delta, t, True,
                    out_dtype=jnp.float32, **kw)
    args = [_t(x) for x in (q, k, v, do, lse_j, delta)]
    dq = fa.flash_bwd_dq(*args, t, out_dtype=torch.float32, **kw)
    dk, dv = fa.flash_bwd_dkv(*args, t, out_dtype=torch.float32, q_len=t,
                              **kw)
    _close(dq[:, rows], want[0][:, rows], 5e-3, "dQ")
    _close(dk, want[1], 5e-3, "dK")
    _close(dv, want[2], 5e-3, "dV")


def _bthd(b, t, h, d, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "wrappers"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [100, 197])
def test_flash_core_gradients_match_jax_grad(t, causal, use_kernel):
    """``flash_attention`` under autograd (``_FlashCore``: the flash
    backward with delta in fp32) against ``jax.grad`` of the JAX
    ``flash_attention(use_pallas=False)``."""
    q, k, v, cot = _bthd(2, t, 2, D, seed=t + causal)

    def jloss(a, b, c):
        return jnp.sum(jfa.flash_attention(a, b, c, causal=causal,
                                           use_pallas=False) * cot)

    out_j = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                causal=causal, use_pallas=False)
    grads_j = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal,
                             use_kernel=use_kernel)
    (out * _t(cot)).sum().backward()
    _close(out, np.asarray(out_j), 1e-5, "out")
    for g, w, name in zip((tq.grad, tk.grad, tv.grad), grads_j, "qkv"):
        _close(g, np.asarray(w), 1e-5, f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_dense_core_and_dispatch_match_jax(dtype, causal):
    """Below the crossover (always, off CUDA) ``flash_attention`` is
    ``dense_core``, as the JAX dispatch is; both match the JAX core."""
    q, k, v, _ = _bthd(2, 50, 3, 32, seed=3)
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    want = np.asarray(jatt.dense_core(
        *(jnp.asarray(x, jd) for x in (q, k, v)), causal=causal
    ).astype(jnp.float32))
    tq, tk, tv = (_t(x).to(td) for x in (q, k, v))
    got = att.dense_core(tq, tk, tv, causal=causal)
    assert got.dtype == td
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(got.float(), want, tol)
    assert torch.equal(fa.flash_attention(tq, tk, tv, causal=causal), got)


@pytest.mark.parametrize("t", [128 * i for i in range(1, 33)])
def test_pick_block_matches_jax(t):
    assert fa.pick_block(t) == jfa.pick_block(t)
    assert fa.MAX_BLOCK == jfa.MAX_BLOCK


@pytest.mark.parametrize("t", [100, 197, 300, 2049])
def test_pick_block_refuses_what_jax_refuses(t):
    with pytest.raises(ValueError, match="multiple of 128"):
        jfa.pick_block(t)
    with pytest.raises(ValueError, match="multiple of 128"):
        fa.pick_block(t)


TABLE = {"crossover_t": 512,
         "measured_speedups_fwd_bwd": {"512": 1.02, "1024": 1.04,
                                       "2048": 1.30, "4096": 1.72}}


@pytest.mark.parametrize("record", ["table", "none"])
@pytest.mark.parametrize("t", [100, 511, 512, 576, 1024, 1056, 2040, 2047,
                               2048, 4096, 8192])
def test_flash_preferred_gives_jax_answers(monkeypatch, record, t):
    """The dispatch predicate on one crossover record (the cases of the
    JAX package's ``test_dispatch_padding_tax``; with no record both use
    ``DEFAULT_CROSSOVER_T``): "on the TPU" becomes "tensors on CUDA"."""
    rec = TABLE if record == "table" else {}
    monkeypatch.setattr(jfa, "_crossover_record", lambda: rec)
    monkeypatch.setattr(fa, "_crossover_record", lambda: rec)
    for on_accel, device in ((True, "cuda"), (False, "cpu")):
        monkeypatch.setattr(jfa, "_on_tpu", lambda a=on_accel: a)
        assert fa.flash_preferred(t, device) == jfa.flash_preferred(t), \
            (t, device)


def test_port_reads_only_its_own_crossover_record():
    assert fa.DEFAULT_CROSSOVER_T == jfa.DEFAULT_CROSSOVER_T == 2048
    assert fa.FLASH_TIE_THRESHOLD == jfa.FLASH_TIE_THRESHOLD
    assert fa._CROSSOVER_FILE.endswith("attn_crossover_cuda.json")
    assert "_torch" in fa._CROSSOVER_FILE
    # No CUDA record is committed: the default applies, not the TPU's 512.
    assert fa.flash_crossover() == fa.DEFAULT_CROSSOVER_T
    assert jfa.flash_crossover() != fa.flash_crossover()


def test_slots_with_their_own_offsets_are_independent_calls():
    """One call over N slots with per-slot (q_offset, k_offset) equals N
    calls, one per slot: the layout a ring hop launches."""
    q, k, v, do = _inputs(256, bh=6, seed=2)
    qs, ks = [0, 256, 512], [256, 0, 512]
    args = [_t(x) for x in (q, k, v)]
    o, lse = fa.flash_fwd(*args, 256, causal=True, q_offset=qs, k_offset=ks)
    delta = (_t(do) * o).sum(-1, keepdim=True)
    grads = fa._flash_bwd_impl(*args, _t(do), lse, delta, 256, causal=True,
                               q_offset=qs, k_offset=ks)
    for i, (qo, ko) in enumerate(zip(qs, ks)):
        rows = slice(2 * i, 2 * i + 2)
        sub = [x[rows] for x in args]
        o_i, lse_i = fa.flash_fwd(*sub, 256, causal=True, q_offset=qo,
                                  k_offset=ko)
        assert torch.equal(o[rows], o_i) and torch.equal(lse[rows], lse_i)
        g_i = fa._flash_bwd_impl(*sub, _t(do)[rows], lse_i, delta[rows],
                                 256, causal=True, q_offset=qo, k_offset=ko)
        for g, gi in zip(grads, g_i):
            assert torch.equal(g[rows], gi)
    with pytest.raises(ValueError, match="slots"):
        fa.flash_fwd(*args, 256, causal=True, q_offset=[0, 1, 2, 3],
                     k_offset=0)


@pytest.mark.parametrize("with_acc", [False, True], ids=["fresh", "dq_acc"])
@pytest.mark.parametrize("causal,q_off,k_off", MASKS,
                         ids=["full", "causal", "causal_q128", "causal_k128"])
def test_fused_backward_matches_plain_and_jax(causal, q_off, k_off,
                                              with_acc):
    """``flash_bwd`` (K6 + K7 fused; the plain version on the CPU) against
    ``flash_bwd_plain`` and the JAX plain backward in fp32. With
    ``dq_acc`` the hop's dQ is added to what the buffer holds, in place,
    and the buffer is returned as dQ."""
    t = 197
    q, k, v, do = _inputs(t, seed=40 + q_off + 2 * k_off + causal)
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    o_j, lse_j = _jax_fwd(q, k, v, t, False, **kw)
    delta = (do * o_j).sum(-1, keepdims=True)
    want = _jax_bwd(q, k, v, do, lse_j, delta, t, False, **kw)
    args = [_t(x) for x in (q, k, v, do, lse_j, delta)]
    plain = fa.flash_bwd_plain(*args, t, **kw)
    start = np.random.default_rng(1).standard_normal(q.shape).astype(
        np.float32)
    acc = _t(start) if with_acc else None
    got = fa.flash_bwd(*args, t, dq_acc=acc, q_len=t, **kw)
    if with_acc:
        assert got[0] is acc
        _close(got[0] - _t(start), want[0], 1e-5, "dQ added")
        assert torch.allclose(got[0], _t(start) + plain[0], atol=0, rtol=0)
    for g, p, w, name in zip(got, plain, want, ("dQ", "dK", "dV")):
        assert g.dtype == torch.float32
        if not (with_acc and name == "dQ"):
            assert torch.equal(g, p), name
            _close(g, w, 1e-5, name)


@pytest.mark.parametrize("out_dtype", [None, "bfloat16"])
def test_fused_backward_output_dtype_and_no_cpu_launch(out_dtype):
    q, k, v, do = (_t(x) for x in _inputs(128, seed=5))
    o, lse = fa.flash_fwd(q, k, v, 128)
    delta = (do * o).sum(-1, keepdim=True)
    od = getattr(torch, out_dtype) if out_dtype else None
    before = fa.flash_bwd.launches
    got = fa.flash_bwd(q, k, v, do, lse, delta, 128, out_dtype=od)
    assert fa.flash_bwd.launches == before
    want = fa.flash_bwd_plain(q, k, v, do, lse, delta, 128, out_dtype=od)
    for g, w in zip(got, want):
        assert g.dtype == (od or torch.float32)
        assert torch.equal(g, w)
    meta = torch.empty((4, 128, 64), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fa.flash_bwd(meta, meta, meta, meta, meta, meta, 128)


@pytest.mark.parametrize("device,dtype,use_kernel,route", [
    ("cuda", torch.bfloat16, True, "fused"),
    ("cuda", torch.float32, True, "k6_k7"),
    ("cuda", torch.bfloat16, False, "plain"),
    ("cpu", torch.bfloat16, True, "plain"),
    ("cpu", torch.float32, True, "plain")])
def test_backward_routes_on_dtype(device, dtype, use_kernel, route):
    assert fa._bwd_route(device, dtype, use_kernel) == route


@pytest.mark.parametrize("route", ["fused", "k6_k7", "plain"])
@pytest.mark.parametrize("with_acc", [False, True], ids=["fresh", "dq_acc"])
def test_flash_bwd_impl_runs_the_routed_wrappers(monkeypatch, route,
                                                 with_acc):
    """``_flash_bwd_impl`` calls what its route names (the wrappers run
    their plain versions on CPU tensors), each route giving the same
    gradients and the same ``dq_acc`` contract."""
    q, k, v, do = (_t(x) for x in _inputs(256, seed=6))
    o, lse = fa.flash_fwd(q, k, v, 256, causal=True)
    delta = (do * o).sum(-1, keepdim=True)
    called = []
    for name in ("flash_bwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "_bwd_plain_into"):
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _r=real, _n=name, **kw:
                            called.append(_n) or _r(*a, **kw))
    monkeypatch.setattr(fa, "_bwd_route", lambda *a: route)
    acc = torch.ones(q.shape) if with_acc else None
    got = fa._flash_bwd_impl(q, k, v, do, lse, delta, 256, causal=True,
                             dq_acc=acc)
    assert called == {"fused": ["flash_bwd", "_bwd_plain_into"],
                      "k6_k7": ["flash_bwd_dq", "flash_bwd_dkv"],
                      "plain": ["_bwd_plain_into"]}[route]
    want = fa.flash_bwd_plain(q, k, v, do, lse, delta, 256, causal=True)
    assert torch.equal(got[0], want[0] + 1 if with_acc else want[0])
    assert (got[0] is acc) == with_acc
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("device,dtype,use_kernel,route", [
    ("cuda", torch.bfloat16, True, "wgmma"),
    ("cuda", torch.float32, True, "k5"),
    ("cuda", torch.bfloat16, False, "plain"),
    ("cpu", torch.bfloat16, True, "plain"),
    ("cpu", torch.float32, True, "plain")])
def test_forward_routes_on_dtype(device, dtype, use_kernel, route):
    assert fa._fwd_route(device, dtype, use_kernel) == route


@pytest.mark.parametrize("route", ["wgmma", "k5", "plain"])
@pytest.mark.parametrize("out_dtype", [None, "float32"])
def test_flash_fwd_impl_runs_the_routed_wrapper(monkeypatch, route,
                                                out_dtype):
    """``_flash_fwd_impl`` calls what its route names, with the caller's
    mask and output dtype. The wgmma wrapper takes CUDA tensors only, so
    here each stand-in computes the plain version."""
    q, k, v, _ = (_t(x).to(torch.bfloat16) for x in _inputs(256, seed=8))
    kw = dict(out_dtype=getattr(torch, out_dtype) if out_dtype else None,
              causal=True, q_offset=[0, 256], k_offset=[0, 0])
    called = []
    real = fa.flash_fwd_plain
    for name in ("flash_fwd_wgmma", "flash_fwd", "flash_fwd_plain"):
        monkeypatch.setattr(fa, name, lambda *a, _n=name, **k_:
                            called.append((_n, k_)) or real(*a, **k_))
    monkeypatch.setattr(fa, "_fwd_route", lambda *a: route)
    o, lse = fa._flash_fwd_impl(q, k, v, 200, **kw)
    name = {"wgmma": "flash_fwd_wgmma", "k5": "flash_fwd",
            "plain": "flash_fwd_plain"}[route]
    assert called == [(name, kw)]
    want = real(q, k, v, 200, **kw)
    assert o.dtype == (kw["out_dtype"] or torch.bfloat16)
    assert torch.equal(o, want[0]) and torch.equal(lse, want[1])


def test_flash_fwd_wgmma_refuses_cpu_and_fp32_and_counts_only_launches():
    """The wgmma forward has no CPU route of its own (``_fwd_route`` takes
    the plain version there): it refuses CPU tensors of either dtype and
    any device that is not CUDA, and a refused call counts nothing."""
    q, k, v, _ = (_t(x) for x in _inputs(128, seed=9))
    before = fa.flash_fwd_wgmma.launches
    for dtype in (torch.bfloat16, torch.float32):
        x = q.to(dtype)
        with pytest.raises(RuntimeError, match="no kernel for device cpu"):
            fa.flash_fwd_wgmma(x, k.to(dtype), v.to(dtype), 128)
    meta = torch.empty((4, 128, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fa.flash_fwd_wgmma(meta, meta, meta, 128)
    with pytest.raises(ValueError, match="bfloat16"):
        fa._check_wgmma_inputs("flash forward (wgmma)", q, k, v,
                               torch.float32)
    # The forward on CPU bf16 tensors, kernels asked for: the plain route.
    o, lse = fa._flash_fwd_impl(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                128, out_dtype=torch.float32)
    want = fa.flash_fwd_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), 128,
                              out_dtype=torch.float32)
    assert torch.equal(o, want[0]) and torch.equal(lse, want[1])
    assert fa.flash_fwd_wgmma.launches == before


@pytest.mark.parametrize("shape,dtype,out_dtype,match", [
    ((4, 128, 32), torch.bfloat16, torch.float32, "head dims"),
    ((4, 128, 256), torch.bfloat16, torch.float32, "head dims"),
    ((4, 96, 64), torch.bfloat16, torch.float32, "multiple of 64"),
    ((4, 128, 64), torch.float32, torch.float32, "takes bfloat16"),
    ((4, 128, 64), torch.float16, torch.float32, "float32 or bfloat16"),
    ((4, 128, 64), torch.bfloat16, torch.float16, "output dtype")])
def test_wgmma_input_checks_name_the_limit(shape, dtype, out_dtype, match):
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        fa._check_wgmma_inputs("flash forward (wgmma)", x, x, x, out_dtype)


def test_wrappers_count_only_kernel_launches_and_refuse_other_devices():
    q, k, v, do = (_t(x) for x in _inputs(128, seed=4))
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_fwd(q, k, v, 128)
    delta = (do * o).sum(-1, keepdim=True)
    fa.flash_bwd_dq(q, k, v, do, lse, delta, 128)
    fa.flash_bwd_dkv(q, k, v, do, lse, delta, 128)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == before
    meta = torch.empty((4, 128, 64), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fa.flash_fwd(meta, meta, meta, 128)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fa.flash_bwd_dkv(meta, meta, meta, meta, meta, meta, 128)


@pytest.mark.parametrize("shape,dtype,match", [
    ((4, 128, 32), torch.float32, "head dims"),
    ((4, 128, 96), torch.bfloat16, "head dims"),
    ((4, 128, 64), torch.float16, "float32 or bfloat16"),
    ((4, 100, 64), torch.float32, "multiple of 64")])
def test_kernel_input_checks_name_the_limit(shape, dtype, match):
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        fa._check_kernel_inputs("flash forward", x, x, x, torch.float32)


def test_kernel_sources_and_replaced_tpu_kernels():
    import pathlib
    repo = pathlib.Path(__file__).resolve().parents[1]
    assert (repo / fa.KERNEL_SOURCE).is_file()
    src = pathlib.Path(jfa.__file__).read_text().splitlines()
    want = {"flash_fwd": ["_fwd_kernel"],
            "flash_fwd_wgmma": ["_fwd_kernel"],
            "flash_bwd": ["_bwd_dq_kernel", "_bwd_dkv_kernel"],
            "flash_bwd_dq": ["_bwd_dq_kernel"],
            "flash_bwd_dkv": ["_bwd_dkv_kernel"]}
    assert set(fa.REPLACES) == set(want)
    for name, refs in fa.REPLACES.items():
        refs = refs.split(", ")
        assert len(refs) == len(want[name])
        for ref, fn in zip(refs, want[name]):
            path, line = ref.rsplit(":", 1)
            assert (repo / path).resolve() == \
                pathlib.Path(jfa.__file__).resolve()
            assert src[int(line) - 1].startswith(f"def {fn}("), ref


# -- on the card -----------------------------------------------------------------

CARD_CASES = {
    # name: (bh, t, d, dtype, out dtype, kwargs, tolerance)
    "hop_bf16_fp32out": (24, 2048, 64, "bfloat16", "float32", {}, 2e-2),
    "fp32": (8, 512, 64, "float32", "float32", {}, 2e-3),
    "t197_padded256": (8, 256, 64, "bfloat16", "bfloat16",
                       dict(kv_len=197), 2e-2),
    "causal_128_0": (8, 256, 64, "float32", "float32",
                     dict(causal=True, q_offset=128), 2e-3),
    "two_slots": (8, 256, 64, "bfloat16", "float32",
                  dict(causal=True, q_offset=[0, 256], k_offset=[0, 0]),
                  2e-2),
    "d128": (8, 512, 128, "bfloat16", "float32", {}, 2e-2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernels_match_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K5-K7 run only on the card")
    bh, t, d, dtype, out_dtype, kw, tol = CARD_CASES[case]
    kw = dict(kw)
    kv_len = kw.pop("kv_len", t)
    dtype, out_dtype = getattr(torch, dtype), getattr(torch, out_dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((bh, t, d), generator=gen, device="cuda"
                               ).to(dtype) for _ in range(4))
    for x in (q, k, v, do):
        x[:, kv_len:] = 0
    before = fa.flash_fwd.launches
    o, lse = fa.flash_fwd(q, k, v, kv_len, out_dtype=out_dtype, **kw)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, kv_len, out_dtype=out_dtype,
                                    **kw)
    delta = (do.float() * o_p.float()).sum(-1, keepdim=True)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_p, delta, kv_len,
                         out_dtype=out_dtype, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_p, delta, kv_len,
                              out_dtype=out_dtype, q_len=kv_len, **kw)
    want = fa.flash_bwd_plain(q, k, v, do, lse_p, delta, kv_len,
                              out_dtype=out_dtype, **kw)
    pairs = [(o, o_p), (lse, lse_p), (dq, want[0]), (dk, want[1]),
             (dv, want[2])]
    fused_before = fa.flash_bwd.launches
    if dtype == torch.bfloat16:     # the fused backward: one launch
        fused = fa.flash_bwd(q, k, v, do, lse_p, delta, kv_len,
                             out_dtype=out_dtype, q_len=kv_len, **kw)
        pairs += list(zip(fused, want))
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + 1
    assert fa.flash_bwd.launches == fused_before + (dtype == torch.bfloat16)
    rows = slice(0, kv_len)
    for i, (got, ref) in enumerate(pairs):
        if i % 5 in (0, 1, 2):      # O, LSE and dQ: the unpadded rows
            got, ref = got[:, rows], ref[:, rows]
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
def test_future_block_gives_the_skipped_hop_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K5-K7 run only on the card")
    q = torch.randn((8, 256, 64), device="cuda")
    o, lse = fa.flash_fwd(q, q, q, 256, causal=True, k_offset=2048)
    delta = torch.ones((8, 256, 1), device="cuda")
    dq = fa.flash_bwd_dq(q, q, q, q, lse, delta, 256, causal=True,
                         k_offset=2048)
    dk, dv = fa.flash_bwd_dkv(q, q, q, q, lse, delta, 256, causal=True,
                              k_offset=2048)
    b = q.to(torch.bfloat16)
    fused = fa.flash_bwd(b, b, b, b, lse, delta, 256, causal=True,
                         k_offset=2048)
    torch.cuda.synchronize()
    assert float(o.abs().max()) == 0.0 and float(lse.max()) <= -1e29
    for g in (dq, dk, dv, *fused):
        assert float(g.abs().max()) == 0.0


BF16_CARD_CASES = sorted(n for n, c in CARD_CASES.items()
                         if c[3] == "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_CARD_CASES)
def test_wgmma_forward_matches_plain_on_card(case):
    """The wgmma forward (K5 on bf16) against the plain version and the
    first version, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the wgmma forward runs only on "
                    "the card")
    bh, t, d, dtype, out_dtype, kw, tol = CARD_CASES[case]
    kw = dict(kw)
    kv_len = kw.pop("kv_len", t)
    out_dtype = getattr(torch, out_dtype)
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn((bh, t, d), generator=gen, device="cuda"
                           ).to(torch.bfloat16) for _ in range(3))
    for x in (q, k, v):
        x[:, kv_len:] = 0
    before = fa.flash_fwd_wgmma.launches
    o, lse = fa.flash_fwd_wgmma(q, k, v, kv_len, out_dtype=out_dtype, **kw)
    torch.cuda.synchronize()
    assert fa.flash_fwd_wgmma.launches == before + 1
    assert o.dtype == out_dtype and lse.shape == (bh, t, 1)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, kv_len, out_dtype=out_dtype,
                                    **kw)
    o_1, lse_1 = fa.flash_fwd(q, k, v, kv_len, out_dtype=out_dtype, **kw)
    rows = slice(0, kv_len)
    for got in ((o, lse), (o_1, lse_1)):
        for a, b in zip(got, (o_p, lse_p)):
            torch.testing.assert_close(a[:, rows].float(),
                                       b[:, rows].float(), atol=tol,
                                       rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_wgmma_forward_future_block_on_card(out_dtype):
    """A block wholly in the future of every query runs no key tile: O = 0
    and LSE = -1e30, the JAX ring's skipped-hop values."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the wgmma forward runs only on "
                    "the card")
    q = torch.randn((8, 256, 64), device="cuda").to(torch.bfloat16)
    o, lse = fa.flash_fwd_wgmma(q, q, q, 256, causal=True, k_offset=2048,
                                out_dtype=getattr(torch, out_dtype))
    torch.cuda.synchronize()
    assert float(o.abs().max()) == 0.0 and float(lse.max()) <= -1e29


@pytest.mark.cuda
def test_wgmma_forward_is_bit_equal_across_launches_on_card():
    """Nothing in the forward is summed with atomics: two launches on one
    input give the same O and LSE bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the wgmma forward runs only on "
                    "the card")
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn((24, 2048, 64), generator=gen, device="cuda"
                           ).to(torch.bfloat16) for _ in range(3))
    a = fa.flash_fwd_wgmma(q, k, v, 2048, out_dtype=torch.float32)
    b = fa.flash_fwd_wgmma(q, k, v, 2048, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-3), ("bfloat16", 2e-2)])
def test_flash_attention_autograd_on_card(dtype, tol):
    """``flash_attention`` under autograd on the card (the wgmma forward
    and the fused backward on bf16, the first-version K5, K6 and K7 on
    fp32, through ``_FlashCore``; T = 197 padded to 256) against the same
    op with the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K5-K7 run only on the card")
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, cot = (torch.randn((2, 197, 4, 64), generator=gen,
                                device="cuda").to(getattr(torch, dtype))
                    for _ in range(4))
    before = (fa.flash_fwd.launches, fa.flash_bwd.launches,
              fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches,
              fa.flash_fwd_wgmma.launches)
    results = []
    for use_kernel in (True, False):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention(*xs, use_kernel=use_kernel)
        (out.float() * cot.float()).sum().backward()
        results.append([out] + [x.grad for x in xs])
    torch.cuda.synchronize()
    bf16 = dtype == "bfloat16"
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches,
            fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches,
            fa.flash_fwd_wgmma.launches) == (
        before[0] + (not bf16), before[1] + bf16, before[2] + (not bf16),
        before[3] + (not bf16), before[4] + bf16)
    for got, want in zip(*results):
        assert got.dtype == want.dtype == q.dtype
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
