"""The port's ring attention (``parallel/ring_attention.py``: N sequence
slots on one device) against the JAX package's (N virtual CPU devices
under ``shard_map``): the dense ring and the ring x flash composition
with plain hops, forward and gradients within 1e-5 in fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.parallel import \
    ring_attention as jra
from distributed_parameter_server_for_ml_training_tpu.parallel.mesh import \
    make_mesh as jax_make_mesh
from distributed_parameter_server_for_ml_training_tpu_torch.parallel import \
    ring_attention as ra
from distributed_parameter_server_for_ml_training_tpu_torch.parallel.mesh \
    import SEQ_AXIS, make_mesh

H, D = 2, 64


def _inputs(t, b=1, seed=0):
    r = np.random.default_rng(seed)
    return [r.standard_normal((b, t, H, D)).astype(np.float32)
            for _ in range(4)]


def _jax_run(fn, q, k, v, cot):
    out = fn(*(jnp.asarray(x) for x in (q, k, v)))
    grads = jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) * cot),
                     argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(x) for x in (out, *grads)]


def _torch_run(fn, q, k, v, cot):
    tq, tk, tv = (torch.from_numpy(x.copy()).requires_grad_()
                  for x in (q, k, v))
    out = fn(tq, tk, tv)
    (out * torch.from_numpy(cot)).sum().backward()
    return [x.detach().numpy() for x in (out, tq.grad, tk.grad, tv.grad)]


def _assert_all_close(got, want, tol=1e-5):
    for g, w, name in zip(got, want, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_dense_ring_matches_jax(n, causal):
    q, k, v, cot = _inputs(16 * n, b=2, seed=n)
    want = _jax_run(jra.make_ring_attention(
        jax_make_mesh(n, axis_names=("seq",)), axis="seq", causal=causal),
        q, k, v, cot)
    got = _torch_run(ra.make_ring_attention(
        make_mesh(n, "cpu", axis_names=(SEQ_AXIS,)), causal=causal),
        q, k, v, cot)
    _assert_all_close(got, want)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "wrappers"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_flash_ring_matches_jax(n, causal, use_kernel):
    """Each hop one call over all slots with per-slot offsets, against the
    JAX ring (one hop per device, ``lax.cond`` skipping future blocks under
    causal masking)."""
    q, k, v, cot = _inputs(128 * n, seed=10 + n)
    want = _jax_run(jra.make_ring_flash_attention(
        jax_make_mesh(n, axis_names=("seq",)), axis="seq", causal=causal,
        use_pallas=False), q, k, v, cot)
    got = _torch_run(ra.make_ring_flash_attention(
        make_mesh(n, "cpu", axis_names=(SEQ_AXIS,)), causal=causal,
        use_kernel=use_kernel), q, k, v, cot)
    _assert_all_close(got, want)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_flash_ring_on_the_fused_backward_route_matches_jax(monkeypatch, n,
                                                            causal):
    """The route bf16 CUDA inputs take (``flash_bwd``, each hop adding its
    dq into the ring's fp32 accumulator), run here by forcing the route on
    CPU tensors, against the JAX ring. Every hop gets the same buffer."""
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        flash_attention as fa

    monkeypatch.setattr(fa, "_bwd_route", lambda *a: "fused")
    real = fa.flash_bwd
    buffers = []

    def spy(*a, dq_acc=None, **kw):
        buffers.append(dq_acc)
        return real(*a, dq_acc=dq_acc, **kw)

    monkeypatch.setattr(fa, "flash_bwd", spy)
    q, k, v, cot = _inputs(128 * n, seed=30 + n)
    want = _jax_run(jra.make_ring_flash_attention(
        jax_make_mesh(n, axis_names=("seq",)), axis="seq", causal=causal,
        use_pallas=False), q, k, v, cot)
    got = _torch_run(ra.make_ring_flash_attention(
        make_mesh(n, "cpu", axis_names=(SEQ_AXIS,)), causal=causal),
        q, k, v, cot)
    _assert_all_close(got, want)
    assert len(buffers) == n and buffers[0] is not None
    assert all(b is buffers[0] for b in buffers)
    assert buffers[0].dtype == torch.float32


def test_flash_ring_matches_dense_ring_and_dense_attention():
    q, k, v, cot = _inputs(256, b=2, seed=5)
    mesh = make_mesh(2, "cpu", axis_names=(SEQ_AXIS,))
    flash = _torch_run(ra.make_ring_flash_attention(mesh), q, k, v, cot)
    dense = _torch_run(ra.make_ring_attention(mesh), q, k, v, cot)
    single = _torch_run(ra.dense_attention, q, k, v, cot)
    _assert_all_close(flash, dense, 1e-4)
    _assert_all_close(dense, single, 1e-4)
    want = np.asarray(jra.dense_attention(*(jnp.asarray(x)
                                            for x in (q, k, v))))
    np.testing.assert_allclose(single[0], want, atol=1e-5, rtol=1e-5)


def test_skipped_future_hop_equals_the_cond_branch(monkeypatch):
    """Under causal masking a hop whose block lies wholly in the future of a
    slot's queries gives, in the kernel, O = 0 and LSE = -1e30 (no key
    tile runs), the JAX ``cond`` branch's values; the plain version
    computes the hop densely. Either way the merge weights it by exactly
    0, so the ring's output and gradients equal those of a ring whose
    future hops return the ``cond`` branch, bit for bit."""
    n, tl = 4, 128
    q, k, v, cot = _inputs(n * tl, seed=21)
    mesh = make_mesh(n, "cpu", axis_names=(SEQ_AXIS,))
    plain = _torch_run(ra.make_ring_flash_attention(mesh, causal=True),
                       q, k, v, cot)

    real_fwd, real_bwd = ra._hop_fwd, ra._hop_bwd
    skipped = []

    def future(q_offset, k_offset, rows_per_slot):
        """Flags over a hop's rows: is the slot's block all in the future?"""
        return torch.tensor([ko > qo + tl - 1 for qo, ko in
                             zip(q_offset, k_offset)]
                            ).repeat_interleave(rows_per_slot)

    def cond_fwd(q3, k3, v3, use_kernel, causal, q_offset, k_offset):
        o, lse = real_fwd(q3, k3, v3, use_kernel, causal, q_offset,
                          k_offset)
        rows = q3.shape[0] // n
        fut = future(q_offset, k_offset, rows)
        # The plain version's future rows: LSE = -1e30 + log(Tk) = -1e30.
        assert bool((lse[fut] <= -1e29).all())
        skipped.append(int(fut.sum()) // rows)
        return (torch.where(fut[:, None, None], 0.0, o),
                torch.where(fut[:, None, None], -1e30, lse))

    def cond_bwd(q3, k3, v3, do3, lse_tot, delta, use_kernel, causal,
                 q_offset, k_offset, dq_acc):
        dq_before = dq_acc.clone()
        grads = real_bwd(q3, k3, v3, do3, lse_tot, delta, use_kernel,
                         causal, q_offset, k_offset, dq_acc=dq_acc)
        fut = future(q_offset, k_offset, q3.shape[0] // n)
        # The plain backward masks every key of such a hop: it adds exact
        # 0 to the ring's dq and its dk/dv are the cond branch's zeros.
        assert grads[0] is dq_acc
        assert torch.equal(dq_acc[fut], dq_before[fut])
        for g in grads[1:]:
            assert bool((g[fut] == 0).all())
        return grads

    monkeypatch.setattr(ra, "_hop_fwd", cond_fwd)
    monkeypatch.setattr(ra, "_hop_bwd", cond_bwd)
    cond = _torch_run(ra.make_ring_flash_attention(mesh, causal=True),
                      q, k, v, cot)
    # Hop s skips the slots my < s: 0 + 1 + 2 + 3 of them.
    assert skipped == [0, 1, 2, 3]
    for a, b in zip(plain, cond):
        assert np.array_equal(a, b)


def test_hop_offsets_follow_the_rotation():
    assert ra._hop_offsets(4, 128, 0) == ([0, 128, 256, 384],
                                          [0, 128, 256, 384])
    assert ra._hop_offsets(4, 128, 1) == ([0, 128, 256, 384],
                                          [384, 0, 128, 256])


def test_flash_ring_needs_128_multiple_shards_as_jax_does():
    q = torch.zeros((1, 200, H, D))
    fn = ra.make_ring_flash_attention(make_mesh(2, "cpu",
                                                axis_names=(SEQ_AXIS,)))
    with pytest.raises(ValueError, match="multiple of 128"):
        fn(q, q, q)
    jfn = jra.make_ring_flash_attention(
        jax_make_mesh(2, axis_names=("seq",)), axis="seq", use_pallas=False)
    with pytest.raises(ValueError, match="multiple of 128"):
        jfn(*(jnp.zeros((1, 200, H, D)),) * 3)


def test_seq_mesh():
    mesh = make_mesh(4, "cpu", axis_names=(SEQ_AXIS,))
    assert mesh.shape == {"seq": 4} and mesh.axis_name == "seq"
    assert make_mesh(2, "cpu").shape == {"data": 2}
    # Two axes (item 10, third part): the trailing axis takes the slots
    # left, as JAX's divides its devices; over ranks they stay refused.
    two = make_mesh(2, "cpu", axis_names=("data", "model"), num_slots=8)
    assert two.shape == {"data": 2, "model": 4}
    assert two.axis_name == "data" and two.num_workers == 2
    with pytest.raises(NotImplementedError, match="item 10, sixth part"):
        type(two)(2, two.device, "data", group=object(), axes=two.axes)
    with pytest.raises(ValueError, match="sequence slots"):
        ra.make_ring_attention(make_mesh(3, "cpu", axis_names=(SEQ_AXIS,)))(
            *(torch.zeros((1, 8, H, D)),) * 3)
