"""The port's ViT (``models/vit.py``) against the flax model, with the
weights carried across by ``utils/pytree.params_from_jax``.

fp32 logits agree within rtol 1e-4 / atol 1e-5, with the dense core and
with the flash ring (plain hops, 2 sequence slots against 2 virtual
devices). fp32 parameter gradients are held to float64: the flax model
run in float64 (with a float64 softmax) is the reference, and on every
tensor the port's largest error from it may be at most twice the larger
of JAX's own fp32 error and 1e-7 of the tensor's largest entry. An
element-wise tolerance against JAX's fp32 gradient cannot hold on every
CPU: an entry that is the small difference of terms of size ~20 carries
each framework's rounding of those terms. bf16 logits within 2e-2 of the
jitted flax model, since the two frameworks' bf16 kernels (gelu,
LayerNorm, matmul accumulation) round at different places."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.models import vit as jvit
from distributed_parameter_server_for_ml_training_tpu.parallel.mesh import \
    make_mesh as jax_make_mesh
from distributed_parameter_server_for_ml_training_tpu.parallel \
    .ring_attention import \
    make_ring_flash_attention as jax_ring_flash
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import \
    flatten_params as jax_flatten
from distributed_parameter_server_for_ml_training_tpu_torch.models import (
    ViT, ViT_Tiny, get_model)
from distributed_parameter_server_for_ml_training_tpu_torch.parallel.mesh \
    import SEQ_AXIS, make_mesh
from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
    .ring_attention import make_ring_flash_attention
from distributed_parameter_server_for_ml_training_tpu_torch.utils.pytree \
    import flax_names, params_from_jax, params_to_jax, to_flax_layout
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

SHAPES = {
    "tiny": dict(patch_size=4, hidden_dim=192, depth=4, num_heads=3),
    "small": dict(patch_size=4, hidden_dim=64, depth=2, num_heads=2),
}


def _pair(shape, pool, ring, image, dtype="float32", seed=0):
    """(flax model, its params, the port's model with those weights)."""
    kw = dict(SHAPES[shape], num_classes=10, pool=pool)
    jattn = tattn = None
    if ring:
        jattn = jax_ring_flash(jax_make_mesh(2, axis_names=("seq",)),
                               axis="seq", use_pallas=False)
        tattn = make_ring_flash_attention(
            make_mesh(2, "cpu", axis_names=(SEQ_AXIS,)))
    jm = jvit.ViT(**kw, dtype=getattr(jnp, dtype), attention_fn=jattn)
    params = jm.init(jax.random.PRNGKey(seed),
                     np.zeros((1, image, image, 3), np.float32),
                     train=False)["params"]
    tm = ViT(**kw, dtype=getattr(torch, dtype), attention_fn=tattn,
             image_size=image)
    tm.load_state_dict(params_from_jax(jax_flatten(params)))
    return jm, params, tm


def _dense_core64(q, k, v):
    """The dense attention core in float64 throughout (the JAX package's
    casts its softmax to fp32)."""
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(logits, axis=-1),
                      v)


def _flax_grads(model, params, x, cot):
    def loss(p):
        return jnp.sum(model.apply({"params": p}, x, train=False) * cot)

    return {k: np.asarray(v, np.float64) for k, v in
            jax_flatten(jax.jit(jax.grad(loss))(params)).items()}


def _images(n, image, seed=1):
    r = np.random.default_rng(seed)
    return r.standard_normal((n, image, image, 3)).astype(np.float32)


CASES = [("tiny", "cls", False), ("tiny", "gap", False),
         ("tiny", "gap", True), ("small", "cls", False),
         ("small", "gap", False), ("small", "gap", True)]


@pytest.mark.parametrize("shape,pool,ring", CASES,
                         ids=[f"{s}-{p}-{'ring' if r else 'dense'}"
                              for s, p, r in CASES])
def test_fp32_logits_and_grads_match_flax(shape, pool, ring,
                                          one_torch_thread):
    image = 64 if ring else 32        # the ring: 256 tokens, 128 a slot
    jm, params, tm = _pair(shape, pool, ring, image)
    x = _images(2, image)
    cot = np.random.default_rng(2).standard_normal((2, 10)).astype(
        np.float32)

    def loss(p):
        logits = jm.apply({"params": p}, x, train=False)
        return jnp.sum(logits * cot), logits

    (_, want), jax_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    want, jax_g = np.asarray(want), jax_flatten(jax_g)
    logits = tm(torch.from_numpy(x))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5)
    (logits * torch.from_numpy(cot)).sum().backward()
    pnames, _ = flax_names(tm)
    own = dict(tm.named_parameters())
    assert sorted(pnames.values()) == sorted(jax_g)

    # The float64 reference: the dense flax model (the ring computes the
    # same function), and the port's own float64 model beside it.
    with jax.enable_x64(True):
        jm64 = jvit.ViT(**SHAPES[shape], num_classes=10, pool=pool,
                        dtype=jnp.float64, attention_fn=_dense_core64)
        ref = _flax_grads(jm64, jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), params),
            x.astype(np.float64), cot)
    tm64 = ViT(**SHAPES[shape], num_classes=10, pool=pool,
               dtype=torch.float64, image_size=image)
    tm64.load_state_dict(tm.state_dict())
    tm64.double()
    (tm64(torch.from_numpy(x).double())
     * torch.from_numpy(cot).double()).sum().backward()
    own64 = dict(tm64.named_parameters())
    for tname, fname in pnames.items():
        top = np.abs(ref[fname]).max()
        np.testing.assert_allclose(
            to_flax_layout(own64[tname].grad).numpy(), ref[fname], rtol=0,
            atol=1e-12 * max(top, 1.0), err_msg=fname)
        port_err = np.abs(to_flax_layout(own[tname].grad).numpy()
                          - ref[fname]).max()
        jax_err = np.abs(jax_g[fname] - ref[fname]).max()
        assert port_err <= 2 * max(jax_err, 1e-7 * top), (
            fname, port_err, jax_err, top)


@pytest.mark.parametrize("pool", ["cls", "gap"])
@pytest.mark.parametrize("shape", ["tiny", "small"])
def test_bf16_logits_match_flax(shape, pool):
    """Against the flax model under ``jax.jit``, as the JAX package's
    trainers run it: XLA fuses the elementwise chains (gelu's among them)
    and rounds a fused chain's result once, as the port's fused torch ops
    do. (Run op by op, JAX rounds bf16 after every op instead.)"""
    jm, params, tm = _pair(shape, pool, False, 32, dtype="bfloat16")
    x = _images(4, 32, seed=3)
    want = np.asarray(jax.jit(
        lambda p: jm.apply({"params": p}, x, train=False))(params))
    got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("pool", ["cls", "gap"])
def test_names_order_and_round_trip_match_flax(pool):
    """Flat names in flax's creation order, flax shapes (HWIO patch embed,
    [in, out] Dense kernels, 3-D cls_token and pos_embed), and a byte-equal
    round trip flax -> torch -> flax."""
    jm, params, tm = _pair("tiny", pool, False, 32, seed=4)
    flat = jax_flatten(params)
    got, stats = params_to_jax(tm)
    assert stats == {}
    assert list(got) == list(flat)
    for k in flat:
        assert got[k].shape == flat[k].shape, k
        assert got[k].tobytes() == np.asarray(flat[k]).tobytes(), k
    assert flat["patch_embed/kernel"].shape == (4, 4, 3, 192)
    assert flat["pos_embed"].ndim == 3
    assert ("cls_token" in flat) == (pool == "cls")


def test_vit_b16_shape_and_count_match_flax():
    want = jax.eval_shape(
        lambda k: jvit.ViT_B16(1000).init(
            k, jnp.zeros((1, 224, 224, 3)), train=False),
        jax.random.PRNGKey(0))["params"]
    want = {k: tuple(v.shape)
            for k, v in jax_flatten(want, as_numpy=False).items()}
    tm = get_model("vit_b16", num_classes=1000, device="cpu", image_size=224)
    got, _ = params_to_jax(tm)
    assert {k: v.shape for k, v in got.items()} == want
    assert sum(v.size for v in got.values()) == sum(
        int(np.prod(s)) for s in want.values())


def test_init_is_seeded_and_flax_like():
    a, b, c = (get_model("vit_tiny", device="cpu", image_size=32, seed=s)
               for s in (3, 3, 4))
    pa, pb, pc = (params_to_jax(m)[0] for m in (a, b, c))
    assert all(np.array_equal(pa[k], pb[k]) for k in pa)
    assert not np.array_equal(pa["block_0/attn/qkv/kernel"],
                              pc["block_0/attn/qkv/kernel"])
    fc1 = pa["block_0/mlp/fc1/kernel"]              # lecun normal, fan-in 192
    assert abs(fc1.std() - np.sqrt(1 / 192)) < 0.05 * np.sqrt(1 / 192)
    assert abs(pa["pos_embed"].std() - 0.02) < 0.002
    assert np.all(pa["cls_token"] == 0) and np.all(pa["head/bias"] == 0)
    assert np.all(pa["block_1/ln2/scale"] == 1)
    assert isinstance(a, ViT) and isinstance(ViT_Tiny(image_size=32), ViT)


def test_vit_refuses_what_flax_refuses():
    with pytest.raises(ValueError, match="pool"):
        ViT(pool="avg")
    with pytest.raises(ValueError, match="not divisible by patch"):
        ViT(patch_size=16, image_size=40)
