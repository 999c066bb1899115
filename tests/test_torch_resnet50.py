"""The port's ResNet-50, the ImageNet stem and its space-to-depth form
(``models/resnet.py``) against the flax models, with the weights carried
across by ``utils/pytree.params_from_jax``.

- structure at full width: names, shapes and parameter counts against
  ``jax.eval_shape`` for the 7x7, the s2d and the CIFAR stem; for the
  first two the flat order against ``model.init`` and a byte-equal round
  trip flax -> torch -> flax;
- one full-width eval forward, batch 2 at 224 px, fp32: logits within
  atol/rtol 1e-4 of flax's (as ``test_torch_models.py``);
- at tiny widths (8 filters, stages (1, 1, 1, 1)) on every stem:
  train-mode logits (atol/rtol 1e-4) and batch statistics (1e-5) in
  fp32, as the ResNet-18 tests hold them; parameter gradients, and
  per-slot gradients against JAX's per-device gradients under
  ``shard_map`` on 4 virtual CPU devices, in float64 in both packages,
  per tensor within 1e-6 of its largest entry (fp32 gradients of this
  deeper net cannot be held element-wise: a ReLU input within rounding
  of 0 falls on either side in either framework); ``forward`` as one
  slot of ``forward_slots`` in float64 (1e-10); ``max_stages`` feature
  maps (1e-4);
- ``s2d_stem_kernel`` byte-equal to the JAX package's, and the s2d model
  equal to the 7x7 model within 1e-5 (the same function, summed in
  another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_parameter_server_for_ml_training_tpu.models import \
    resnet as jresnet
from distributed_parameter_server_for_ml_training_tpu.parallel import \
    make_mesh as jax_make_mesh
from distributed_parameter_server_for_ml_training_tpu.parallel.mesh import \
    shard_map
from distributed_parameter_server_for_ml_training_tpu.train.steps import \
    cross_entropy_loss as jax_cross_entropy
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import (
    flatten_params as jax_flatten, unflatten_params as jax_unflatten)
from distributed_parameter_server_for_ml_training_tpu_torch.data import (
    standardize, to_float)
from distributed_parameter_server_for_ml_training_tpu_torch.models import (
    BatchNorm, Bottleneck, ResNet, ResNet50, count_params, get_model,
    s2d_stem_kernel)
from distributed_parameter_server_for_ml_training_tpu_torch.parallel import \
    DATA_AXIS
from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
    .sync_dp import make_slot_grad_fn
from distributed_parameter_server_for_ml_training_tpu_torch.utils.pytree \
    import flax_names, params_from_jax, params_to_jax, to_flax_layout
from torch_threads import one_torch_thread_per_module  # noqa: F401

STEMS = {"imagenet": dict(imagenet_stem=True),
         "s2d": dict(imagenet_stem=True, s2d_stem=True),
         "cifar": {}}
#: Parameters at full width, 1,000 and 100 classes (flax's counts).
COUNTS = {"imagenet": (25_557_032, 23_712_932),
          "s2d": (25_559_912, 23_715_812),
          "cifar": (25_549_352, 23_705_252)}


def _stats_like(flat: dict, seed: int) -> dict:
    """Non-trivial running statistics, so eval mode is a real test."""
    r = np.random.default_rng(seed)
    return {k: (np.abs(r.standard_normal(a.shape)) + 0.5).astype(np.float32)
            if k.endswith("var") else
            r.standard_normal(a.shape).astype(np.float32) * 0.1
            for k, a in flat.items()}


def _flax_order(stem: str) -> tuple[list, list]:
    """Flax's creation order (``model.init``'s) of ResNet-50's parameter
    and statistics names, read while ``jax.eval_shape`` traces the init
    (its result comes back sorted, as every jax pytree output)."""
    order = []

    def init(key):
        v = jresnet.ResNet50(1000, **STEMS[stem]).init(
            key, jnp.zeros((1, 32, 32, 3)), train=False)
        order.extend(list(jax_flatten(v[c], as_numpy=False))
                     for c in ("params", "batch_stats"))
        return v

    jax.eval_shape(init, jax.random.PRNGKey(0))
    return order[0], order[1]


@pytest.fixture(scope="module")
def full_width():
    """Full-width ResNet-50 weights (1,000 classes) in flax layouts for the
    7x7 and the s2d stem, drawn from a seed (the port's lecun-normal
    init), with non-trivial running statistics."""
    out = {}
    for stem in ("imagenet", "s2d"):
        gen = torch.Generator().manual_seed(7)
        params, stats = params_to_jax(ResNet50(1000, generator=gen,
                                               **STEMS[stem]))
        out[stem] = (params, _stats_like(stats, 1))
    return out


@pytest.mark.parametrize("num_classes", [1000, 100])
@pytest.mark.parametrize("stem", list(STEMS))
def test_full_width_structure_matches_flax(stem, num_classes):
    shapes = jax.eval_shape(
        lambda k: jresnet.ResNet50(num_classes, **STEMS[stem]).init(
            k, jnp.zeros((1, 224, 224, 3)), train=False),
        jax.random.PRNGKey(0))
    want_p = {k: tuple(v.shape) for k, v in
              jax_flatten(shapes["params"], as_numpy=False).items()}
    want_s = {k: tuple(v.shape) for k, v in
              jax_flatten(shapes["batch_stats"], as_numpy=False).items()}
    tm = ResNet50(num_classes, **STEMS[stem])
    params, stats = params_to_jax(tm)
    assert {k: v.shape for k, v in params.items()} == want_p
    assert {k: v.shape for k, v in stats.items()} == want_s
    assert len(params) == 161 and len(stats) == 106
    want = COUNTS[stem][0 if num_classes == 1000 else 1]
    assert count_params(tm) == sum(np.prod(s) for s in want_p.values()) \
        == want
    conv = "stem_conv_s2d/kernel" if stem == "s2d" else "stem_conv/kernel"
    assert conv in params and all(
        isinstance(getattr(tm, f"Bottleneck_{i}"), Bottleneck)
        for i in range(16))


@pytest.mark.parametrize("stem", ["imagenet", "s2d"])
def test_full_width_order_and_round_trip_match_flax(full_width, stem):
    """Flat names in flax's creation order (``model.init``'s), and flax
    layouts -> torch -> flax layouts byte for byte, batch statistics
    included."""
    params, stats = full_width[stem]
    assert (list(params), list(stats)) == _flax_order(stem)
    tm = ResNet50(1000, **STEMS[stem])
    tm.load_state_dict(params_from_jax(params, stats))
    back_p, back_s = params_to_jax(tm)
    for k in params:
        assert back_p[k].tobytes() == np.asarray(params[k]).tobytes(), k
    for k in stats:
        assert back_s[k].tobytes() == stats[k].tobytes(), k


def test_full_width_eval_logits_match_flax(full_width):
    """Batch 2 at 224 px through the 7x7 stem and max-pool, fp32."""
    params, stats = full_width["imagenet"]
    x = np.random.default_rng(3).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    jm = jresnet.ResNet50(1000, imagenet_stem=True)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": jax_unflatten(params),
         "batch_stats": jax_unflatten(stats)}, x))
    tm = ResNet50(1000, imagenet_stem=True)
    tm.load_state_dict(params_from_jax(params, stats))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 1000)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


# -- tiny widths --------------------------------------------------------------

TINY = dict(stage_sizes=(1, 1, 1, 1), num_filters=8, num_classes=10)


def _tiny_pair(stem: str, seed: int = 0, axis_name=None):
    """(flax tiny Bottleneck ResNet, its variables with non-trivial
    statistics, the port's model with those weights)."""
    jm = jresnet.ResNet(**TINY, block_cls=jresnet.Bottleneck,
                        axis_name=axis_name, **STEMS[stem])
    v = jm.init(jax.random.PRNGKey(seed),
                np.zeros((1, 32, 32, 3), np.float32), train=False)
    params = jax_flatten(v["params"])
    stats = _stats_like(jax_flatten(v["batch_stats"]), seed)
    tm = ResNet(**TINY, block_cls=Bottleneck, axis_name=axis_name,
                **STEMS[stem])
    tm.load_state_dict(params_from_jax(params, stats))
    return jm, params, stats, tm


def _images(n, seed=1, size=32):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                  tree)


def _port64(stem: str, params: dict, stats: dict, axis_name=None):
    tm = ResNet(**TINY, block_cls=Bottleneck, dtype=torch.float64,
                axis_name=axis_name, **STEMS[stem])
    tm.load_state_dict(params_from_jax(params, stats))
    return tm.double()


def _assert_grads_close(got: dict, want: dict):
    """float64 gradients, per tensor within 1e-6 of its largest entry:
    the flax model casts its logits to fp32 before the loss, which
    perturbs every cotangent at ~1e-7 relative."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(np.asarray(got[k], np.float64), w,
                                   rtol=0, atol=1e-6 * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.parametrize("stem", list(STEMS))
def test_tiny_train_logits_stats_and_grads_match_flax(stem):
    """fp32 train-mode logits and batch statistics; the gradients in
    float64 in both packages. (In fp32 a ReLU input within rounding of 0
    can fall on either side in either framework, which moves a
    gradient by a whole element's contribution.)"""
    jm, params, stats, tm = _tiny_pair(stem)
    x = _images(8)
    y = np.arange(8) % 10
    variables = {"params": jax_unflatten(params),
                 "batch_stats": jax_unflatten(stats)}
    want, mutated = jax.jit(lambda v: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables)
    want_s = jax_flatten(mutated["batch_stats"])
    tm.train()
    with torch.no_grad():
        logits = tm(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    _, got_s = params_to_jax(tm)
    assert set(got_s) == set(want_s)
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], atol=1e-5,
                                   rtol=1e-5, err_msg=k)

    with jax.enable_x64(True):
        jm64 = jresnet.ResNet(**TINY, block_cls=jresnet.Bottleneck,
                              dtype=jnp.float64, **STEMS[stem])
        x64, s64 = x.astype(np.float64), _f64(variables["batch_stats"])

        def loss_fn(p):
            out, _ = jm64.apply({"params": p, "batch_stats": s64}, x64,
                                train=True, mutable=["batch_stats"])
            return jax_cross_entropy(out, y)

        want_g = jax_flatten(jax.jit(jax.grad(loss_fn))(
            _f64(variables["params"])))
    t64 = _port64(stem, params, stats).train()
    torch.nn.functional.cross_entropy(
        t64(torch.from_numpy(x).double()),
        torch.from_numpy(y).long()).backward()
    pnames, _ = flax_names(t64)
    own = dict(t64.named_parameters())
    assert list(pnames.values()) == list(params)
    _assert_grads_close({f: to_flax_layout(own[t].grad).numpy()
                         for t, f in pnames.items()}, want_g)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("stem", list(STEMS))
def test_tiny_forward_is_one_slot_of_forward_slots(stem, train):
    """Three slots with the same weights: each slot's logits are its
    one-slot logits (grouped convs, the s2d reshape and the max-pool per
    slot), in float64 to 1e-10. In training the statistics are shared
    over the slots, so the slots see the same images there."""
    _, params, stats, _ = _tiny_pair(stem)
    tm = _port64(stem, params, stats, axis_name=DATA_AXIS)
    x = _images(12).reshape(3, 4, 32, 32, 3).astype(np.float64)
    if train:
        x = np.broadcast_to(x[:1], x.shape).copy()
    tm.train(train)
    leaves = {k: p[None].expand(3, *p.shape)
              for k, p in tm.named_parameters()}
    with torch.no_grad():
        got = tm.forward_slots(torch.from_numpy(x), leaves)
        want = torch.stack([tm(torch.from_numpy(x[i])) for i in range(3)])
    torch.testing.assert_close(got, want, atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize("stem", ["imagenet", "s2d"])
def test_tiny_per_slot_grads_match_jax_per_device_grads(devices, stem):
    """4 slots against 4 virtual devices: each slot's gradient through the
    cross-replica BatchNorm, as each JAX device computes it, in float64
    (as above), and each slot's loss (within 1e-6: flax's logits are
    fp32)."""
    n = 4
    jm, params, stats, tm = _tiny_pair(stem, axis_name="data")
    r = np.random.default_rng(5)
    images = r.integers(0, 255, (16, 32, 32, 3), dtype=np.uint8)
    labels = (np.arange(16) % 10).astype(np.int32)
    x64 = standardize(to_float(torch.from_numpy(images))).double()

    def body(p, s, xs, ys):
        def loss_fn(p):
            out, mut = jm64.apply({"params": p, "batch_stats": s}, xs,
                                  train=True, mutable=["batch_stats"])
            return jax_cross_entropy(out, ys), mut
        (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return jax.tree_util.tree_map(lambda a: a[None], g), loss[None]

    with jax.enable_x64(True):
        jm64 = jresnet.ResNet(**TINY, block_cls=jresnet.Bottleneck,
                              dtype=jnp.float64, axis_name="data",
                              **STEMS[stem])
        jg, jl = jax.jit(shard_map(
            body, mesh=jax_make_mesh(n),
            in_specs=(P(), P(), P("data"), P("data")),
            out_specs=(P("data"), P("data")), check_vma=False))(
            _f64(jax_unflatten(params)), _f64(jax_unflatten(stats)),
            x64.numpy(), labels)
        jg, jl = jax_flatten(jg), np.asarray(jl)
    t64 = _port64(stem, params, stats, axis_name=DATA_AXIS)
    p64 = {k: torch.from_numpy(np.asarray(v, np.float64))
           for k, v in params.items()}
    s64 = {k: torch.from_numpy(np.asarray(v, np.float64))
           for k, v in stats.items()}
    g, losses, _, _ = make_slot_grad_fn(t64)(
        p64, s64, x64.view(n, -1, 32, 32, 3),
        torch.from_numpy(labels).view(n, -1))
    np.testing.assert_allclose(losses.numpy(), jl, rtol=1e-6)
    assert list(g) == list(params)
    for k in jg:
        assert tuple(g[k].shape) == jg[k].shape, k
    _assert_grads_close({k: v.numpy() for k, v in g.items()}, jg)


@pytest.mark.parametrize("stages", [1, 2, 4])
def test_max_stages_feature_maps_match_flax(stages):
    """A truncated network returns the NHWC feature map (no pool, no head),
    and builds only the stages it runs, as flax does."""
    jm = jresnet.ResNet(**TINY, block_cls=jresnet.Bottleneck,
                        imagenet_stem=True, max_stages=stages)
    v = jm.init(jax.random.PRNGKey(2), np.zeros((1, 64, 64, 3), np.float32),
                train=False)
    params = jax_flatten(v["params"])
    stats = _stats_like(jax_flatten(v["batch_stats"]), 2)
    tm = ResNet(**TINY, block_cls=Bottleneck, imagenet_stem=True,
                max_stages=stages)
    got_p, _ = params_to_jax(tm)
    assert list(got_p) == list(params)
    tm.load_state_dict(params_from_jax(params, stats))
    tm.eval()
    x = _images(2, size=64)
    want = np.asarray(jm.apply({"params": v["params"],
                                "batch_stats": jax_unflatten(stats)}, x,
                               train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# -- the space-to-depth stem --------------------------------------------------

@pytest.mark.parametrize("channels,filters", [(3, 64), (3, 8), (2, 5)])
def test_s2d_stem_kernel_byte_equal_to_jax(channels, filters):
    w = np.random.default_rng(channels * filters).standard_normal(
        (7, 7, channels, filters)).astype(np.float32)
    got = s2d_stem_kernel(w)
    want = jresnet.s2d_stem_kernel(w)
    assert got.shape == want.shape == (4, 4, 4 * channels, filters)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="7x7"):
        s2d_stem_kernel(np.zeros((3, 3, 3, 8), np.float32))


@pytest.mark.parametrize("train", [False, True])
def test_s2d_model_equals_the_7x7_model(train):
    """The 7x7 model's weights with its stem kernel mapped by
    ``s2d_stem_kernel`` compute the same logits (and, in training, the
    same batch statistics) through the s2d stem."""
    _, params, stats, tm = _tiny_pair("imagenet", seed=3)
    s2d = {("stem_conv_s2d/kernel" if k == "stem_conv/kernel" else k):
           (s2d_stem_kernel(v) if k == "stem_conv/kernel" else v)
           for k, v in params.items()}
    ts = ResNet(**TINY, block_cls=Bottleneck, **STEMS["s2d"])
    ts.load_state_dict(params_from_jax(s2d, stats))
    x = torch.from_numpy(_images(4, seed=4, size=64))
    tm.train(train)
    ts.train(train)
    with torch.no_grad():
        torch.testing.assert_close(ts(x), tm(x), atol=1e-5, rtol=1e-5)
    for a, b in zip(ts.buffers(), tm.buffers()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="even"):
        ts(torch.zeros(1, 33, 33, 3))


# -- the registry -------------------------------------------------------------

@pytest.mark.parametrize("name,image_size", [
    ("resnet50", 224), ("resnet50", 32), ("resnet18", 96), ("resnet18", 95)])
def test_registry_takes_the_imagenet_stem_from_96_px(name, image_size):
    """As the JAX registry: both ResNets take the 7x7/2 stem and max-pool
    at ``image_size >= 96``, the CIFAR stem below; ``resnet50`` is
    Bottlenecks [3, 4, 6, 3]."""
    model = get_model(name, num_classes=1000, device="cpu",
                      image_size=image_size, dtype="float32")
    big = image_size >= 96
    assert model.imagenet_stem is big
    assert model.stem_conv.kernel_size == ((7, 7) if big else (3, 3))
    assert model.stem_conv.stride == ((2, 2) if big else (1, 1))
    blocks = [getattr(model, b) for b in model.block_names]
    assert len(blocks) == (16 if name == "resnet50" else 8)
    assert all(isinstance(b, Bottleneck) == (name == "resnet50")
               for b in blocks)
    assert all(isinstance(m.axis_name, type(None)) for m in model.modules()
               if isinstance(m, BatchNorm))
    with torch.no_grad():
        out = model.eval()(torch.zeros(1, image_size, image_size, 3))
    assert tuple(out.shape) == (1, 1000)
