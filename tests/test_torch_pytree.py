"""Flax <-> torch parameter names and layouts (utils/pytree.py)."""

import jax
import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.models import (
    ResNet as JaxResNet, ResNet18 as JaxResNet18)
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import \
    flatten_params as jax_flatten
from distributed_parameter_server_for_ml_training_tpu_torch.models import (
    ResNet, ResNet18, count_params)
from distributed_parameter_server_for_ml_training_tpu_torch.utils.pytree \
    import (flatten_params, params_from_jax, params_to_jax, to_flax_layout,
            to_torch_layout, torch_name, unflatten_params)


def _jax_shapes(model):
    shapes = jax.eval_shape(
        lambda k, x: model.init(k, x, train=False),
        jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32))
    return ({k: tuple(v.shape) for k, v in
             jax_flatten(shapes["params"], as_numpy=False).items()},
            {k: tuple(v.shape) for k, v in
             jax_flatten(shapes["batch_stats"], as_numpy=False).items()})


def test_resnet18_names_shapes_and_count_match_flax():
    want_p, want_s = _jax_shapes(JaxResNet18(100))
    params, stats = params_to_jax(ResNet18(100))
    # eval_shape returns sorted dicts; the order is pinned against
    # model.init below.
    assert {k: v.shape for k, v in params.items()} == want_p
    assert {k: v.shape for k, v in stats.items()} == want_s
    assert len(params) == 62
    assert sum(v.size for v in params.values()) == 11_220_132
    assert count_params(ResNet18(100)) == 11_220_132


def test_flat_order_matches_flax_init_order():
    """The store keys (and wire order) follow flax's creation order, which
    ``model.init`` (not ``eval_shape``) returns."""
    m = JaxResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    v = m.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32),
               train=False)
    params, stats = params_to_jax(
        ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10))
    assert list(params) == list(jax_flatten(v["params"]))
    assert list(stats) == list(jax_flatten(v["batch_stats"]))


def test_round_trip_jax_torch_jax_is_byte_equal():
    m = JaxResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    v = m.init(jax.random.PRNGKey(3), np.zeros((1, 32, 32, 3), np.float32),
               train=False)
    p0 = jax_flatten(v["params"])
    r = np.random.default_rng(0)
    s0 = {k: r.standard_normal(a.shape).astype(np.float32) ** 2
          for k, a in jax_flatten(v["batch_stats"]).items()}
    module = ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    module.load_state_dict(params_from_jax(p0, s0))
    p1, s1 = params_to_jax(module)
    assert list(p1) == list(p0) and list(s1) == list(s0)
    for k in p0:
        assert p1[k].dtype == np.float32
        assert p1[k].tobytes() == np.asarray(p0[k]).tobytes(), k
    for k in s0:
        assert s1[k].tobytes() == s0[k].tobytes(), k


def test_layout_conversions():
    hwio = np.arange(3 * 3 * 4 * 8, dtype=np.float32).reshape(3, 3, 4, 8)
    dense = np.arange(6, dtype=np.float32).reshape(2, 3)
    sd = params_from_jax({"c/kernel": hwio, "d/kernel": dense,
                          "d/bias": np.zeros(3, np.float32),
                          "bn/scale": np.ones(8, np.float32)},
                         {"bn/mean": np.zeros(8, np.float32)})
    assert sd["c.weight"].shape == (8, 4, 3, 3)
    assert torch.equal(sd["c.weight"][5, 2],
                       torch.from_numpy(hwio[:, :, 2, 5]))
    assert torch.equal(sd["d.weight"], torch.from_numpy(dense.T))
    assert set(sd) == {"c.weight", "d.weight", "d.bias", "bn.weight",
                       "bn.running_mean"}
    with pytest.raises(KeyError):
        torch_name("x/weird", "params")


def test_flatten_unflatten_round_trip():
    tree = {"a": {"b": np.ones(2), "c": {"d": np.zeros(1)}}, "e": np.ones(3)}
    flat = flatten_params(tree)
    assert list(flat) == ["a/b", "a/c/d", "e"]
    back = unflatten_params(flat)
    assert list(back) == ["a", "e"] and list(back["a"]["c"]) == ["d"]


@pytest.mark.parametrize("name,torch_shape,flax_shape", [
    ("block_0/moe/router", (8, 4), (8, 4)),
    ("block_0/moe/w1", (4, 8, 32), (4, 8, 32)),
    ("block_0/moe/b1", (4, 32), (4, 32)),
    ("block_0/moe/w2", (4, 32, 8), (4, 32, 8)),
    ("block_0/moe/b2", (4, 8), (4, 8)),
    ("stages/block_0/attn/qkv/kernel", (2, 24, 8), (2, 8, 24)),
    ("stages/block_1/ln2/scale", (2, 8), (2, 8)),
    ("stages/block_1/mlp/fc1/bias", (2, 32), (2, 32)),
    ("prologue/patch_embed/kernel", (8, 3, 4, 4), (4, 4, 3, 8)),
    ("epilogue/head/kernel", (10, 8), (8, 10)),
])
def test_named_layouts_take_precedence_over_rank(name, torch_shape,
                                                 flax_shape):
    """The leaf names the layout: MoE leaves keep flax's (a 2-D router is
    not a Dense kernel), a stacked Dense kernel swaps its last two dims
    under the stage axis, a stacked LayerNorm scale stays; the round trip
    is exact."""
    t = torch.arange(float(np.prod(torch_shape))).view(torch_shape)
    f = to_flax_layout(t, name)
    assert tuple(f.shape) == flax_shape
    assert to_torch_layout(f.contiguous(), name).equal(t)
    if name.endswith("qkv/kernel"):
        assert f[1].equal(t[1].t())
    mapped = params_from_jax({name: f.numpy()})
    assert list(mapped) == [torch_name(name)]
    assert mapped[torch_name(name)].equal(t)
