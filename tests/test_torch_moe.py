"""The port's Switch-MoE (``parallel/moe.py``: E expert slots on one
device) against the JAX package's (E virtual CPU devices under
``shard_map``), mirroring ``tests/test_moe.py``'s one-axis cases at D 16,
H 32: outputs, routing statistics, capacity drops, gradients and the
dense reference, from the same numpy inputs and the JAX package's
parameters. The routing indices are compared first, for equality: a
near-tie routed differently would move a token's output by O(1). Then
fp32 values within rtol 1e-5 / atol 1e-6 (the products are summed in
another order); ``load`` and ``drop_frac`` are counts over dyadic shard
sizes and must be equal. The dp x ep cases (a ``(data, expert)`` mesh of
2 x 4 slots against 2 x 4 virtual devices, ``tests/test_moe.py``'s
composition cases): outputs, statistics and gradients against JAX's at
generous and tight capacities, the dense reference, and JAX's dp x ep
gradient equal to its one-group gradient. Also the ViT with a MoE MLP
against the flax model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.models import vit as jvit
from distributed_parameter_server_for_ml_training_tpu.parallel import \
    make_mesh as jax_make_mesh
from distributed_parameter_server_for_ml_training_tpu.parallel import \
    moe as jmoe
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import \
    flatten_params as jax_flatten
from distributed_parameter_server_for_ml_training_tpu_torch.models import \
    vit as tvit
from distributed_parameter_server_for_ml_training_tpu_torch.parallel import \
    moe
from distributed_parameter_server_for_ml_training_tpu_torch.parallel.mesh \
    import EXPERT_AXIS, make_mesh
from distributed_parameter_server_for_ml_training_tpu_torch.train.steps \
    import collect_moe_stats
from distributed_parameter_server_for_ml_training_tpu_torch.utils.pytree \
    import params_from_jax, params_to_jax
from torch_threads import one_torch_thread_per_module  # noqa: F401

E, D, H = 8, 16, 32
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jparams():
    return jmoe.init_moe_params(jax.random.PRNGKey(0), D, H, E)


def _torch_params(jparams, requires_grad=False):
    return {k: torch.tensor(np.asarray(v)).requires_grad_(requires_grad)
            for k, v in jparams.items()}


def _tokens(n, seed):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def _jax_routing(jparams, tokens):
    probs = jax.nn.softmax(jnp.asarray(tokens) @ jparams["router"], axis=-1)
    return np.asarray(jnp.argmax(probs, axis=-1))


def _port(capacity):
    return moe.make_moe_ffn(make_mesh(E, "cpu", axis_names=(EXPERT_AXIS,)),
                            capacity)


@pytest.mark.parametrize("n,capacity,seed", [
    (64, 64, 1),        # generous: no drops
    (64, 1, 2),         # one token an expert a shard survives
    (128, 3, 4),        # partial drops in most shards
    (256, 8, 5)])
def test_moe_matches_jax(devices, jparams, n, capacity, seed):
    tokens = _tokens(n, seed)
    params = _torch_params(jparams)
    _, idx, _ = moe._route(torch.from_numpy(tokens), params["router"])
    np.testing.assert_array_equal(idx.numpy(), _jax_routing(jparams, tokens))
    want_out, want = jmoe.make_moe_ffn(
        jax_make_mesh(E, axis_names=("expert",)), capacity=capacity)(
        jparams, jnp.asarray(tokens))
    out, stats = _port(capacity)(params, torch.from_numpy(tokens))
    np.testing.assert_array_equal(stats["load"].numpy(),
                                  np.asarray(want["load"]))
    assert float(stats["drop_frac"]) == float(want["drop_frac"])
    # Dropped rows are exactly zero in both.
    np.testing.assert_array_equal(np.all(out.numpy() == 0, axis=1),
                                  np.all(np.asarray(want_out) == 0, axis=1))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    for k in ("importance", "aux_loss"):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)
    if capacity == 1:
        assert float(stats["drop_frac"]) > 0


def test_positions_count_within_each_shard(jparams):
    """Every token routed to expert 0: each of the E shards keeps its own
    first ``capacity`` tokens (a count over the whole batch would keep only
    shard 0's)."""
    params = _torch_params(jparams)
    params["router"] = torch.zeros(D, E)
    params["router"][:, 0] = 1.0
    tokens = torch.from_numpy(np.abs(_tokens(64, 3)))    # 8 a shard
    out, stats = _port(2)(params, tokens)
    kept = ~torch.all(out == 0, dim=1)
    assert kept.view(E, 8).sum(1).tolist() == [2] * E
    assert kept.view(E, 8)[:, :2].all()
    assert float(stats["drop_frac"]) == 0.75
    assert stats["load"].tolist() == [1.0] + [0.0] * (E - 1)


def test_moe_gradients_match_jax(devices, jparams):
    """d/d(params, tokens) of sum(out^2) + aux_loss at a capacity that
    drops some tokens."""
    tokens = _tokens(128, 6)
    jfn = jmoe.make_moe_ffn(jax_make_mesh(E, axis_names=("expert",)),
                            capacity=4)

    def jloss(p, x):
        out, st = jfn(p, x)
        return jnp.sum(out ** 2) + st["aux_loss"]

    want = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(tokens))
    params = _torch_params(jparams, requires_grad=True)
    x = torch.from_numpy(tokens).requires_grad_()
    out, st = _port(4)(params, x)
    assert float(st["drop_frac"]) > 0
    ((out ** 2).sum() + st["aux_loss"]).backward()
    for k in params:
        np.testing.assert_allclose(params[k].grad.numpy(),
                                   np.asarray(want[0][k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)


def test_dense_reference_matches_jax(jparams):
    tokens = _tokens(64, 7)
    want = jmoe.dense_reference(jparams, jnp.asarray(tokens))
    params = _torch_params(jparams)
    got = moe.dense_reference(params, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    out, stats = _port(64)(params, torch.from_numpy(tokens))
    np.testing.assert_allclose(out.numpy(), got.numpy(), **TOL)
    assert float(stats["drop_frac"]) == 0.0


def test_routing_stats_and_aux_loss(jparams):
    """load and importance sum to 1, aux_loss >= 1, and the aux loss moves
    the router only (f_e is a stopped count)."""
    params = _torch_params(jparams, requires_grad=True)
    _, stats = _port(128)(params, torch.from_numpy(_tokens(128, 5)))
    stat = {k: v.detach() for k, v in stats.items()}
    assert abs(float(stat["load"].sum()) - 1) < 1e-5
    assert abs(float(stat["importance"].sum()) - 1) < 1e-5
    assert float(stat["aux_loss"]) >= 1 - 1e-5
    stats["aux_loss"].backward()
    assert float(params["router"].grad.abs().sum()) > 0
    assert params["w1"].grad is None or \
        float(params["w1"].grad.abs().sum()) == 0.0


def test_float64_run_routes_alike_and_stays_close(jparams):
    """The card check's reference in miniature: the same call in float64
    routes every token alike and its output is within 1e-5 of fp32's."""
    tokens = torch.from_numpy(_tokens(128, 8))
    p32 = _torch_params(jparams)
    out32, st32 = _port(6)(p32, tokens)
    p64 = {k: v.double() for k, v in p32.items()}
    out64, st64 = _port(6)(p64, tokens.double())
    assert out64.dtype == torch.float64
    assert float(st64["drop_frac"]) == float(st32["drop_frac"])
    np.testing.assert_array_equal(st64["load"].numpy(),
                                  st32["load"].numpy())
    np.testing.assert_allclose(out32.numpy(), out64.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_refusals(jparams):
    """What stays refused: tokens that do not split into the shards,
    experts that are not one a slot, a two-axis mesh without its slot
    count (JAX's "not divisible" where the count does not divide) and a
    mesh of two axes over ranks (item 10's sixth part). The dp x ep mesh
    item 10's third part brought builds with JAX's shape."""
    mesh = make_mesh(2, "cpu", axis_names=("data", "expert"), num_slots=8)
    assert mesh.shape == {"data": 2, "expert": 4}
    assert callable(moe.make_moe_ffn(mesh, 8, data_axis="data"))
    with pytest.raises(ValueError, match="num_slots"):
        make_mesh(2, "cpu", axis_names=("data", "expert"))
    with pytest.raises(ValueError, match="not divisible by 3"):
        make_mesh(3, "cpu", axis_names=("data", "expert"), num_slots=8)
    with pytest.raises(NotImplementedError, match="item 10, sixth part"):
        type(mesh)(2, mesh.device, "data", group=object(), axes=mesh.axes)
    with pytest.raises(ValueError, match="do not split"):
        _port(8)(_torch_params(jparams), torch.zeros(12, D))
    four = moe.make_moe_ffn(make_mesh(4, "cpu", axis_names=(EXPERT_AXIS,)),
                            8)
    with pytest.raises(ValueError, match="one expert a slot"):
        four(_torch_params(jparams), torch.zeros(16, D))


# ---------------------------------------------------------------------------
# dp x ep: data 2 x 4 experts
# ---------------------------------------------------------------------------

DP, E4 = 2, 4


@pytest.fixture(scope="module")
def jparams4():
    return jmoe.init_moe_params(jax.random.PRNGKey(0), D, H, E4)


def _dp_meshes():
    return (jax_make_mesh(DP, axis_names=("data", "expert")),
            make_mesh(DP, "cpu", axis_names=("data", "expert"),
                      num_slots=DP * E4))


@pytest.mark.parametrize("n,capacity,seed", [
    (64, 64, 2),        # generous: no drops (JAX's composition case)
    (128, 3, 7)])       # drops counted within each group's shards
def test_dp_ep_matches_jax(devices, jparams4, n, capacity, seed):
    """Outputs, statistics and the routing of every shard of both groups
    against JAX's dp x ep; at the generous capacity also the dense
    reference, the statistics summing to 1 over the whole mesh."""
    jmesh, mesh = _dp_meshes()
    tokens = _tokens(n, seed)
    want_out, want = jmoe.make_moe_ffn(jmesh, capacity=capacity,
                                       data_axis="data")(
        jparams4, jnp.asarray(tokens))
    params = _torch_params(jparams4)
    out, stats = moe.make_moe_ffn(mesh, capacity, data_axis="data")(
        params, torch.from_numpy(tokens))
    np.testing.assert_array_equal(stats["load"].numpy(),
                                  np.asarray(want["load"]))
    assert float(stats["drop_frac"]) == float(want["drop_frac"])
    np.testing.assert_array_equal(np.all(out.numpy() == 0, axis=1),
                                  np.all(np.asarray(want_out) == 0, axis=1))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    for k in ("importance", "aux_loss"):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)
    if capacity >= n:
        assert float(stats["drop_frac"]) == 0.0
        ref = moe.dense_reference(params, torch.from_numpy(tokens))
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-5)
        assert abs(float(stats["load"].sum()) - 1.0) <= 1e-6
    else:
        assert float(stats["drop_frac"]) > 0


def test_dp_ep_positions_count_within_each_group_shard(jparams4):
    """Every token routed to expert 0: each of the 8 shards of the two
    groups keeps its own first ``capacity`` tokens."""
    _, mesh = _dp_meshes()
    params = _torch_params(jparams4)
    params["router"] = torch.zeros(D, E4)
    params["router"][:, 0] = 1.0
    tokens = torch.from_numpy(np.abs(_tokens(64, 3)))    # 8 a shard
    out, stats = moe.make_moe_ffn(mesh, 2, data_axis="data")(params, tokens)
    kept = ~torch.all(out == 0, dim=1)
    assert kept.view(DP * E4, 8).sum(1).tolist() == [2] * (DP * E4)
    assert float(stats["drop_frac"]) == 0.75


def test_dp_ep_gradients_match_jax(devices, jparams4):
    """d/d(params, tokens) of sum(out^2) + aux against JAX's dp x ep at a
    capacity that drops tokens; at a generous one the dp x ep gradient
    equals the one-group (ep only) gradient, JAX's data-axis psum."""
    jmesh, mesh = _dp_meshes()
    tokens = _tokens(128, 6)

    def run(capacity, data_axis, tmesh):
        params = _torch_params(jparams4, requires_grad=True)
        x = torch.from_numpy(tokens).requires_grad_()
        out, st = moe.make_moe_ffn(tmesh, capacity, data_axis=data_axis)(
            params, x)
        ((out ** 2).sum() + st["aux_loss"]).backward()
        return {**{k: v.grad for k, v in params.items()}, "x": x.grad}, st

    jfn = jmoe.make_moe_ffn(jmesh, capacity=4, data_axis="data")

    def jloss(p, x):
        out, st = jfn(p, x)
        return jnp.sum(out ** 2) + st["aux_loss"]

    want = jax.grad(jloss, argnums=(0, 1))(jparams4, jnp.asarray(tokens))
    got, st = run(4, "data", mesh)
    assert float(st["drop_frac"]) > 0
    for k in jparams4:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[0][k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)
    # Generous capacity: the grouping changes no gradient but the aux
    # loss's (its statistics are per shard); compare out^2 alone.
    g_dp, _ = run(128, "data", mesh)
    g_ep, _ = run(128, None, make_mesh(E4, "cpu",
                                       axis_names=(EXPERT_AXIS,)))
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(g_dp[k].numpy(), g_ep[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_init_moe_params_shapes_match_jax(jparams):
    got = moe.init_moe_params(torch.Generator().manual_seed(0), D, H, E)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in jparams.items()}
    assert not got["b1"].any() and not got["b2"].any()


@pytest.mark.parametrize("train", [True, False])
def test_moe_vit_matches_flax(devices, train):
    """vit_tiny (fp32, gap, 4 experts a block) from the flax model's
    weights: logits within 1e-4 / 1e-5; a training forward keeps each
    layer's routing stats (equal load and drop fraction to the flax
    model's sown ones), an eval forward records nothing."""
    n_exp, cap, image = 4, 16, 32
    x = np.random.default_rng(9).normal(size=(4, image, image, 3)) \
        .astype(np.float32)
    jmodel = jvit.ViT(patch_size=4, hidden_dim=192, depth=2, num_heads=3,
                      num_classes=10, pool="gap", moe_experts=n_exp,
                      moe_fn=jmoe.make_moe_ffn(
                          jax_make_mesh(n_exp, axis_names=("expert",),
                                        devices=jax.devices()[:n_exp]),
                          capacity=cap))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, sown = jmodel.apply(variables, jnp.asarray(x),
                              mutable=["intermediates"])
    flat = jax_flatten(jax.device_get(variables["params"]))
    model = tvit.ViT(patch_size=4, hidden_dim=192, depth=2, num_heads=3,
                     num_classes=10, pool="gap", image_size=image,
                     moe_experts=n_exp, moe_fn=moe.make_moe_ffn(
                         make_mesh(n_exp, "cpu",
                                   axis_names=(EXPERT_AXIS,)), cap))
    model.load_state_dict(params_from_jax(flat))
    got_flat, _ = params_to_jax(model)
    assert set(got_flat) == set(flat)
    for k in flat:
        assert got_flat[k].tobytes() == np.asarray(flat[k]).tobytes(), k
    model.train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    layers = collect_moe_stats(model)
    if not train:
        assert layers == []
        return
    jlayers = [sown["intermediates"][f"block_{i}"]["moe"]["moe_stats"][0]
               for i in range(2)]
    assert len(layers) == 2
    for st, js in zip(layers, jlayers):
        np.testing.assert_array_equal(st["load"].numpy(),
                                      np.asarray(js["load"]))
        assert float(st["drop_frac"]) == float(js["drop_frac"])
