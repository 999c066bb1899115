"""Every registry model under the port's data-parallel modes, against the
JAX package: ``vit_tiny`` (LayerNorm, no batch statistics) and a tiny
ResNet-50 (Bottlenecks [1, 1], 8 filters, the 7x7 ImageNet stem
and its max-pool), on the CPU, the JAX side on the virtual CPU devices of
``conftest.py``.

- ``ViT.forward_slots``: each slot's logits are its one-slot logits
  (fp32 within 1e-5, float64 within 1e-10);
- per-slot ViT gradients against JAX's per-device gradients under
  ``shard_map`` on 4 devices, and the worker's grad step against JAX's
  ``make_grad_step``: per tensor within 1e-4 of its largest entry (an
  entry that is the difference of large terms carries each framework's
  rounding of them, so no element-wise tolerance holds on every CPU);
- the sync step: for the ViT, ``none`` against JAX's step within rtol
  2e-4 / atol 2e-5, as ``test_torch_sync_dp.py`` holds ResNet-18's; for
  the tiny ResNet-50 ``none`` in float64 in both packages within 1e-6 of
  each tensor's largest entry (in fp32 a ReLU input within rounding of 0
  falls on either side in either framework); the deterministic int8
  ring over each model's real per-slot gradient rows bit-equal to JAX's
  ring; and each model's ``int8`` step within the stochastic ring's
  error bound of its uncompressed step (the JAX ring on the CPU rounds
  to nearest, so the two packages' int8 steps differ by up to two rings'
  errors);
- ``SyncTrainer``, async workers with int8 pushes and ``local_sgd``, and
  ``cli train --mode sync|async`` with these models end to end.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_parameter_server_for_ml_training_tpu.data.cifar import (
    standardize as jax_standardize, to_float as jax_to_float)
from distributed_parameter_server_for_ml_training_tpu.models import \
    resnet as jresnet, vit as jvit
from distributed_parameter_server_for_ml_training_tpu.parallel import (
    make_mesh as jax_make_mesh, make_sync_dp_step as jax_make_sync_dp_step,
    shard_batch as jax_shard_batch)
from distributed_parameter_server_for_ml_training_tpu.parallel.mesh import \
    shard_map
from distributed_parameter_server_for_ml_training_tpu.parallel.sync_dp \
    import _int8_ring_allreduce_mean as jax_ring
from distributed_parameter_server_for_ml_training_tpu.train import (
    create_train_state as jax_create_train_state,
    server_sgd as jax_server_sgd)
from distributed_parameter_server_for_ml_training_tpu.train.steps import (
    cross_entropy_loss as jax_cross_entropy,
    make_grad_step as jax_make_grad_step)
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import (
    flatten_params as jax_flatten, unflatten_params as jax_unflatten)
from distributed_parameter_server_for_ml_training_tpu_torch import cli
from distributed_parameter_server_for_ml_training_tpu_torch.data import (
    standardize, synthetic_cifar100, synthetic_imagenet, to_float)
from distributed_parameter_server_for_ml_training_tpu_torch.models import (
    Bottleneck, ResNet, ViT_Tiny)
from distributed_parameter_server_for_ml_training_tpu_torch.parallel import (
    DATA_AXIS, make_mesh, make_sync_dp_step, shard_batch)
from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
    .sync_dp import (_int8_ring_allreduce_mean, make_slot_grad_fn,
                     ravel_slots, ring_payload_bytes)
from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
    ParameterStore, StoreConfig, WorkerConfig, run_workers)
from distributed_parameter_server_for_ml_training_tpu_torch.train \
    .distributed import DistributedConfig, SyncTrainer
from distributed_parameter_server_for_ml_training_tpu_torch.train \
    .optimizers import server_sgd
from distributed_parameter_server_for_ml_training_tpu_torch.train.steps \
    import make_grad_step
from distributed_parameter_server_for_ml_training_tpu_torch.train \
    .train_state import train_state_from_jax
from distributed_parameter_server_for_ml_training_tpu_torch.utils.metrics \
    import parse_metrics_lines
from distributed_parameter_server_for_ml_training_tpu_torch.utils.pytree \
    import params_from_jax, params_to_jax
from torch_threads import one_torch_thread_per_module  # noqa: F401

R50 = dict(stage_sizes=(1, 1), num_filters=8, num_classes=10,
           imagenet_stem=True)


def _jax_model(name, axis_name=None, dtype=jnp.float32):
    if name == "vit":
        return jvit.ViT_Tiny(num_classes=10, dtype=dtype)
    return jresnet.ResNet(**R50, block_cls=jresnet.Bottleneck,
                          axis_name=axis_name, dtype=dtype)


def _port_model(name, axis_name=None, dtype=torch.float32):
    if name == "vit":
        return ViT_Tiny(num_classes=10, dtype=dtype, image_size=32)
    return ResNet(**R50, block_cls=Bottleneck, axis_name=axis_name,
                  dtype=dtype)


@pytest.fixture(scope="module")
def init():
    """Each model's initial flax variables (flat): the ViT's and the tiny
    ResNet-50's."""
    out = {}
    for name in ("vit", "r50"):
        st = jax_create_train_state(_jax_model(name, "data"),
                                    jax.random.PRNGKey(0),
                                    jax_server_sgd(0.1))
        out[name] = (jax_flatten(st.params), jax_flatten(st.batch_stats))
    return out


@pytest.fixture(scope="module")
def batch():
    r = np.random.default_rng(7)
    images = r.integers(0, 255, (16, 32, 32, 3), dtype=np.uint8)
    labels = (np.arange(16) % 10).astype(np.int32)
    return images, labels


def _close_to_max(got: dict, want: dict, frac: float):
    """Per tensor: max |got - want| <= frac * max |want| (+1e-12)."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[k], np.float64)
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=frac * np.abs(w).max() + 1e-12,
                                   err_msg=k)


def _numpy(flat: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in flat.items()}


# -- the ViT over slots -------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-10)])
def test_vit_forward_is_one_slot_of_forward_slots(init, dtype, tol):
    """Three slots with their own weights and images: slot i's logits are
    the one-slot model's with slot i's weights (the grouped patch conv,
    the batched Dense layers, per-slot LayerNorm, the core over the folded
    batch)."""
    params, _ = init["vit"]
    tm = _port_model("vit", dtype=dtype)
    tm.load_state_dict(params_from_jax(params))
    tm.to(dtype)
    r = np.random.default_rng(2)
    x = torch.from_numpy(r.standard_normal((3, 4, 32, 32, 3))).to(dtype)
    leaves = {k: torch.stack([p * (1 + 0.1 * i) for i in range(3)])
              for k, p in tm.named_parameters()}
    with torch.no_grad():
        got = tm.forward_slots(x, leaves)
        want = []
        for i in range(3):
            tm.load_state_dict({k: v[i] for k, v in leaves.items()})
            want.append(tm(x[i]))
    assert got.dtype == torch.promote_types(dtype, torch.float32)
    torch.testing.assert_close(got, torch.stack(want), atol=tol, rtol=tol)


def test_vit_per_slot_grads_match_jax_per_device_grads(devices, init, batch):
    n = 4
    params, _ = init["vit"]
    images, labels = batch
    jm = _jax_model("vit")

    def body(p, xs, ys):
        def loss_fn(p):
            out = jm.apply({"params": p}, jax_standardize(jax_to_float(xs)),
                           train=True)
            return jax_cross_entropy(out, ys)
        loss, g = jax.value_and_grad(loss_fn)(p)
        return jax.tree_util.tree_map(lambda a: a[None], g), loss[None]

    fn = jax.jit(shard_map(body, mesh=jax_make_mesh(n),
                           in_specs=(P(), P("data"), P("data")),
                           out_specs=(P("data"), P("data")),
                           check_vma=False))
    jg, jl = fn(jax_unflatten(params), images, labels)
    tm = _port_model("vit")
    st = train_state_from_jax(tm, params, {}, server_sgd(0.1))
    x = standardize(to_float(torch.from_numpy(images))).view(
        n, -1, 32, 32, 3)
    g, losses, logits, stats = make_slot_grad_fn(tm)(
        st.params, st.batch_stats, x, torch.from_numpy(labels).view(n, -1))
    assert stats == {} and tuple(logits.shape) == (n, 16 // n, 10)
    # cls_token and pos_embed are 4-D with the slot axis and keep their
    # layout; Dense kernels come back [in, out].
    assert tuple(g["cls_token"].shape) == (n, 1, 1, 192)
    assert tuple(g["block_0/attn/qkv/kernel"].shape) == (n, 192, 576)
    assert list(g) == list(params)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-5)
    _close_to_max(_numpy(g), jax_flatten(jg), 1e-4)


def test_vit_async_grad_step_matches_jax(init, batch):
    params, _ = init["vit"]
    images, labels = batch
    jg, jstats, jloss, jacc = jax_make_grad_step(
        _jax_model("vit"), augment=False)(jax_unflatten(params), {}, images,
                                          labels, jax.random.PRNGKey(1), 0)
    g, stats, loss, acc = make_grad_step(_port_model("vit"), augment=False)(
        params, {}, images, labels)
    assert stats == {} == jax_flatten(jstats)
    assert list(g) == list(params)
    assert all(v.is_contiguous() for v in g.values())
    _close_to_max(_numpy(g), jax_flatten(jg), 1e-4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(acc) == pytest.approx(float(jacc))


# -- the sync step ------------------------------------------------------------

def _jax_sync_step(name, init, batch, compression, n=4, dtype=jnp.float32):
    params, stats = init[name]
    cast = (lambda t: t) if dtype == jnp.float32 else (
        lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), t))
    st = jax_create_train_state(_jax_model(name, "data", dtype),
                                jax.random.PRNGKey(0), jax_server_sgd(0.1))
    st = st.replace(params=cast(jax_unflatten(params)),
                    batch_stats=cast(jax_unflatten(stats)))
    mesh = jax_make_mesh(n)
    out, metrics = jax_make_sync_dp_step(mesh, compression=compression,
                                         augment=False)(
        st, *jax_shard_batch(mesh, batch), jax.random.PRNGKey(1))
    return jax_flatten(out.params), jax_flatten(out.batch_stats), metrics


def _port_sync_step(name, init, batch, compression, n=4,
                    dtype=torch.float32):
    params, stats = init[name]
    model = _port_model(name, DATA_AXIS, dtype)
    st = train_state_from_jax(model, params, stats, server_sgd(0.1))
    if dtype == torch.float64:
        model.double()
        st = st.replace(
            params={k: v.double() for k, v in st.params.items()},
            batch_stats={k: v.double() for k, v in st.batch_stats.items()})
    mesh = make_mesh(n, "cpu")
    step = make_sync_dp_step(mesh, model, compression=compression,
                             augment=False)
    return step(st, *shard_batch(mesh, batch), 1)


def test_vit_sync_none_step_matches_jax(devices, init, batch):
    """No batch statistics to sync: the step takes a ViT built without
    ``axis_name`` and returns empty statistics."""
    jp, js, jm = _jax_sync_step("vit", init, batch, "none")
    got, m = _port_sync_step("vit", init, batch, "none")
    assert got.step == 1 and got.batch_stats == {} == js
    assert set(got.params) == set(jp)
    for k in jp:
        np.testing.assert_allclose(got.params[k].numpy(), np.asarray(jp[k]),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    assert tuple(m["worker_loss"].shape) == (4,)


def test_resnet50_sync_none_step_matches_jax_in_float64(devices, init,
                                                        batch):
    with jax.enable_x64(True):
        jp, js, jm = _jax_sync_step("r50", init, batch, "none",
                                    dtype=jnp.float64)
    got, m = _port_sync_step("r50", init, batch, "none",
                             dtype=torch.float64)
    assert got.step == 1
    _close_to_max(_numpy(got.params), jp, 1e-6)
    _close_to_max(_numpy(got.batch_stats), js, 1e-6)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["vit", "r50"])
def test_int8_step_within_the_ring_bound_of_uncompressed(init, batch, name):
    """The int8 step moves each parameter as the uncompressed step does,
    up to the stochastic ring's error: every partial sum a hop
    quantizes is bounded by S = max_e sum_w |g_w[e]|, so each block's
    scale by S / 127, and the mean carries at most N - 1 requantized
    partials (each divided by N) and one quantized mean: under (N + 1)
    scales, times the learning rate 0.1. Batch statistics are the
    forward's and equal. Replicas identical; the wire bytes 2 (N - 1)
    payloads of the model's chunk."""
    n = 4
    params, stats = init[name]
    exact, _ = _port_sync_step(name, init, batch, "none")
    quant, m = _port_sync_step(name, init, batch, "int8")
    model = _port_model(name, DATA_AXIS)
    st = train_state_from_jax(model, params, stats, server_sgd(0.1))
    images, labels = batch
    x = standardize(to_float(torch.from_numpy(images))).view(
        n, -1, 32, 32, 3)
    g, _, _, _ = make_slot_grad_fn(model)(
        st.params, st.batch_stats, x, torch.from_numpy(labels).view(n, -1))
    flat, _ = ravel_slots(g)
    bound = 0.1 * (n + 1) * float(flat.abs().sum(0).max()) / 127
    for k in exact.params:
        np.testing.assert_allclose(quant.params[k].numpy(),
                                   exact.params[k].numpy(), rtol=0,
                                   atol=bound, err_msg=k)
    for k in exact.batch_stats:
        assert torch.equal(quant.batch_stats[k], exact.batch_stats[k]), k
    assert bool(m["ring_replicas_identical"])
    assert m["wire_bytes_per_slot"] == 2 * (n - 1) * ring_payload_bytes(
        -(-flat.shape[1] // n))


@pytest.mark.parametrize("name", ["vit", "r50"])
def test_deterministic_ring_on_model_grads_bit_equal_to_jax(devices, init,
                                                            batch, name):
    """The ring over each model's real per-slot gradient rows, raveled in
    ``ravel_pytree``'s order (the chunk boundaries, and so every block's
    absmax, follow from it), bit-equal to JAX's ring run eagerly on the
    same rows, as ``test_torch_sync_dp.py`` runs it."""
    n = 4
    params, stats = init[name]
    model = _port_model(name, DATA_AXIS)
    st = train_state_from_jax(model, params, stats, server_sgd(0.1))
    images, labels = batch
    x = standardize(to_float(torch.from_numpy(images))).view(
        n, -1, 32, 32, 3)
    g, _, _, _ = make_slot_grad_fn(model)(
        st.params, st.batch_stats, x, torch.from_numpy(labels).view(n, -1))
    flat, _ = ravel_slots(g)
    rows = flat.detach().numpy()

    def body(vals, key):
        return jax_ring(vals[0], "data", n, key[0])[None]

    fn = shard_map(body, mesh=jax_make_mesh(n),
                   in_specs=(P("data"), P("data")), out_specs=P("data"),
                   check_vma=False)
    want = np.asarray(fn(rows, jax.random.split(jax.random.PRNGKey(7), n)))
    got = _int8_ring_allreduce_mean(flat, 0, stochastic=False).numpy()
    assert got.shape == want.shape == rows.shape
    for d in range(n):
        assert got[d].tobytes() == want[d].tobytes(), d


def test_sync_step_checks_batchnorm_sync_only_where_there_is_batchnorm():
    mesh = make_mesh(2, "cpu")
    make_sync_dp_step(mesh, _port_model("vit"))
    with pytest.raises(ValueError, match="axis_name"):
        make_sync_dp_step(mesh, _port_model("r50"))


# -- the trainers and the CLI -------------------------------------------------

def test_sync_trainer_resnet50_on_imagenet_synth(capsys):
    """Full-width ResNet-50 (1,000 classes) at 96 px (the ImageNet stem),
    2 slots of 2 images, one int8 step: replicas identical, wire bytes
    from the model's 25,557,032 values."""
    ds = synthetic_imagenet(n_train=4, n_test=2, image_size=96)
    trainer = SyncTrainer(ds, DistributedConfig(
        mode="sync", model="resnet50", num_workers=2, batch_size=2,
        num_epochs=1, compression="int8", dtype="float32",
        num_classes=1000, device="cpu"))
    assert trainer.model.imagenet_stem
    before = {k: v.clone() for k, v in trainer.state.params.items()}
    trainer.train(emit_metrics=True)
    assert trainer.global_steps == 1 and trainer.ring_replicas_identical
    assert trainer.wire_bytes_per_slot_step == 2 * ring_payload_bytes(
        -(-25_557_032 // 2))
    assert len(before) == 161
    assert any(not torch.equal(before[k], v)
               for k, v in trainer.state.params.items())
    rows = parse_metrics_lines(capsys.readouterr().out)
    assert rows[0]["global_steps_completed"] == 1


@pytest.mark.parametrize("mode", ["faithful", "local_sgd"])
def test_async_vit_workers_push_int8(mode):
    """Two workers over a store with int8 pushes (the codec and its error
    feedback over the ViT's 56 tensors, no batch statistics), faithful
    and local_sgd (K=2)."""
    ds = synthetic_cifar100(n_train=64, n_test=16, num_classes=10, seed=3)
    model = _port_model("vit")
    init, stats = params_to_jax(model)
    assert stats == {} and len(init) == 56
    store = ParameterStore(init, StoreConfig(
        mode="async", total_workers=2, push_codec="int8"))
    results = run_workers(store, model, ds, 2, WorkerConfig(
        batch_size=16, num_epochs=1, device="cpu", k_step_mode=mode,
        sync_steps=1 if mode == "faithful" else 2, eval_each_epoch=False))
    pushes = sum(r.pushes_accepted for r in results)
    assert all(r.error is None for r in results)
    assert pushes == (4 if mode == "faithful" else 2)
    final, step = store.snapshot()
    assert step == pushes
    assert all(np.isfinite(v).all() for v in final.values())
    assert any(not np.array_equal(final[k], init[k]) for k in init)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_cli_train_vit_tiny(capsys, mode):
    rc = cli.main(["train", "--mode", mode, "--model", "vit_tiny",
                   "--workers", "2", "--epochs", "1", "--synthetic",
                   "--num-train", "32", "--num-test", "8", "--batch-size",
                   "8", "--emit-metrics", "--device", "cpu", "--dtype",
                   "float32", "--compression", "int8"])
    assert rc == 0
    server, *workers = parse_metrics_lines(capsys.readouterr().out)
    assert server["mode"] == mode and len(workers) == 2
    assert server["global_steps_completed"] == (2 if mode == "sync" else 4)
    assert all(np.isfinite(w["train_loss_per_epoch"][0]) for w in workers)
    json.dumps(server)
