"""The port's sync data parallelism against the JAX package.

Inputs are made with numpy from a seed and go through both packages. The
tiny ResNet (stages (1, 1), 8 filters, 10 classes, fp32) runs on the CPU;
the JAX side on the 8 virtual CPU devices of ``conftest.py``.

- the deterministic int8 ring is bit-equal to JAX's
  ``_int8_ring_allreduce_mean`` (whose CPU path rounds to nearest);
- per-slot gradients equal JAX's per-device gradients under
  ``shard_map`` within rtol 1e-4 / atol 1e-5 (fp32; the frameworks order
  the convolution sums differently);
- one ``none`` step equals JAX's single-process full-batch step within
  rtol 2e-4 / atol 2e-5, as ``test_sync_dp.py`` holds the JAX sync step;
  bf16 within 0.02 / 1e-3 and int8 within 0.05 / 1e-3 of JAX's steps of
  the same compression (``test_sync_dp.py``, ``test_quantize.py``).
"""

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from jax.sharding import PartitionSpec as P

from distributed_parameter_server_for_ml_training_tpu.data.cifar import (
    standardize as jax_standardize, to_float as jax_to_float)
from distributed_parameter_server_for_ml_training_tpu.models import \
    ResNet as JaxResNet
from distributed_parameter_server_for_ml_training_tpu.parallel import (
    make_mesh as jax_make_mesh, make_sync_dp_step as jax_make_sync_dp_step,
    shard_batch as jax_shard_batch)
from distributed_parameter_server_for_ml_training_tpu.parallel.mesh import \
    shard_map
from distributed_parameter_server_for_ml_training_tpu.parallel.sync_dp \
    import _int8_ring_allreduce_mean as jax_ring
from distributed_parameter_server_for_ml_training_tpu.train import (
    create_train_state as jax_create_train_state,
    make_train_step as jax_make_train_step, server_sgd as jax_server_sgd)
from distributed_parameter_server_for_ml_training_tpu.train.steps import \
    cross_entropy_loss as jax_cross_entropy
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import (
    flatten_params as jax_flatten, unflatten_params as jax_unflatten)
from distributed_parameter_server_for_ml_training_tpu_torch.data import (
    make_batches, standardize, synthetic_cifar100, to_float)
from distributed_parameter_server_for_ml_training_tpu_torch.models import \
    ResNet
from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
    quantize as Q
from distributed_parameter_server_for_ml_training_tpu_torch.parallel import (
    DATA_AXIS, make_mesh, make_sync_dp_step, shard_batch, worker_axis_size)
from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
    .sync_dp import (_int8_ring_allreduce_mean, make_slot_grad_fn,
                     mix_seed, ravel_slots, ring_payload_bytes)
from distributed_parameter_server_for_ml_training_tpu_torch.train \
    .distributed import DistributedConfig, SyncTrainer
from distributed_parameter_server_for_ml_training_tpu_torch.train \
    .optimizers import server_sgd
from distributed_parameter_server_for_ml_training_tpu_torch.train \
    .train_state import create_train_state, train_state_from_jax


def _jax_model(axis_name="data"):
    return JaxResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10,
                     axis_name=axis_name)


def _torch_model():
    return ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10,
                  axis_name=DATA_AXIS)


@pytest.fixture(scope="module")
def init():
    """The JAX tiny model's initial variables, flat (flax names)."""
    st = jax_create_train_state(_jax_model(), jax.random.PRNGKey(0),
                                jax_server_sgd(0.1))
    return jax_flatten(st.params), jax_flatten(st.batch_stats)


@pytest.fixture(scope="module")
def batch():
    r = np.random.default_rng(7)
    images = r.integers(0, 255, (32, 32, 32, 3), dtype=np.uint8)
    labels = (np.arange(32) % 10).astype(np.int32)
    return images, labels


def _port_state(init):
    params, stats = init
    model = _torch_model()
    return model, train_state_from_jax(model, params, stats, server_sgd(0.1))


def _assert_flat_close(got: dict, want: dict, rtol, atol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def _jax_sync_step(devices, init, batch, compression):
    mesh = jax_make_mesh(8)
    params, stats = init
    st = jax_create_train_state(_jax_model(), jax.random.PRNGKey(0),
                                jax_server_sgd(0.1))
    st = st.replace(params=jax_unflatten(params),
                    batch_stats=jax_unflatten(stats))
    bi, bl = jax_shard_batch(mesh, batch)
    step = jax_make_sync_dp_step(mesh, compression=compression,
                                 augment=False)
    out, metrics = step(st, bi, bl, jax.random.PRNGKey(1))
    return jax_flatten(out.params), jax_flatten(out.batch_stats), metrics


def _port_sync_step(init, batch, compression):
    model, st = _port_state(init)
    mesh = make_mesh(8, "cpu")
    step = make_sync_dp_step(mesh, model, compression=compression,
                             augment=False)
    bi, bl = shard_batch(mesh, batch)
    return step(st, bi, bl, 1)


# -- the int8 ring ---------------------------------------------------------

def _jax_ring_outputs(n, values):
    """The JAX ring over an n-device mesh, run eagerly as
    ``test_quantize.py`` runs it: each jitted quantize and dequantize
    materializes its fp32 result before the add, as the TPU's Pallas
    dequantize does. (Under one ``jax.jit`` XLA's CPU backend contracts
    the dequantize multiply and the add into one FMA, which rounds once
    where the reference's kernels round twice.)"""
    mesh = jax_make_mesh(n)

    def body(vals, key):
        return jax_ring(vals[0], "data", n, key[0])[None]

    fn = shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                   out_specs=P("data"), check_vma=False)
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    return np.asarray(fn(values, keys))


@pytest.mark.parametrize("n", [4, 8])
def test_deterministic_ring_bit_equal_to_jax(devices, n):
    vals = np.random.default_rng(0).normal(size=(n, 5000)).astype(np.float32)
    want = _jax_ring_outputs(n, vals)
    got = _int8_ring_allreduce_mean(torch.from_numpy(vals), 0,
                                    stochastic=False)
    assert tuple(got.shape) == want.shape == (n, 5000)
    for d in range(n):
        assert got[d].numpy().tobytes() == want[d].tobytes(), d


@pytest.mark.parametrize("n", [4, 8])
def test_stochastic_ring_replicas_identical_and_near_mean(n):
    """Every row bit-identical (the all-gather ships one quantization of
    each chunk), and the mean within (n+1) scales of exact (N-1
    requantizations of running partials plus one of the mean), as
    ``test_quantize.py:99-114`` holds the JAX ring."""
    vals = np.random.default_rng(0).normal(size=(n, 5000)).astype(np.float32)
    outs = _int8_ring_allreduce_mean(torch.from_numpy(vals), 11).numpy()
    for d in range(1, n):
        np.testing.assert_array_equal(outs[d], outs[0])
    true_mean = vals.mean(axis=0)
    scale = np.abs(true_mean).max() / 127.0
    np.testing.assert_allclose(outs[0], true_mean, atol=(n + 1) * scale,
                               rtol=0.05)


def test_stochastic_ring_seeds_matter():
    vals = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 3000)).astype(np.float32))
    a = _int8_ring_allreduce_mean(vals, 5)
    b = _int8_ring_allreduce_mean(vals, 5)
    c = _int8_ring_allreduce_mean(vals, 6)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("n,size", [(4, 5000), (4, 11_220_132 // 64),
                                    (8, 129), (1, 300)])
def test_ring_wire_bytes_follow_the_model(n, size):
    """Each slot hands 2(N-1) payloads of int8 codes + fp32 scales per
    step: ~2(N-1)/N x S bytes plus the padding and scales."""
    wire = {}
    x = torch.ones((n, size))
    _int8_ring_allreduce_mean(x, 0, wire=wire)
    chunk = -(-size // n)
    rows_padded, _, n_blocks = Q.block_layout(chunk)
    assert wire.get("bytes_per_slot", 0) == 2 * (n - 1) * (
        rows_padded * 128 + 4 * n_blocks) == 2 * (n - 1) * \
        ring_payload_bytes(chunk)


def test_ring_on_cpu_counts_no_launches():
    before = (Q.block_quantize.launches, Q.block_quantize_stochastic.launches,
              Q.block_dequantize.launches)
    _int8_ring_allreduce_mean(torch.ones((4, 1000)), 3)
    _int8_ring_allreduce_mean(torch.ones((4, 1000)), 3, stochastic=False)
    assert (Q.block_quantize.launches, Q.block_quantize_stochastic.launches,
            Q.block_dequantize.launches) == before


def test_single_slot_ring_still_quantizes():
    """N=1: no hops, but the mean is quantized once, as in the reference."""
    x = torch.tensor([[0.3, -0.7, 0.01, 1.0]])
    got = _int8_ring_allreduce_mean(x, 0, stochastic=False)
    want = Q.quantize_dequantize_int8(x[0])
    assert torch.equal(got[0], want) and not torch.equal(got, x)


def test_mix_seed_is_deterministic_and_spreads():
    assert mix_seed(1, 2, 3) == mix_seed(1, 2, 3)
    seeds = {mix_seed(7, slot, hop) for slot in range(8) for hop in range(8)}
    assert len(seeds) == 64 and all(0 <= s < 2 ** 64 for s in seeds)


# -- per-slot gradients and flatten order ----------------------------------

def _jax_per_device_grads(params, stats, images, labels, n):
    jm = _jax_model()

    def body(p, s, xs, ys):
        def loss_fn(p):
            out, mut = jm.apply({"params": p, "batch_stats": s},
                                jax_standardize(jax_to_float(xs)),
                                train=True, mutable=["batch_stats"])
            return jax_cross_entropy(out, ys), mut
        (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return jax.tree_util.tree_map(lambda a: a[None], g), loss[None]

    fn = jax.jit(shard_map(body, mesh=jax_make_mesh(n),
                           in_specs=(P(), P(), P("data"), P("data")),
                           out_specs=(P("data"), P("data")),
                           check_vma=False))
    return fn(jax_unflatten(params), jax_unflatten(stats), images, labels)


@pytest.mark.parametrize("n", [4, 8])
def test_per_slot_grads_match_jax_per_device_grads(devices, init, batch, n):
    params, stats = init
    images, labels = batch
    jg, jl = _jax_per_device_grads(params, stats, images, labels, n)
    jg = jax_flatten(jg)
    model, st = _port_state(init)
    x = standardize(to_float(torch.from_numpy(images))).view(
        n, -1, 32, 32, 3)
    g, losses, logits, _ = make_slot_grad_fn(model)(
        st.params, st.batch_stats, x, torch.from_numpy(labels).view(n, -1))
    assert list(g) == list(params) and tuple(logits.shape) == (n, 32 // n,
                                                               10)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-5)
    for k in jg:
        assert tuple(g[k].shape) == jg[k].shape, k
        np.testing.assert_allclose(g[k].numpy(), jg[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_ravel_slots_is_ravel_pytree_order(init):
    """Chunk boundaries (and so every block's absmax) depend on the flatten
    order: each slot's row equals ``ravel_pytree`` of the nested flax tree,
    bit for bit."""
    params, _ = init
    r = np.random.default_rng(3)
    per_slot = {k: r.normal(size=(3, *v.shape)).astype(np.float32)
                for k, v in params.items()}
    flat, unravel = ravel_slots({k: torch.from_numpy(v)
                                 for k, v in per_slot.items()})
    for w in range(3):
        want, _ = ravel_pytree(jax_unflatten({k: v[w]
                                              for k, v in per_slot.items()}))
        assert flat[w].numpy().tobytes() == np.asarray(want).tobytes()
    back = unravel(flat[1])
    for k, v in per_slot.items():
        np.testing.assert_array_equal(back[k].numpy(), v[1])


# -- whole steps against JAX -----------------------------------------------

def test_none_step_equals_jax_single_process_step(devices, init, batch):
    """8 slots with no compression == one full-batch step (the reference's
    push/aggregate/apply/fetch cycle, server.py:239-288)."""
    params, stats = init
    st1 = jax_create_train_state(_jax_model(None), jax.random.PRNGKey(0),
                                 jax_server_sgd(0.1))
    st1 = st1.replace(params=jax_unflatten(params),
                      batch_stats=jax_unflatten(stats))
    single = jax.jit(jax_make_train_step(augment=False))
    want, want_m = single(st1, *batch, jax.random.PRNGKey(9))
    got, m = _port_sync_step(init, batch, "none")
    assert got.step == 1
    _assert_flat_close(got.params, jax_flatten(want.params), 2e-4, 2e-5)
    _assert_flat_close(got.batch_stats, jax_flatten(want.batch_stats),
                       2e-4, 2e-5)
    np.testing.assert_allclose(float(m["loss"]), float(want_m["loss"]),
                               rtol=1e-4)
    assert tuple(m["worker_loss"].shape) == (8,)
    assert tuple(m["worker_accuracy"].shape) == (8,)


def test_bf16_step_close_to_jax_bf16_step(devices, init, batch):
    jp, _, _ = _jax_sync_step(devices, init, batch, "bf16")
    got, _ = _port_sync_step(init, batch, "bf16")
    _assert_flat_close(got.params, jp, 0.02, 1e-3)


def test_int8_step_close_to_jax_int8_step(devices, init, batch):
    jp, js, jm = _jax_sync_step(devices, init, batch, "int8")
    got, m = _port_sync_step(init, batch, "int8")
    _assert_flat_close(got.params, jp, 0.05, 1e-3)
    _assert_flat_close(got.batch_stats, js, 2e-4, 2e-5)
    assert bool(m["ring_replicas_identical"])
    size = sum(v.size for v in init[0].values())
    assert m["wire_bytes_per_slot"] == 2 * 7 * ring_payload_bytes(
        -(-size // 8))


def test_int8_step_close_to_uncompressed_step(init, batch):
    exact, _ = _port_sync_step(init, batch, "none")
    quant, _ = _port_sync_step(init, batch, "int8")
    for k in exact.params:
        np.testing.assert_allclose(quant.params[k].numpy(),
                                   exact.params[k].numpy(), rtol=0.05,
                                   atol=1e-3, err_msg=k)


def test_int8_run_learns():
    """Loss falls over a short int8 run on learnable synthetic data (the
    reference's 'accuracy goes up' check, SURVEY.md §4)."""
    d = synthetic_cifar100(n_train=512, n_test=64, num_classes=10, seed=5)
    model = _torch_model()
    torch.manual_seed(0)
    st = create_train_state(model, server_sgd(0.1))
    mesh = make_mesh(8, "cpu")
    step = make_sync_dp_step(mesh, model, compression="int8", augment=False)
    losses = []
    for epoch in range(6):
        for xb, yb in make_batches(d.x_train, d.y_train, 64, seed=epoch):
            st, metrics = step(st, *shard_batch(mesh, (xb, yb)), 0)
            losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4]) * 0.8


def test_step_draws_its_augmentation_from_seed_and_step(init, batch):
    model, st = _port_state(init)
    mesh = make_mesh(4, "cpu")
    step = make_sync_dp_step(mesh, model, compression="none", augment=True)
    bi, bl = shard_batch(mesh, batch)
    a, _ = step(st, bi, bl, 3)
    b, _ = step(st, bi, bl, 3)
    c, _ = step(st, bi, bl, 4)
    k = "stem_conv/kernel"
    assert torch.equal(a.params[k], b.params[k])
    assert not torch.equal(a.params[k], c.params[k])


# -- validation ------------------------------------------------------------

def test_uneven_batch_rejected():
    """A batch not divisible by the slot count fails loudly (the reference
    silently skewed coverage, SURVEY.md §2 elastic row)."""
    mesh = make_mesh(8, "cpu")
    with pytest.raises(ValueError, match="evenly"):
        shard_batch(mesh, (np.zeros((12, 32, 32, 3), np.uint8),
                           np.zeros((12,), np.int32)))


def test_shard_batch_gives_contiguous_slices(batch):
    mesh = make_mesh(4, "cpu")
    bi, bl = shard_batch(mesh, batch)
    assert tuple(bi.shape) == (4, 8, 32, 32, 3) and bl.dtype == torch.int32
    np.testing.assert_array_equal(bi[2].numpy(), batch[0][16:24])


def test_mesh():
    mesh = make_mesh(4, "cpu")
    assert worker_axis_size(mesh) == 4 and mesh.shape == {DATA_AXIS: 4}
    assert make_mesh(2, ["cpu", "cpu"]).device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="multi-card slice"):
        make_mesh(4, ["cuda:0", "cuda:1"])
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")


def test_step_needs_cross_replica_batchnorm():
    model = ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    with pytest.raises(ValueError, match="axis_name"):
        make_sync_dp_step(make_mesh(2, "cpu"), model)
    with pytest.raises(ValueError, match="compression"):
        make_sync_dp_step(make_mesh(2, "cpu"), _torch_model(),
                          compression="int4")


def test_sync_trainer_on_cpu(capsys):
    """SyncTrainer end to end at full width on the CPU: two steps of two
    slots, METRICS_JSON rows, test accuracy, replica identity."""
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .metrics import parse_metrics_lines
    d = synthetic_cifar100(n_train=32, n_test=16)
    cfg = DistributedConfig(mode="sync", num_workers=2, batch_size=8,
                            num_epochs=1, compression="int8",
                            dtype="float32", device="cpu")
    trainer = SyncTrainer(d, cfg)
    before = {k: v.clone() for k, v in trainer.state.params.items()}
    metrics = trainer.train(emit_metrics=True)
    assert metrics["global_steps_completed"] == 2 == trainer.state.step
    assert trainer.ring_replicas_identical is True
    assert trainer.wire_bytes_per_slot_step == 2 * ring_payload_bytes(
        -(-11_220_132 // 2))
    assert any(not torch.equal(before[k], v)
               for k, v in trainer.state.params.items())
    rows = parse_metrics_lines(capsys.readouterr().out)
    assert len(rows) == 3 and rows[0]["mode"] == "sync"
    assert all(np.isfinite(r["train_loss_per_epoch"][0]) for r in rows[1:])


@pytest.mark.cuda
def test_ring_on_card_matches_plain_and_counts_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    vals = np.random.default_rng(2).normal(size=(4, 50_001)).astype(
        np.float32)
    cpu = torch.from_numpy(vals)
    for stochastic in (True, False):
        counts = (Q.block_quantize.launches,
                  Q.block_quantize_stochastic.launches,
                  Q.block_dequantize.launches)
        got = _int8_ring_allreduce_mean(cpu.cuda(), 9, stochastic=stochastic)
        torch.cuda.synchronize()
        want = _int8_ring_allreduce_mean(cpu, 9, stochastic=stochastic)
        assert torch.equal(got.cpu(), want)
        k2 = Q.block_quantize.launches - counts[0]
        k3 = Q.block_quantize_stochastic.launches - counts[1]
        k4 = Q.block_dequantize.launches - counts[2]
        assert (k2, k3, k4) == ((0, 4, 7) if stochastic else (4, 0, 7))
