"""The port's device-resident epochs and input prefetch on the CPU
(counterparts of ``tests/test_device_loop.py``), the worker's prefetch,
and, marked ``cuda``, the captured epoch against the eager one on a card.

The loop on the CPU runs the same step body as the graph, uncaptured; it
must equal, bit for bit, the host-driven step over the same permutation
(the same ops on the same inputs), and its test-set top-1 over the padded
test set must equal a host eval of the same state."""

import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu_torch.data import (
    make_batches, synthetic_cifar100)
from distributed_parameter_server_for_ml_training_tpu_torch.models import \
    ResNet
from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
    ParameterStore, StoreConfig, WorkerConfig, run_workers)
from distributed_parameter_server_for_ml_training_tpu_torch.train \
    .device_loop import DeviceEpochLoop, prefetch_to_device
from distributed_parameter_server_for_ml_training_tpu_torch.train \
    .optimizers import baseline_optimizer
from distributed_parameter_server_for_ml_training_tpu_torch.train.steps \
    import make_eval_step, make_train_step
from distributed_parameter_server_for_ml_training_tpu_torch.train \
    .train_state import module_train_state
from distributed_parameter_server_for_ml_training_tpu_torch.utils.pytree \
    import params_to_jax


def _tiny(seed=0, device="cpu"):
    return ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10,
                  generator=torch.Generator().manual_seed(seed)).to(device)


def _pair(seed, device, augment, steps_per_epoch, milestones=(1,)):
    """Two identical models with their states and steps."""
    out = []
    for _ in range(2):
        model = _tiny(seed, device)
        state = module_train_state(model, baseline_optimizer(
            milestones=milestones, steps_per_epoch=steps_per_epoch))
        out.append((model, state, make_train_step(model, augment=augment)))
    return out


def _eval_fn(model):
    step = make_eval_step(model)
    return lambda x, y: step({}, {}, x, y)[0]


def _state_equal(a, b) -> list:
    return [i for i, (x, y) in enumerate(zip(a.tensors(), b.tensors()))
            if not torch.equal(x, y)]


def test_device_loop_equals_host_loop_over_the_same_permutation():
    """Two epochs across a milestone, 130 test images in eval batches of
    64 (padded by 62 with label -1)."""
    ds = synthetic_cifar100(n_train=200, n_test=130, num_classes=10, seed=2)
    (m1, s1, step1), (m2, s2, step2) = _pair(0, "cpu", False, 3)
    loop = DeviceEpochLoop(ds, step1, _eval_fn(m1), batch_size=64,
                           eval_batch_size=64,
                           generator=torch.Generator().manual_seed(7))
    assert loop.steps_per_epoch == 3 and not loop.graph
    gen = torch.Generator().manual_seed(7)
    for epoch in range(2):
        s1, m = loop.run_epoch(s1)
        perm = torch.randperm(200, generator=gen)[:192].view(3, 64)
        losses = []
        for idx in perm:
            s2, hm = step2(s2, ds.x_train[idx.numpy()],
                           ds.y_train[idx.numpy()])
            losses.append(float(hm["loss"]))
        assert _state_equal(s1, s2) == [], epoch
        assert m["loss"] == losses
        assert m["train_loss"] == pytest.approx(np.mean(losses))
        assert len(m["accuracy"]) == 3
        lr = np.float32(0.1) if epoch == 0 else np.float32(0.1) ** 2
        assert np.array(m["learning_rate"], np.float32).tolist() \
            == [lr] * 3
    assert s1.step == s2.step == 6 and int(s1.opt_state.count) == 6
    # The loop's top-1 over the padded test set equals a host eval of
    # the same state over the unpadded one.
    ev = make_eval_step(m2)
    correct = total = 0
    for xb, yb in make_batches(ds.x_test, ds.y_test, 64, shuffle=False,
                               drop_remainder=False):
        c, t = ev({}, {}, xb, yb)
        correct += int(c)
        total += t
    assert total == 130
    assert m["test_accuracy"] == correct / total


def test_device_loop_records_the_augment_draws():
    """With augmentation the loop keeps each step's draws: the ones the
    host step takes from the same generator state."""
    ds = synthetic_cifar100(n_train=128, n_test=16, num_classes=10, seed=1)
    (m1, s1, step1), (_, s2, step2) = _pair(3, "cpu", True, 2)
    loop = DeviceEpochLoop(ds, step1, _eval_fn(m1), batch_size=64,
                           generator=torch.Generator().manual_seed(11))
    s1, m = loop.run_epoch(s1)
    gen = torch.Generator().manual_seed(11)
    perm = torch.randperm(128, generator=gen).view(2, 64)
    for i, idx in enumerate(perm):
        s2, hm = step2(s2, ds.x_train[idx.numpy()], ds.y_train[idx.numpy()],
                       gen)
        assert torch.equal(loop.draws[i], hm["augment_draws"])
    assert _state_equal(s1, s2) == []
    assert loop.draws[..., :2].max() <= 8 and loop.draws[..., 2].max() <= 1


def test_device_loop_rejects_undersized_dataset():
    ds = synthetic_cifar100(n_train=16, n_test=16, num_classes=10)
    model = _tiny()
    state = module_train_state(model, baseline_optimizer())
    with pytest.raises(ValueError, match="fewer than one batch"):
        DeviceEpochLoop(ds, make_train_step(model), _eval_fn(model),
                        batch_size=64, generator=torch.Generator())
    assert state.step == 0


def test_device_loop_graph_needs_a_card():
    ds = synthetic_cifar100(n_train=64, n_test=16, num_classes=10)
    model = _tiny()
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA"):
        DeviceEpochLoop(ds, make_train_step(model), _eval_fn(model),
                        batch_size=32, generator=torch.Generator(),
                        graph=True)


class TestPrefetchToDevice:
    """``prefetch_to_device``: order-preserving, bitwise, lazy."""

    def _batches(self, n=7, size=4):
        rng = np.random.default_rng(0)
        return [(rng.integers(0, 256, (size, 8, 8, 3)).astype(np.uint8),
                 rng.integers(0, 10, (size,)).astype(np.int32))
                for _ in range(n)]

    def test_values_and_order_preserved(self):
        src = self._batches()
        out = list(prefetch_to_device(iter(src), depth=2, device="cpu"))
        assert len(out) == len(src)
        for (xs, ys), (xd, yd) in zip(src, out):
            assert isinstance(xd, torch.Tensor) and xd.dtype == torch.uint8
            np.testing.assert_array_equal(xd.numpy(), xs)
            np.testing.assert_array_equal(yd.numpy(), ys)

    def test_depth_zero_is_passthrough(self):
        src = self._batches(n=3)
        out = list(prefetch_to_device(iter(src), depth=0, device="cpu"))
        assert all(xd is xs and yd is ys
                   for (xs, ys), (xd, yd) in zip(src, out))

    def test_keeps_depth_transfers_in_flight(self):
        pulled = []
        src = self._batches(n=5)

        def source():
            for b in src:
                pulled.append(len(pulled))
                yield b

        it = prefetch_to_device(source(), depth=2, device="cpu")
        assert pulled == []   # lazy: nothing moves until the first pull
        next(it)
        # The first pull primes the pipeline (2 batches) and dispatches the
        # replacement for the one it hands out.
        assert len(pulled) == 3
        assert len(list(it)) == 4

    def test_fewer_batches_than_depth(self):
        src = self._batches(n=2)
        out = list(prefetch_to_device(iter(src), depth=8, device="cpu"))
        assert len(out) == 2
        np.testing.assert_array_equal(out[1][0].numpy(), src[1][0])

    def test_cuda_asked_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
        it = prefetch_to_device(iter(self._batches(n=1)), depth=2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            next(it)


def _async_store_params(prefetch: int) -> dict:
    model = _tiny(5)
    init, _ = params_to_jax(model)
    store = ParameterStore({k: v.copy() for k, v in init.items()},
                           StoreConfig(mode="async", total_workers=1,
                                       learning_rate=0.1,
                                       push_codec="none"))
    ds = synthetic_cifar100(192, 32, 10, seed=3)
    (r,) = run_workers(store, model, ds, 1, WorkerConfig(
        batch_size=64, num_epochs=1, augment=True, device="cpu",
        prefetch_batches=prefetch))
    assert r.pushes_accepted == 3
    return store.snapshot()[0]


def test_worker_prefetch_gives_bit_equal_store_params():
    """One async worker, the JAX default prefetch of 2 against none."""
    assert WorkerConfig(device="cpu").prefetch_batches == 2
    a, b = _async_store_params(2), _async_store_params(0)
    assert list(a) == list(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


# -- on the card (skip here; scripts/run_cuda_tests.py runs them) ---------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _cuda_loops(augment):
    ds = synthetic_cifar100(n_train=256, n_test=100, num_classes=10, seed=4)
    loops = []
    for graph, (model, state, step) in zip(
            (True, False), _pair(0, "cuda", augment, 4, milestones=(1, 2))):
        gen = torch.Generator(device="cuda").manual_seed(9)
        loops.append((DeviceEpochLoop(ds, step, _eval_fn(model),
                                      batch_size=64, generator=gen,
                                      graph=graph), state, gen))
    return loops


@pytest.mark.cuda
def test_graphed_epochs_equal_eager_epochs_on_the_card(monkeypatch):
    """Three epochs of 4 steps, augment on: the captured loop against the
    eager loop over the same permutations and draws, bit for bit, with
    cuDNN's deterministic algorithms (the default ones sum some gradients
    in an order that changes from launch to launch)."""
    _need_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    (graph_loop, gs, ggen), (eager_loop, es, egen) = _cuda_loops(True)
    for epoch in range(3):
        gs, gm = graph_loop.run_epoch(gs)
        es, em = eager_loop.run_epoch(es)
        assert torch.equal(graph_loop.draws, eager_loop.draws), epoch
        assert torch.equal(ggen.get_state(), egen.get_state()), epoch
        for a, b in zip(gs.tensors(), es.tensors()):
            assert torch.equal(a, b), epoch
        assert gm["loss"] == em["loss"], epoch
    assert gs.step == es.step == 12 and int(gs.opt_state.count) == 12
    assert graph_loop._cuda_graph is not None


@pytest.mark.cuda
def test_to_float_on_the_card_is_the_cpu_true_division():
    """A CUDA tensor divided by a host scalar is a reciprocal multiply,
    one ulp off the reference's x / 255 for some pixel values; the port
    divides by a device tensor."""
    _need_cuda()
    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import to_float
    x = torch.arange(256, dtype=torch.uint8)
    assert torch.equal(to_float(x.cuda()).cpu(), to_float(x))


@pytest.mark.cuda
def test_graphed_learning_rate_follows_the_milestones():
    """The graph reads the learning rate from the device count: 0.1, then
    0.010000001, then 0.001, bit for bit, one epoch each."""
    _need_cuda()
    (loop, state, _), _ = _cuda_loops(False)
    want = [0x3DCCCCCD, 0x3C23D70B, 0x3A83126F]
    for epoch in range(3):
        state, m = loop.run_epoch(state)
        bits = np.array(m["learning_rate"], np.float32).view(np.uint32)
        assert bits.tolist() == [want[epoch]] * 4, epoch


@pytest.mark.cuda
def test_prefetch_to_the_card_is_bitwise():
    _need_cuda()
    src = TestPrefetchToDevice()._batches(n=6, size=32)
    out = list(prefetch_to_device(iter(src), depth=2, device="cuda"))
    torch.cuda.synchronize()
    for (xs, ys), (xd, yd) in zip(src, out):
        assert xd.is_cuda and torch.equal(xd.cpu(), torch.from_numpy(xs))
        assert torch.equal(yd.cpu(), torch.from_numpy(ys))
