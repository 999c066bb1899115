"""The whole slice on the tiny ResNet: the port's run_workers against the
JAX package's, one async worker, augment off, one epoch of
``synthetic_cifar100(640, 128, 10, seed=1)`` (5 pushes of 128).

- push_codec="none": final store params agree to atol 1e-4 (fp32; the
  frameworks order convolution sums differently);
- push_codec="int8" with the device codec: they agree within one
  quantization step per push, lr x the sum over pushes of each tensor's
  scale — an int8 code may flip at a rounding boundary because the fp32
  gradients differ by rounding.
"""

import jax
import numpy as np
import pytest

from distributed_parameter_server_for_ml_training_tpu.data.cifar import \
    synthetic_cifar100 as jax_synthetic
from distributed_parameter_server_for_ml_training_tpu.models import \
    ResNet as JaxResNet
from distributed_parameter_server_for_ml_training_tpu.ps.store import (
    ParameterStore as JaxStore, StoreConfig as JaxConfig)
from distributed_parameter_server_for_ml_training_tpu.ps.worker import (
    WorkerConfig as JaxWorkerConfig, run_workers as jax_run_workers)
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import \
    flatten_params as jax_flatten
from distributed_parameter_server_for_ml_training_tpu_torch.data import \
    synthetic_cifar100
from distributed_parameter_server_for_ml_training_tpu_torch.models import \
    ResNet
from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
    ParameterStore, StoreConfig, WorkerConfig, run_workers)

LR = 0.1


@pytest.fixture(scope="module")
def setup():
    jm = JaxResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    v = jm.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32),
                train=False)
    init = jax_flatten(v["params"])
    ds = synthetic_cifar100(640, 128, 10, seed=1)
    jds = jax_synthetic(640, 128, 10, seed=1)
    assert np.array_equal(ds.x_train, jds.x_train)
    tm = ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    return jm, init, ds, jds, tm


def _recording(store):
    """Wrap ``store.push`` to record each payload's int8 scales."""
    seen = []
    push = store.push

    def rec(worker_id, gradients, fetched_step):
        seen.append({k[:-len("::int8scale")]: float(v[0])
                     for k, v in gradients.items()
                     if k.endswith("::int8scale")})
        return push(worker_id, gradients, fetched_step)

    store.push = rec
    return seen


def _run_both(setup, codec):
    jm, init, ds, jds, tm = setup
    jstore = JaxStore({k: v.copy() for k, v in init.items()},
                      JaxConfig(mode="async", total_workers=1,
                                learning_rate=LR, push_codec=codec))
    pstore = ParameterStore({k: v.copy() for k, v in init.items()},
                            StoreConfig(mode="async", total_workers=1,
                                        learning_rate=LR, push_codec=codec))
    jseen, pseen = _recording(jstore), _recording(pstore)
    jr = jax_run_workers(jstore, jm, jds, 1, JaxWorkerConfig(
        batch_size=128, num_epochs=1, augment=False))
    pr = run_workers(pstore, tm, ds, 1, WorkerConfig(
        batch_size=128, num_epochs=1, augment=False, device="cpu"))
    assert jr[0].pushes_accepted == pr[0].pushes_accepted == 5
    assert jstore.global_step == pstore.global_step == 5
    return jstore.snapshot()[0], pstore.snapshot()[0], jseen, pseen, pr[0]


def test_slice_fp32_push_matches_jax(setup):
    jp, pp, _, _, r = _run_both(setup, "none")
    assert list(jp) == list(pp)
    for k in jp:
        np.testing.assert_allclose(pp[k], jp[k], atol=1e-4, err_msg=k)
    assert len(r.test_accuracies) == 1 and len(r.train_loss_per_epoch) == 1
    assert np.isfinite(r.train_loss_per_epoch[0])


def test_slice_int8_device_codec_within_one_step_per_push(setup):
    jp, pp, jseen, pseen, _ = _run_both(setup, "int8")
    assert len(jseen) == len(pseen) == 5
    assert all(list(a) == list(jp) for a in pseen)
    for k in jp:
        step = LR * sum(max(a[k], b[k]) for a, b in zip(jseen, pseen))
        np.testing.assert_allclose(pp[k], jp[k], atol=step + 1e-5,
                                   rtol=0, err_msg=k)


def test_two_async_workers_complete(setup):
    _, init, ds, _, tm = setup
    store = ParameterStore({k: v.copy() for k, v in init.items()},
                           StoreConfig(mode="async", total_workers=2,
                                       learning_rate=LR, push_codec="int8",
                                       staleness_bound=1))
    results = run_workers(store, tm, ds, 2, WorkerConfig(
        batch_size=64, num_epochs=1, augment=True, device="cpu"))
    assert all(r.error is None for r in results)
    assert sorted(r.worker_id for r in results) == [0, 1]
    m = store.metrics()
    assert sum(r.pushes_accepted for r in results) \
        == m["gradients_processed"] == store.global_step > 0
    assert sum(r.pushes_rejected for r in results) == m["gradients_rejected"]
    assert sum(r.local_steps_completed for r in results) == 10
    final, _ = store.snapshot()
    assert any(not np.array_equal(final[k], init[k]) for k in init)
