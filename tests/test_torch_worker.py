"""The port's worker against the JAX package's on the paths the slice
test does not take: the fp16 push codec (the store's default, which the
CLI runs), the K-step 'accumulate' mode (the window mean), 'local_sgd'
(the fused local step, K=4), the overlapped comms pipeline and the bf16
fetch codec. Tiny ResNet, one async worker, augment off; final store
params agree within fp16 rounding of each push (fp16, 2e-4), to 1e-4 in
fp32 (accumulate, local_sgd: the frameworks order the convolution sums
differently), to 2e-4 with int8 pushes (overlap: an int8 code may round
the other way) and to 5e-4 with bf16 fetches (a fetched parameter near a
bf16 rounding boundary may round the other way)."""

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


@pytest.fixture(scope="module")
def setup():
    jm = JaxResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    v = jm.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32),
                train=False)
    tm = ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    return (jm, jax_flatten(v["params"]), tm,
            synthetic_cifar100(384, 64, 10, seed=2),
            jax_synthetic(384, 64, 10, seed=2))


@pytest.mark.parametrize("store_kw,cfg_kw,atol,pushes", [
    (dict(push_codec="fp16"), dict(), 2e-4, 6),
    (dict(push_codec="none"), dict(k_step_mode="accumulate", sync_steps=4),
     1e-4, 2),
    (dict(push_codec="none"), dict(k_step_mode="local_sgd", sync_steps=4),
     1e-4, 2),
    (dict(push_codec="int8"), dict(k_step_mode="accumulate", sync_steps=2,
                                   overlap=True), 2e-4, 3),
    (dict(push_codec="none", fetch_codec="bf16"), dict(), 5e-4, 6),
], ids=["fp16_push", "accumulate_k4", "local_sgd_k4", "overlap_int8_k2",
        "bf16_fetch"])
def test_worker_paths_match_jax(setup, store_kw, cfg_kw, atol, pushes):
    jm, init, tm, ds, jds = setup
    jstore = JaxStore({k: v.copy() for k, v in init.items()},
                      JaxConfig(mode="async", total_workers=1, **store_kw))
    pstore = ParameterStore({k: v.copy() for k, v in init.items()},
                            StoreConfig(mode="async", total_workers=1,
                                        **store_kw))
    jr = jax_run_workers(jstore, jm, jds, 1, JaxWorkerConfig(
        batch_size=64, num_epochs=1, augment=False, **cfg_kw))
    pr = run_workers(pstore, tm, ds, 1, WorkerConfig(
        batch_size=64, num_epochs=1, augment=False, device="cpu", **cfg_kw))
    assert jr[0].pushes_accepted == pr[0].pushes_accepted == pushes
    assert pr[0].local_steps_completed == 6
    jp, pp = jstore.snapshot()[0], pstore.snapshot()[0]
    for k in jp:
        np.testing.assert_allclose(pp[k], jp[k], atol=atol, err_msg=k)
    assert pr[0].test_accuracies and \
        abs(pr[0].test_accuracies[0] - jr[0].test_accuracies[0]) <= 2 / 64
