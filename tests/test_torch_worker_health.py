"""The port's worker half of the self-healing loop against the JAX
package's: each worker, over an in-process store that takes its health
reports like a ``RemoteStore`` and hands it the same scripted directives
at the same push boundaries (tiny ResNet, 64 images, augment off), ends
with the same ``directives_applied``, ``pushes_quarantined``, pushes
reaching the store, fetches (full or delta), steps and epochs; the
report on the same params and batch agrees (loss and grad norm within a
relative 1e-5, the finite flags, step, epoch and push codec exact), and
in accumulate mode the report of a window of two batches at the same
params (the norm of the pushed mean: within 5e-5, the frameworks' two
backward passes each ordering their sums their own way); a NaN window
under int8 raises the JAX worker's ValueError (naming the first tensor
of its own encode order); a worker without the capability sends
nothing. On a
card (``cuda``): the push boundary's norm against float64 on the CPU,
and ``DeviceCodec.reset()`` dropping the carry."""

import math
import re

import jax
import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.data.cifar import \
    synthetic_cifar100 as jax_synthetic
from distributed_parameter_server_for_ml_training_tpu.models import \
    ResNet as JaxResNet
from distributed_parameter_server_for_ml_training_tpu.ps.store import (
    ParameterStore as JaxStore, StoreConfig as JaxConfig)
from distributed_parameter_server_for_ml_training_tpu.ps.worker import (
    PSWorker as JaxWorker, WorkerConfig as JaxWorkerConfig)
from distributed_parameter_server_for_ml_training_tpu.train.steps import \
    make_grad_step as jax_make_grad_step
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import \
    flatten_params as jax_flatten
from distributed_parameter_server_for_ml_training_tpu_torch.data import \
    synthetic_cifar100
from distributed_parameter_server_for_ml_training_tpu_torch.models import \
    ResNet
from distributed_parameter_server_for_ml_training_tpu_torch.ops \
    .device_codec import DeviceCodec
from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
    ParameterStore, PSWorker, StoreConfig, WorkerConfig)

BATCH = 16   # 64 images: 4 steps an epoch


@pytest.fixture(scope="module")
def setup():
    jm = JaxResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    v = jm.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32),
                train=False)
    tm = ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    # One compiled JAX grad step for every JAX worker of the module.
    return (jm, jax_flatten(v["params"]), tm,
            synthetic_cifar100(64, 16, 10, seed=2),
            jax_synthetic(64, 16, 10, seed=2),
            jax_make_grad_step(jm, augment=False))


class Directing:
    """An in-process store that takes the worker's health report like a
    ``RemoteStore`` (the capability on, the provider installed) and hands
    it ``script[n]``'s directives when it polls after its n-th push."""

    def __init__(self, inner, script=None, capable=True):
        self._inner = inner
        self._script = dict(script or {})
        self.supports_health_report = capable
        self.health_provider = None
        self.health_revision = None
        self.pushes, self.reports, self.fetches = [], [], []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def fetch(self, worker_id=None, have_step=None):
        self.fetches.append(have_step is not None)
        return self._inner.fetch(worker_id, have_step=have_step)

    def push(self, worker_id, grads, fetched_step):
        self.pushes.append(fetched_step)
        self.reports.append(self.health_provider()
                            if self.health_provider else None)
        return self._inner.push(worker_id, grads, fetched_step)

    def take_directives(self):
        return self._script.pop(len(self.pushes), [])


def _run_pair(setup, script=None, codec="int8", capable=True, epochs=1,
              **cfg_kw):
    """The JAX and the port worker, each over a Directing store of its
    package from the same params: {package: (worker, directing store)}."""
    jm, init, tm, ds, jds, jax_step = setup
    cfg = dict(batch_size=BATCH, num_epochs=epochs, augment=False,
               eval_each_epoch=False, **cfg_kw)
    out = {}
    for name, store_cls, conf, worker_cls, wcfg, model, data in (
            ("jax", JaxStore, JaxConfig, JaxWorker, JaxWorkerConfig(**cfg),
             jm, jds),
            ("port", ParameterStore, StoreConfig, PSWorker,
             WorkerConfig(device="cpu", **cfg), tm, ds)):
        inner = store_cls({k: v.copy() for k, v in init.items()},
                          conf(mode="async", total_workers=1,
                               push_codec=codec))
        store = Directing(inner, script, capable)
        kw = {"grad_step": jax_step} if name == "jax" else {}
        w = worker_cls(store, model, data, wcfg, worker_name="w", **kw)
        w.run()
        out[name] = (w, store)
    return out


SCRIPT = {
    1: [{"seq": 1, "action": "quarantine", "steps": 2}],
    2: [{"seq": 2, "action": "refetch_params"}],
    3: [{"seq": 3, "action": "rebalance_shard"}],
    5: [{"seq": 4, "action": "drain"}, {"seq": 5, "action": "reboot"}],
}


def test_directives_act_as_jax_workers_do(setup, capsys):
    runs = _run_pair(setup, SCRIPT, epochs=3)
    (jw, js), (pw, ps) = runs["jax"], runs["port"]
    assert jw.result.error is None and pw.result.error is None, \
        (jw.result.error, pw.result.error)
    for attr in ("directives_applied", "pushes_quarantined",
                 "pushes_accepted", "pushes_rejected",
                 "local_steps_completed"):
        assert getattr(pw.result, attr) == getattr(jw.result, attr), attr
    assert len(pw.result.epoch_times) == len(jw.result.epoch_times)
    assert ps.pushes == js.pushes and ps.fetches == js.fetches
    # Epoch 1: push, 2 quarantined windows, push; epoch 2 ends after its
    # first push (rebalance_shard); epoch 3 after its second (drain); the
    # unknown action is ignored.
    assert pw.result.directives_applied == {
        "quarantine": 1, "refetch_params": 1, "rebalance_shard": 1,
        "drain": 1}
    assert pw.result.pushes_quarantined == 2
    assert len(ps.pushes) == 5 and len(pw.result.epoch_times) == 3
    assert pw.result.local_steps_completed == 7
    m = pw.result.metrics(1, 0.1, pw.config)
    assert m["directives_applied"] == pw.result.directives_applied \
        and m["pushes_quarantined"] == 2
    out = capsys.readouterr().out
    assert "DIRECTIVE worker=w id=0 action=quarantine seq=1" in out
    assert "DRAINED worker=w id=0 epoch=3" in out


@pytest.mark.parametrize("codec,cfg_kw,rtol", [
    ("int8", {}, 1e-5), ("fp16", {}, 1e-5),
    ("none", {"k_step_mode": "accumulate", "sync_steps": 2}, 5e-5)],
    ids=["int8_faithful", "fp16_faithful", "accumulate_k2"])
def test_reports_match_jax(setup, codec, cfg_kw, rtol):
    runs = _run_pair(setup, codec=codec, **cfg_kw)
    (jw, js), (pw, ps) = runs["jax"], runs["port"]
    assert jw.result.error is None and pw.result.error is None
    assert len(ps.reports) == len(js.reports) > 0
    # The first report is on the same params and batch.
    got, want = ps.reports[0], js.reports[0]
    for k in ("step", "epoch", "loss_finite", "grad_finite", "push_codec",
              "pipeline_depth", "reconnects", "heartbeat_errors"):
        assert got[k] == want[k], k
    for k in ("loss", "grad_norm"):
        assert math.isclose(got[k], want[k], rel_tol=rtol), (k, got, want)
    assert set(got) == set(want)
    want_codec = {"int8": "int8+ef", "fp16": "fp16", "none": "none"}[codec]
    assert got["push_codec"] == want_codec
    assert [r["step"] for r in ps.reports] == [r["step"]
                                               for r in js.reports]


def test_nan_window_under_int8_raises_jax_error(setup, capsys):
    runs = _run_pair(setup, codec="int8", nan_inject_step=1)
    (jw, js), (pw, ps) = runs["jax"], runs["port"]
    assert isinstance(jw.result.error, ValueError)
    assert type(pw.result.error) is type(jw.result.error)
    name = re.compile(r"'[^']+'")
    assert name.sub("<t>", str(pw.result.error)) \
        == name.sub("<t>", str(jw.result.error))
    assert "non-finite values in input" in str(pw.result.error)
    # The NaN never reached the store; the first push did.
    assert ps.pushes == js.pushes == [0]
    assert "fault injection: NaN gradients/loss" in capsys.readouterr().out


def test_no_capability_sends_no_report(setup):
    runs = _run_pair(setup, codec="int8", capable=False)
    for _, store in runs.values():
        assert store.health_provider is None and store.reports
        assert all(r is None for r in store.reports)
    assert runs["port"][0]._health == {}


def test_heartbeat_errors_reach_the_report(setup):
    """A failing heartbeat tick is counted in the report, as the JAX
    worker counts it."""
    _, init, tm, ds, _, _ = setup
    w = PSWorker(Directing(ParameterStore(init)), tm, ds,
                 WorkerConfig(device="cpu"))

    class Failing:
        def fetch(self, *a, **k):
            raise ConnectionError("down")

    w.store = Failing()
    w._done.set()
    w._done.clear()
    ticks = iter([False, True])
    w._done.wait = lambda interval: next(ticks)
    w._heartbeat_loop(0.01)
    assert w._health == {"heartbeat_errors": 1} and w._health_rev == 1
    assert w.result.heartbeat_errors == 1


@pytest.mark.cuda
def test_cuda_boundary_norm_against_float64():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    shapes = [(3, 3, 64, 64), (64,), (512, 100), (100,), (7, 7, 3, 64)]
    host = {f"t{i}": (rng.standard_normal(s) * 10.0 ** rng.uniform(-4, 1))
            .astype(np.float32) for i, s in enumerate(shapes)}
    grads = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    loss = torch.tensor(2.25, device="cuda", dtype=torch.bfloat16)
    lval, gval = PSWorker._loss_and_norm(loss, grads)
    want = math.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))
                         for v in host.values()))
    assert lval == 2.25
    assert math.isclose(gval, want, rel_tol=1e-5), (gval, want)
    grads["t1"][3] = float("nan")
    assert math.isnan(PSWorker._loss_and_norm(loss, grads)[1])


@pytest.mark.cuda
def test_cuda_device_codec_reset_drops_the_carry():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .compression import ErrorFeedback, compress_push

    rng = np.random.default_rng(6)
    pushes = [{"a": rng.standard_normal((300,)).astype(np.float32),
               "b": rng.standard_normal((40, 7)).astype(np.float32)}
              for _ in range(2)]
    plan = {"a": "int8", "b": "int8"}
    codec = DeviceCodec(error_feedback=True, device="cuda")
    codec.encode_now({k: torch.from_numpy(v).cuda()
                      for k, v in pushes[0].items()}, plan)
    assert len(codec._residual) == 2
    codec.reset()
    assert codec._residual == {}
    got = codec.encode_now({k: torch.from_numpy(v).cuda()
                            for k, v in pushes[1].items()}, plan)
    want = compress_push(pushes[1], plan, ef=ErrorFeedback())
    assert list(got) == list(want)
    for k in want:
        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes()
