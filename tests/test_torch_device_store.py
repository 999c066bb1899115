"""The port's device-resident store (``…_torch/ps/device_store.py``) against
the JAX package's ``DeviceParameterStore`` (JAX on the CPU) and against
the port's host store, on the CPU (``device="cpu"``).

One scripted call sequence per case (a full sync round of 3 workers, a
ragged round, async staleness weighting and its bound, a shape
mismatch, elastic expiry under a scripted clock) goes into both device
stores: every return and the final params must be equal bit for bit —
the JAX store's update is one fused multiply-add under XLA's CPU jit,
and its mean over n workers a multiply by fp32 ``1/n`` folded into the
scale, which the port computes the same way. The same sequence into the
port's python store agrees within the JAX package's own tolerance for
that comparison (``tests/test_device_store.py``: rtol 1e-6, atol 1e-6).
Also: a fetched snapshot is unchanged by a later push, update times are
sampled every ``wait_every`` updates, workers and ``AsyncTrainer`` train
over the store, the trainer's configs equal the JAX package's, and,
marked ``cuda``, the store on the card equals the store on the CPU."""

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_parameter_server_for_ml_training_tpu.models as jax_models
from distributed_parameter_server_for_ml_training_tpu.data.cifar import \
    synthetic_cifar100 as jax_synthetic
from distributed_parameter_server_for_ml_training_tpu.ps.device_store \
    import DeviceParameterStore as JaxDeviceStore
from distributed_parameter_server_for_ml_training_tpu.ps.store import \
    StoreConfig as JaxConfig
from distributed_parameter_server_for_ml_training_tpu.ps.worker import \
    WorkerConfig as JaxWorkerConfig
from distributed_parameter_server_for_ml_training_tpu.train.distributed \
    import AsyncTrainer as JaxAsyncTrainer, \
    DistributedConfig as JaxDistributedConfig
import distributed_parameter_server_for_ml_training_tpu_torch.models as \
    port_models
from distributed_parameter_server_for_ml_training_tpu_torch.data import \
    synthetic_cifar100
from distributed_parameter_server_for_ml_training_tpu_torch.models import \
    ResNet
from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
    DeviceParameterStore, ParameterStore, StoreConfig, WorkerConfig,
    make_store, run_workers)
from distributed_parameter_server_for_ml_training_tpu_torch.train \
    .distributed import AsyncTrainer, DistributedConfig
from distributed_parameter_server_for_ml_training_tpu_torch.utils.pytree \
    import params_to_jax

SHAPES = {"conv/kernel": (3, 3, 3, 8), "conv/bias": (8,),
          "dense/kernel": (8, 10), "dense/bias": (10,)}


def _params():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(seed: int, names=None, bad_shape=False) -> dict:
    rng = np.random.default_rng(100 + seed)
    out = {k: (rng.standard_normal(s) * 1e-1).astype(np.float32)
           for k, s in SHAPES.items() if names is None or k in names}
    if bad_shape:
        out["dense/bias"] = np.zeros((11,), np.float32)
    return out


#: Each case: StoreConfig fields, then the ops. ("push", worker, grads
#: seed, fetched step[, names or "bad"]), ("fetch", worker), ("clock", t),
#: ("expire",), ("finished", worker), ("register",).
CASES = {
    "sync_full_3": (dict(mode="sync", total_workers=3), [
        ("register",), ("register",), ("register",),
        *[("push", w, 10 * r + w, r) for r in range(3) for w in range(3)],
        ("fetch", 0)]),
    "sync_ragged": (dict(mode="sync", total_workers=2), [
        ("register",), ("register",),
        ("push", 0, 1, 0), ("push", 1, 2, 0, ("conv/kernel", "dense/bias")),
        ("push", 0, 3, 1), ("push", 1, 4, 1, ("dense/kernel",)),
        ("push", 0, 5, 2), ("push", 1, 6, 2), ("fetch", 1)]),
    "async_staleness": (dict(mode="async", total_workers=2,
                             staleness_bound=2), [
        ("register",), ("register",),
        ("push", 0, 1, 0), ("push", 1, 2, 0), ("push", 0, 3, 1),
        ("push", 1, 4, 0), ("push", 0, 5, 4), ("push", 1, 6, 1),
        ("fetch", 0), ("push", 1, 7, 5)]),
    "shape_mismatch": (dict(mode="async", total_workers=1), [
        ("register",), ("push", 0, 1, 0, "bad"), ("push", 0, 2, 0),
        ("fetch", 0)]),
    "elastic_expiry": (dict(mode="sync", total_workers=3, elastic=True,
                            worker_timeout=10.0), [
        ("clock", 100.0), ("register",), ("register",), ("register",),
        ("push", 0, 1, 0), ("push", 1, 2, 0), ("clock", 105.0),
        ("push", 0, 3, 0), ("clock", 112.0), ("expire",),
        ("register",), ("push", 2, 4, 1), ("push", 0, 5, 1),
        ("push", 1, 6, 1), ("finished", 1), ("push", 0, 7, 2),
        ("push", 2, 8, 2), ("fetch", 0)]),
}


#: A round whose FIRST push is partial. The JAX device store means every
#: name some worker pushed; the host store (the reference's
#: aggregate_gradients_sync, server.py:148) takes the round's names from
#: its first push and drops the rest. So this case holds the port's
#: device store to the JAX one only.
FIRST_PUSH_PARTIAL = (dict(mode="sync", total_workers=2), [
    ("register",), ("register",),
    ("push", 0, 1, 0, ("dense/kernel",)), ("push", 1, 2, 0),
    ("push", 1, 3, 1, ("conv/bias",)), ("push", 0, 4, 1),
    ("fetch", 0)])


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _drive(store, ops, to_input, clock) -> list:
    """Run ``ops`` against ``store``; returns what each op returned, with
    fetched params brought to the host."""
    out = []
    for op in ops:
        kind = op[0]
        if kind == "clock":
            clock.t = op[1]
            continue
        if kind == "register":
            out.append(store.register_worker())
        elif kind == "push":
            names = op[4] if len(op) > 4 and op[4] != "bad" else None
            g = _grads(op[2], names, bad_shape=len(op) > 4 and op[4] == "bad")
            out.append(store.push(op[1], {k: to_input(v)
                                          for k, v in g.items()}, op[3]))
        elif kind == "fetch":
            params, step = store.fetch(op[1])
            out.append((step, {k: np.array(v.cpu() if isinstance(
                v, torch.Tensor) else v) for k, v in params.items()}))
        elif kind == "expire":
            out.append(sorted(store.expire_stale_workers()))
        elif kind == "finished":
            out.append(store.job_finished(op[1]))
    return out


def _run_case(case, monkeypatch, make, to_input):
    cfg, ops = CASES.get(case) or FIRST_PUSH_PARTIAL
    clock = _Clock()
    monkeypatch.setattr(time, "time", clock)
    store = make(cfg)
    results = _drive(store, ops, to_input, clock)
    return store, results


def _port(cfg):
    return DeviceParameterStore(_params(), StoreConfig(learning_rate=0.1,
                                                       **cfg), device="cpu")


def _jax(cfg):
    return JaxDeviceStore(_params(), JaxConfig(learning_rate=0.1, **cfg))


def _host(cfg):
    return ParameterStore(_params(), StoreConfig(learning_rate=0.1,
                                                 push_codec="none", **cfg))


def _same_results(a, b, exact=True):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        if isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], dict):
            assert x[0] == y[0], i
            assert list(x[1]) == list(y[1]) or not exact, i
            for k in x[1]:
                if exact:
                    assert x[1][k].tobytes() == y[1][k].tobytes(), (i, k)
                else:
                    np.testing.assert_allclose(x[1][k], y[1][k], rtol=1e-6,
                                               atol=1e-6, err_msg=k)
        else:
            assert x == y, (i, x, y)


_METRIC_KEYS = ("mode", "global_steps_completed", "total_parameter_updates",
                "gradients_processed", "gradients_rejected",
                "average_staleness", "max_staleness", "store_backend",
                "update_time_wait_every")


@pytest.mark.parametrize("case", [*CASES, "first_push_partial"])
def test_scripted_sequence_matches_jax_device_store(case, monkeypatch,
                                                    capsys):
    """Bit-equal returns, params (key order included) and counters."""
    jstore, want = _run_case(case, monkeypatch, _jax, jnp.asarray)
    pstore, got = _run_case(case, monkeypatch, _port,
                            lambda a: torch.from_numpy(a.copy()))
    _same_results(got, want)
    jp, js = jstore.snapshot()
    pp, ps = pstore.snapshot()
    assert ps == js and list(pp) == list(jp)
    for k in jp:
        assert pp[k].tobytes() == jp[k].tobytes(), k
    jm, pm = jstore.metrics(), pstore.metrics()
    assert {k: pm.get(k) for k in _METRIC_KEYS} == \
        {k: jm.get(k) for k in _METRIC_KEYS}
    if case == "shape_mismatch":
        assert got[1] is False and pm["gradients_rejected"] == 1


@pytest.mark.parametrize("case", list(CASES))
def test_scripted_sequence_matches_the_host_store(case, monkeypatch, capsys):
    """The same returns as the port's python store, params within the JAX
    package's rtol 1e-6 / atol 1e-6 for this comparison."""
    hstore, want = _run_case(case, monkeypatch, _host, np.asarray)
    pstore, got = _run_case(case, monkeypatch, _port,
                            lambda a: torch.from_numpy(a.copy()))
    _same_results(got, want, exact=False)
    hp, hs = hstore.snapshot()
    pp, ps = pstore.snapshot()
    assert ps == hs
    for k in hp:
        np.testing.assert_allclose(pp[k], hp[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_fetched_snapshot_is_unchanged_by_later_pushes():
    """Fetch hands out references, and no push writes them: the store
    rebinds new tensors, so what a worker holds stays the fetched step's
    values."""
    store = make_store("device", _params(), StoreConfig(
        mode="async", total_workers=1), device="cpu")
    store.register_worker()
    held, step = store.fetch(0)
    before = {k: v.clone() for k, v in held.items()}
    for i in range(3):
        assert store.push(0, {k: torch.from_numpy(v) for k, v in
                              _grads(i).items()}, store.global_step)
    now, _ = store.fetch(0)
    assert step == 0 and store.global_step == 3
    for k in held:
        assert torch.equal(held[k], before[k]), k
        assert not torch.equal(now[k], before[k]), k
    # The host snapshot is a copy, never a view of the store's tensors.
    snap, _ = store.snapshot()
    snap["dense/bias"][...] = 0
    assert not torch.equal(store.fetch(0)[0]["dense/bias"],
                           torch.zeros(10))


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_update_times_are_sampled_every_wait_every(mode):
    store = DeviceParameterStore(_params(), StoreConfig(
        mode=mode, total_workers=1), device="cpu")
    store.register_worker()
    for i in range(20):
        store.push(0, {k: torch.from_numpy(v)
                       for k, v in _grads(i).items()}, store.global_step)
    assert store.global_step == 20
    assert len(store.stats.update_times) == 20 // store.wait_every == 2
    assert store.metrics()["update_time_wait_every"] == 8
    assert "update_time_wait_every" not in _host(
        dict(mode=mode, total_workers=1)).metrics()


@pytest.fixture(scope="module")
def tiny():
    model = ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    return model, synthetic_cifar100(384, 64, 10, seed=2)


@pytest.mark.parametrize("overlap", [False, True])
def test_workers_train_over_the_device_store(tiny, overlap, capsys):
    """Two workers over the device store: every push lands with no codec
    and no host copy, the params move, and the loss falls over 2
    epochs."""
    model, ds = tiny
    flat, _ = params_to_jax(model)
    store = make_store("device", flat, StoreConfig(
        mode="async", total_workers=2, learning_rate=0.05), device="cpu")
    results = run_workers(store, model, ds, 2, WorkerConfig(
        batch_size=32, num_epochs=2, augment=False, device="cpu",
        overlap=overlap, eval_each_epoch=False))
    assert all(r.pushes_accepted == 12 and r.pushes_rejected == 0
               for r in results)
    assert store.global_step == 24
    final, _ = store.snapshot()
    assert sum(not np.array_equal(final[k], flat[k]) for k in flat) \
        == len(flat)
    losses = np.mean([r.train_loss_per_epoch for r in results], axis=0)
    assert np.all(np.isfinite(losses)) and losses[1] < losses[0]


def _tiny_models(monkeypatch):
    def port_get_model(name, num_classes=10, device="cpu", **kw):
        return ResNet(stage_sizes=(1, 1), num_filters=8,
                      num_classes=num_classes).to(device)

    class JaxModel:
        """Stands in for the flax model: the JAX trainer only inits it
        to build its store."""

        def init(self, rng, x, train=False):
            return {"params": {"dense": {"kernel": np.zeros((3, 2),
                                                            np.float32)}}}

    def jax_get_model(name, num_classes=10, **kw):
        return JaxModel()

    monkeypatch.setattr(port_models, "get_model", port_get_model)
    monkeypatch.setattr(jax_models, "get_model", jax_get_model)


def test_async_trainer_dispatches_on_store_backend(monkeypatch, capsys):
    _tiny_models(monkeypatch)
    ds = synthetic_cifar100(64, 16, 10, seed=0)
    for backend, cls in (("python", ParameterStore),
                         ("device", DeviceParameterStore)):
        trainer = AsyncTrainer(ds, DistributedConfig(
            mode="async", num_workers=2, num_epochs=1, batch_size=16,
            store_backend=backend, num_classes=10, augment=False,
            device="cpu"))
        assert type(trainer.store) is cls
        metrics = trainer.train()
        assert metrics["store_backend"] == backend
        assert metrics["global_steps_completed"] == 4


def _shared_defaults(port_cls, jax_cls):
    port = {f.name: f.default for f in dataclasses.fields(port_cls)}
    jax_ = {f.name: f.default for f in dataclasses.fields(jax_cls)}
    shared = sorted(set(port) & set(jax_))
    return ({k: port[k] for k in shared}, {k: jax_[k] for k in shared},
            set(jax_) - set(port))


def test_distributed_and_worker_config_defaults_match_jax():
    """Every field the two packages share has the JAX default, name by
    name (``mode`` is ``sync``, as JAX's); the JAX fields the port lacks
    are named here."""
    port, jax_, missing = _shared_defaults(DistributedConfig,
                                           JaxDistributedConfig)
    assert port == jax_
    assert missing == set()
    assert DistributedConfig(device="cpu").mode == "sync"
    port, jax_, missing = _shared_defaults(WorkerConfig, JaxWorkerConfig)
    assert port == jax_
    assert "device_codec" in port and missing == set()


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_async_trainer_store_config_matches_jax(mode, monkeypatch):
    """The StoreConfig each package's AsyncTrainer builds from the same
    DistributedConfig fields is equal, field by field."""
    _tiny_models(monkeypatch)
    kw = dict(mode=mode, num_workers=3, learning_rate=0.05,
              staleness_bound=4, strict_rounds=True, elastic=True,
              worker_timeout=12.0, num_classes=10)
    port = AsyncTrainer(synthetic_cifar100(32, 8, 10, seed=0),
                        DistributedConfig(device="cpu", **kw))
    jaxt = JaxAsyncTrainer(jax_synthetic(32, 8, 10, seed=0),
                           JaxDistributedConfig(**kw))
    assert dataclasses.asdict(port.store.config) == \
        dataclasses.asdict(jaxt.store.config)
    port = AsyncTrainer(synthetic_cifar100(32, 8, 10, seed=0),
                        DistributedConfig(device="cpu", num_classes=10))
    jaxt = JaxAsyncTrainer(jax_synthetic(32, 8, 10, seed=0),
                           JaxDistributedConfig(num_classes=10))
    assert dataclasses.asdict(port.store.config) == \
        dataclasses.asdict(jaxt.store.config)


# -- on the card (skip here; scripts/run_cuda_tests.py runs them) ---------

@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_device_store_on_the_card_equals_the_cpu(case, monkeypatch,
                                                 capsys):
    """The scripted sequence through the store on the card and on the
    CPU: every return and the final params bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def on(device):
        def make(cfg):
            return DeviceParameterStore(_params(), StoreConfig(
                learning_rate=0.1, **cfg), device=device)
        return make

    cstore, want = _run_case(case, monkeypatch, on("cpu"),
                             lambda a: torch.from_numpy(a.copy()))
    gstore, got = _run_case(case, monkeypatch, on("cuda"),
                            lambda a: torch.from_numpy(a.copy()).cuda())
    _same_results(got, want)
    cp, cs = cstore.snapshot()
    gp, gs = gstore.snapshot()
    assert gs == cs and list(gp) == list(cp)
    for k in cp:
        assert gp[k].tobytes() == cp[k].tobytes(), k


@pytest.mark.cuda
def test_overlap_over_the_card_store_equals_serial(tiny):
    """One worker over the store on the card, deterministic cuDNN: pushes
    and prefetches on the comms thread (the prefetch on its side stream)
    leave the store bit-equal to the serial run, so the store's stream
    waited for each pusher's gradients and each fetcher waited for the
    store's updates."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model, ds = tiny
    flat, _ = params_to_jax(model)
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    runs = []
    try:
        for overlap in (False, True):
            store = DeviceParameterStore(flat, StoreConfig(
                mode="async", total_workers=1, learning_rate=0.05),
                device="cuda")
            run_workers(store, model, ds, 1, WorkerConfig(
                batch_size=32, num_epochs=1, augment=False, device="cuda",
                overlap=overlap, eval_each_epoch=False))
            runs.append(store.snapshot())
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = prev
    (serial, s_step), (piped, p_step) = runs
    assert s_step == p_step == 12
    for k in serial:
        assert serial[k].tobytes() == piped[k].tobytes(), k
