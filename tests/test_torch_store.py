"""The port's ParameterStore against the JAX package's on one scripted
sequence of registers, fetches and pushes: parameters bit-equal after
every step, accept/reject decisions equal, ``metrics()`` equal apart from
timing fields."""

import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.ops.compression \
    import compress_push as jax_compress
from distributed_parameter_server_for_ml_training_tpu.ps.store import (
    ParameterStore as JaxStore, StoreConfig as JaxConfig)
from distributed_parameter_server_for_ml_training_tpu_torch.ps import \
    make_store
from distributed_parameter_server_for_ml_training_tpu_torch.ps.store import (
    ParameterStore, StoreConfig)

SHAPES = {"conv/kernel": (3, 3, 2, 4), "dense/kernel": (6, 5),
          "dense/bias": (5,)}
TIMING = {"total_training_time_seconds", "average_update_time_seconds",
          "updates_per_second"}


def _params():
    r = np.random.default_rng(0)
    return {k: r.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


class Pair:
    """Drive both stores with the same calls and check they agree."""

    def __init__(self, **cfg):
        p = _params()
        self.jax = JaxStore({k: v.copy() for k, v in p.items()},
                            JaxConfig(**cfg))
        self.port = ParameterStore({k: v.copy() for k, v in p.items()},
                                   StoreConfig(**cfg))
        self.codec = cfg.get("push_codec")
        self.rng = np.random.default_rng(1)
        self.decisions = []

    def both(self, method, *args, **kw):
        a = getattr(self.jax, method)(*args, **kw)
        b = getattr(self.port, method)(*args, **kw)
        return a, b

    def payload(self, shapes=SHAPES):
        g = {k: (self.rng.standard_normal(s) * 0.1).astype(np.float32)
             for k, s in shapes.items()}
        if self.codec in ("int8", "int4", "topk"):
            scales = self.jax.gradient_scales()[0] or None
            return jax_compress(g, {k: self.codec for k in g}, scales=scales)
        if self.codec in (None, "fp16"):
            return {k: v.astype(np.float16) for k, v in g.items()}
        return g

    def push(self, worker, fetched_step, payload=None):
        payload = payload if payload is not None else self.payload()
        a = self.jax.push(worker, {k: np.array(v) for k, v in
                                   payload.items()}, fetched_step)
        b = self.port.push(worker, {k: np.array(v) for k, v in
                                    payload.items()}, fetched_step)
        assert a == b
        self.decisions.append(a)
        self.check()
        return a

    def fetch(self, worker, have_step=None):
        (pa, sa), (pb, sb) = self.both("fetch", worker, have_step=have_step)
        assert sa == sb and list(pa) == list(pb)
        for k in pa:
            assert pa[k].dtype == pb[k].dtype
            assert pa[k].tobytes() == pb[k].tobytes(), k
        return sa

    def check(self):
        assert self.jax.global_step == self.port.global_step
        for k in SHAPES:
            assert self.jax.parameters[k].tobytes() == \
                self.port.parameters[k].tobytes(), k
        ma = {k: v for k, v in self.jax.metrics().items() if k not in TIMING}
        mb = {k: v for k, v in self.port.metrics().items() if k not in TIMING}
        assert ma == mb
        assert self.jax.gradient_scales() == self.port.gradient_scales()


@pytest.mark.parametrize("codec", ["none", "fp16", "int8"])
def test_async_staleness_weighting_and_bound(codec):
    bound = 3
    pair = Pair(mode="async", total_workers=2, staleness_bound=bound,
                push_codec=codec, learning_rate=0.1)
    w0, _ = pair.both("register_worker", "a")[0]
    w1, _ = pair.both("register_worker", "b")[0]
    for staleness in range(bound + 2):
        basis = pair.fetch(w0)
        for _ in range(staleness):
            assert pair.push(w1, pair.fetch(w1))
        assert pair.push(w0, basis) == (staleness <= bound)
    assert pair.decisions.count(False) == 1
    assert pair.port.metrics()["gradients_rejected"] == 1
    assert pair.port.metrics()["max_staleness"] == bound


@pytest.mark.parametrize("compressed_domain", [True, False])
@pytest.mark.parametrize("codec", ["none", "int8"])
def test_sync_rounds_with_double_push_quirk(codec, compressed_domain):
    pair = Pair(mode="sync", total_workers=2, push_codec=codec,
                compressed_domain=compressed_domain, learning_rate=0.1)
    w0, _ = pair.both("register_worker")[0]
    w1, _ = pair.both("register_worker")[0]
    step = pair.fetch(w0)
    pair.push(w0, step)
    # Quirk 3 (store.py:11-17): a double push overwrites w0's entry and
    # still counts, completing the round with ONE distinct contribution.
    pair.push(w0, step)
    assert pair.port.global_step == 1
    for _ in range(3):           # three full rounds, scales refreshing
        s0, s1 = pair.fetch(w0), pair.fetch(w1)
        pair.push(w0, s0)
        pair.push(w1, s1)
    assert pair.port.global_step == 4
    if codec == "int8":
        assert pair.port.gradient_scales()[0]      # published scales


def test_strict_rounds_and_malformed_pushes():
    pair = Pair(mode="sync", total_workers=2, push_codec="none",
                strict_rounds=True)
    w0, _ = pair.both("register_worker")[0]
    w1, _ = pair.both("register_worker")[0]
    pair.push(w0, 0)
    pair.push(w0, 0)
    assert pair.port.global_step == 0        # distinct workers counted
    bad = pair.payload({**SHAPES, "dense/bias": (6,)})
    assert pair.push(w1, 0, bad) is False    # shape mismatch refused
    pair.push(w1, 0)
    assert pair.port.global_step == 1


def test_delta_fetch_and_membership():
    pair = Pair(mode="async", total_workers=2, push_codec="none")
    w0, _ = pair.both("register_worker")[0]
    step = pair.fetch(w0)
    (pa, sa), (pb, sb) = pair.both("fetch", w0, have_step=step)
    assert pa == pb == {} and sa == sb == step       # NOT_MODIFIED
    pair.push(w0, step)
    assert pair.fetch(w0, have_step=step) == step + 1
    pair.both("job_finished", w0)
    assert pair.port.active_workers == pair.jax.active_workers == set()
    assert pair.port.wait_all_finished(0) and pair.jax.wait_all_finished(0)
    (pa, sa), (pb, sb) = pair.both("snapshot")
    assert sa == sb == pair.port.global_step
    for k in pa:
        assert pa[k].tobytes() == pb[k].tobytes(), k


def test_config_validation_and_backends():
    for bad in (dict(mode="x"), dict(mode="tp"), dict(total_workers=0),
                dict(total_workers=33), dict(total_workers=-1)):
        with pytest.raises(ValueError):
            StoreConfig(**bad)
        with pytest.raises(ValueError):
            JaxConfig(**bad)
    with pytest.raises(ValueError):
        ParameterStore(_params(), StoreConfig(push_codec="zip"))
    store = make_store("python", _params(), StoreConfig())
    assert store.push_codec == "fp16"          # the reference's default
    store = make_store("native", _params(), StoreConfig())
    assert (type(store).__name__, store.store_backend, store.push_codec) \
        == ("NativeParameterStore", "native", "fp16")
    with pytest.raises(ValueError, match="unknown store backend"):
        make_store("arena", _params(), StoreConfig())
    store = make_store("device", _params(), StoreConfig(), device="cpu")
    assert (type(store).__name__, store.store_backend, store.push_codec,
            store.keeps_device_arrays) == ("DeviceParameterStore",
                                           "device", "none", True)
    if not torch.cuda.is_available():
        # The card unless the CPU is asked for; never the CPU quietly.
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_store("device", _params(), StoreConfig())
