"""The port's worker modes on the CPU, held against the port's own
serial and faithful paths: ``local_sgd`` with K=1 pushes the faithful
gradient (equal up to ±0 uncompressed, the same int8 bytes with the int8
codec), ``overlap=True`` leaves the store bit-equal to the serial loop
with one worker, NaN injection poisons the step it names (the window
accumulator under local_sgd), and the heartbeat pings, counts its
failures and logs each transition. Tiny ResNet, one async worker,
augment off."""

import threading

import numpy as np
import pytest

from distributed_parameter_server_for_ml_training_tpu_torch.data import \
    synthetic_cifar100
from distributed_parameter_server_for_ml_training_tpu_torch.models import \
    ResNet
from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
    PSWorker, ParameterStore, StoreConfig, WorkerConfig)
from distributed_parameter_server_for_ml_training_tpu_torch.utils.pytree \
    import params_to_jax

STEPS = 6           # batches of 32 in the one epoch


@pytest.fixture(scope="module")
def setup():
    tm = ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    init, _ = params_to_jax(tm)
    return tm, init, synthetic_cifar100(32 * STEPS, 32, 10, seed=3)


class Recorder:
    """A store that records every push payload (and can fail heartbeat
    fetches) on the way to a real ParameterStore."""

    def __init__(self, store, fail_pings: int = 0):
        self._store = store
        self.pushes = []
        self.fail_pings = fail_pings

    def __getattr__(self, name):
        return getattr(self._store, name)

    def push(self, wid, grads, step):
        self.pushes.append({k: np.array(v) for k, v in grads.items()})
        return self._store.push(wid, grads, step)

    def fetch(self, wid=None, have_step=None):
        # The training loop runs on this (the main) thread; the heartbeat
        # pings from its own.
        if self.fail_pings and \
                threading.current_thread() is not threading.main_thread():
            self.fail_pings -= 1
            raise ConnectionError("injected ping failure")
        return self._store.fetch(wid, have_step=have_step)


def _run(setup, codec="none", fail_pings=0, mode="async", **cfg_kw):
    tm, init, ds = setup
    store = Recorder(ParameterStore(
        {k: v.copy() for k, v in init.items()},
        StoreConfig(mode=mode, total_workers=1, push_codec=codec)),
        fail_pings=fail_pings)
    worker = PSWorker(store, tm, ds, WorkerConfig(
        batch_size=32, num_epochs=1, augment=False, eval_each_epoch=False,
        device="cpu", **cfg_kw))
    worker.run()
    assert worker.result.error is None, worker.result.error
    return store, worker.result


def _positive_zero(payload: dict) -> dict:
    """The payload with every -0.0 made +0.0 (integer arrays as they
    are)."""
    return {k: v + np.zeros((), v.dtype) if v.dtype.kind == "f" else v
            for k, v in payload.items()}


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_local_sgd_k1_pushes_the_faithful_gradient(setup, codec):
    """K=1: the accumulator holds ``0 + g`` at the fetched params, so the
    pushed mean is the faithful gradient — equal up to ±0 in fp32, and
    the same int8 codes and scales (±0 both code 0)."""
    faithful, rf = _run(setup, codec)
    local, rl = _run(setup, codec, k_step_mode="local_sgd")
    assert rf.pushes_accepted == rl.pushes_accepted == STEPS
    for a, b in zip(faithful.pushes, local.pushes):
        assert list(a) == list(b)
        if codec == "int8":
            for k in a:
                assert a[k].tobytes() == b[k].tobytes(), k
        else:
            pa, pb = _positive_zero(a), _positive_zero(b)
            for k in a:
                assert pa[k].tobytes() == pb[k].tobytes(), k
    fp, lp = faithful.snapshot()[0], local.snapshot()[0]
    for k in fp:
        assert fp[k].tobytes() == lp[k].tobytes(), k


@pytest.mark.parametrize("codec,cfg", [
    ("int8", dict(k_step_mode="accumulate", sync_steps=2)),
    ("none", dict(k_step_mode="local_sgd", sync_steps=4)),
    ("fp16", dict(sync_steps=3))],
    ids=["int8_accumulate_k2", "none_local_sgd_k4", "fp16_faithful_k3"])
def test_overlap_is_bit_equal_to_serial_with_one_worker(setup, codec, cfg):
    """The pipeline keeps the serial loop's RPC order; with one worker
    every fetched step is the serial loop's too, so the store ends bit
    for bit where the serial run ends."""
    serial, rs = _run(setup, codec, **cfg)
    piped, rp = _run(setup, codec, overlap=True, **cfg)
    assert rs.pushes_accepted == rp.pushes_accepted > 0
    (sp, sstep), (pp, pstep) = serial.snapshot(), piped.snapshot()
    assert sstep == pstep
    for k in sp:
        assert sp[k].tobytes() == pp[k].tobytes(), k
    for a, b in zip(serial.pushes, piped.pushes):
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("how", ["config", "env", "local_sgd"])
def test_nan_injection_poisons_its_step(setup, how, monkeypatch, capsys):
    kw = dict(nan_inject_step=2)
    if how == "env":
        monkeypatch.setenv("DPS_NAN_STEP", "2")
        kw = {}
    elif how == "local_sgd":
        kw.update(k_step_mode="local_sgd", sync_steps=3)
    store, r = _run(setup, "none", **kw)
    assert "fault injection: NaN gradients/loss" in capsys.readouterr().out
    finite = [all(np.isfinite(v).all() for v in p.values())
              for p in store.pushes]
    # Faithful K=1: pushes 0 and 1 finite, push 2 poisoned (and the
    # params after it); local_sgd K=3: the first window's push poisoned.
    assert finite[:2] == ([True, True] if how != "local_sgd"
                          else [False, False])
    assert not finite[-1] and np.isnan(r.train_loss_per_epoch[0])


def test_heartbeat_pings_counts_failures_and_recovers(setup, capsys):
    _, r = _run(setup, "none", heartbeat_interval=0.01, fail_pings=2)
    out = capsys.readouterr().out
    assert r.heartbeats > 0 and r.heartbeat_errors == 2
    assert out.count("HEARTBEAT_FAILING") == 1
    assert out.count("HEARTBEAT_RECOVERED") == 1
    assert out.index("HEARTBEAT_FAILING") < out.index("HEARTBEAT_RECOVERED")


def test_worker_config_takes_the_jax_fields():
    cfg = WorkerConfig(device="cpu", k_step_mode="local_sgd", local_lr=0.05,
                       overlap=True, heartbeat_interval=2.0,
                       reconnect_timeout=30.0, reconnect_backoff=0.1,
                       nan_inject_step=4)
    assert (cfg.local_lr, cfg.reconnect_backoff) == (0.05, 0.1)
    with pytest.raises(ValueError):
        WorkerConfig(device="cpu", prefetch_batches=-1)


@pytest.mark.parametrize("codec,cfg_kw", [
    ("int8", {}), ("int4", {}), ("topk", {}),
    ("int8", {"overlap": True, "sync_steps": 2,
              "k_step_mode": "accumulate"})],
    ids=["int8", "int4", "topk", "int8_overlap"])
def test_device_codec_off_pushes_the_numpy_encode(setup, codec, cfg_kw):
    """``device_codec=False`` (the JAX option) encodes each quantized push
    with the NumPy ``compress_push`` and its own error feedback: the same
    payloads, byte for byte, as the device codec's plain version."""
    on, r_on = _run(setup, codec, **cfg_kw)
    off, r_off = _run(setup, codec, device_codec=False, **cfg_kw)
    assert r_off.pushes_accepted == r_on.pushes_accepted > 0
    assert len(off.pushes) == len(on.pushes)
    for a, b in zip(on.pushes, off.pushes):
        assert list(a) == list(b)
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k
