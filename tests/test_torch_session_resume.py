"""Session resume of the port's worker: a port server on 127.0.0.1 is
stopped just before the worker's 3rd push leaves, and a new one is
started on the same port from ``load_snapshot`` of the old store's
snapshot. The worker's reconnect state machine re-registers, re-fetches
at the restored step and re-sends the stranded push under its own token
(``RemoteStore.repush_last``), serial and through the overlapped
pipeline; every push is applied exactly once. A push the old server
applied whose reply was lost is answered as a duplicate by a server
restored with ``restore_server_state`` from a store checkpoint and its
push-token journal, not applied twice. With resume off a lost server
still fails the worker, the stranded gradient's fate follows the
staleness semantics, and a worker riding many resets holds one channel
at a time."""

import threading
import time

import grpc
import numpy as np
import pytest

from distributed_parameter_server_for_ml_training_tpu_torch.comms import (
    ParameterService, RemoteStore, SessionLostError, serve)
from distributed_parameter_server_for_ml_training_tpu_torch.comms import \
    client as PC
from distributed_parameter_server_for_ml_training_tpu_torch.data import \
    synthetic_cifar100
from distributed_parameter_server_for_ml_training_tpu_torch.models import \
    ResNet
from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
    PSWorker, ParameterStore, StoreConfig, WorkerConfig)
from distributed_parameter_server_for_ml_training_tpu_torch.utils.pytree \
    import params_to_jax


@pytest.fixture(scope="module")
def tiny():
    model = ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    flat, _ = params_to_jax(model)
    return model, flat


def _store(flat, **kw):
    cfg = dict(mode="sync", total_workers=1, elastic=True,
               worker_timeout=60.0, push_codec="int8")
    cfg.update(kw)
    return ParameterStore({k: v.copy() for k, v in flat.items()},
                          StoreConfig(**cfg))


@pytest.mark.parametrize("overlap", [False, True])
def test_worker_resumes_through_a_server_restart(tiny, overlap, capsys):
    model, flat = tiny
    store1 = _store(flat)
    server1, port = serve(store1, port=0, host="127.0.0.1",
                          service=ParameterService(store1))
    client = RemoteStore(f"127.0.0.1:{port}", rpc_timeout=5.0,
                         rpc_retries=1, rpc_backoff=0.05)
    ds = synthetic_cifar100(n_train=96, n_test=16, num_classes=10)
    worker = PSWorker(client, model, ds, WorkerConfig(
        batch_size=16, num_epochs=3, sync_steps=2, overlap=overlap,
        augment=False, eval_each_epoch=False, reconnect_timeout=60.0,
        reconnect_backoff=0.05, device="cpu"))
    killed, restarted = threading.Event(), threading.Event()
    holder = {}

    def restart_after_kill():
        killed.wait(120)
        time.sleep(0.3)     # the worker's retries see UNAVAILABLE first
        params, step = holder["snapshot"]
        store2 = _store({k: np.zeros_like(v) for k, v in flat.items()})
        store2.load_snapshot(params, step)
        server2, bound = serve(store2, port=port, host="127.0.0.1",
                               service=ParameterService(store2))
        assert bound == port, "could not rebind the old port"
        holder["server2"], holder["store2"] = server2, store2
        restarted.set()

    inner_push = client._call["PushGradrients"]

    def push_with_kill(request, timeout=None):
        # The 3rd push becomes the in-flight gradient: snapshot the store
        # (2 applies), stop the server, let the send hit the dead socket.
        push_with_kill.calls += 1
        if push_with_kill.calls == 3 and not killed.is_set():
            holder["snapshot"] = store1.snapshot()
            server1.stop(grace=None).wait(10)
            killed.set()
        return inner_push(request, timeout=timeout)

    push_with_kill.calls = 0
    client._call["PushGradrients"] = push_with_kill
    t = threading.Thread(target=restart_after_kill, daemon=True)
    t.start()
    worker.start()
    worker.join(timeout=300)
    t.join(timeout=120)
    try:
        assert killed.is_set() and restarted.is_set()
        assert not worker.is_alive()
        assert worker.result.error is None, worker.result.error
        assert worker.result.reconnects == 1
        # 3 epochs x 6 batches, K=2: 9 pushes; 2 applied before the stop
        # (in the snapshot), the stranded 3rd re-sent after the resume,
        # the rest on the new server — none twice.
        assert holder["snapshot"][1] == 2
        assert worker.result.pushes_accepted == 9
        store2 = holder["store2"]
        assert store2.stats.gradients_processed == 7
        assert store2.global_step == 9
        out = capsys.readouterr().out
        assert "RECONNECTED" in out and "inflight=repushed" in out
    finally:
        if "server2" in holder:
            holder["server2"].stop(grace=None)
        client.close()


def test_lost_reply_is_a_duplicate_after_a_journal_restore(tiny, tmp_path,
                                                          capsys):
    """The old server applies the worker's 2nd push, then its reply is
    lost: a snapshot (params and push-token journal) is flushed and the
    server stopped. A new server on the same port, restored with
    ``restore_server_state``, answers the worker's retry under the old
    token as a duplicate: the push is applied once, not twice."""
    from distributed_parameter_server_for_ml_training_tpu_torch \
        .checkpoint import PeriodicStoreCheckpointer, restore_server_state

    model, flat = tiny
    store1 = _store(flat)
    svc1 = ParameterService(store1)
    ckpt = PeriodicStoreCheckpointer(store1, str(tmp_path), interval=3600.0,
                                     journal_fn=svc1.journal_snapshot)
    ckpt.start()
    server1, port = serve(store1, port=0, host="127.0.0.1", service=svc1)
    client = RemoteStore(f"127.0.0.1:{port}", rpc_timeout=5.0,
                         rpc_retries=1, rpc_backoff=0.05)
    ds = synthetic_cifar100(n_train=96, n_test=16, num_classes=10)
    worker = PSWorker(client, model, ds, WorkerConfig(
        batch_size=16, num_epochs=1, sync_steps=2, augment=False,
        eval_each_epoch=False, reconnect_timeout=60.0,
        reconnect_backoff=0.05, device="cpu"))
    killed, restarted = threading.Event(), threading.Event()
    holder = {}

    def restart_after_kill():
        killed.wait(120)
        time.sleep(0.3)     # the worker's retries see UNAVAILABLE first
        store2 = _store({k: np.zeros_like(v) for k, v in flat.items()})
        svc2 = ParameterService(store2)
        holder["restored"] = restore_server_state(store2, svc2,
                                                  str(tmp_path))
        server2, bound = serve(store2, port=port, host="127.0.0.1",
                               service=svc2)
        assert bound == port, "could not rebind the old port"
        holder["server2"], holder["store2"] = server2, store2
        restarted.set()

    inner_push = client._call["PushGradrients"]

    def push_losing_reply(request, timeout=None):
        push_losing_reply.calls += 1
        if push_losing_reply.calls == 2 and not killed.is_set():
            inner_push(request, timeout=timeout)     # applied ...
            ckpt.stop(final_snapshot=True)           # ... and journaled
            server1.stop(grace=None).wait(10)
            killed.set()
            # ... but its reply never arrives: the send that answers it
            # hits the stopped server.
        return inner_push(request, timeout=timeout)

    push_losing_reply.calls = 0
    client._call["PushGradrients"] = push_losing_reply
    t = threading.Thread(target=restart_after_kill, daemon=True)
    t.start()
    worker.start()
    worker.join(timeout=300)
    t.join(timeout=120)
    try:
        assert killed.is_set() and restarted.is_set()
        assert not worker.is_alive()
        assert worker.result.error is None, worker.result.error
        assert worker.result.reconnects == 1
        # 6 batches, K=2: 3 pushes. The restore holds 2 applies and a
        # journal entry for the 2nd; its retry is a duplicate, so only
        # the 3rd applies on the new server.
        store2 = holder["store2"]
        assert store2.stats.gradients_processed == 1
        assert store2.global_step == 3
        assert worker.result.pushes_accepted == 3
        step, journaled = holder["restored"]
        assert step == 2 and journaled >= 1
    finally:
        if "server2" in holder:
            holder["server2"].stop(grace=None)
        client.close()


def test_resume_off_keeps_the_terminal_failure(tiny):
    """reconnect_timeout=0 (the default): a lost server fails the worker
    with the SessionLostError behind it."""
    model, flat = tiny
    store = _store(flat, mode="async", elastic=False)
    server, port = serve(store, port=0, host="127.0.0.1")
    client = RemoteStore(f"127.0.0.1:{port}", rpc_timeout=2.0,
                         rpc_retries=1, rpc_backoff=0.05)
    ds = synthetic_cifar100(n_train=64, n_test=16, num_classes=10)
    worker = PSWorker(client, model, ds, WorkerConfig(
        batch_size=16, num_epochs=3, augment=False, eval_each_epoch=False,
        device="cpu"))

    def kill_soon():
        while store.stats.gradients_processed < 1:
            time.sleep(0.005)
        server.stop(grace=None)

    t = threading.Thread(target=kill_soon, daemon=True)
    t.start()
    worker.start()
    worker.join(timeout=120)
    t.join(timeout=30)
    assert not worker.is_alive()
    assert worker._session_lost(worker.result.error) is not None
    client.close()


def test_repush_viability_follows_the_staleness_semantics(tiny):
    model, flat = tiny
    store = _store(flat, mode="async", staleness_bound=3)
    worker = PSWorker(store, model, synthetic_cifar100(
        n_train=32, n_test=16, num_classes=10), WorkerConfig(device="cpu"))
    assert worker._repush_viable(old_fetched=5, server_step=7) is True
    assert worker._repush_viable(old_fetched=5, server_step=9) is False
    assert worker._repush_viable(old_fetched=5, server_step=4) is False
    store.config.mode = "sync"
    assert worker._repush_viable(old_fetched=5, server_step=40) is True
    assert worker._repush_viable(old_fetched=5, server_step=4) is False
    lost = SessionLostError("gone")
    wrapped = RuntimeError("comms pipeline failed")
    wrapped.__cause__ = lost
    assert worker._session_lost(lost) is lost
    assert worker._session_lost(wrapped) is lost
    assert worker._session_lost(ValueError("x")) is None


def test_repeated_channel_resets_hold_one_channel(monkeypatch):
    """``reset_channel`` closes the abandoned channel BEFORE building its
    replacement, so a worker riding many resets holds one at a time."""
    created, closed = [], []
    real = grpc.insecure_channel

    def tracked(address, options=None):
        ch = real(address, options=options)
        created.append(ch)
        close = ch.close

        def close_and_count():
            closed.append(ch)
            close()
        ch.close = close_and_count
        return ch

    monkeypatch.setattr(PC.grpc, "insecure_channel", tracked)
    client = RemoteStore("127.0.0.1:1")
    for _ in range(10):
        client.reset_channel()
        assert len(created) - len(closed) == 1
    client.close()
    assert len(created) == len(closed) == 11


def test_register_retries_override(monkeypatch):
    """``register_worker(retries=1)`` makes one attempt (the reconnect
    loop paces its own backoff); the constructor's budget otherwise."""
    client = RemoteStore("127.0.0.1:1", register_retries=3, rpc_timeout=0.2)
    sleeps = []
    monkeypatch.setattr(PC.time, "sleep", sleeps.append)
    with pytest.raises(ConnectionError, match="after 1 attempts"):
        client.register_worker("w", retries=1)
    assert sleeps == []
    with pytest.raises(ConnectionError, match="after 3 attempts"):
        client.register_worker("w")
    assert sleeps == [1.0, 2.0]
    client.close()
