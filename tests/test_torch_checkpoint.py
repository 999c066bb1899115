"""Checkpoints of the port (``…_torch/checkpoint/``) on the CPU.

Store snapshots are the JAX package's format: a record that the JAX
``save_store`` wrote restores in the port, and one the port wrote (from
its host store or its device store) restores in JAX, params bit-equal,
step and push-token journal equal. The recovery rules are JAX's: a torn
npz falls back to the previous record, a flipped bit is caught by the
CRC, an explicit step stays strict, a cross-job or cross-shard restore
is refused, a pre-v4 record is the ``default`` job, and the periodic
checkpointer survives a failed save. ``CheckpointManager`` (``torch.save``
in place of Orbax) round-trips a train state in place and keeps
``max_to_keep`` files. A resumed ``BaselineTrainer`` and ``SyncTrainer``
equal the uninterrupted run bit for bit, an ``AsyncTrainer`` resumes its
store, and ``cli serve --store-backend device --checkpoint-dir`` restores
its last snapshot with ``--restore``. Marked ``cuda``: the graphed
baseline resumes bit-equal on the card."""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.checkpoint import (
    load_store_record as jax_load_record, restore_store as jax_restore,
    save_store as jax_save)
from distributed_parameter_server_for_ml_training_tpu.ps.store import (
    ParameterStore as JaxStore, StoreConfig as JaxConfig)
import distributed_parameter_server_for_ml_training_tpu_torch.models as \
    port_models
from distributed_parameter_server_for_ml_training_tpu_torch import cli
from distributed_parameter_server_for_ml_training_tpu_torch.checkpoint import (
    STORE_SNAPSHOT_VERSION, CheckpointManager, PeriodicStoreCheckpointer,
    load_store_record, restore_server_state, restore_store, save_store)
from distributed_parameter_server_for_ml_training_tpu_torch.data import \
    synthetic_cifar100
from distributed_parameter_server_for_ml_training_tpu_torch.models import \
    ResNet
from distributed_parameter_server_for_ml_training_tpu_torch.parallel.mesh \
    import DATA_AXIS
from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
    DeviceParameterStore, ParameterStore, StoreConfig)
from distributed_parameter_server_for_ml_training_tpu_torch.train \
    .baseline import BaselineConfig, BaselineTrainer
from distributed_parameter_server_for_ml_training_tpu_torch.train \
    .distributed import AsyncTrainer, DistributedConfig, SyncTrainer

SHAPES = {"conv/kernel": (3, 3, 3, 8), "conv/bias": (8,),
          "dense/kernel": (8, 10), "dense/bias": (10,)}
JOURNAL = [{"nonce": "0123456789ab", "count": 2, "accepted": True,
            "worker_id": 0, "step": 2},
           {"nonce": "ba9876543210", "count": 1, "accepted": False,
            "worker_id": 1, "step": 2}]


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _advanced(store, steps=3):
    """Registers a worker and applies ``steps`` async pushes."""
    store.register_worker()
    for i in range(steps):
        rng = np.random.default_rng(50 + i)
        g = {k: (rng.standard_normal(s) * 1e-2).astype(np.float32)
             for k, s in SHAPES.items()}
        if getattr(store, "keeps_device_arrays", False):
            g = {k: torch.from_numpy(v) for k, v in g.items()}
        assert store.push(0, g, store.global_step)
    return store


def _port_store(backend, **cfg):
    config = StoreConfig(mode="async", total_workers=1, push_codec="none",
                         **cfg)
    if backend == "device":
        return DeviceParameterStore(_params(), config, device="cpu")
    return ParameterStore(_params(), config)


@pytest.mark.parametrize("backend", ["python", "device"])
def test_a_jax_record_restores_in_the_port(tmp_path, backend):
    jstore = _advanced(JaxStore(_params(), JaxConfig(
        mode="async", total_workers=1, push_codec="none")))
    jax_save(jstore, str(tmp_path), journal_fn=lambda: JOURNAL)
    pstore = _port_store(backend)

    class Svc:
        def load_journal(self, entries):
            self.entries = entries
            return len(entries)

    svc = Svc()
    step, loaded = restore_server_state(pstore, svc, str(tmp_path))
    assert step == jstore.global_step == 3 and loaded == 2
    assert svc.entries == JOURNAL
    want, _ = jstore.snapshot()
    got, _ = pstore.snapshot()
    assert list(got) == list(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("backend", ["python", "device"])
def test_a_port_record_restores_in_jax(tmp_path, backend):
    pstore = _advanced(_port_store(backend))
    path = save_store(pstore, str(tmp_path), journal_fn=lambda: JOURNAL)
    assert os.path.basename(path) == "store_00000003.npz"
    # The JAX reader takes the port's record: meta v4, journal, identity.
    params, meta = jax_load_record(str(tmp_path))
    assert meta["format_version"] == STORE_SNAPSHOT_VERSION == 4
    assert meta["push_journal"] == JOURNAL and meta["global_step"] == 3
    assert meta["job"] == "default" and meta["shard"] == {
        "shard_index": 0, "shard_count": 1}
    assert meta["aggregation"]["push_codec"] == "none"
    assert meta["npz_size"] == os.path.getsize(path)
    jstore = JaxStore({k: np.zeros_like(v) for k, v in _params().items()},
                      JaxConfig(mode="async", total_workers=1,
                                push_codec="none"))
    assert jax_restore(jstore, str(tmp_path)) == 3
    want, _ = pstore.snapshot()
    got, _ = jstore.snapshot()
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
    # The metadata is the JAX writer's, key for key.
    jdir = tmp_path / "jax"
    jax_save(jstore, str(jdir), journal_fn=lambda: JOURNAL)
    with open(jdir / "store_00000003.json") as f:
        jmeta = json.load(f)
    assert list(meta) == list(jmeta)
    assert list(meta["aggregation"]) == list(jmeta["aggregation"])


def _two_records(tmp_path):
    store = _port_store("python")
    store.register_worker()
    save_store(store, str(tmp_path))
    _advanced(store, 2)
    save_store(store, str(tmp_path))
    return store


def test_a_torn_npz_falls_back_to_the_previous_record(tmp_path, capsys):
    _two_records(tmp_path)
    newest = tmp_path / "store_00000002.npz"
    newest.write_bytes(newest.read_bytes()[:100])
    params, meta = load_store_record(str(tmp_path))
    assert meta["global_step"] == 0
    assert "CHECKPOINT_FALLBACK store_00000002.npz" in capsys.readouterr().out
    for k, v in _params().items():
        assert params[k].tobytes() == v.tobytes()


def test_a_flipped_bit_is_caught_by_the_crc(tmp_path, capsys):
    _two_records(tmp_path)
    newest = tmp_path / "store_00000002.npz"
    data = bytearray(newest.read_bytes())
    data[len(data) // 2] ^= 0x04
    newest.write_bytes(bytes(data))
    _, meta = load_store_record(str(tmp_path))
    assert meta["global_step"] == 0
    assert "checksum mismatch" in capsys.readouterr().out


def test_an_explicit_step_stays_strict(tmp_path):
    _two_records(tmp_path)
    newest = tmp_path / "store_00000002.npz"
    newest.write_bytes(newest.read_bytes()[:100])
    with pytest.raises(Exception):
        load_store_record(str(tmp_path), step=2)
    with pytest.raises(FileNotFoundError):
        load_store_record(str(tmp_path), step=7)
    assert load_store_record(str(tmp_path), step=0)[1]["global_step"] == 0


def test_cross_job_and_cross_shard_restores_are_refused(tmp_path):
    store = _port_store("python", job_id="alpha")
    save_store(store, str(tmp_path))
    with pytest.raises(ValueError, match="cross-job"):
        restore_store(_port_store("python", job_id="beta"), str(tmp_path))
    with pytest.raises(ValueError, match="cross-shard"):
        restore_store(_port_store("python", job_id="alpha", shard_index=1,
                                  shard_count=2), str(tmp_path))
    assert restore_store(_port_store("python", job_id="alpha"),
                         str(tmp_path)) == 0


def test_a_pre_v4_record_counts_as_the_default_job(tmp_path):
    _advanced(_port_store("python"))
    store = _advanced(_port_store("python"))
    save_store(store, str(tmp_path))
    meta_path = tmp_path / "store_00000003.json"
    meta = json.loads(meta_path.read_text())
    for key in ("job", "npz_crc32", "npz_size", "format_version"):
        meta.pop(key)
    meta_path.write_text(json.dumps(meta))
    assert restore_store(_port_store("python"), str(tmp_path)) == 3
    with pytest.raises(ValueError, match="cross-job"):
        restore_store(_port_store("python", job_id="alpha"), str(tmp_path))


def test_the_periodic_checkpointer_survives_a_failed_save(tmp_path,
                                                          capsys):
    store = _port_store("python")
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    ckpt = PeriodicStoreCheckpointer(store, str(blocker), interval=0.02)
    ckpt.start()
    threading.Event().wait(0.2)
    assert ckpt.is_alive() and ckpt.last_error is not None
    ckpt.directory = str(tmp_path / "ok")     # the disk comes back
    threading.Event().wait(0.2)
    assert ckpt.stop(final_snapshot=True) is None
    assert load_store_record(str(tmp_path / "ok"))[1]["global_step"] == 0
    assert "periodic store snapshot failed" in capsys.readouterr().out


@pytest.fixture
def tiny_models(monkeypatch):
    def get_model(name, num_classes=10, device="cpu", axis_name=None,
                  seed=0, **kw):
        return ResNet(stage_sizes=(1, 1), num_filters=8,
                      num_classes=num_classes, axis_name=axis_name,
                      generator=torch.Generator().manual_seed(seed)
                      ).to(device)

    monkeypatch.setattr(port_models, "get_model", get_model)


def _baseline(ds, device="cpu", device_loop=False, dtype="float32"):
    model = port_models.get_model("resnet18", num_classes=10,
                                  device=device, seed=3)
    return BaselineTrainer(ds, BaselineConfig(
        batch_size=32, num_epochs=2, milestones=(1,), num_classes=10,
        dtype=dtype, device=device, device_loop=device_loop), model=model)


def _tensors(state):
    out = {**{f"p:{k}": v for k, v in state.params.items()},
           **{f"s:{k}": v for k, v in state.batch_stats.items()}}
    if state.opt_state is not None:
        out.update({f"m:{k}": v for k, v in state.opt_state.trace.items()})
        out["count"] = state.opt_state.count
    return {k: v.detach().cpu().clone() for k, v in out.items()}


def _assert_states_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert list(ta) == list(tb) and a.step == b.step
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def test_checkpoint_manager_round_trip_in_place_and_max_to_keep(
        tmp_path, tiny_models):
    ds = synthetic_cifar100(64, 16, 10, seed=1)
    trainer = _baseline(ds)
    trainer.train_epoch(1)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    saved = _tensors(trainer.state)
    for step in (2, 4, 6, 8):
        assert mgr.save(trainer.state, step=step, extra={"k": step}) == step
    assert mgr.steps() == [4, 6, 8] and mgr.latest_step() == 8
    fresh = _baseline(ds)
    ptrs = {k: v.data_ptr() for k, v in fresh.state.params.items()}
    got = mgr.restore(fresh.state)
    assert got is fresh.state and got.step == 8
    assert {k: v.data_ptr() for k, v in got.params.items()} == ptrs
    for k, v in _tensors(got).items():
        assert torch.equal(v, saved[k]), k
    assert mgr.restore_extra(6) == {"k": 6}
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(fresh.state)


def test_baseline_trainer_resume_equals_the_uninterrupted_run(
        tmp_path, tiny_models, capsys):
    ds = synthetic_cifar100(96, 16, 10, seed=1)
    full = _baseline(ds)
    whole = full.train(checkpoint_dir=str(tmp_path / "a"))
    first = _baseline(ds)
    first.config.num_epochs = 1
    first.train(checkpoint_dir=str(tmp_path / "b"))
    resumed = _baseline(ds)
    again = resumed.train(checkpoint_dir=str(tmp_path / "b"), resume=True)
    assert "resumed from step 3 (epoch 2)" in capsys.readouterr().out
    _assert_states_equal(resumed.state, full.state)
    assert again.train_losses == whole.train_losses[1:]
    assert again.test_accuracies == whole.test_accuracies[1:]


def test_sync_trainer_resume_equals_the_uninterrupted_run(
        tmp_path, tiny_models, capsys):
    ds = synthetic_cifar100(64, 16, 10, seed=1)

    def trainer(epochs):
        return SyncTrainer(ds, DistributedConfig(
            mode="sync", num_workers=2, batch_size=8, num_epochs=epochs,
            compression="int8", dtype="float32", num_classes=10,
            device="cpu"))
    full = trainer(2)
    full.train(checkpoint_dir=str(tmp_path / "a"))
    trainer(1).train(checkpoint_dir=str(tmp_path / "b"))
    resumed = trainer(2)
    resumed.train(checkpoint_dir=str(tmp_path / "b"), resume=True)
    assert "resumed from step 4 (epoch 2)" in capsys.readouterr().out
    assert resumed.global_steps == full.global_steps == 8
    _assert_states_equal(resumed.state, full.state)
    assert resumed.train_loss_per_epoch == full.train_loss_per_epoch[1:]


def test_async_trainer_snapshots_and_resumes_its_store(tmp_path,
                                                       tiny_models, capsys):
    ds = synthetic_cifar100(64, 16, 10, seed=1)
    cfg = dict(mode="async", num_workers=2, num_epochs=1, batch_size=16,
               store_backend="device", num_classes=10, augment=False,
               device="cpu")
    first = AsyncTrainer(ds, DistributedConfig(**cfg))
    first.train(checkpoint_dir=str(tmp_path))
    params, meta = load_store_record(str(tmp_path))
    assert meta["global_step"] == 4
    again = AsyncTrainer(ds, DistributedConfig(**cfg))
    metrics = again.train(checkpoint_dir=str(tmp_path), resume=True)
    assert "resumed store from global step 4" in capsys.readouterr().out
    assert metrics["global_steps_completed"] == 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serve_device_store_checkpoints_and_restores(tmp_path,
                                                         tiny_models,
                                                         capsys):
    """``serve --store-backend device --device cpu --checkpoint-dir D``
    serves one worker to the end and leaves its final snapshot; a second
    ``serve ... --restore`` starts from that step."""
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        import RemoteStore
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        PSWorker, WorkerConfig)

    ds = synthetic_cifar100(64, 16, 10, seed=1)
    steps = []
    for restore in (False, True):
        port = _free_port()
        argv = ["serve", "--mode", "async", "--workers", "1",
                "--store-backend", "device", "--device", "cpu",
                "--num-classes", "10", "--port", str(port),
                "--checkpoint-dir", str(tmp_path),
                "--checkpoint-interval", "3600"]
        rc = {}
        t = threading.Thread(target=lambda: rc.update(
            rc=cli.main(argv + (["--restore"] if restore else []))),
            daemon=True)
        t.start()
        client = RemoteStore(f"127.0.0.1:{port}", rpc_timeout=10.0)
        worker = PSWorker(client, ResNet(stage_sizes=(1, 1), num_filters=8,
                                         num_classes=10), ds,
                          WorkerConfig(batch_size=16, num_epochs=1,
                                       augment=False, device="cpu",
                                       eval_each_epoch=False))
        worker.start()
        worker.join(120)
        t.join(60)
        client.close()
        assert not t.is_alive() and rc == {"rc": 0}
        assert worker.result.error is None and \
            worker.result.pushes_accepted == 4
        steps.append(load_store_record(str(tmp_path))[1]["global_step"])
    assert steps == [4, 8]
    err = capsys.readouterr().err
    assert "backend=device" in err and "restored store at step 4" in err


@pytest.mark.slow
@pytest.mark.parametrize("checkpoint", [True, False],
                         ids=["checkpoint_dir", "plain"])
def test_cli_serve_process_on_sigterm(tmp_path, checkpoint):
    """A ``cli serve`` process is sent SIGTERM while it waits for its
    second worker. With ``--checkpoint-dir`` the shutdown hooks write the
    store's end state and the process exits 143; the snapshot restores
    into a fresh store bit-equal to what the server served last. A plain
    serve installs no hooks and dies by the signal, with no closing
    METRICS_JSON line, as the JAX package's does."""
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        import RemoteStore
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        PSWorker, WorkerConfig)

    ckpt = tmp_path / "ckpt"
    argv = [sys.executable, "-m",
            "distributed_parameter_server_for_ml_training_tpu_torch.cli",
            "serve", "--mode", "async", "--workers", "2", "--device",
            "cpu", "--num-classes", "10", "--port", "0", "--emit-metrics"]
    if checkpoint:
        argv += ["--checkpoint-dir", str(ckpt),
                 "--checkpoint-interval", "3600"]
    repo = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(repo)}
    with open(tmp_path / "out", "w+") as out, \
            open(tmp_path / "err", "w+") as err:
        server = subprocess.Popen(argv, cwd=tmp_path, env=env, stdout=out,
                                  stderr=err, text=True)
        try:
            deadline, up = time.monotonic() + 120, None
            while up is None and server.poll() is None \
                    and time.monotonic() < deadline:
                time.sleep(0.1)
                err.seek(0)
                up = re.search(r"parameter server up on :(\d+)", err.read())
            assert up, "cli serve did not come up"
            client = RemoteStore(f"127.0.0.1:{up.group(1)}",
                                 rpc_timeout=10.0)
            # The server's model, ResNet-18 at 10 classes; a shard of 32
            # of the 64 images, two pushes.
            worker = PSWorker(client, port_models.get_model(
                "resnet18", num_classes=10, device="cpu"),
                              synthetic_cifar100(64, 16, 10, seed=1),
                              WorkerConfig(batch_size=16, num_epochs=1,
                                           augment=False, device="cpu",
                                           eval_each_epoch=False))
            worker.start()
            worker.join(120)
            served, step = client.fetch()
            served = {k: np.array(v) for k, v in served.items()}
            client.close()
            server.send_signal(signal.SIGTERM)
            rc = server.wait(60)
        finally:
            if server.poll() is None:
                server.kill()
                server.wait()
        out.seek(0)
        stdout = out.read()
        err.seek(0)
        stderr = err.read()
    assert worker.result.error is None and step == 2
    if not checkpoint:
        assert rc == -signal.SIGTERM, stderr
        assert "METRICS_JSON" not in stdout
        return
    assert rc == 143, stderr
    store = ParameterStore({k: np.zeros_like(v) for k, v in served.items()},
                           StoreConfig(mode="async", total_workers=2))

    class Svc:
        def load_journal(self, entries):
            return len(entries)

    assert restore_server_state(store, Svc(), str(ckpt))[0] == 2
    got, _ = store.snapshot()
    assert list(got) == list(served)
    for k in served:
        assert got[k].tobytes() == served[k].tobytes(), k


# -- on the card (skip here; scripts/run_cuda_tests.py runs them) ---------

@pytest.mark.cuda
def test_graphed_baseline_resume_is_bit_equal_on_the_card(tmp_path,
                                                          tiny_models):
    """``BaselineTrainer(device_loop=True)`` with deterministic cuDNN: a
    trainer restored from epoch 1 replays its graph over the restored
    tensors, and its epoch 2 equals the uninterrupted run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        ds = synthetic_cifar100(128, 32, 10, seed=1)
        full = _baseline(ds, "cuda", device_loop=True)
        whole = full.train(checkpoint_dir=str(tmp_path / "a"))
        first = _baseline(ds, "cuda", device_loop=True)
        first.config.num_epochs = 1
        first.train(checkpoint_dir=str(tmp_path / "b"))
        resumed = _baseline(ds, "cuda", device_loop=True)
        again = resumed.train(checkpoint_dir=str(tmp_path / "b"),
                              resume=True)
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = prev
    assert resumed._device_loop._cuda_graph is not None
    _assert_states_equal(resumed.state, full.state)
    assert again.train_losses == whole.train_losses[1:]
