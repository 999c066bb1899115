"""The port's multi-process sync data parallelism, with ranks as threads.

Each rank is a thread holding its own ``ProcessGroupGloo`` on one shared
``HashStore``, so R ranks run in one pytest process; every thread is
joined with a timeout, and a hang fails the test. The tiny ResNet of
``test_torch_sync_dp.py`` (stages (1, 1), 8 filters, 10 classes, fp32)
runs on the CPU; the JAX side on the 8 virtual CPU devices.

- the int8 ring over R ranks of S rows is bit-equal to one rank's R*S
  rows, with equal wire bytes;
- the cross-rank mean (forward and backward) equals a one-rank mean over
  the same rows within 1e-6;
- a 2 x 4 ``none`` step equals JAX's 8-device step within rtol 2e-4 /
  atol 2e-5 (params and batch statistics) and rtol 1e-4 (loss), as
  ``test_none_step_equals_jax_single_process_step``; bf16 within 0.02 /
  1e-3; int8 within 0.05 / 1e-3 of the port's 1 x 8 step;
- a rank's augmented images are bit-equal to the 1 x 8 run's slots;
- every rank ends two steps with bit-identical params and statistics;
- one rank through the multi-rank code equals the one-process step bit
  for bit;
- ``initialize`` joins a job started by ``torchrun`` (``WORLD_SIZE``,
  ``RANK``, ``LOCAL_RANK``) with ``env://``, and its ``slow`` test runs
  two ``cli train --multihost`` processes under those variables alone.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from distributed_parameter_server_for_ml_training_tpu.models import \
    ResNet as JaxResNet
from distributed_parameter_server_for_ml_training_tpu.parallel import (
    make_mesh as jax_make_mesh, make_sync_dp_step as jax_make_sync_dp_step,
    shard_batch as jax_shard_batch)
from distributed_parameter_server_for_ml_training_tpu.train import (
    create_train_state as jax_create_train_state, server_sgd as jax_server_sgd)
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import (
    flatten_params as jax_flatten, unflatten_params as jax_unflatten)
from distributed_parameter_server_for_ml_training_tpu_torch import cli
from distributed_parameter_server_for_ml_training_tpu_torch.models import \
    ResNet
from distributed_parameter_server_for_ml_training_tpu_torch.parallel import (
    DATA_AXIS, RankGroup, make_global_mesh, make_mesh, make_sync_dp_step,
    shard_batch, shard_batch_global)
from distributed_parameter_server_for_ml_training_tpu_torch.parallel import \
    multihost as mh
from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
    .sync_dp import _int8_ring_allreduce_mean, augment_slots
from distributed_parameter_server_for_ml_training_tpu_torch.train \
    .optimizers import server_sgd
from distributed_parameter_server_for_ml_training_tpu_torch.train \
    .train_state import train_state_from_jax
from torch_threads import one_torch_thread_per_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


#: ``fn(group)`` on thread-ranks, each over its own ``ProcessGroupGloo``
#: on one ``HashStore``; a rank still running after the timeout fails.
run_ranks = mh.thread_ranks


def _jax_model(axis_name="data"):
    return JaxResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10,
                     axis_name=axis_name)


@pytest.fixture(scope="module")
def init():
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
    model = ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10,
                   axis_name=DATA_AXIS)
    return model, train_state_from_jax(model, *init, server_sgd(0.1))


def _steps(mesh, init, batch, compression, augment, steps=1):
    """``steps`` sync steps from the JAX init over ``mesh`` (one process's
    or one rank's): the final state and each step's metrics."""
    model, st = _port_state(init)
    step = make_sync_dp_step(mesh, model, compression=compression,
                             augment=augment)
    bi, bl = (shard_batch_global if mesh.group is not None
              else shard_batch)(mesh, batch)
    metrics = []
    for _ in range(steps):
        st, m = step(st, bi, bl, 1)
        metrics.append(m)
    return st, metrics


def _ranks_steps(ranks, slots, init, batch, compression, augment, steps=1):
    def fn(group):
        mesh = make_global_mesh(ranks * slots, "cpu", group=group)
        return _steps(mesh, init, batch, compression, augment, steps)
    return run_ranks(ranks, fn)


def _jax_sync_step(init, batch, compression):
    params, stats = init
    st = jax_create_train_state(_jax_model(), jax.random.PRNGKey(0),
                                jax_server_sgd(0.1))
    st = st.replace(params=jax_unflatten(params),
                    batch_stats=jax_unflatten(stats))
    mesh = jax_make_mesh(8)
    step = jax_make_sync_dp_step(mesh, compression=compression,
                                 augment=False)
    out, m = step(st, *jax_shard_batch(mesh, batch), jax.random.PRNGKey(1))
    return jax_flatten(out.params), jax_flatten(out.batch_stats), m


def _assert_close(got: dict, want: dict, rtol, atol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def _assert_bits(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert a[k].numpy().tobytes() == b[k].numpy().tobytes(), k


# -- the collectives --------------------------------------------------------

@pytest.mark.parametrize("ranks,slots", [(2, 2), (2, 4), (4, 2)])
def test_ring_over_ranks_bit_equal_to_one_rank(ranks, slots):
    vals = np.random.default_rng(0).normal(
        size=(ranks * slots, 5003)).astype(np.float32)
    wire_one = {}
    want = _int8_ring_allreduce_mean(torch.from_numpy(vals), 11,
                                     wire=wire_one)

    def fn(group):
        wire = {}
        rows = torch.from_numpy(vals[group.rank * slots:
                                     (group.rank + 1) * slots])
        return _int8_ring_allreduce_mean(rows, 11, wire=wire,
                                         group=group), wire

    got = run_ranks(ranks, fn)
    for r, (rows, wire) in enumerate(got):
        assert wire == wire_one
        for s in range(slots):
            assert rows[s].numpy().tobytes() == \
                want[r * slots + s].numpy().tobytes(), (r, s)


def test_rank_mean_forward_backward_and_reductions():
    """3 ranks: the differentiable mean and its gradient against one
    rank's mean over the same rows; min and mean over ranks."""
    r = np.random.default_rng(1)
    vals = r.normal(size=(3, 2, 16)).astype(np.float32)
    weights = r.normal(size=(3, 2, 16)).astype(np.float32)
    x = torch.from_numpy(vals).requires_grad_()
    y = x.mean(0)
    sum((y * torch.from_numpy(w)).sum() for w in weights).backward()

    def fn(group):
        xr = torch.from_numpy(vals[group.rank]).requires_grad_()
        yr = mh.rank_mean(xr, group)
        (yr * torch.from_numpy(weights[group.rank])).sum().backward()
        low = mh.rank_reduce(torch.tensor([group.rank + 5], dtype=torch.int32),
                             "min", group)
        avg = mh.rank_reduce(torch.tensor(float(group.rank)), "mean", group)
        return yr.detach(), xr.grad, int(low), float(avg)

    for rank, (yr, grad, low, avg) in enumerate(run_ranks(3, fn)):
        np.testing.assert_allclose(yr.numpy(), y.detach().numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(grad.numpy(), x.grad[rank].numpy(),
                                   rtol=1e-6, atol=1e-6)
        assert (low, avg) == (5, 1.0)
    with pytest.raises(ValueError, match="mean or min"):
        mh.rank_reduce(torch.zeros(1), "max",
                       RankGroup(None, 0, 1, "gloo"))


# -- whole steps ------------------------------------------------------------

@pytest.mark.parametrize("compression", ["none", "bf16"])
def test_step_over_ranks_against_jax_eight_device_step(devices, init, batch,
                                                       compression):
    jp, js, jm = _jax_sync_step(init, batch, compression)
    got = _ranks_steps(2, 4, init, batch, compression, augment=False)
    for st, (m,) in got:
        assert st.step == 1
        if compression == "none":
            _assert_close(st.params, jp, 2e-4, 2e-5)
            _assert_close(st.batch_stats, js, 2e-4, 2e-5)
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                       rtol=1e-4)
        else:
            _assert_close(st.params, jp, 0.02, 1e-3)
        assert tuple(m["worker_loss"].shape) == (4,)


def test_int8_ranks_identical_and_close_to_one_process(init, batch):
    """2 x 4 int8, augment on, two steps: every rank bit-identical, the
    ring's rows identical, the wire bytes of the 1 x 8 ring, and params
    within 0.05 / 1e-3 of the 1 x 8 run's."""
    one, one_m = _steps(make_mesh(8, "cpu"), init, batch, "int8", True, 2)
    got = _ranks_steps(2, 4, init, batch, "int8", True, 2)
    (st0, m0), (st1, m1) = got
    _assert_bits(st0.params, st1.params)
    _assert_bits(st0.batch_stats, st1.batch_stats)
    for m in (*m0, *m1):
        assert bool(m["ring_replicas_identical"])
        assert m["wire_bytes_per_slot"] == one_m[0]["wire_bytes_per_slot"]
    assert float(m0[-1]["loss"]) == float(m1[-1]["loss"])
    for k in one.params:
        np.testing.assert_allclose(st0.params[k].numpy(),
                                   one.params[k].numpy(), rtol=0.05,
                                   atol=1e-3, err_msg=k)


def test_augmented_slots_equal_one_process_slots(batch):
    """Each rank's crops and flips draw from the whole global batch: its
    images are the one-process run's images of its slots, bit for bit."""
    x = torch.from_numpy(batch[0]).view(8, 4, 32, 32, 3)

    def gen():
        return torch.Generator().manual_seed(1234)

    whole = augment_slots(x, gen(), 8)
    for rank in range(2):
        part = augment_slots(x[rank * 4:(rank + 1) * 4], gen(), 8, rank * 4)
        assert torch.equal(part, whole[rank * 4:(rank + 1) * 4]), rank
    assert not torch.equal(whole, x)


@pytest.mark.parametrize("compression", ["none", "bf16", "int8"])
def test_one_rank_equals_single_process_step_bit_for_bit(init, batch,
                                                         compression):
    """R = 1: the rank-scoped BatchNorm, the ring's hop and the means
    through a one-rank group change no bit of two augmented steps."""
    one, one_m = _steps(make_mesh(8, "cpu"), init, batch, compression, True,
                        2)
    [(st, m)] = _ranks_steps(1, 8, init, batch, compression, True, 2)
    _assert_bits(st.params, one.params)
    _assert_bits(st.batch_stats, one.batch_stats)
    for a, b in zip(m, one_m):
        assert float(a["loss"]) == float(b["loss"])
        assert float(a["accuracy"]) == float(b["accuracy"])
        assert torch.equal(a["worker_loss"], b["worker_loss"])


# -- the mesh, the trainer and the CLI -------------------------------------

def test_global_mesh_and_batch_slices(batch):
    def fn(group):
        mesh = make_global_mesh(8, "cpu", group=group)
        bi, bl = shard_batch_global(mesh, batch)
        return (mesh.shape, mesh.rank, mesh.num_ranks, mesh.local_slots,
                mesh.slot_offset, bi, bl)

    for rank, (shape, rk, nr, local, off, bi, bl) in \
            enumerate(run_ranks(2, fn)):
        assert (shape, rk, nr, local, off) == ({DATA_AXIS: 8}, rank, 2, 4,
                                               4 * rank)
        assert tuple(bi.shape) == (4, 4, 32, 32, 3)
        np.testing.assert_array_equal(
            bi.reshape(16, 32, 32, 3).numpy(),
            batch[0][16 * rank:16 * (rank + 1)])
        np.testing.assert_array_equal(bl.reshape(-1).numpy(),
                                      batch[1][16 * rank:16 * (rank + 1)])
    one = RankGroup(None, 0, 2, "gloo")
    with pytest.raises(ValueError, match="divide evenly"):
        make_global_mesh(3, "cpu", group=one)
    with pytest.raises(ValueError, match="evenly"):
        shard_batch_global(make_global_mesh(4, "cpu", group=one),
                           (np.zeros((6, 32, 32, 3), np.uint8),))
    assert mh.host_local_slice(np.arange(8), one).tolist() == [0, 1, 2, 3]
    assert mh.fetch_replicated({"a": {"b": torch.ones(2)}})["a"]["b"] \
        .tolist() == [1.0, 1.0]


def test_sync_trainer_over_ranks(capsys):
    """``SyncTrainer`` on 2 thread-ranks x 1 slot of full-width ResNet-18:
    rank 0 evaluates and emits, rank 1 records NaN and emits nothing,
    every rank's params end bit-identical, per-worker rows carry only the
    shared fields."""
    from distributed_parameter_server_for_ml_training_tpu_torch.data import \
        synthetic_cifar100
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .distributed import DistributedConfig, SyncTrainer
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .metrics import parse_metrics_lines
    d = synthetic_cifar100(n_train=4, n_test=4)

    def fn(group):
        cfg = DistributedConfig(mode="sync", num_workers=2, batch_size=2,
                                num_epochs=1, compression="int8",
                                dtype="float32", device="cpu")
        trainer = SyncTrainer(d, cfg, group=group)
        return trainer, trainer.train(emit_metrics=True)

    (t0, m0), (t1, m1) = run_ranks(2, fn, timeout=240)
    assert m0["processes"] == 2 and m0["global_steps_completed"] == 1
    assert t0.ranks_params_identical is t1.ranks_params_identical is True
    _assert_bits(t0.state.params, t1.state.params)
    assert np.isfinite(t0.test_accuracies[0])
    assert np.isnan(t1.test_accuracies[0])
    assert t0.ring_replicas_identical is True
    rows = parse_metrics_lines(capsys.readouterr().out)
    assert len(rows) == 3 and rows[0]["ranks_params_identical"] is True
    assert all("train_loss_per_epoch" not in r for r in rows[1:])
    with pytest.raises(ValueError, match="divide evenly"):
        SyncTrainer(d, DistributedConfig(mode="sync", num_workers=3,
                                         device="cpu"),
                    group=RankGroup(None, 0, 2, "gloo"))


def test_cli_multihost_flags_and_refusals(monkeypatch):
    monkeypatch.setenv("DPS_COORDINATOR", "127.0.0.1:1234")
    monkeypatch.setenv("DPS_NUM_PROCESSES", "2")
    monkeypatch.setenv("DPS_PROCESS_ID", "1")
    args = cli.build_parser().parse_args(["train", "--mode", "sync",
                                          "--multihost"])
    assert (args.multihost, args.coordinator, args.num_processes,
            args.process_id, args.dist_backend) == (
        True, "127.0.0.1:1234", 2, 1, None)
    args = cli.build_parser().parse_args(
        ["train", "--coordinator", "h:1", "--num-processes", "4",
         "--process-id", "3", "--dist-backend", "gloo"])
    assert (args.multihost, args.coordinator, args.num_processes,
            args.process_id, args.dist_backend) == (False, "h:1", 4, 3,
                                                    "gloo")
    with pytest.raises(SystemExit, match="--multihost applies to --mode "
                       "sync"):
        cli.main(["train", "--mode", "async", "--multihost"])
    with pytest.raises(SystemExit, match="--dist-backend applies to "
                       "--multihost"):
        cli.main(["train", "--mode", "sync", "--dist-backend", "gloo"])


def test_torchrun_env_joins_with_env_method(monkeypatch):
    """With no argument and no ``DPS_*`` variable, ``WORLD_SIZE`` and
    ``RANK`` join with ``env://`` at that rank and world size, on the card
    of ``LOCAL_RANK`` (else of ``RANK``); a ``DPS_*`` variable or an
    argument given keeps the explicit contract and its error."""
    for var in ("DPS_COORDINATOR", "DPS_NUM_PROCESSES", "DPS_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    joins, cards = [], []
    monkeypatch.setattr(mh.dist, "init_process_group",
                        lambda backend, **kw: joins.append((backend, kw)))
    monkeypatch.setattr(mh, "process_device",
                        lambda device, index: cards.append((device, index))
                        or torch.device("cpu"))
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mh.initialize(device="cuda") == torch.device("cpu")
    assert joins == [("gloo", {"init_method": "env://", "world_size": 4,
                               "rank": 3})]
    assert cards == [("cuda", 1)]
    monkeypatch.delenv("LOCAL_RANK")
    mh.initialize(device="cpu", backend="gloo")
    assert cards[-1] == ("cpu", 3) and joins[-1][1]["rank"] == 3
    monkeypatch.setenv("DPS_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="--coordinator"):
        mh.initialize(device="cpu")
    monkeypatch.delenv("DPS_COORDINATOR")
    with pytest.raises(ValueError, match="--coordinator"):
        mh.initialize(num_processes=4, device="cpu")
    assert len(joins) == 2


def test_no_fallback_hides_the_device_or_the_backend(monkeypatch):
    for var in ("DPS_COORDINATOR", "DPS_NUM_PROCESSES", "DPS_PROCESS_ID",
                "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(NotImplementedError, match="--multihost"):
        make_mesh(2, ["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="--coordinator"):
        mh.initialize(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mh.process_device("cuda", 0)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mh.initialize("127.0.0.1:1", 1, 0)
    with pytest.raises(ValueError, match="nccl backend needs a card"):
        mh.initialize("127.0.0.1:1", 1, 0, backend="nccl", device="cpu")
    assert mh.process_device("cpu", 3) == torch.device("cpu")
    assert not RankGroup(None, 0, 2, "gloo").staged(torch.device("cpu"))
    assert RankGroup(None, 0, 2, "gloo").staged(torch.device("cuda", 0))
    assert not RankGroup(None, 0, 2, "nccl").staged(torch.device("cuda", 0))
    assert (mh.process_index(), mh.process_count()) == (0, 1)


# -- two processes ----------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_cli_processes_match_one_process(tmp_path):
    """``cli train --mode sync --multihost`` in 2 processes of 2 slots
    (gloo on the CPU) against one process of 4 slots, on the same
    augmented global batches (fp32, no compression, 2 steps of 16).

    Full-width ResNet-18 at 4 images a slot amplifies the order of fp32
    sums: one process over 4 slots and over 2 slots, the same function,
    differ by ~4e-4 after a step. The 2-process params must lie within
    twice that distance of the 4-slot run's, every tensor, and the ranks
    must end bit-identical."""
    common = ["train", "--mode", "sync", "--batch-size", "4",
              "--compression", "none", "--dtype", "float32", "--epochs",
              "1", "--synthetic", "--num-train", "32", "--num-test", "8",
              "--device", "cpu", "--emit-metrics"]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "distributed_parameter_server_for_ml_training_tpu_torch.cli",
         *common, "--workers", "4", "--multihost", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
         str(rank), "--checkpoint-dir", str(tmp_path / f"multi{rank}")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        finally:
            p.kill()
        logs.append(out.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n\n".join(logs)
    assert '"ranks_params_identical": true' in logs[0], logs[0]
    assert "METRICS_JSON" not in logs[1] and "rank 1 of 2" in logs[1]
    assert not os.listdir(tmp_path / "multi1")
    for workers in (4, 2):
        assert cli.main([*common, "--workers", str(workers),
                         "--batch-size", str(16 // workers),
                         "--checkpoint-dir", str(tmp_path / f"one{workers}")
                         ]) == 0

    def params(name):
        d = tmp_path / name
        (f,) = sorted(os.listdir(d))[-1:]
        return torch.load(d / f, weights_only=True)["params"]

    got, want, other = params("multi0"), params("one4"), params("one2")
    assert set(got) == set(want) == set(other)
    spread = max(float((want[k] - other[k]).abs().max()) for k in want)
    assert 0 < spread < 1e-2
    for k in want:
        assert float((got[k] - want[k]).abs().max()) <= 2 * spread, k


@pytest.mark.slow
def test_two_cli_processes_join_under_torchrun_env(tmp_path):
    """Two ``cli train --mode sync --multihost --device cpu`` processes
    given only torchrun's variables (``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; no ``--coordinator``
    and no ``DPS_*``) join one job: rank 0 reports both ranks'
    params bit-identical and rank 1 emits nothing."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("DPS_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "distributed_parameter_server_for_ml_training_tpu_torch.cli",
         "train", "--mode", "sync", "--multihost", "--workers", "2",
         "--batch-size", "2", "--compression", "int8", "--dtype", "float32",
         "--epochs", "1", "--synthetic", "--num-train", "8", "--num-test",
         "4", "--device", "cpu", "--emit-metrics"],
        env={**env, "WORLD_SIZE": "2", "RANK": str(rank),
             "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(port)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        finally:
            p.kill()
        logs.append(out.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n\n".join(logs)
    assert '"processes": 2' in logs[0] and \
        '"ranks_params_identical": true' in logs[0], logs[0]
    assert "METRICS_JSON" not in logs[1] and "rank 1 of 2" in logs[1]
