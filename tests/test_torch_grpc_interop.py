"""Each package's worker against each package's gRPC server, over real
gRPC on localhost: the port's ``PSWorker`` through its ``RemoteStore``
against the JAX ``ParameterService`` and against the port's, and the JAX
``PSWorker`` through the JAX ``RemoteStore`` against both. A 1-worker sync
epoch of a few batches of a tiny ResNet on the CPU (int8 pushes with error
feedback, the compressed-domain store, shared scales, delta fetches) must
reach the same global step with bit-equal store params against either
server, and the request frames the two servers record must be equal byte
for byte once the push token's 12-hex nonce is masked, and so for a
Bottleneck ResNet and a ViT with either package's worker; so must a
``local_sgd`` worker through the overlapped pipeline against an elastic,
expiring, bf16-fetch server of each package. Against the other package's
server with a cluster monitor, each package's worker sends its health
reports and the server's monitor ingests them.

Every server binds 127.0.0.1 at port 0 and is stopped by a fixture
finalizer; every client call has a deadline (``rpc_timeout``). A test
marked ``slow`` runs the port's ``cli serve`` with two ``cli worker
--device cpu`` processes."""

import math
import os
import re
import subprocess
import sys
import threading
from concurrent import futures
from pathlib import Path

import grpc
import jax
import numpy as np
import pytest
import torch

from distributed_parameter_server_for_ml_training_tpu.comms import \
    client as JC, service as JS
from distributed_parameter_server_for_ml_training_tpu.data.cifar import \
    synthetic_cifar100 as jax_synthetic
from distributed_parameter_server_for_ml_training_tpu.models import \
    ResNet as JaxResNet
from distributed_parameter_server_for_ml_training_tpu.ps.store import (
    ParameterStore as JaxStore, StoreConfig as JaxConfig)
from distributed_parameter_server_for_ml_training_tpu.ps.worker import (
    PSWorker as JaxWorker, WorkerConfig as JaxWorkerConfig)
from distributed_parameter_server_for_ml_training_tpu.telemetry import \
    ClusterMonitor as JaxMonitor
from distributed_parameter_server_for_ml_training_tpu.telemetry.registry \
    import MetricsRegistry as JaxRegistry
from distributed_parameter_server_for_ml_training_tpu.utils.pytree import \
    flatten_params as jax_flatten
from distributed_parameter_server_for_ml_training_tpu_torch.comms import \
    client as PC, service as PS, wire as PW
from distributed_parameter_server_for_ml_training_tpu_torch.data import \
    synthetic_cifar100
from distributed_parameter_server_for_ml_training_tpu_torch.models import \
    ResNet
from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
    PSWorker, ParameterStore, StoreConfig, WorkerConfig)
from distributed_parameter_server_for_ml_training_tpu_torch.telemetry import \
    ClusterMonitor, MetricsRegistry
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

REPO = Path(__file__).resolve().parents[1]
RPC_TIMEOUT = 30.0
STEPS = 4           # batches of 64 in the one epoch
TOKEN = re.compile(rb'"push_token": "[0-9a-f]{12}:')


@pytest.fixture(scope="module")
def setup():
    jm = JaxResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    v = jm.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32),
                train=False)
    tm = ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10)
    return (jm, jax_flatten(v["params"]), tm,
            synthetic_cifar100(64 * STEPS, 64, 10, seed=2),
            jax_synthetic(64 * STEPS, 64, 10, seed=2))


@pytest.fixture
def start_server():
    """``start(package, params) -> (address, store, recorded requests)``;
    every server started is stopped at teardown."""
    servers = []

    def start(package: str, params: dict, reports=None, **options):
        cfg = dict(mode="sync", total_workers=1, push_codec="int8",
                   **options)
        if package == "jax":
            store = JaxStore({k: v.copy() for k, v in params.items()},
                             JaxConfig(**cfg))
            monitor = None if reports is None else _monitor(
                JaxMonitor, JaxRegistry, store, reports)
            svc = JS.ParameterService(store, monitor=monitor)
        else:
            store = ParameterStore({k: v.copy() for k, v in params.items()},
                                   StoreConfig(**cfg))
            monitor = None if reports is None else _monitor(
                ClusterMonitor, MetricsRegistry, store, reports)
            svc = PS.ParameterService(store, monitor=monitor)
        recorded = []
        for rpc in ("register_worker", "push_gradrients",
                    "fetch_parameters", "job_finished"):
            body = getattr(svc, rpc)

            def wrapped(request, ctx, body=body, rpc=rpc):
                recorded.append((rpc, bytes(request)))
                return body(request, ctx)
            setattr(svc, rpc, wrapped)
        if package == "jax":
            server = grpc.server(futures.ThreadPoolExecutor(max_workers=4),
                                 options=JS.GRPC_OPTIONS)
            server.add_generic_rpc_handlers((svc.handlers(),))
            port = server.add_insecure_port("127.0.0.1:0")
            server.start()
        else:
            server, port = PS.serve(store, port=0, max_rpc_workers=4,
                                    service=svc, host="127.0.0.1")
        servers.append(server)
        return f"127.0.0.1:{port}", store, recorded

    yield start
    for server in servers:
        server.stop(grace=None).wait(10)


def _monitor(monitor_cls, registry_cls, store, reports: list):
    """A cluster monitor (not started) whose ingested reports are also
    appended to ``reports`` as (worker id, report)."""
    monitor = monitor_cls(store, registry=registry_cls())
    ingest = monitor.ingest

    def spy(worker_id, report):
        reports.append((worker_id, dict(report)))
        return ingest(worker_id, report)
    monitor.ingest = spy
    return monitor


def _masked(recorded):
    return [(rpc, TOKEN.sub(b'"push_token": "<nonce>:', req))
            for rpc, req in recorded]


def _bit_equal(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


def test_port_worker_trains_against_both_servers(setup, start_server):
    _, init, tm, ds, _ = setup
    _port_worker_against_both(start_server, init, tm, ds)


def _port_worker_against_both(start_server, init, tm, ds):
    runs = {}
    for package in ("jax", "port"):
        address, store, recorded = start_server(package, init)
        remote = PC.RemoteStore(address, rpc_timeout=RPC_TIMEOUT)
        worker = PSWorker(remote, tm, ds, WorkerConfig(
            batch_size=64, num_epochs=1, augment=False, device="cpu"))
        worker.run()
        remote.close()
        assert worker.result.error is None, worker.result.error
        assert worker.result.pushes_accepted == STEPS
        runs[package] = (store.snapshot(), recorded, worker.result)
    (jp, jstep), jrec, jres = runs["jax"]
    (pp, pstep), prec, pres = runs["port"]
    assert jstep == pstep == STEPS
    _bit_equal(pp, jp)
    assert any(not np.array_equal(pp[k], init[k]) for k in init)
    assert _masked(prec) == _masked(jrec)
    pushes = [req for rpc, req in prec if rpc == "push_gradrients"]
    assert len(pushes) == STEPS
    # Every push carried a token and the CRC trailer.
    for p in pushes:
        meta, frame = PS.unpack_msg(p)
        assert TOKEN.match(b'"push_token": "'
                           + meta["push_token"].encode()), meta
        assert PW.frame_checksum_ok(frame) is True
    # Delta fetches were sent, and the wire accounting names every RPC.
    assert any(b'"have_step"' in req for rpc, req in prec
               if rpc == "fetch_parameters")
    assert pres.wire == jres.wire and \
        pres.wire["rpc_counts"]["PushGradrients"] == STEPS


def _other_model(kind: str):
    """(flax model, its flat params, the port's model) for a Bottleneck
    ResNet (the ImageNet stem at 32 px) or a small ViT."""
    from distributed_parameter_server_for_ml_training_tpu.models import (
        resnet as jresnet, vit as jvit)
    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        import Bottleneck, ViT
    if kind == "bottleneck":
        kw = dict(stage_sizes=(1, 1), num_filters=8, num_classes=10,
                  imagenet_stem=True)
        jm = jresnet.ResNet(block_cls=jresnet.Bottleneck, **kw)
        tm = ResNet(block_cls=Bottleneck, **kw)
    else:
        kw = dict(patch_size=4, hidden_dim=64, depth=2, num_heads=2,
                  num_classes=10)
        jm = jvit.ViT(**kw)
        tm = ViT(**kw, image_size=32)
    v = jm.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32),
                train=False)
    return jm, jax_flatten(v["params"]), tm


@pytest.mark.parametrize("worker_package", ["port", "jax"])
@pytest.mark.parametrize("kind", ["bottleneck", "vit"])
def test_other_models_train_against_both_servers(setup, start_server, kind,
                                                 worker_package,
                                                 one_torch_thread):
    """A Bottleneck ResNet and a ViT (no batch statistics) over the wire:
    each package's worker reaches the same step with bit-equal store
    params against either server, and sends the same request bytes once
    the token's nonce is masked."""
    *_, ds, jds = setup
    jm, init, tm = _other_model(kind)
    if worker_package == "port":
        _port_worker_against_both(start_server, init, tm, ds)
        return
    runs = {}
    for package in ("port", "jax"):
        address, store, recorded = start_server(package, init)
        remote = JC.RemoteStore(address, rpc_timeout=RPC_TIMEOUT)
        worker = JaxWorker(remote, jm, jds, JaxWorkerConfig(
            batch_size=64, num_epochs=1, augment=False))
        worker.run()
        remote.close()
        assert worker.result.error is None, worker.result.error
        assert worker.result.pushes_accepted == STEPS
        runs[package] = (store.snapshot(), recorded)
    (jp, jstep), jrec = runs["jax"]
    (pp, pstep), prec = runs["port"]
    assert jstep == pstep == STEPS
    _bit_equal(pp, jp)
    assert _masked(prec) == _masked(jrec)


def test_jax_worker_trains_against_both_servers(setup, start_server):
    """ROADMAP §1 item 2's acceptance test: a JAX worker against the
    port's service reaches the step and params it reaches against the
    JAX service."""
    jm, init, _, _, jds = setup
    runs = {}
    for package in ("port", "jax"):
        address, store, recorded = start_server(package, init)
        remote = JC.RemoteStore(address, rpc_timeout=RPC_TIMEOUT)
        worker = JaxWorker(remote, jm, jds, JaxWorkerConfig(
            batch_size=64, num_epochs=1, augment=False))
        worker.run()
        remote.close()
        assert worker.result.error is None, worker.result.error
        assert worker.result.pushes_accepted == STEPS
        runs[package] = (store.snapshot(), recorded)
    (jp, jstep), jrec = runs["jax"]
    (pp, pstep), prec = runs["port"]
    assert jstep == pstep == STEPS
    _bit_equal(pp, jp)
    assert _masked(prec) == _masked(jrec)


#: The store options and worker modes of ROADMAP §1 item 3 over the wire.
MODE_OPTIONS = dict(fetch_codec="bf16", elastic=True, worker_timeout=30)
MODE_CONFIG = dict(k_step_mode="local_sgd", sync_steps=2, overlap=True)


@pytest.mark.parametrize("worker_package", ["port", "jax"])
def test_worker_modes_against_both_servers(setup, start_server,
                                           worker_package):
    """local_sgd (K=2) through the overlapped comms pipeline against an
    elastic, expiring, bf16-fetch server of each package: the same
    worker reaches the same step with bit-equal store params against
    either server, and sends the same request bytes once the token's
    nonce is masked."""
    jm, init, tm, ds, jds = setup
    runs = {}
    for package in ("jax", "port"):
        address, store, recorded = start_server(package, init,
                                                **MODE_OPTIONS)
        if worker_package == "port":
            remote = PC.RemoteStore(address, rpc_timeout=RPC_TIMEOUT)
            worker = PSWorker(remote, tm, ds, WorkerConfig(
                batch_size=64, num_epochs=1, augment=False, device="cpu",
                **MODE_CONFIG))
        else:
            remote = JC.RemoteStore(address, rpc_timeout=RPC_TIMEOUT)
            worker = JaxWorker(remote, jm, jds, JaxWorkerConfig(
                batch_size=64, num_epochs=1, augment=False, **MODE_CONFIG))
        worker.run()
        remote.close()
        assert worker.result.error is None, worker.result.error
        assert worker.result.pushes_accepted == STEPS // 2
        assert remote.config.elastic and remote.fetch_codec == "bf16"
        assert remote.membership_snapshot() == [0]
        runs[package] = (store.snapshot(), recorded)
    (jp, jstep), jrec = runs["jax"]
    (pp, pstep), prec = runs["port"]
    assert jstep == pstep == STEPS // 2
    _bit_equal(pp, jp)
    assert any(not np.array_equal(pp[k], init[k]) for k in init)
    assert _masked(prec) == _masked(jrec)


@pytest.mark.parametrize("worker_package", ["port", "jax"])
def test_health_reports_reach_the_other_packages_monitor(
        setup, start_server, worker_package):
    """Each package's worker against the OTHER package's server with a
    cluster monitor: the register reply advertises ``health_report``, and
    every report the worker piggybacks (from the first push on) reaches
    the server's monitor, step by step, with the int8 codec and error
    feedback named."""
    jm, init, tm, ds, jds = setup
    server = "jax" if worker_package == "port" else "port"
    reports = []
    address, store, _ = start_server(server, init, reports=reports)
    if worker_package == "port":
        remote = PC.RemoteStore(address, rpc_timeout=RPC_TIMEOUT)
        worker = PSWorker(remote, tm, ds, WorkerConfig(
            batch_size=64, num_epochs=1, augment=False, device="cpu"))
    else:
        remote = JC.RemoteStore(address, rpc_timeout=RPC_TIMEOUT)
        worker = JaxWorker(remote, jm, jds, JaxWorkerConfig(
            batch_size=64, num_epochs=1, augment=False))
    worker.run()
    remote.close()
    assert worker.result.error is None, worker.result.error
    assert remote.supports_health_report
    assert worker.result.pushes_accepted == STEPS
    assert {w for w, _ in reports} == {0}
    assert sorted({r["step"] for _, r in reports}) == list(
        range(1, STEPS + 1))
    for _, r in reports:
        assert r["push_codec"] == "int8+ef" and r["epoch"] == 0
        assert r["loss_finite"] and r["grad_finite"]
        assert math.isfinite(r["loss"]) and r["grad_norm"] > 0
    assert store.global_step == STEPS


def test_port_client_refuses_a_sharded_registration(start_server, setup):
    """A garbled shard map in a reply is refused, never adopted: the
    client keeps the map it holds (none before a sharded registration),
    as the JAX client does; a valid one is adopted."""
    from distributed_parameter_server_for_ml_training_tpu_torch.ps \
        .sharding import ShardInfo
    _, init, _, _, _ = setup
    address, _, _ = start_server("port", init)
    remote = PC.RemoteStore(address, rpc_timeout=RPC_TIMEOUT)
    remote._note_shard_map({"shard_map": {"version": 1}})
    assert remote.shard_map is None
    good = ShardInfo(0, 2, ["a:1", "b:2"]).shard_map()
    remote._note_shard_map({"shard_map": good})
    remote._note_shard_map({"shard_map": dict(good, version=9,
                                              shard_count=3)})
    assert remote.shard_map == good and remote._shard_map_version == 1
    wid, total = remote.register_worker("w")
    assert remote.shard_map is None           # an unsharded server
    assert (wid, total) == (0, 1)
    assert remote.supports_checksum and remote.supports_delta_fetch
    assert remote.repush_last(0) is None     # nothing pushed yet
    # A single-job server answers the admin plane's SubmitJob
    # FAILED_PRECONDITION, as a JAX server without --jobs does.
    for call in (lambda: remote.submit_job(""),
                 lambda: remote.drain_job("x")):
        with pytest.raises(grpc.RpcError) as err:
            call()
        assert err.value.code() == grpc.StatusCode.FAILED_PRECONDITION
    remote.job_finished(wid)
    remote.close()
    # Client-side faults are served: the spec arms the JAX package's
    # schedule, given as an argument or through DPS_FAULTS_CLIENT.
    from distributed_parameter_server_for_ml_training_tpu.comms.faults \
        import FaultInjector as JaxInjector
    spec = "seed=1;push.unavailable@p=0.3;fetch.drop_reply@n=2"
    faulty = PC.RemoteStore(address, faults=spec)
    want = [JaxInjector(spec).schedule_preview(op, 30)
            for op in ("PushGradrients", "FetchParameters")]
    assert [faulty.faults.schedule_preview(op, 30) for op in (
        "PushGradrients", "FetchParameters")] == want
    faulty.close()
    os.environ["DPS_FAULTS_CLIENT"] = spec
    try:
        faulty = PC.RemoteStore(address)
    finally:
        del os.environ["DPS_FAULTS_CLIENT"]
    assert faulty.faults.spec == spec and faulty.faults.side == "client"
    faulty.close()
    # A client asking for a job against a server without tenancy lands in
    # the only job there is and never labels an envelope.
    tenant = PC.RemoteStore(address, job="vision", rpc_timeout=RPC_TIMEOUT)
    wid, _ = tenant.register_worker("t")
    meta = {}
    tenant._attach_job(meta)
    assert not tenant.supports_jobs and meta == {} and wid >= 0
    tenant.close()


def _read_port(proc, timeout: float) -> int:
    """The bound port from ``cli serve``'s 'parameter server up on :P'."""
    found = {}

    def scan():
        for line in proc.stderr:
            m = re.search(r"parameter server up on :(\d+)", line)
            if m:
                found["port"] = int(m.group(1))
                return

    t = threading.Thread(target=scan, daemon=True)
    t.start()
    t.join(timeout)
    if "port" not in found:
        raise AssertionError("cli serve did not come up")
    return found["port"]


@pytest.mark.slow
def test_cli_serve_and_two_cli_workers(tmp_path):
    """The reference's topology as processes: ``cli serve`` and two ``cli
    worker --device cpu`` (full ResNet-18, 1 step each), every process
    exiting 0 within the timeout."""
    cli = [sys.executable, "-m",
           "distributed_parameter_server_for_ml_training_tpu_torch.cli"]
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = []
    try:
        server = subprocess.Popen(
            cli + ["serve", "--mode", "async", "--workers", "2",
                   "--push-codec", "int8", "--port", "0", "--emit-metrics"],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        procs.append(server)
        port = _read_port(server, 120)
        workers = [subprocess.Popen(
            cli + ["worker", "--server", f"127.0.0.1:{port}",
                   "--worker-name", f"w{i}", "--synthetic", "--num-train",
                   "64", "--num-test", "32", "--batch-size", "32",
                   "--epochs", "1", "--device", "cpu", "--emit-metrics"],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i in range(2)]
        procs += workers
        outs = [w.communicate(timeout=600)[0] for w in workers]
        s_out, s_err = server.communicate(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [w.returncode for w in workers] == [0, 0], outs
    assert server.returncode == 0, s_err
    assert all("METRICS_JSON" in o and '"PushGradrients": 1' in o
               for o in outs), outs
    assert '"global_steps_completed": 2' in s_out, s_out


@pytest.mark.parametrize("argv,item", [
    (["perf", "check"], "item 11"),
], ids=lambda v: "_".join(v) if isinstance(v, list) else v)
def test_cli_flags_of_later_slices_are_refused(argv, item):
    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    with pytest.raises(NotImplementedError, match=f"ROADMAP §1 {item}"):
        cli.main(argv)


@pytest.mark.parametrize("argv", [
    ["serve", "--jobs", "a:weight=1"],
    ["worker", "--job", "vision", "--device", "cpu"],
    ["loadgen", "--targets", "h:1", "--job", "vision"],
], ids=lambda v: "_".join(v))
def test_cli_tenancy_flags_are_served(argv, monkeypatch):
    """``serve --jobs``, ``worker --job`` and ``loadgen --job``, refused
    until tenancy landed, reach what they drive: the service's job table,
    the worker's ``RemoteStore(job=)``, the load generator's stamp."""
    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        import loadgen

    class Reached(Exception):
        pass

    seen = {}

    def stop(name):
        def fn(*args, **kwargs):
            seen[name] = (args, kwargs)
            raise Reached
        return fn

    monkeypatch.setattr(PS, "serve", stop("serve"))
    monkeypatch.setattr(PC, "RemoteStore", stop("RemoteStore"))
    monkeypatch.setattr(loadgen, "run_loadgen", stop("run_loadgen"))
    with pytest.raises(Reached):
        cli.main(argv + (["--port", "0", "--num-classes", "10",
                          "--no-health-monitor"]
                         if argv[0] == "serve" else
                         ["--synthetic", "--num-train", "8", "--num-test",
                          "8"] if argv[0] == "worker" else []))
    if argv[0] == "serve":
        svc = seen["serve"][1]["service"]
        assert svc.jobs.names() == ["default", "a"]
        assert svc.qos is svc.jobs.qos
        assert svc.jobs.qos_table()["a"] == (1.0, 8)
    elif argv[0] == "worker":
        assert seen["RemoteStore"][1]["job"] == "vision"
    else:
        assert seen["run_loadgen"][1]["job"] == "vision"


@pytest.mark.parametrize("argv", [
    ["serve", "--faults", "seed=7;push.drop_reply@n=2;fetch.delay=0@p=0.4",
     "--no-health-monitor", "--port", "0"],
    ["worker", "--faults", "seed=7;push.unavailable@n=3;fetch.deadline@"
     "every=4", "--device", "cpu", "--server", "127.0.0.1:1"],
], ids=lambda v: "_".join(v[:2]))
def test_cli_faults_arm_the_jax_schedule(argv, tiny_cli, monkeypatch):
    """``serve --faults`` and ``worker --faults``, refused until the serve
    tier landed, arm an injector whose schedule is the JAX package's for
    the same spec, on each of the four RPCs (the command is cut short
    where the service is served or the worker starts)."""
    from distributed_parameter_server_for_ml_training_tpu.comms.faults \
        import FaultInjector as JaxInjector
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import \
        worker as W
    cli, seen = tiny_cli, {}

    class Service(PS.ParameterService):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["faults"] = self.faults

    class Worker:
        def __init__(self, store, *a, **kw):
            seen["faults"] = store.faults

    def cut(*a, **kw):
        raise KeyboardInterrupt

    monkeypatch.setattr(PS, "ParameterService", Service)
    monkeypatch.setattr(PS, "serve", cut)
    monkeypatch.setattr(W, "PSWorker", Worker)
    monkeypatch.setattr(Worker, "start", cut, raising=False)
    with pytest.raises(KeyboardInterrupt):
        cli.main(argv)
    spec = argv[argv.index("--faults") + 1]
    assert seen["faults"].spec == spec
    assert seen["faults"].side == ("server" if argv[0] == "serve"
                                   else "client")
    for op in ("RegisterWorker", "PushGradrients", "FetchParameters",
               "JobFinished"):
        assert seen["faults"].schedule_preview(op, 40) \
            == JaxInjector(spec).schedule_preview(op, 40)


@pytest.fixture
def tiny_cli(monkeypatch):
    """The CLI over a tiny ResNet (10 classes) and 16 synthetic images:
    what is checked is that the flag is served, not a run."""
    from distributed_parameter_server_for_ml_training_tpu_torch import cli, \
        models

    def get_model(name, num_classes=10, device="cpu", **kw):
        return ResNet(stage_sizes=(1, 1), num_filters=8,
                      num_classes=num_classes).to(device)

    monkeypatch.setattr(models, "get_model", get_model)
    monkeypatch.setattr(cli, "_load_dataset",
                        lambda args: synthetic_cifar100(8, 8, 10, seed=0))
    return cli


def _tiny_primaries(n: int):
    """n port shard primaries on 127.0.0.1:0 over the tiny ResNet's
    partition (async, int8 pushes); returns (stores, servers, peers)."""
    from distributed_parameter_server_for_ml_training_tpu_torch.ps \
        .sharding import ShardInfo, partition_keys
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .pytree import params_to_jax
    flat, _ = params_to_jax(ResNet(stage_sizes=(1, 1), num_filters=8,
                                   num_classes=10))
    parts = partition_keys(flat, n)
    stores, svcs, servers, addrs = [], [], [], []
    for i in range(n):
        store = ParameterStore({k: flat[k] for k in parts[i]}, StoreConfig(
            mode="async", total_workers=1, push_codec="int8",
            shard_index=i, shard_count=n))
        svc = PS.ParameterService(store)
        server, port = PS.serve(store, port=0, service=svc,
                                host="127.0.0.1")
        stores.append(store)
        svcs.append(svc)
        servers.append(server)
        addrs.append(f"127.0.0.1:{port}")
    for i, svc in enumerate(svcs):
        svc.sharding = ShardInfo(i, n, addrs)
    return stores, servers, ",".join(addrs)


@pytest.mark.parametrize("argv", [
    ["serve", "--store-backend", "native"],
    ["train", "--store-backend", "native", "--device", "cpu"],
    ["worker", "--shards", "h:1,h:2", "--device", "cpu"],
    ["worker", "--job", "vision", "--shards", "h:1,h:2", "--device", "cpu"],
], ids=lambda v: "_".join(v))
def test_cli_flags_of_item_9_first_part_are_served(argv, tiny_cli, capsys,
                                                   one_torch_thread):
    """The flags ROADMAP §1 item 9's first part serves, refused until it
    landed: ``serve --store-backend native`` serves a worker over the C++
    arena, ``train --store-backend native`` trains async over it, and
    ``worker --shards`` trains against two shard primaries through a
    ``ShardedRemoteStore``; ``--job`` with ``--shards`` is refused in the
    JAX CLI's words."""
    import socket

    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .metrics import parse_metrics_lines
    cli = tiny_cli
    if "--job" in argv:
        with pytest.raises(SystemExit, match="--job does not compose with "
                                             "--shards"):
            cli.main(argv)
        return
    if argv[0] == "serve":
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        rc = {}
        server = threading.Thread(target=lambda: rc.update(rc=cli.main(
            argv + ["--mode", "async", "--workers", "1", "--num-classes",
                    "10", "--push-codec", "int8", "--port", str(port),
                    "--no-health-monitor", "--emit-metrics"])),
            daemon=True)
        server.start()
        assert cli.main(["worker", "--server", f"127.0.0.1:{port}",
                         "--synthetic", "--batch-size", "8", "--epochs",
                         "1", "--device", "cpu"]) == 0
        server.join(60)
        assert not server.is_alive() and rc == {"rc": 0}
        rows = parse_metrics_lines(capsys.readouterr().out)
        assert rows[-1]["store_backend"] == "native"
        assert rows[-1]["global_steps_completed"] == 1
    elif argv[0] == "train":
        assert cli.main(argv + ["--mode", "async", "--workers", "1",
                                "--batch-size", "8", "--epochs", "1",
                                "--synthetic", "--emit-metrics"]) == 0
        server = next(r for r in parse_metrics_lines(
            capsys.readouterr().out) if "store_backend" in r)
        assert server["store_backend"] == "native"
        assert server["global_steps_completed"] == 1
    else:
        stores, servers, peers = _tiny_primaries(2)
        try:
            assert cli.main(["worker", "--shards", peers, "--synthetic",
                             "--batch-size", "8", "--epochs", "1",
                             "--device", "cpu"]) == 0
        finally:
            for server in servers:
                server.stop(grace=None)
        assert [s.global_step for s in stores] == [1, 1]


@pytest.mark.parametrize("argv", [
    ["serve", "--telemetry"],
    ["serve", "--metrics-port", "0"],
    ["serve", "--incidents-dir", "incidents"],
    ["serve", "--no-memory-telemetry"],
], ids=lambda v: "_".join(v))
def test_cli_telemetry_flags_are_served(argv):
    """The serve flags of ROADMAP §1 item 8's second part, refused until
    it landed, parse."""
    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    cli.build_parser().parse_args(argv)


@pytest.mark.parametrize("argv", [
    ["serve", "--checkpoint-dir", "ckpt"],
    ["serve", "--checkpoint-dir", "ckpt", "--restore"],
    ["serve", "--store-backend", "device"],
], ids=lambda v: "_".join(v))
def test_cli_checkpoint_and_device_store_flags_are_served(argv):
    """The flags of ROADMAP §1 items 4 and 5 parse;
    ``--restore`` without a directory is refused as in JAX."""
    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    cli.build_parser().parse_args(argv)
    if "--restore" in argv:
        with pytest.raises(SystemExit, match="needs --checkpoint-dir"):
            cli.main(["serve", "--restore"])


@pytest.mark.parametrize("model", ["vit_tiny", "resnet50"])
def test_cli_serve_and_worker_train_any_registry_model(model, capsys,
                                                       one_torch_thread):
    """``cli serve --model M`` in a thread and ``cli worker --model M
    --device cpu`` against it (full width, 2 steps of 4 images, int8
    pushes): the worker finishes, every push applies, the server exits
    0."""
    import socket

    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .metrics import parse_metrics_lines
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    rc = {}
    server = threading.Thread(target=lambda: rc.update(rc=cli.main([
        "serve", "--mode", "async", "--workers", "1", "--model", model,
        "--push-codec", "int8", "--port", str(port), "--emit-metrics"])),
        daemon=True)
    server.start()
    assert cli.main(["worker", "--server", f"127.0.0.1:{port}", "--model",
                     model, "--synthetic", "--num-train", "8", "--num-test",
                     "4", "--batch-size", "4", "--epochs", "1", "--device",
                     "cpu", "--dtype", "float32", "--emit-metrics"]) == 0
    server.join(60)
    assert not server.is_alive() and rc == {"rc": 0}
    rows = parse_metrics_lines(capsys.readouterr().out)
    worker = next(r for r in rows if "worker_id" in r)
    store = next(r for r in rows if "global_steps_completed" in r)
    assert worker["local_steps_completed"] == 2
    assert store["global_steps_completed"] == 2
