"""Multi-job tenancy across the two packages, over localhost gRPC and
through checkpoints.

Each package's ``RemoteStore(job=...)`` against each package's tenancy
server (``ParameterService(jobs=JobManager(...))`` on 127.0.0.1:0): the
registration adopts the job the server reports (a legacy client lands in
``default``, a garbled id too), every envelope after it carries the job,
``submit_job``/``drain_job`` work over the wire, and the job stores end
bit-equal in all four pairings. Then the per-job checkpoint lineages: the
port's ``cli serve --jobs --checkpoint-dir D`` (in a thread) writes
``D/job-<name>/``, which JAX's ``restore_server_state`` restores into the
same job and refuses for another, each lineage holding only its own
job's push tokens; a restarted ``cli serve --restore`` restores every
job's step; and the same the other way round, from lineages the JAX
package writes in that layout.
"""

import functools
import os
import socket
import threading
from concurrent import futures

import grpc
import numpy as np
import pytest

from distributed_parameter_server_for_ml_training_tpu.checkpoint import (
    load_store_record as jax_load, restore_server_state as jax_restore,
    save_store as jax_save)
from distributed_parameter_server_for_ml_training_tpu.comms import \
    client as JC, service as JS
from distributed_parameter_server_for_ml_training_tpu.ops.compression \
    import compress_push as jax_compress_push
from distributed_parameter_server_for_ml_training_tpu.ps import \
    tenancy as JT
from distributed_parameter_server_for_ml_training_tpu.ps.store import (
    ParameterStore as JaxStore, StoreConfig as JaxConfig)
from distributed_parameter_server_for_ml_training_tpu.telemetry.registry \
    import MetricsRegistry as JaxRegistry
from distributed_parameter_server_for_ml_training_tpu_torch import cli
from distributed_parameter_server_for_ml_training_tpu_torch.checkpoint \
    import (load_store_record, restore_server_state, save_store)
from distributed_parameter_server_for_ml_training_tpu_torch.comms import \
    client as PC, service as PS
from distributed_parameter_server_for_ml_training_tpu_torch.ps import \
    tenancy as PT
from distributed_parameter_server_for_ml_training_tpu_torch.ps.store import (
    ParameterStore, StoreConfig)
from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
    .registry import MetricsRegistry
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

SHAPES = {"conv/kernel": (3, 3, 3, 8), "conv/bias": (8,),
          "dense/kernel": (8, 10), "dense/bias": (10,)}
JOBS = ("joba:mode=sync,sync_quorum=1,total_workers=1;"
        "jobb:mode=async,staleness_bound=4")
RPC_TIMEOUT = 10.0

#: Each package: (service, tenancy, store, config, registry, client).
PKGS = {"jax": (JS, JT, JaxStore, JaxConfig, JaxRegistry, JC),
        "port": (PS, PT, ParameterStore, StoreConfig, MetricsRegistry, PC)}


def _params():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(seed: int) -> dict:
    rng = np.random.default_rng(100 + seed)
    g = {k: (rng.standard_normal(s) * 1e-2).astype(np.float32)
         for k, s in SHAPES.items()}
    return jax_compress_push(g, {k: "int8" for k in g})


def _server(pkg: str):
    """A tenancy server of ``pkg`` on 127.0.0.1:0; returns (service,
    job manager, server, address, recorded push metas)."""
    svc_mod, tenancy, store, config, registry, _ = PKGS[pkg]
    primary = store(_params(), config(mode="async", total_workers=2,
                                      push_codec="int8"))
    jobs = tenancy.JobManager(primary, tenancy.parse_jobs_spec(JOBS),
                              registry=registry())
    svc = svc_mod.ParameterService(primary, jobs=jobs)
    metas = []
    body = svc.push_gradrients

    def recorded(request, ctx):
        metas.append(JS.unpack_msg(request)[0])
        return body(request, ctx)

    svc.push_gradrients = recorded
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=8),
                         options=JS.GRPC_OPTIONS)
    server.add_generic_rpc_handlers((svc.handlers(),))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return svc, jobs, server, f"127.0.0.1:{port}", metas


def _pairing(client_pkg: str, server_pkg: str, capsys) -> dict:
    client = PKGS[client_pkg][5]
    svc, jobs, server, address, metas = _server(server_pkg)
    out = {"replies": []}
    try:
        remotes = {}
        for name, job in (("legacy", None), ("b", "jobb"), ("a", "joba"),
                          ("garbled", "::x")):
            r = client.RemoteStore(address, job=job,
                                   rpc_timeout=RPC_TIMEOUT)
            wid, total = r.register_worker(name)
            remotes[name] = (r, wid)
            out["replies"].append((name, wid, total, r.job,
                                   r.supports_jobs))
        rb, wb = remotes["b"]
        for seed in (1, 2):
            _, step = rb.fetch(wb)
            out["replies"].append(rb.push(wb, _grads(seed), step))
        ra, wa = remotes["a"]
        out["replies"].append(ra.push(wa, _grads(3), 0))
        rg, wg = remotes["garbled"]
        out["replies"].append(rg.push(wg, _grads(4), 0))
        out["replies"].append(rb.fetch(wb, have_step=2)[1])
        admin = remotes["legacy"][0]
        out["replies"].append(admin.submit_job("jobc:mode=async,weight=2"))
        out["replies"].append(admin.drain_job("jobc"))
        with pytest.raises(grpc.RpcError) as bad:
            admin.submit_job("default")
        out["replies"].append(bad.value.code())
        out["stores"] = {
            name: (lambda s: (s[1], {k: v.tobytes()
                                     for k, v in s[0].items()}))(
                jobs.store_for(name).snapshot())
            for name in jobs.names()}
        out["journals"] = {name: svc.journal_snapshot(job=name)
                           for name in jobs.names()}
        out["labels"] = [m.get("job") for m in metas]
        for r, _ in remotes.values():
            r.close()
    finally:
        server.stop(grace=None)
    capsys.readouterr()
    return out


@pytest.mark.parametrize("client_pkg", ["jax", "port"])
def test_each_client_against_each_tenancy_server(client_pkg, capsys):
    got = {s: _pairing(client_pkg, s, capsys) for s in ("jax", "port")}
    port, jax = got["port"], got["jax"]
    assert port["replies"] == jax["replies"]
    assert port["stores"] == jax["stores"]
    assert port["labels"] == jax["labels"]
    # The nonces are the clients' own, so journals compare by job prefix.
    for j in ("default", "joba", "jobb"):
        assert [(e["count"], e["accepted"], e["worker_id"], e["step"])
                for e in port["journals"][j]] == \
            [(e["count"], e["accepted"], e["worker_id"], e["step"])
             for e in jax["journals"][j]]
    regs = port["replies"][:4]
    assert regs[0][1:] == (0, 2, "default", True)
    assert regs[1][1:4] == (8192, 2, "jobb") and regs[1][4]
    assert regs[2][1:4] == (4096, 1, "joba")
    assert regs[3][1:4] == (1, 2, "default")
    assert port["replies"][4:8] == [True, True, True, True]
    assert port["replies"][8] == 2
    assert port["replies"][9]["submitted"] == "jobc"
    assert port["replies"][10] == {"drained": True,
                                   "jobs": ["default", "joba", "jobb"]}
    assert port["replies"][11] == grpc.StatusCode.INVALID_ARGUMENT
    # Every envelope after the handshake carries the server's job.
    assert port["labels"] == ["jobb", "jobb", "joba", "default"]
    assert [port["stores"][j][0] for j in ("default", "joba", "jobb")] \
        == [1, 1, 2]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_serve(directory: str, restore: bool, pushes: dict) -> tuple:
    """The port's ``cli serve --jobs`` in a thread with ``--checkpoint-dir``:
    ``pushes[job]`` pushes from a client of each job, then a legacy
    worker of ``default`` pushes once and finishes, which ends the serve
    loop (its final snapshots written). Returns (rc, each client's push
    nonce by job)."""
    port = _free_port()
    argv = ["serve", "--jobs", "joba;jobb:mode=async", "--mode", "async",
            "--workers", "1", "--model", "vit_tiny", "--image-size", "32",
            "--num-classes", "10", "--push-codec", "none",
            "--no-health-monitor", "--port", str(port),
            "--checkpoint-dir", directory, "--checkpoint-interval", "3600"]
    rc = {}
    t = threading.Thread(target=lambda: rc.update(
        rc=cli.main(argv + (["--restore"] if restore else []))),
        daemon=True)
    t.start()
    address = f"127.0.0.1:{port}"
    tokens = {}
    legacy = PC.RemoteStore(address, rpc_timeout=60.0)
    wid, _ = legacy.register_worker("legacy")
    params, step = legacy.fetch(wid)
    rng = np.random.default_rng(7)
    for job, n in pushes.items():
        r = PC.RemoteStore(address, job=job, rpc_timeout=RPC_TIMEOUT)
        jw, _ = r.register_worker(job)
        for i in range(n):
            _, jstep = r.fetch(jw)
            r.push(jw, {k: (rng.standard_normal(v.shape) * 1e-3).astype(
                np.float32) for k, v in params.items()}, jstep)
        tokens[job] = r._push_nonce
        r.close()
    legacy.push(wid, {k: np.zeros_like(v) for k, v in params.items()},
                step)
    tokens["default"] = legacy._push_nonce
    legacy.job_finished(wid)
    legacy.close()
    t.join(60)
    assert not t.is_alive()
    return rc.get("rc"), tokens


def test_port_cli_lineages_restore_through_jax(tmp_path, capsys,
                                               one_torch_thread):
    """``cli serve --jobs`` writes one lineage per job under
    ``D/job-<name>/``; JAX's ``restore_server_state`` takes each into
    the same job and refuses it for another; no lineage holds another
    job's token; ``cli serve --restore`` restores each job's step."""
    d = str(tmp_path)
    rc, tokens = _cli_serve(d, False, {"joba": 2, "jobb": 3})
    assert rc == 0
    assert {"job-joba", "job-jobb"} <= set(os.listdir(d))
    init, _ = load_store_record(d)
    jprimary = JaxStore({k: v.copy() for k, v in init.items()},
                        JaxConfig(mode="async", total_workers=1,
                                  push_codec="none"))
    jm = JT.JobManager(jprimary, JT.parse_jobs_spec("joba;jobb:mode=async"),
                       registry=JaxRegistry())
    jsvc = JS.ParameterService(jprimary, jobs=jm)
    for job, steps in (("joba", 2), ("jobb", 3)):
        jdir = os.path.join(d, f"job-{job}")
        params, meta = load_store_record(jdir)
        assert meta["job"] == job and meta["global_step"] == steps
        nonces = {e["nonce"] for e in meta["push_journal"]}
        assert nonces == {f"{job}::{tokens[job]}"}
        step, n = jax_restore(jm.store_for(job), jsvc, jdir)
        assert (step, n) == (steps, 1)
        jp, _ = jm.store_for(job).snapshot()
        assert all(jp[k].tobytes() == params[k].tobytes() for k in params)
        other = "jobb" if job == "joba" else "joba"
        with pytest.raises(ValueError, match="cross-job"):
            jax_restore(jm.store_for(other), jsvc, jdir)
        with pytest.raises(ValueError, match="cross-job"):
            jax_restore(jprimary, jsvc, jdir)
    assert {e["nonce"].split("::")[0]
            for e in jsvc.journal_snapshot()} == {"joba", "jobb"}
    # The default lineage journals only the default job's token, bare.
    assert [e["nonce"] for e in load_store_record(d)[1]["push_journal"]] \
        == [tokens["default"]]
    capsys.readouterr()
    rc, _ = _cli_serve(d, True, {})
    err = capsys.readouterr().err
    assert rc == 0 and "jobs=3" in err
    assert "restored job 'joba' at step 2 (+1 journaled push tokens)" in err
    assert "restored job 'jobb' at step 3 (+1 journaled push tokens)" in err


def test_jax_lineages_restore_through_the_port(tmp_path, capsys):
    """The other way round: lineages the JAX package writes in ``cli
    serve``'s layout (``save_store`` of each job's store with the job's
    journal) restore into the port's job stores, and a cross-job restore
    is refused."""
    svc, jobs, server, address, _ = _server("jax")
    try:
        for job, n in (("joba", 1), ("jobb", 2)):
            r = JC.RemoteStore(address, job=job, rpc_timeout=RPC_TIMEOUT)
            wid, _ = r.register_worker(job)
            for i in range(n):
                r.push(wid, _grads(10 + i), r.fetch(wid)[1])
            r.close()
    finally:
        server.stop(grace=None)
    d = str(tmp_path)
    jax_save(jobs.store_for("default"), d, journal_fn=functools.partial(
        svc.journal_snapshot, job="default"))
    for job in ("joba", "jobb"):
        jax_save(jobs.store_for(job), os.path.join(d, f"job-{job}"),
                 journal_fn=functools.partial(svc.journal_snapshot,
                                              job=job))
    primary = ParameterStore(_params(), StoreConfig(
        mode="async", total_workers=2, push_codec="int8"))
    pm = PT.JobManager(primary, PT.parse_jobs_spec(JOBS),
                       registry=MetricsRegistry())
    psvc = PS.ParameterService(primary, jobs=pm)
    for job, steps in (("joba", 1), ("jobb", 2)):
        jdir = os.path.join(d, f"job-{job}")
        params, meta = jax_load(jdir)
        assert {e["nonce"].split("::")[0] for e in meta["push_journal"]} \
            == {job}
        # One journal entry: a client's pushes share its nonce.
        assert restore_server_state(pm.store_for(job), psvc, jdir) \
            == (steps, 1)
        pp, _ = pm.store_for(job).snapshot()
        assert all(pp[k].tobytes() == params[k].tobytes() for k in params)
        other = "jobb" if job == "joba" else "joba"
        with pytest.raises(ValueError, match="cross-job"):
            restore_server_state(pm.store_for(other), psvc, jdir)
    assert restore_server_state(primary, psvc, d) == (0, 0)
    # The port's lineage of a restored job is JAX's, record for record.
    save_store(pm.store_for("jobb"), str(tmp_path / "again"),
               journal_fn=functools.partial(psvc.journal_snapshot,
                                            job="jobb"))
    assert load_store_record(str(tmp_path / "again"))[1]["push_journal"] == \
        jax_load(os.path.join(d, "job-jobb"))[1]["push_journal"]
    capsys.readouterr()
