"""The port's fetch load generator (``comms/loadgen.py``) and the
serve-tier verbs: merged reports, parsed lines and child argv equal to
the JAX package's; ``run_loadgen`` for half a second in each mode
against a port primary and a port replica with no errors; ``cli
loadgen`` and ``cli infer`` in this process against a canary replica,
whose candidate step is promoted by one round of quality feedback and
rolled back by a second. The ``slow`` test runs ``cli serve
--autoscale`` (whose pool spawns a ``cli replica`` process) and ``cli
loadgen --scale-out 2`` against that replica."""

import json
import os
import re
import signal
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from distributed_parameter_server_for_ml_training_tpu.comms import \
    loadgen as JL
from distributed_parameter_server_for_ml_training_tpu.telemetry.registry \
    import Histogram as JaxHistogram
from distributed_parameter_server_for_ml_training_tpu_torch import cli
from distributed_parameter_server_for_ml_training_tpu_torch.comms import \
    loadgen as PL
from distributed_parameter_server_for_ml_training_tpu_torch.comms.replica \
    import ReplicaServer
from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
    .registry import LATENCY_BUCKETS
from torch_serve_tier import grads, primary, wait

REPO = Path(__file__).resolve().parents[1]


def _report(samples_s, mode="delta", targets=("t:1",), qps=None):
    h = JaxHistogram("loadgen_latency", buckets=LATENCY_BUCKETS)
    for v in samples_s:
        h.observe(v)
    return {"targets": list(targets), "mode": mode, "concurrency": 2,
            "duration_s": 1.0 + len(samples_s) / 1000,
            "fetches_ok": len(samples_s), "fetches_err": 1,
            "not_modified": len(samples_s) // 2,
            "bytes_in": 1000 * len(samples_s),
            "qps": qps if qps is not None else float(len(samples_s)),
            "mb_per_s": 1.25, "latency_hist": h.snapshot()}


def test_reports_merge_and_parse_as_jax():
    reports = [_report([0.001 * (i + 1) for i in range(50)]),
               _report([0.05] * 20, mode="full", targets=("t:2", "t:1")),
               _report([0.0004, 2.0, 0.3], qps=3.3333)]
    for subset in (reports[:1], reports, reports[::-1]):
        assert PL.merge_loadgen_reports(subset) == \
            JL.merge_loadgen_reports(subset)
    histless = {k: v for k, v in reports[0].items() if k != "latency_hist"}
    for bad in ([], [reports[1], histless]):
        with pytest.raises(ValueError) as jerr:
            JL.merge_loadgen_reports(bad)
        with pytest.raises(ValueError) as perr:
            PL.merge_loadgen_reports(bad)
        assert str(perr.value) == str(jerr.value)
    line = PL.LOADGEN_JSON_PREFIX + json.dumps(reports[0])
    for text in ("noise\n" + line, line + "\n" + PL.LOADGEN_JSON_PREFIX
                 + "{bad", "[sup] " + line, "nothing here", "",
                 PL.LOADGEN_JSON_PREFIX + "[1, 2]"):
        assert PL.parse_loadgen_json(text) == JL.parse_loadgen_json(text)
    got = PL.loadgen_child_argv("a:1,b:2", 1.5, 3, "delta", python="py")
    want = JL.loadgen_child_argv("a:1,b:2", 1.5, 3, "delta", python="py")
    assert got == [a.replace("_tpu.cli", "_tpu_torch.cli") for a in want]
    # ``--job`` rides the scale-out children's argv, as JAX's does.
    got = PL.loadgen_child_argv("a:1", 1, 1, "full", job="a,b",
                                python="py")
    want = JL.loadgen_child_argv("a:1", 1, 1, "full", job="a,b",
                                 python="py")
    assert got == [a.replace("_tpu.cli", "_tpu_torch.cli") for a in want]
    assert got[got.index("--job") + 1] == "a,b"


@pytest.mark.parametrize("mode", ["full", "delta", "infer"])
def test_run_loadgen_against_a_primary_and_a_replica(mode):
    store, svc, server, paddr = primary()
    rep = ReplicaServer(paddr, poll_interval=0.01, canary=mode == "infer")
    try:
        raddr = f"127.0.0.1:{rep.start()}"
        assert wait(lambda: rep.view()["synced"])
        targets = [raddr] if mode == "infer" else [paddr, raddr]
        res = PL.run_loadgen(targets, duration_s=0.5, concurrency=2,
                             mode=mode, rpc_timeout=5.0)
    finally:
        rep.stop()
        server.stop(grace=None)
    assert res["fetches_err"] == 0 and res["fetches_ok"] > 0
    assert res["latency_hist"]["count"] == res["fetches_ok"]
    assert set(res["per_target"]) == set(targets)
    assert all(row["ok"] > 0 for row in res["per_target"].values())
    if mode == "delta":
        assert res["not_modified"] == res["fetches_ok"]
    if mode == "infer":
        assert res["arms"]["stable"]["ok"] == res["fetches_ok"]
        assert res["arms"]["stable"]["serving_steps"] == [0]
    # The job stamp: threads round-robin over the list, and the result
    # breaks the fetches down by job (a server without tenancy serves
    # every one from its single job).
    store, svc, server, paddr = primary()
    try:
        res = PL.run_loadgen([paddr], duration_s=0.2, concurrency=2,
                             mode=mode if mode != "infer" else "full",
                             rpc_timeout=5.0, job="vision,ranker")
    finally:
        server.stop(grace=None)
    assert set(res["jobs"]) == {"vision", "ranker"}
    assert sum(r["ok"] for r in res["jobs"].values()) == res["fetches_ok"]
    assert all(r["ok"] > 0 and r["err"] == 0 for r in res["jobs"].values())


def _cli(argv, capsys, prefix):
    rc = cli.main(argv)
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith(prefix))
    return rc, json.loads(line[len(prefix):])


def test_cli_infer_promotes_then_rolls_back(capsys):
    """``cli infer`` rounds against a canary replica: quality 0.9 on both
    arms promotes the candidate step; after the next step, quality 0.1
    (below the promoted window's mean) rolls it back, and the step is
    fenced. ``cli loadgen`` runs in each mode against the replica."""
    store, svc, server, paddr = primary()
    rep = ReplicaServer(paddr, poll_interval=0.01, canary=True,
                        canary_fraction=0.5, canary_min_samples=3)
    try:
        raddr = f"127.0.0.1:{rep.start()}"
        wid, _ = store.register_worker("w")
        assert wait(lambda: rep.view()["step"] == 0)
        for rnd, quality, outcome in ((1, 0.9, "promotions"),
                                      (2, 0.1, "rollbacks")):
            store.push(wid, grads(rnd), store.global_step)
            assert wait(lambda: rep.view()["canary"]["canary_step"] == rnd)
            rc, out = _cli(["infer", "--target", raddr, "--count", "12",
                            "--quality", str(quality), "--json"], capsys,
                           "INFER_JSON ")
            assert rc == 0 and len(out["served"]) == 12
            view = rep.view()["canary"]
            assert view[outcome] == 1 and view["canary_step"] is None
            assert {r["arm"] for r in out["served"]} == {"stable",
                                                         "canary"}
        assert view["stable_step"] == 1 and view["bad_steps"] == [2]
        for mode in ("full", "delta", "infer"):
            rc, res = _cli(["loadgen", "--targets", raddr, "--duration",
                            "0.3", "--concurrency", "2", "--fetch-mode",
                            mode], capsys, "LOADGEN_JSON ")
            assert rc == 0 and res["fetches_err"] == 0
        assert res["arms"]["stable"]["serving_steps"] == [1]
    finally:
        rep.stop()
        server.stop(grace=None)


@pytest.mark.slow
def test_cli_serve_autoscale_spawns_a_replica_and_scaled_loadgen(tmp_path):
    """``cli serve --autoscale --autoscale-min 1`` grows its pool to the
    floor (a ``cli replica`` child that mirrors the primary), ``cli
    loadgen --scale-out 2`` against that replica merges two generators'
    reports with no error, and the child exits with the server."""
    base = [sys.executable, "-m",
            "distributed_parameter_server_for_ml_training_tpu_torch.cli"]
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    server = subprocess.Popen(
        base + ["serve", "--mode", "async", "--workers", "1", "--port",
                str(port), "--shard-peers", f"127.0.0.1:{port}",
                "--model", "vit_tiny", "--autoscale", "--autoscale-min",
                "1", "--autoscale-max", "1", "--health-interval", "0.2",
                "--no-memory-telemetry"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []

    def read():
        for line in server.stdout:
            lines.append(line)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        assert wait(lambda: any("replica up on" in ln for ln in lines),
                    240), "".join(lines)
        rport = re.search(r"replica up on :(\d+)",
                          "".join(lines)).group(1)
        out = subprocess.run(
            base + ["loadgen", "--targets", f"127.0.0.1:{rport}",
                    "--duration", "1", "--concurrency", "2",
                    "--scale-out", "2"],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=240)
        assert out.returncode == 0, out.stderr
        res = PL.parse_loadgen_json(out.stdout)
        assert res["reports"] == 2 and res["generators_failed"] == 0
        assert res["fetches_err"] == 0 and res["fetches_ok"] > 0
    finally:
        server.send_signal(signal.SIGINT)
        try:
            server.wait(60)
        finally:
            if server.poll() is None:
                server.kill()
                server.wait()
        reader.join(10)
    text = "".join(lines)
    assert "REPLICA_POOL_GROW index=0 live=1" in text, text
    assert server.returncode == 0, text
