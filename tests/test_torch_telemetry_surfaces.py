"""The port's process telemetry surfaces against the JAX package's
(``…_torch/telemetry/stats.py``, ``prometheus.py``, ``snapshot.py``,
``memory.py``, ``incidents.py``, ``proftrigger.py``): the same inputs,
made from a seed, give equal percentiles, summaries and histogram merges,
byte-equal Prometheus text, equal snapshot lines and journal payloads,
equal memory verdicts and gauges, and equal incident bundles and profile
ledger records with the same dedupe — the JAX package's semantics, with
injected clocks and capture functions. Then the port's HTTP routes on a
free port: ``/metrics``, ``/metrics.json``, ``/healthz`` (200, and 503
while the cluster monitor holds a critical alert), ``/cluster`` and
``/debug/trace``."""

import gzip
import io
import json
import math
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from distributed_parameter_server_for_ml_training_tpu.telemetry import (
    incidents as JI, journal as JJ, memory as JM, proftrigger as JPT,
    prometheus as JP, registry as JR, snapshot as JSN, stats as JST)
from distributed_parameter_server_for_ml_training_tpu_torch.ps.store import \
    ParameterStore
from distributed_parameter_server_for_ml_training_tpu_torch.telemetry import (
    cluster as PCL, incidents as PI, journal as PJ, memory as PM,
    proftrigger as PPT, prometheus as PP, registry as PR, snapshot as PSN,
    stats as PST, trace as PTR)

MiB = 1 << 20


class Clock:
    def __init__(self, t: float = 1_700_000_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


# -- stats ---------------------------------------------------------------

def _hist_snap(rng, le, n_counts, exemplars: bool) -> dict:
    counts = [int(c) for c in rng.integers(0, 50, n_counts)]
    snap = {"le": list(le), "counts": counts,
            "sum": float(rng.random() * 100), "count": sum(counts)}
    if exemplars:
        snap["exemplars"] = {
            str(int(i)): {"value": float(rng.random()),
                          "trace_id": f"t{int(i)}",
                          "ts": float(rng.integers(0, 5))}
            for i in rng.choice(n_counts, 3, replace=False)}
    return snap


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stats_match_jax(seed):
    rng = np.random.default_rng(seed)
    samples = [float(v) for v in rng.exponential(0.05, 1 + 37 * seed)]
    s = sorted(samples)
    for p in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
        assert PST.percentile(s, p) == JST.percentile(s, p)
    assert PST.percentile([], 50) == JST.percentile([], 50) == 0.0
    assert PST.latency_summary(samples) == JST.latency_summary(samples)
    assert PST.latency_summary([]) == JST.latency_summary([])
    le = [0.001 * 2 ** k for k in range(12)]
    snaps = [_hist_snap(rng, le, len(le) + 1, exemplars=k % 2 == 0)
             for k in range(4)]
    assert PST.merge_histograms(snaps) == JST.merge_histograms(snaps)
    assert PST.merge_histograms(snaps[:1]) == JST.merge_histograms(snaps[:1])
    for p in (50, 95, 99):
        merged = PST.merge_histograms(snaps)
        assert PST.histogram_quantile(le, merged["counts"], p) \
            == JST.histogram_quantile(le, merged["counts"], p)
    bad = dict(snaps[0], le=le[:-1], counts=snaps[0]["counts"][:-1])
    for merge in (PST.merge_histograms, JST.merge_histograms):
        with pytest.raises(ValueError, match="different bucket schemes"):
            merge([snaps[0], bad])
        with pytest.raises(ValueError, match="at least one"):
            merge([])


# -- a scripted registry, in either package ------------------------------

def _scripted(reg_mod, seed: int = 0):
    """One registry of counters, gauges and histograms (odd names and
    labels, fractional and whole values) filled from a seed."""
    rng = np.random.default_rng(seed)
    reg = reg_mod.MetricsRegistry()
    reg.counter("dps_pushes_total", worker="0").inc(3)
    reg.counter("dps_pushes_total", worker="1").inc(float(rng.random()))
    reg.counter("dps.odd-name:total").inc(7)
    reg.gauge("dps_queue_depth").set(int(rng.integers(0, 9)))
    reg.gauge("dps_ratio", kind="a-b").set(float(rng.random()))
    reg.gauge("dps_zero").set(0)
    h = reg.histogram("dps_rpc_latency_seconds",
                      buckets=reg_mod.LATENCY_BUCKETS_S, method="Fetch")
    for v in rng.exponential(0.05, 40):
        h.observe(float(v))
    hb = reg.histogram("dps_bytes", buckets=reg_mod.BYTES_BUCKETS)
    for v in rng.integers(1, 1 << 24, 10):
        hb.observe(int(v))
    reg.histogram("dps_empty_seconds")
    return reg


@pytest.mark.parametrize("seed", [0, 5])
def test_render_prometheus_is_byte_equal(seed):
    text = PP.render_prometheus(_scripted(PR, seed))
    assert text == JP.render_prometheus(_scripted(JR, seed))
    assert "# TYPE dps_odd_name:total counter" in text
    assert 'dps_rpc_latency_seconds_bucket{method="Fetch",le="+Inf"} 40' \
        in text


# -- the snapshot stream ---------------------------------------------------

class FakeJournal:
    def __init__(self):
        self.records, self.seals = [], 0

    def append(self, type, payload=None):
        self.records.append((type, json.loads(json.dumps(payload))))
        return {}

    def seal(self):
        self.seals += 1


def _emitter_run(reg_mod, snap_mod):
    clk = Clock()
    reg = _scripted(reg_mod, 3)
    stream, journal = io.StringIO(), FakeJournal()
    em = snap_mod.SnapshotEmitter(reg, interval=1.0, role="server",
                                  proc={"worker": "w0"}, stream=stream,
                                  journal=journal, clock=clk)
    payloads = []
    for k in range(3):
        clk.advance(1.5)
        reg.counter("dps_pushes_total", worker="0").inc(k)
        payloads.append(em.emit_once())
    em.stop(final=True)          # final snapshot + journal sealed
    em.flush_now()               # already stopped: seals only
    return payloads, stream.getvalue().splitlines(), journal


def test_snapshot_lines_and_journal_payloads_match_jax():
    p_pay, p_lines, p_jr = _emitter_run(PR, PSN)
    j_pay, j_lines, j_jr = _emitter_run(JR, JSN)
    assert p_pay == j_pay and p_lines == j_lines
    assert len(p_lines) == 4 and all(
        line.startswith("METRICS_JSON: {\"kind\": \"snapshot\"")
        for line in p_lines)
    assert p_jr.records == j_jr.records and len(p_jr.records) == 4
    # Journaled copies drop the zero-valued vocabulary and the kind.
    assert "dps_zero" not in p_jr.records[0][1]["gauges"]
    assert "dps_empty_seconds" not in p_jr.records[0][1]["histograms"]
    assert p_jr.seals == j_jr.seals == 2
    with pytest.raises(ValueError):
        PSN.SnapshotEmitter(PR.MetricsRegistry(), interval=0)


# -- memory telemetry -------------------------------------------------------

def _memory_series(mem_mod, reg_mod, seed: int):
    """An injected series: a host leak with noise, a device allocator
    creeping with a missing reading and a failed one."""
    rng = np.random.default_rng(seed)
    clk = Clock(1000.0)
    reg = reg_mod.MetricsRegistry()
    noise = rng.integers(0, MiB, 64)
    k = [0]

    def rss():
        k[0] += 1
        if k[0] == 5:
            return None
        v = int(256 * MiB + (clk() - 1000.0) * 3 * MiB + noise[k[0]])
        return {"rss_bytes": v, "peak_rss_bytes": v + MiB}

    def dev():
        if k[0] == 7:
            raise RuntimeError("allocator read failed")
        if k[0] % 4 == 0:
            return None
        used = int(MiB * (10 + k[0]))
        return {"bytes_in_use": used, "peak_bytes_in_use": used + 5,
                "bytes_limit": 80 * 1024 * MiB,
                "device_kind": "NVIDIA H100 80GB HBM3"}

    mon = mem_mod.MemoryMonitor(reg, interval_s=5.0, window_s=40.0,
                                clock=clk, rss_fn=rss, device_fn=dev)
    verdicts = []
    for dt in rng.uniform(0.5, 7.0, 30):
        clk.advance(float(dt))
        verdicts.append(mon.observe())
    verdicts.append(mon.sample())
    return verdicts, reg.snapshot()["gauges"]


@pytest.mark.parametrize("seed", [0, 1])
def test_memory_monitor_verdicts_match_jax(seed):
    p_verdicts, p_gauges = _memory_series(PM, PR, seed)
    j_verdicts, j_gauges = _memory_series(JM, JR, seed)
    assert p_verdicts == j_verdicts
    assert p_gauges == j_gauges
    assert p_verdicts[-1]["growth_bytes_per_s"] == pytest.approx(
        3 * MiB, rel=0.1)
    assert PM.DEVICE_MEMORY_KINDS == JM.DEVICE_MEMORY_KINDS
    assert (PM.HOST_RSS_METRIC, PM.DEVICE_MEMORY_METRIC) \
        == (JM.HOST_RSS_METRIC, JM.DEVICE_MEMORY_METRIC)
    assert PM._slope_bytes_per_s([(5.0, 1), (5.0, 2)]) is None
    with pytest.raises(ValueError):
        PM.MemoryMonitor(PR.MetricsRegistry(), interval_s=0)


def test_memory_monitor_counts_and_logs_failed_reads(capsys):
    """A read that raises reads as None in the verdict, as in JAX, but is
    counted by source, and the first failure of a source is logged."""
    reg = PR.MetricsRegistry()

    def dev():
        raise RuntimeError("allocator read failed")

    mon = PM.MemoryMonitor(reg, rss_fn=lambda: None, device_fn=dev)
    verdicts = [mon.sample(now=float(t)) for t in range(3)]
    assert [v["device"] for v in verdicts] == [None] * 3
    counters = reg.snapshot()["counters"]
    assert counters[PM.READ_ERRORS_METRIC + "{source=device}"] == 3
    assert counters[PM.READ_ERRORS_METRIC + "{source=host}"] == 0
    err = capsys.readouterr().err
    assert err.count("memory telemetry: device read failed") == 1
    assert "allocator read failed" in err


def test_memory_readers_on_the_cpu():
    """The host reader returns the JAX reader's keys; the CPU has no
    allocator stats, as a JAX CPU backend has none."""
    rss = PM.read_host_rss()
    assert set(rss) == set(JM.read_host_rss()) \
        == {"rss_bytes", "peak_rss_bytes"}
    assert rss["peak_rss_bytes"] >= rss["rss_bytes"] > 0
    assert PM.read_device_memory("cpu") is None
    assert JM.read_device_memory() is None


_NO_CONTEXT_PROBE = """
import os, subprocess, sys, torch
from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \\
    import read_device_memory
r = read_device_memory("cuda")
apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                       "--format=csv,noheader"], capture_output=True,
                      text=True, check=True).stdout.split()
assert str(os.getpid()) not in apps, apps
assert r["bytes_in_use"] == r["peak_bytes_in_use"] == 0, r
x = torch.ones(1 << 20, device="cuda")
r2 = read_device_memory("cuda")
assert r2["bytes_in_use"] >= x.numel() * 4, r2
assert r2["bytes_limit"] == torch.cuda.mem_get_info(0)[1], r2
assert r2["device_kind"] == torch.cuda.get_device_name(0), r2
"""


@pytest.mark.cuda
def test_device_memory_read_takes_no_context_on_the_card():
    """A process that never used the card reads 0 bytes in use and holds
    no CUDA context afterwards (``nvidia-smi`` lists no compute app for
    it); once it allocates, the read carries the bytes, the card's total
    memory as ``mem_get_info`` gives it, and the card's name."""
    import subprocess
    import sys

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", _NO_CONTEXT_PROBE], check=True,
                   cwd=repo, env={**os.environ, "PYTHONPATH": repo},
                   timeout=120)


# -- incident capture --------------------------------------------------------

def _bundle(path: str) -> dict:
    out = {}
    for root, _, files in os.walk(path):
        for name in files:
            full = os.path.join(root, name)
            with open(full) as f:
                out[os.path.relpath(full, path)] = f.read()
    return out


def _incident_run(tmp, jr_mod, inc_mod, reg_mod):
    clk = Clock()
    reg = reg_mod.MetricsRegistry()
    journal = jr_mod.JournalWriter(os.path.join(tmp, "journal"),
                                   role="server", registry=reg, clock=clk)
    for k in range(6):
        clk.advance(30.0)
        journal.append("alert", {"rule": "nonfinite_loss", "worker": k % 2,
                                 "state": "fired", "value": k})
    cap = inc_mod.IncidentCapture(
        os.path.join(tmp, "incidents"), journal=journal,
        views_fn=lambda: {"cluster": {"workers": [{"worker": 0}],
                                      "alerts": []}},
        traces_fn=lambda trigger: [("flight-server.json",
                                    {"spans": [], "trigger": trigger})],
        window_s=100.0, cooldown_s=60.0, role="server", registry=reg,
        clock=clk)
    results = []
    events = [{"state": "fired", "severity": "critical", "rule": "dead",
               "worker": 1},
              {"state": "refired", "severity": "critical", "rule": "dead"},
              {"state": "fired", "severity": "warning", "rule": "lag"},
              {"state": "resolved", "severity": "critical", "rule": "dead"}]
    cap.on_alert_events(events)
    clk.advance(10.0)
    results.append(cap.maybe_capture({"rule": "dead"}))      # cooldown
    results.append(cap.maybe_capture({"rule": "nan"}))       # other rule
    cap.on_fleet_view({"alerts": [{"severity": "critical", "rule": "x",
                                   "worker": 0, "since": 1.0}],
                       "slo": {"breaches": [{"severity": "critical",
                                             "rule": "slo_burn_fast",
                                             "objective": "fetch"}]}})
    cap.on_fleet_view({"alerts": [{"severity": "critical", "rule": "x",
                                   "worker": 0, "since": 1.0}]})
    clk.advance(61.0)
    results.append(cap.maybe_capture({"rule": "dead"}))      # past it
    bundles = {name: _bundle(os.path.join(tmp, "incidents", name))
               for name in sorted(os.listdir(os.path.join(tmp,
                                                          "incidents")))}
    rel = [None if r is None else os.path.relpath(r, tmp) for r in results]
    return rel, bundles, reg.snapshot()["counters"]


def test_incident_capture_matches_jax(tmp_path):
    p = _incident_run(str(tmp_path / "port"), PJ, PI, PR)
    j = _incident_run(str(tmp_path / "jax"), JJ, JI, JR)
    p_rel, p_bundles, p_counts = p
    j_rel, j_bundles, j_counts = j
    assert p_rel == j_rel and p_rel[0] is None
    # The manifests name their own journal directories; set those aside.
    strip = str(tmp_path / "port"), str(tmp_path / "jax")
    assert {k: {f: t.replace(strip[0], "T") for f, t in b.items()}
            for k, b in p_bundles.items()} \
        == {k: {f: t.replace(strip[1], "T") for f, t in b.items()}
            for k, b in j_bundles.items()}
    assert len(p_bundles) == 5
    first = p_bundles[sorted(p_bundles)[0]]
    assert set(first) == {"manifest.json", "journal_window.jsonl",
                          "snapshots.json", "traces/flight-server.json"}
    assert len(first["journal_window.jsonl"].splitlines()) == 4
    assert set(json.loads(first["manifest.json"])) \
        == set(PI.MANIFEST_FIELDS) == set(JI.MANIFEST_FIELDS)
    assert (p_counts["dps_incidents_captured_total"],
            p_counts["dps_incidents_suppressed_total"]) == (5, 1)
    assert p_counts == j_counts


# -- trigger-driven profiling -------------------------------------------------

TRACE = {"dot.1": 4000, "fusion.dot.2": 2000, "all-reduce.3": 1500,
         "quantize.4": 300, "opaque_fusion": 800}


def _writer(logdir, window_s):
    """A synthetic TPU-style capture, as the JAX package's tests write."""
    run = os.path.join(logdir, "plugins", "profile", "run")
    os.makedirs(run, exist_ok=True)
    events = [{"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
               "args": {"name": "/device:TPU:0"}}]
    ts = 0
    for name, dur in TRACE.items():
        events.append({"ph": "X", "name": name, "pid": 1, "tid": 1,
                       "ts": ts, "dur": dur})
        ts += dur
    with gzip.open(os.path.join(run, "h.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": events}, f)


def _garbage(logdir, window_s):
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "host0.trace.json"), "w") as f:
        f.write("not json at all{{{")


def _boom(logdir, window_s):
    raise RuntimeError("another profiler session is active")


def _trigger_run(tmp, pt_mod, reg_mod):
    clk = Clock()
    reg = reg_mod.MetricsRegistry()
    mk = {name: pt_mod.ProfileTrigger(
        os.path.join(tmp, name), capture_fn=fn, window_s=0.25,
        cooldown_s=600.0, goodput_drop_threshold=0.5, role="server",
        registry=reg, clock=clk)
        for name, fn in (("ok", _writer), ("bad", _garbage),
                         ("boom", _boom))}
    trig = mk["ok"]
    out = []
    trig.on_alert_events([
        {"state": "fired", "rule": "slo_burn_fast", "value": 14.2},
        {"state": "refired", "rule": "slo_burn_fast"},
        {"state": "resolved", "rule": "slo_burn_slow"},
        {"state": "fired", "rule": "dead_worker"}])
    out.append(trig.on_bench_verdict({"status": "pass"}))
    out.append(trig.on_bench_verdict("garbage"))
    out.append(trig.on_bench_verdict({"status": "regression",
                                      "regressions": ["steps_per_s"]}))
    for f in (0.2, 0.8, 0.3, 0.2, None, True, 0.9, 0.4):
        clk.advance(1.0)
        out.append(trig.observe_goodput(f))
    clk.advance(700.0)
    out.append(trig.observe_goodput(0.9))
    out.append(trig.observe_goodput(0.1))
    out.append(mk["bad"].maybe_capture({"rule": "slo_burn"}))
    out.append(mk["boom"].maybe_capture({"rule": "goodput_drop"}))
    rel = [None if r is None else os.path.relpath(r, tmp) for r in out]
    records = {}
    for root, _, files in os.walk(tmp):
        for name in files:
            path = os.path.join(root, name)
            with open(path) as f:
                text = f.read()
            records[os.path.relpath(path, tmp)] = json.loads(text) \
                if name.startswith("PROFILE_") else len(text)
    return rel, records, reg.snapshot()["counters"]


def test_profile_trigger_matches_jax(tmp_path):
    p_rel, p_recs, p_counts = _trigger_run(str(tmp_path / "p"), PPT, PR)
    j_rel, j_recs, j_counts = _trigger_run(str(tmp_path / "j"), JPT, JR)
    assert p_rel == j_rel and p_recs == j_recs and p_counts == j_counts
    ledger = {k: v for k, v in p_recs.items() if isinstance(v, dict)}
    assert len(ledger) == 6
    ok = [r for k, r in ledger.items() if k.startswith("ok")]
    assert [r["rule"] for r in sorted(ok, key=lambda r: r["id"])] \
        .count("goodput_drop") == 2
    for rec in ok:
        assert set(rec) == set(PPT.PROFILE_RECORD_FIELDS)
        assert rec["profile"]["basis"] == "device_lanes"
        assert rec["profile"]["op_classes"]["quantize-pack"]["events"] == 1
        assert rec["traces_pruned"] is True
    bad = [r for k, r in ledger.items() if not k.startswith("ok")]
    assert all(r["profile"]["basis"] == "none" and not r["traces_pruned"]
               for r in bad)
    assert any(k.endswith("host0.trace.json") for k in p_recs)
    assert PPT.PROFILE_RECORD_FIELDS == JPT.PROFILE_RECORD_FIELDS
    assert p_counts["dps_profiles_suppressed_total"] == 1
    with pytest.raises(ValueError):
        PPT.ProfileTrigger(str(tmp_path), goodput_drop_threshold=0.0)


def test_profile_trigger_default_capture_never_falls_back(tmp_path):
    """Without a card the default capture on ``cuda`` raises, and the
    trigger keeps JAX's rule: the failed capture is swallowed, recorded
    with basis ``none``, its raw dir kept."""
    trig = PPT.ProfileTrigger(str(tmp_path), window_s=0.01,
                              registry=PR.MetricsRegistry())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PPT.default_capture(str(tmp_path / "x"), 0.01)
    with open(trig.maybe_capture({"rule": "slo_burn"})) as f:
        rec = json.load(f)
    assert rec["profile"]["basis"] == "none" and not rec["traces_pruned"]


# -- the HTTP routes ---------------------------------------------------------

def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_http_routes_on_a_free_port():
    reg = _scripted(PR, 1)
    server, port = PP.start_metrics_server(reg, port=0, addr="127.0.0.1")
    jserver, jport = JP.start_metrics_server(_scripted(JR, 1), port=0,
                                             addr="127.0.0.1")
    monitor = None
    try:
        status, ctype, body = _get(port, "/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        assert body == _get(jport, "/metrics")[2] \
            == PP.render_prometheus(reg).encode()
        assert json.loads(_get(port, "/metrics.json")[2]) \
            == json.loads(json.dumps(reg.snapshot()))
        assert _get(port, "/healthz")[:1] == (200,)
        assert json.loads(_get(port, "/healthz")[2]) == {"ok": True}
        assert _get(port, "/cluster")[0] == 404
        assert _get(port, "/nope")[0] == 404
        PTR.enable_tracing(buffer=8, role="server")
        try:
            for k in range(3):
                with PTR.trace_span("worker.step", root=True, step=k):
                    pass
            trace = json.loads(_get(port, "/debug/trace?n=2")[2])
        finally:
            PTR.disable_tracing()
        assert trace["enabled"] is True and len(trace["spans"]) == 2
        store = ParameterStore({"w": np.zeros(3, np.float32)})
        assert store.register_worker("w0")[0] == 0
        monitor = PCL.ClusterMonitor(store, interval=60.0,
                                     registry=PR.MetricsRegistry())
        PCL.set_cluster_monitor(monitor)
        status, _, body = _get(port, "/cluster")
        assert status == 200 and json.loads(body)["alerts"] == []
        assert monitor.ingest(0, {"step": 3, "loss": math.nan,
                                  "grad_norm": 1.0, "loss_finite": False})
        monitor.evaluate()
        status, _, body = _get(port, "/healthz")
        health = json.loads(body)
        assert status == 503 and health["ok"] is False
        assert [a["rule"] for a in health["critical"]] == ["nonfinite_loss"]
        view = json.loads(_get(port, "/cluster")[2])
        assert [a["rule"] for a in view["alerts"]] == ["nonfinite_loss"]
    finally:
        PCL.set_cluster_monitor(None)
        for s in (server, jserver):
            s.shutdown()
            s.server_close()


# -- cli serve wires the surfaces as the JAX CLI does -----------------------

@pytest.fixture
def small(monkeypatch):
    """A narrow ResNet for ``get_model``: what is checked is the wiring."""
    from distributed_parameter_server_for_ml_training_tpu_torch import models

    def get_model(name, num_classes=10, device="cpu", **kw):
        return models.ResNet(stage_sizes=(1, 1), num_filters=8,
                             num_classes=num_classes).to(device)

    monkeypatch.setattr(models, "get_model", get_model)


def _serve_until_bound(monkeypatch, capsys, argv, probe=None):
    """``cli serve --device cpu`` cut short where it would bind; ``probe``
    runs there, inside the telemetry session. Returns the service."""
    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        import service as S
    seen = {}

    def bound(store, port=8000, service=None, **kw):
        seen["svc"] = service
        if probe is not None:
            seen["probe"] = probe(service, capsys.readouterr().err)
        raise KeyboardInterrupt

    monkeypatch.setattr(S, "serve", bound)
    try:
        with pytest.raises(KeyboardInterrupt):
            cli.main(["serve", "--mode", "async", "--workers", "2",
                      "--device", "cpu", *argv])
    finally:
        svc = seen.get("svc")
        if svc is not None and svc.monitor is not None:
            svc.monitor.stop(final=False)
        PCL.set_cluster_monitor(None)
    return seen


def test_serve_memory_telemetry_is_on_with_the_monitor(small, monkeypatch,
                                                       capsys):
    mon = _serve_until_bound(monkeypatch, capsys, [])["svc"].monitor
    assert isinstance(mon.memory, PM.MemoryMonitor)
    verdict = mon.memory.sample()
    assert verdict["rss_bytes"] > 0 and verdict["device"] is None
    assert mon.profile_trigger is None and mon.emit_stream is False
    off = _serve_until_bound(monkeypatch, capsys,
                             ["--no-memory-telemetry"])["svc"].monitor
    assert off.memory is None


def test_serve_surfaces_answer_while_serving(small, monkeypatch, capsys,
                                             tmp_path):
    """``--metrics-port 0 --telemetry --journal-dir --incidents-dir
    --profile-triggers``: the endpoint serves ``/metrics``, ``/healthz``
    and ``/cluster`` (with the memory block) while the server runs, the
    incident capture and the profile trigger listen on the monitor, the
    cluster stream is on, and the journal holds the final snapshot."""
    import re

    def probe(svc, err):
        port = int(re.search(r"serving /metrics on :(\d+)", err).group(1))
        return err, {path: _get(port, path) for path in
                     ("/metrics", "/healthz", "/cluster")}

    seen = _serve_until_bound(monkeypatch, capsys, [
        "--metrics-port", "0", "--telemetry", "--telemetry-interval", "60",
        "--journal-dir", str(tmp_path / "j"), "--incidents-dir",
        str(tmp_path / "i"), "--incident-window", "30",
        "--incident-cooldown", "5", "--profile-triggers", "--profiles-dir",
        str(tmp_path / "p"), "--profile-window", "0.5",
        "--profile-cooldown", "7", "--goodput-drop-threshold", "0.3"],
        probe=probe)
    err, pages = seen["probe"]
    assert pages["/metrics"][0] == 200 and b"# TYPE" in pages["/metrics"][2]
    assert (pages["/healthz"][0], json.loads(pages["/healthz"][2])) \
        == (200, {"ok": True})
    view = json.loads(pages["/cluster"][2])
    assert pages["/cluster"][0] == 200 and view["memory"]["device"] is None
    mon = seen["svc"].monitor
    assert mon.emit_stream is True
    trig = mon.profile_trigger
    assert (trig.profiles_dir, trig.window_s, trig.cooldown_s,
            trig.goodput_drop_threshold) == (str(tmp_path / "p"), 0.5, 7.0,
                                             0.3)
    assert trig.capture_fn.keywords == {"device": "cpu"}
    listeners = [getattr(fn, "__self__", None) for fn in mon._listeners]
    assert trig in listeners
    cap = next(x for x in listeners if isinstance(x, PI.IncidentCapture))
    assert (cap.window_s, cap.cooldown_s) == (30.0, 5.0)
    types = [r["type"] for r in PJ.read_journal(str(tmp_path / "j"))]
    assert "snapshot" in types
    assert "incidents: capture armed" in err
    assert "profiles: trigger engine armed" in err


@pytest.mark.parametrize("flag", [["--incidents-dir", "i"],
                                  ["--profile-triggers"]])
def test_serve_capture_flags_need_the_monitor(small, flag):
    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    with pytest.raises(SystemExit, match="needs the health monitor"):
        cli.main(["serve", "--device", "cpu", "--no-health-monitor", *flag])


def test_metrics_line_survives_a_concurrent_print(tmp_path):
    """``emit_metrics_json`` writes its line and newline in one write: a
    print from another thread of the process (a snapshot emitter, an
    autoscaler's log) lands before or after the line, never on it, so
    every METRICS_JSON line of a file parses."""
    import sys
    import threading

    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .metrics import emit_metrics_json

    stop = threading.Event()
    n = 50000
    with open(tmp_path / "log.txt", "w+", buffering=512) as f:
        def chatter():
            while not stop.is_set():
                print("x" * 50, file=f)

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        t = threading.Thread(target=chatter)
        t.start()
        try:
            for i in range(n):
                emit_metrics_json({"i": i, "pad": "y" * 200}, f)
        finally:
            stop.set()
            t.join(10)
            sys.setswitchinterval(interval)
        assert not t.is_alive()
        f.seek(0)
        rows = [json.loads(line.split("METRICS_JSON:", 1)[1])
                for line in f.read().splitlines()
                if "METRICS_JSON:" in line]
    assert [r["i"] for r in rows] == list(range(n))


def test_build_info_labels_name_the_installed_torch():
    """``dps_build_info`` carries JAX's labels with torch in jax's place:
    the package version, the installed torch's version as its metadata
    gives it, and the host platform."""
    import importlib.metadata
    import sys

    from distributed_parameter_server_for_ml_training_tpu_torch import \
        __version__

    reg = PR.MetricsRegistry()
    assert PR.register_build_info(reg).value == 1.0
    want = (f'dps_build_info{{platform="{sys.platform}",'
            f'torch="{importlib.metadata.version("torch")}",'
            f'version="{__version__}"}} 1')
    text = PP.render_prometheus(reg)
    assert "# TYPE dps_build_info gauge" in text
    assert want in text.splitlines(), text
