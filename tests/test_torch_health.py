"""The port's cluster health layer (``…_torch/telemetry/health.py``,
``cluster.py``, ``slo.py``, ``stats.py``, ``remediation.py``) against the
JAX package's: the rule, severity, directive and action catalogs and the
default thresholds are equal; one scripted sequence of worker reports
(through each service's fetch handler and straight into the monitor),
store pushes, membership expiries, corrupt frames and RPC latencies, on
an injected clock, fed into both packages' ``ClusterMonitor`` — each with
a ``RemediationEngine`` acting on its own ``ParameterService`` and an
``SloEvaluator`` on its own registry — gives the same edge events, active
alerts, remediation actions, directives, quarantines, fetch replies and
``cluster_view()``, over the host store and over the device store (the
JAX one on the CPU, the port's with ``device="cpu"``);
``sanitize_report`` of garbled reports and the worker autoscaler's
decisions are equal too; and reports, directives and quarantines racing
on one port service lose nothing."""

import math
import time

import numpy as np
import pytest

from distributed_parameter_server_for_ml_training_tpu.comms import \
    service as JS
from distributed_parameter_server_for_ml_training_tpu.ps.device_store \
    import DeviceParameterStore as JaxDeviceStore
from distributed_parameter_server_for_ml_training_tpu.ps.store import (
    ParameterStore as JaxStore, StoreConfig as JaxConfig)
from distributed_parameter_server_for_ml_training_tpu.telemetry import \
    cluster as JCL, health as JH, registry as JR, remediation as JRM, \
    slo as JSLO, stats as JST
from distributed_parameter_server_for_ml_training_tpu_torch.comms import \
    service as PS
from distributed_parameter_server_for_ml_training_tpu_torch.ps \
    .device_store import DeviceParameterStore
from distributed_parameter_server_for_ml_training_tpu_torch.ps.store import (
    ParameterStore, StoreConfig)
from distributed_parameter_server_for_ml_training_tpu_torch.telemetry import \
    cluster as PCL, health as PH, registry as PR, remediation as PRM, \
    slo as PSLO, stats as PST

SHAPES = {"conv/kernel": (3, 3, 3, 4), "dense/kernel": (4, 10),
          "dense/bias": (10,)}

#: Each package's modules, by role.
PACKAGES = {
    "jax": dict(service=JS, cluster=JCL, remediation=JRM, slo=JSLO,
                registry=JR, store=JaxStore, config=JaxConfig,
                device_store=JaxDeviceStore),
    "port": dict(service=PS, cluster=PCL, remediation=PRM, slo=PSLO,
                 registry=PR, store=ParameterStore, config=StoreConfig,
                 device_store=lambda p, c: DeviceParameterStore(
                     p, c, device="cpu")),
}


def _params():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(seed: int) -> dict:
    rng = np.random.default_rng(100 + seed)
    return {k: (rng.standard_normal(s) * 1e-2).astype(np.float32)
            for k, s in SHAPES.items()}


def test_catalogs_and_defaults_equal_jax():
    assert PH.RULE_CATALOG == JH.RULE_CATALOG
    assert list(PH.RULE_CATALOG) == list(JH.RULE_CATALOG)
    assert PH.SEVERITIES == JH.SEVERITIES
    assert PS.DIRECTIVE_CATALOG == JS.DIRECTIVE_CATALOG
    assert PS.DIRECTIVES_PER_WORKER_CAP == JS.DIRECTIVES_PER_WORKER_CAP
    assert PH.HealthThresholds() == PH.HealthThresholds(
        **vars(JH.HealthThresholds()))
    assert PCL.REPORT_FIELDS == JCL.REPORT_FIELDS
    assert PRM.ACTION_CATALOG == JRM.ACTION_CATALOG
    assert PRM.ACTION_OUTCOMES == JRM.ACTION_OUTCOMES
    assert PRM.DEFAULT_POLICY_RULES == JRM.DEFAULT_POLICY_RULES
    assert vars(PRM.RemediationPolicy()) == vars(JRM.RemediationPolicy())
    assert vars(PRM.WorkerAutoscalePolicy()) \
        == vars(JRM.WorkerAutoscalePolicy())
    assert [vars(o) for o in PSLO.default_objectives(80.0, 0.95)] \
        == [vars(o) for o in JSLO.default_objectives(80.0, 0.95)]


def _report(step: int, loss, grad_norm, **extra) -> dict:
    return {"step": step, "epoch": 0, "loss": loss, "grad_norm": grad_norm,
            "loss_finite": True, "grad_finite": True,
            "push_codec": "int8+ef", "goodput_fraction": 0.5, **extra}


def script() -> list:
    """(clock seconds, op, args): three workers (0 and 1 hear
    directives, 2 is a legacy peer) report healthily, then: a gradient
    explosion, non-finite reports (one NaN shipped raw through the JSON
    hop), a directive delivery and its ack, a straggler, a corrupt frame,
    a staleness spike, an SLO burn, an expiry, recovery, a stall, a
    divergence, a plateau, silence, goodbyes."""
    ops = [(0, "register", ("w0", True)), (0, "register", ("w1", True)),
           (0, "register", ("w2", False))]
    for k in range(1, 7):
        for w in range(3):
            ops.append((k, "report", (w, _report(10 * k, 4.0 - 0.1 * k - w,
                                                 1.0 + 0.01 * k + w))))
        ops.append((k, "evaluate", ()))
    ops += [
        (7, "report", (1, _report(70, 3.2, 100.0))),    # explosion
        (7, "evaluate", ()),
        (8, "report", (0, _report(80, None, None, loss_finite=False,
                                  grad_finite=False))),
        (8, "ingest", (2, {"step": 80, "loss": float("nan"),
                           "grad_norm": 3.0})),
        (8, "evaluate", ()),
        (9, "report", (0, _report(80, None, None, loss_finite=False,
                                  grad_finite=False))),  # directives ride
        (9, "fetch_ack", (0, 2)),
        (10, "report", (0, _report(200, 2.9, 1.1))),
        (10, "report", (1, _report(60, 2.9, 2.1))),      # straggler
        (10, "report", (2, _report(200, 2.9, 3.1))),
        (10, "evaluate", ()),
        (11, "corrupt", ()),
        (11, "evaluate", ()),
        (12, "pushes", (3, 6)),                          # staleness spike
        (12, "evaluate", ()),
        (13, "latency", ("FetchParameters", 0.5, 20)),   # SLO burn
        (13, "latency", ("PushGradrients", 0.01, 20)),
        (13, "evaluate", ()),
        (14, "expire", ([2],)),
        (14, "evaluate", ()),
        (15, "report", (0, _report(210, 2.8, 1.1))),
        (15, "evaluate", ()),
        (16, "view", ()),
        (50, "report", (1, _report(60, 2.9, 2.1))),      # stalled
        (50, "report", (0, _report(220, 20.0, 1.1))),    # divergence
        (50, "evaluate", ()),
        (120, "evaluate", ()),                           # re-alerts
        (400, "report", (0, _report(400, 2.79, 1.1))),
        (400, "report", (1, _report(61, 2.9, 2.1))),     # plateau
        (400, "evaluate", ()),
        (440, "evaluate", ()),                           # silence
        (440, "view", ()),
        (441, "job_finished", (0,)),
        (441, "job_finished", (1,)),
        (441, "evaluate", ()),
        (442, "view", ()),
    ]
    return ops


class Stack:
    """One package's store, service, monitor, engine and SLO evaluator on
    one scripted clock, with registries of their own."""

    def __init__(self, pkg: str, backend: str, clock):
        m = PACKAGES[pkg]
        cfg = m["config"](mode="async", total_workers=3, staleness_bound=1)
        self.store = (m["store"] if backend == "host"
                      else m["device_store"])(_params(), cfg)
        self.reg = m["registry"].MetricsRegistry()
        self.monitor = m["cluster"].ClusterMonitor(
            self.store, registry=self.reg, clock=clock)
        self.monitor.slo = m["slo"].SloEvaluator(registry=self.reg)
        self.service = m["service"].ParameterService(
            self.store, monitor=self.monitor, reject_nonfinite=True)
        self.engine = m["remediation"].RemediationEngine(
            self.store, service=self.service, clock=clock,
            registry=self.reg)
        self.monitor.remediation = self.engine
        self.monitor.add_listener(self.engine.handle_events)
        self.pack = m["service"].pack_msg
        self.unpack = m["service"].unpack_msg

    def run(self, op: str, args) -> object:
        svc, mon = self.service, self.monitor
        if op == "register":
            name, capable = args
            meta = {"worker_name": name}
            if capable:
                meta["capabilities"] = ["directives"]
            return svc.register_worker(self.pack(meta), None)
        if op == "report":
            wid, report = args
            return svc.fetch_parameters(self.pack(
                {"worker_id": wid, "health": report}), None)
        if op == "fetch_ack":
            wid, ack = args
            return svc.fetch_parameters(self.pack(
                {"worker_id": wid, "directives_ack": ack}), None)
        if op == "ingest":
            return mon.ingest(*args)
        if op == "pushes":
            accepted, stale = args
            out = [self.store.push(0, _grads(i), self.store.global_step)
                   for i in range(accepted)]
            return out + [self.store.push(1, _grads(10 + i), 0)
                          for i in range(stale)]
        if op == "latency":
            method, seconds, n = args
            hist = self.reg.histogram("dps_rpc_server_latency_seconds",
                                      buckets=PR.LATENCY_BUCKETS,
                                      method=method)
            for _ in range(n):
                hist.observe(seconds)
            return None
        if op == "corrupt":
            return mon.note_corrupt_frame()
        if op == "expire":
            return mon.note_expired(*args)
        if op == "evaluate":
            events = mon.evaluate()
            return (events, mon.active_alerts(evaluate=False),
                    list(self.engine.events), svc.quarantine_view(),
                    {w: svc.directives_for(w) for w in range(3)})
        if op == "view":
            return mon.cluster_view(evaluate=False)
        if op == "job_finished":
            return svc.job_finished(self.pack({"worker_id": args[0]}), None)
        raise ValueError(op)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_scripted_monitor_sequence_matches_jax(backend, monkeypatch,
                                               capsys):
    now = {"t": 0.0}
    monkeypatch.setattr(time, "time", lambda: 7_000.0 + now["t"])
    clock = time.time
    stacks = {pkg: Stack(pkg, backend, clock) for pkg in PACKAGES}
    fired = set()
    for i, (t, op, args) in enumerate(script()):
        now["t"] = float(t)
        want = stacks["jax"].run(op, args)
        got = stacks["port"].run(op, args)
        assert got == want, (i, t, op, got, want)
        if op == "evaluate":
            fired |= {(e["rule"], e["worker"]) for e in got[0]
                      if e["state"] == "fired"}
    # The script reached every rule it aims at, and the engine acted.
    assert {r for r, _ in fired} >= {
        "grad_explosion", "nonfinite_loss", "nonfinite_grad",
        "straggler_lag", "wire_corrupt", "staleness_spike", "slo_burn_fast",
        "slo_burn_slow", "dead_worker", "worker_stall", "loss_divergence",
        "loss_plateau"}
    port, jax_ = stacks["port"], stacks["jax"]
    actions = {(e["action"], e["worker"], e["outcome"])
               for e in port.engine.events}
    assert {("quarantine", 0, "ok"), ("refetch", 0, "ok"),
            ("quarantine", 2, "ok"), ("refetch", 2, "skipped"),
            ("quorum_exclude", 1, "ok"), ("rebalance", 1, "ok"),
            ("respawn", 2, "delegated"), ("quarantine", 0,
                                          "lifted")} <= actions
    assert port.engine.view() == jax_.engine.view()
    assert port.monitor.slo.view() == jax_.monitor.slo.view()
    assert port.reg.snapshot()["counters"] == jax_.reg.snapshot()["counters"]
    (jp, jstep), (pp, pstep) = jax_.store.snapshot(), port.store.snapshot()
    assert jstep == pstep == 3
    for k in jp:
        np.testing.assert_allclose(pp[k], jp[k], rtol=0, atol=1e-6)
    assert "REMEDIATION action=quarantine rule=nonfinite_loss worker=0 " \
        "outcome=ok" in capsys.readouterr().out


GARBLED = [
    None, 3, "report", [], {}, {"unknown": 1},
    {"step": "12", "epoch": 1.9, "loss": "2.5", "grad_norm": float("inf")},
    {"step": True, "loss": float("nan"), "grad_finite": 0},
    {"loss": "nan", "grad_norm": [1], "push_codec": "x" * 80},
    {"push_codec": "", "examples_per_s": "fast", "reconnects": "2"},
    {"loss_finite": "no", "goodput_fraction": -1e309, "pipeline_depth": 1.5},
]


@pytest.mark.parametrize("report", GARBLED, ids=range(len(GARBLED)))
def test_sanitize_report_matches_jax(report):
    got, want = PCL.sanitize_report(report), JCL.sanitize_report(report)
    assert got == want
    assert (PCL.ClusterMonitor(ParameterStore(_params()),
                               registry=PR.MetricsRegistry())
            .ingest(0, report)) == (want is not None)


def test_histogram_quantile_matches_jax():
    edges = list(PR.LATENCY_BUCKETS)
    rng = np.random.default_rng(3)
    for _ in range(20):
        counts = [int(c) for c in rng.integers(0, 5, len(edges) + 1)]
        for p in (50, 95, 99, 100):
            assert PST.histogram_quantile(edges, counts, p) \
                == JST.histogram_quantile(edges, counts, p)
    assert PST.histogram_quantile(edges, [0] * (len(edges) + 1), 99) is None


class Supervisor:
    def __init__(self):
        self.n = 2

    def count(self):
        return self.n

    def grow(self):
        self.n += 1

    def shrink(self):
        if self.n <= 0:
            return None
        self.n -= 1
        return self.n


@pytest.mark.parametrize("with_supervisor", [True, False])
def test_worker_autoscaler_decisions_match_jax(with_supervisor, capsys):
    pressure = [{"queue_depth": d, "stragglers": s, "workers": 2}
                for d, s in [(5, 0), (6, 0), (7, 0), (8, 0), (9, 0),
                             (2, 0), (0, 0), (0, 0), (0, 0), (0, 0),
                             (0, 1), (0.5, 0), (0.5, 0), (0.5, 0),
                             (0.5, 0), (0.5, 0), (0.5, 0), (0.5, 0)]]
    runs = {}
    for name, mod, reg in (("jax", JRM, JR), ("port", PRM, PR)):
        t = {"now": 0.0}
        feed = iter(pressure)
        scaler = mod.WorkerAutoscaler(
            "vision", lambda: next(feed),
            supervisor=Supervisor() if with_supervisor else None,
            policy=mod.WorkerAutoscalePolicy(cooldown_s=5.0,
                                             sustain_ticks=2),
            registry=reg.MetricsRegistry(), clock=lambda: t["now"])
        out = []
        for i in range(len(pressure)):
            t["now"] = 4.0 * i
            out.append(scaler.tick())
        runs[name] = (out, scaler.view())
    assert runs["port"] == runs["jax"]
    decisions = [e for e in runs["port"][0] if e is not None]
    assert {e["action"] for e in decisions} == {"worker_grow",
                                                "worker_shrink"}
    assert "WORKER_AUTOSCALE job=vision" in capsys.readouterr().out
    with pytest.raises(ValueError, match="depth_low"):
        PRM.WorkerAutoscalePolicy(depth_low=5.0, depth_high=4.0)


def test_slo_objective_errors_match_jax():
    for mod in (PSLO, JSLO):
        with pytest.raises(ValueError, match="target must be in"):
            mod.SloObjective("x", "FetchParameters", 1.0)
        with pytest.raises(ValueError, match="slow window"):
            mod.SloEvaluator(fast_window_s=10, slow_window_s=5,
                             registry=PR.MetricsRegistry())
    assert math.isclose(PSLO.SloObjective("x", "m", 0.99).budget, 0.01)


def test_concurrent_reports_directives_and_quarantines_lose_nothing():
    """More threads than cores, a shortened switch interval: ingests,
    evaluations, directive posts and quarantines racing on one port
    service and monitor lose no report and no directive seq."""
    import os
    import sys
    import threading

    store = ParameterStore(_params(), StoreConfig(mode="async",
                                                  total_workers=8))
    reg = PR.MetricsRegistry()
    monitor = PCL.ClusterMonitor(store, registry=reg)
    svc = PS.ParameterService(store, monitor=monitor)
    for i in range(8):
        svc.register_worker(PS.pack_msg({"worker_name": f"w{i}",
                                         "capabilities": ["directives"]}),
                            None)
    n_threads, rounds = (os.cpu_count() or 1) + 2, 60
    seqs, errors = [], []

    def run(t: int):
        wid = t % 8
        try:
            for k in range(rounds):
                assert monitor.ingest(wid, {"step": k, "loss": 1.0,
                                            "grad_norm": 1.0})
                seqs.append(svc.post_directive(wid, "drain"))
                svc.quarantine(wid, 30.0)
                svc.is_quarantined(wid)
                svc.unquarantine(wid)
                if k % 10 == 0:
                    monitor.evaluate()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert sorted(seqs) == list(range(1, n_threads * rounds + 1))
    assert reg.counter("dps_cluster_reports_total").value \
        == n_threads * rounds
    assert svc.quarantine_view() == {}
    assert all(len(svc.directives_for(w)) == PS.DIRECTIVES_PER_WORKER_CAP
               for w in range(8))
