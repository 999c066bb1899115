"""The port's fleet observatory (``…_torch/telemetry/fleet.py``) against
the JAX package's: the same canned ``/metrics.json``, ``/metrics`` and
``/cluster`` bodies of two shard primaries (each with its ``sharding``
block), served from in-thread HTTP servers on loopback, scraped by both
packages' ``FleetCollector`` on one injected clock. The views, the SLO
readings, the collectors' own instruments and the HTTP surface must be
equal, with the wall-clock fields (a scrape's milliseconds) excluded by
name. Then the CLI renderers over the view: ``status --via-fleet``'s
synthesized cluster view, ``top``'s dashboard, sparklines and exit
codes, each equal to the JAX CLI's. Every scrape has a 5 s timeout."""

from __future__ import annotations

import copy
import json
import random
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from distributed_parameter_server_for_ml_training_tpu import cli as JC
from distributed_parameter_server_for_ml_training_tpu.telemetry import (
    fleet as JF, registry as JR, slo as JS)
from distributed_parameter_server_for_ml_training_tpu_torch import cli as PC
from distributed_parameter_server_for_ml_training_tpu_torch.telemetry import (
    fleet as PF, prometheus as PP, registry as PR, slo as PS)

TIMEOUT_S = 5.0
FETCH = "dps_rpc_server_latency_seconds{method=FetchParameters}"
#: Fields read off the host's wall clock, not the injected one.
WALL_FIELDS = ("scrape_ms", "last_ms")


class Canned:
    """One fake fleet process serving fixed bodies: ``/metrics.json`` and
    ``/metrics`` rendered once from a port registry, ``/cluster`` from a
    dict (None: 404, as a process without a monitor)."""

    def __init__(self, registry, cluster=None, json_snapshot=True):
        self.bodies = {}
        self.set(registry, cluster, json_snapshot)

        outer = self

        class H(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                body = outer.bodies.get(self.path.partition("?")[0])
                if body is None:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def set(self, registry, cluster=None, json_snapshot=True) -> None:
        bodies = {"/metrics": PP.render_prometheus(registry).encode()}
        if json_snapshot:
            bodies["/metrics.json"] = json.dumps(
                registry.snapshot()).encode()
        if cluster is not None:
            bodies["/cluster"] = json.dumps(cluster).encode()
        self.bodies = bodies

    @property
    def target(self) -> str:
        return f"127.0.0.1:{self.port}"

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def _registry(rng, shard: int, scale: float = 1.0):
    """A shard primary's registry, from ``rng``: RPC latencies and calls,
    store counters, a gauge."""
    reg = PR.MetricsRegistry()
    for method in ("FetchParameters", "PushGradrients"):
        h = reg.histogram("dps_rpc_server_latency_seconds",
                          buckets=PR.LATENCY_BUCKETS_S, method=method)
        for _ in range(rng.randint(5, 40)):
            h.observe(rng.choice([rng.uniform(0.001, 0.02),
                                  rng.uniform(0.02, 0.3) * scale]))
        reg.counter("dps_rpc_server_calls_total", rpc=method).inc(
            rng.randint(10, 90))
        reg.counter("dps_rpc_server_errors_total", method=method).inc(
            rng.randint(0, 2))
    reg.counter("dps_store_fetches_total", backend="python").inc(
        rng.randint(1, 50))
    reg.gauge("dps_store_global_step").set(float(rng.randint(0, 16)))
    reg.gauge("dps_shard_owned_keys").set(float(30 + shard))
    return reg


def _cluster(shard: int, peers: list, step: int, replica=None) -> dict:
    """A shard primary's ``/cluster`` view with its ``sharding`` block."""
    sharding = {"shard_id": shard, "shard_count": len(peers),
                "map_version": 1, "primaries": peers, "replicas": []}
    if replica is not None:
        sharding["replicas"].append(replica)
    return {"role": "server", "pid": 1000 + shard, "mode": "async",
            "global_step": step,
            "workers": [{"worker": w, "alive": True, "step": step,
                         "report": {"step": step}} for w in range(2)],
            "alerts": [], "alerts_total": {"critical": 0, "warning": 0,
                                           "info": 0},
            "remediation": {"active": [], "dry_run": False},
            "sharding": sharding}


def _strip(obj):
    """``obj`` without the wall-clock fields, recursively."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in WALL_FIELDS}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _collectors(targets, now, **kw):
    """(JAX collector, port collector), each on its own registry and on
    the shared injected clock ``now``."""
    kw.setdefault("interval_s", 0.05)
    kw.setdefault("timeout_s", TIMEOUT_S)
    return (JF.FleetCollector(targets, registry=JR.MetricsRegistry(),
                              clock=lambda: now[0], **kw),
            PF.FleetCollector(targets, registry=PR.MetricsRegistry(),
                              clock=lambda: now[0], **kw))


@pytest.fixture
def primaries():
    rng = random.Random(21)
    procs = [Canned(_registry(rng, i)) for i in range(2)]
    peers = [f"127.0.0.1:{5000 + i}" for i in range(2)]
    for i, p in enumerate(procs):
        p.set(_registry(rng, i), _cluster(i, peers, 4))
    yield procs, peers, rng
    for p in procs:
        p.stop()


def test_rollup_catalog_and_text_parser_equal():
    assert PF.FLEET_ROLLUP_FIELDS == JF.FLEET_ROLLUP_FIELDS
    assert PF._QPS_FAMILIES == JF._QPS_FAMILIES
    rng = random.Random(3)
    text = PP.render_prometheus(_registry(rng, 0))
    assert PF.parse_prometheus_text(text) == JF.parse_prometheus_text(text)
    assert PF._normalize_target("h:1/") == JF._normalize_target("h:1/")
    assert PF._since_param("a=1&since=7") == JF._since_param("a=1&since=7")


def test_views_equal_over_two_shard_primaries(primaries):
    """Ticks over the two primaries, their bodies changing between
    ticks: every view equal, the merged histogram the union of the
    shards' (its count their sum), both shards found through their
    ``sharding`` blocks."""
    procs, peers, rng = primaries
    now = [1_700_000_000.0]
    jc, pc = _collectors([p.target for p in procs], now)
    for tick in range(4):
        for c in (jc, pc):
            res = c.tick()
            assert (res["ok"], res["failed"]) == (2, 0)
        jv, pv = jc.view(), pc.view()
        assert _strip(pv) == _strip(jv)
        shard_ids = sorted(r["shard_id"] for r in pv["tiers"]["primaries"])
        assert shard_ids == [0, 1]
        assert pv["tiers"]["primary_addresses"] == sorted(peers)
        snaps = [json.loads(p.bodies["/metrics.json"]) for p in procs]
        merged = pv["rollups"]["histograms"][FETCH]
        assert merged["count"] == sum(s["histograms"][FETCH]["count"]
                                      for s in snaps)
        now[0] += 5.0
        for i, p in enumerate(procs):
            p.set(_registry(rng, i), _cluster(i, peers, 4 * (tick + 2)))
    jr, pr = jc.registry.snapshot(), pc.registry.snapshot()
    for snap in (jr, pr):
        snap["histograms"].pop("dps_fleet_scrape_seconds")
    assert pr == jr


def test_slo_readings_equal_and_breach_over_merged_series():
    """Slow fetches on both shards: the fleet-scope evaluator of each
    package reads the same objectives, windows and breaches."""
    rng = random.Random(5)
    peers = ["127.0.0.1:1", "127.0.0.1:2"]
    procs = [Canned(_registry(rng, i, scale=20.0),
                    _cluster(i, peers, 3)) for i in range(2)]
    now = [1_700_000_000.0]
    try:
        jc = JF.FleetCollector([p.target for p in procs],
                               registry=JR.MetricsRegistry(),
                               timeout_s=TIMEOUT_S, clock=lambda: now[0],
                               objectives=JS.default_objectives(
                                   fetch_p99_ms=50.0))
        pc = PF.FleetCollector([p.target for p in procs],
                               registry=PR.MetricsRegistry(),
                               timeout_s=TIMEOUT_S, clock=lambda: now[0],
                               objectives=PS.default_objectives(
                                   fetch_p99_ms=50.0))
        for _ in range(3):
            jc.tick()
            pc.tick()
            assert pc.view()["slo"] == jc.view()["slo"]
            now[0] += 20.0
            for i, p in enumerate(procs):
                p.set(_registry(rng, i, scale=20.0), _cluster(i, peers, 3))
        slo = pc.view()["slo"]
        assert slo["scope"] == "fleet"
        assert {b["objective"] for b in slo["breaches"]} >= \
            {"fetch_latency"}
        assert PC._top_exit_code(pc.view()) == JC._top_exit_code(jc.view())
    finally:
        for p in procs:
            p.stop()


def test_discovery_text_fallback_and_dead_target_equal():
    """A primary announcing a replica's metrics address (adopted, then
    drained), a replica serving only ``/metrics`` text, and a dead
    target: the same targets, stale flags, rollups and error series."""
    rng = random.Random(9)
    replica = Canned(_registry(rng, 9), json_snapshot=False)
    rep_row = {"address": "127.0.0.1:7", "step": 3, "lag_steps": 1,
               "tier": 1, "metrics": replica.target}
    primary = Canned(_registry(rng, 0),
                     _cluster(0, ["127.0.0.1:1"], 4, replica=rep_row))
    dead = Canned(_registry(rng, 1))
    dead_target = dead.target
    dead.stop()
    now = [1_700_000_000.0]
    jc, pc = _collectors([primary.target, dead_target], now)
    try:
        for step in range(3):
            if step == 2:   # the primary stops announcing the replica
                primary.set(_registry(rng, 0),
                            _cluster(0, ["127.0.0.1:1"], 5))
            for c in (jc, pc):
                c.tick()
            assert _strip(pc.view()) == _strip(jc.view())
            jr, pr = jc.registry.snapshot(), pc.registry.snapshot()
            for snap in (jr, pr):
                snap["histograms"].pop("dps_fleet_scrape_seconds")
            assert pr == jr
            now[0] += 2.0
        rows = {t["target"]: t for t in pc.view()["targets"]}
        assert rows[f"http://{dead_target}"]["stale"]
        assert f"http://{replica.target}" not in rows
    finally:
        primary.stop()
        replica.stop()


def test_http_surface_equal(primaries):
    procs, _, _ = primaries
    now = [1_700_000_000.0]
    jc, pc = _collectors([p.target for p in procs], now)
    servers = [JF.start_fleet_server(jc, port=0, addr="127.0.0.1"),
               PF.start_fleet_server(pc, port=0, addr="127.0.0.1")]
    try:
        for _ in range(3):
            jc.tick()
            pc.tick()
            now[0] += 1.0
        got = []
        for _, port in servers:
            base = f"http://127.0.0.1:{port}"
            full = json.loads(urllib.request.urlopen(
                base + "/fleet", timeout=TIMEOUT_S).read())
            since = json.loads(urllib.request.urlopen(
                base + "/fleet?since=2", timeout=TIMEOUT_S).read())
            text = urllib.request.urlopen(
                base + "/metrics", timeout=TIMEOUT_S).read().decode()
            health = json.loads(urllib.request.urlopen(
                base + "/healthz", timeout=TIMEOUT_S).read())
            got.append((_strip(full), _strip(since), health,
                        "dps_fleet_ticks_total 3" in text))
        assert got[1] == got[0]
        assert got[1][1]["history_since"] == 2
        assert len(got[1][1]["history"]["fleet_qps"]) == 1
        assert got[1][3]
    finally:
        for server, _ in servers:
            server.shutdown()
            server.server_close()


def test_cli_renderers_equal_on_the_view(primaries):
    """``status --via-fleet`` and ``top`` render a real view the same."""
    procs, _, _ = primaries
    now = [1_700_000_000.0]
    _, pc = _collectors([p.target for p in procs], now)
    pc.tick()
    view = pc.view()
    view["alerts"] = [{"rule": "dead_worker", "severity": "critical",
                       "worker": 1, "message": "m", "target": "t"}]
    for v in (view, {}, {"history": {"p99_ms": [None, 1.0, 3.0]}}):
        assert PC._render_top(copy.deepcopy(v)) == \
            JC._render_top(copy.deepcopy(v))
        assert PC._top_exit_code(v) == JC._top_exit_code(v)
        cv = PC._cluster_view_from_fleet(v)
        assert cv == JC._cluster_view_from_fleet(v)
        assert PC._render_status(cv) == JC._render_status(cv)
    for values in ([], [None, 2.0], [1.0, 1.0], [0.0, 3.5, 7.0, None]):
        assert PC._sparkline(values) == JC._sparkline(values)
    local, hist = None, None
    for ticks, since in ((3, None), (5, 3), (2, 5)):
        v = {"ticks": ticks, "history": {"fleet_qps": [1.0] * ticks}}
        if since is not None:
            v["history_since"] = since
        jv, pv = copy.deepcopy(v), copy.deepcopy(v)
        hist = JC._merge_top_history(hist, jv, since)
        local = PC._merge_top_history(local, pv, since)
        assert pv == jv
        assert {k: list(r) for k, r in local.items()} == \
            {k: list(r) for k, r in hist.items()}
