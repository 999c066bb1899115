"""Prometheus text exposition (format 0.0.4) over stdlib HTTP.

The JAX package's ``telemetry/prometheus.py``, carried over whole (it is
framework-neutral) with the port's registry, cluster monitor and flight
recorder. Serves ``GET /metrics`` from the same process as the gRPC
parameter server (``cli serve --metrics-port N``) — the pull-based
complement to the push-style snapshot stream. ``GET /healthz`` answers
200 with a tiny JSON body (503 naming the offenders while the cluster
monitor holds a critical alert), ``GET /cluster`` serves the monitor's
view, ``GET /metrics.json`` the registry snapshot and
``GET /debug/trace`` the flight recorder's tail.

No third-party dependency: the renderer writes the text format directly and
``ThreadingHTTPServer`` (stdlib) serves it. Scrapes read instrument
snapshots under each instrument's own lock — consistent per instrument,
lock-free across instruments, never blocking a hot path for the whole
scrape.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .registry import Histogram, MetricsRegistry, get_registry

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_OK = re.compile(r"[^a-zA-Z0-9_]")


def _name(n: str) -> str:
    return _NAME_OK.sub("_", n)


def _labels(labels: dict, extra: str = "") -> str:
    parts = [f'{_LABEL_OK.sub("_", k)}="{v}"'
             for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: float) -> str:
    return repr(v) if isinstance(v, float) and not v.is_integer() \
        else str(int(v))


def render_prometheus(registry: MetricsRegistry | None = None) -> str:
    """Registry -> Prometheus text format. Histograms render cumulative
    ``_bucket{le=...}`` series (the registry stores per-bucket counts;
    the cumulative sum happens here), plus ``_sum``/``_count``."""
    registry = registry or get_registry()
    lines: list[str] = []
    seen_types: set[str] = set()
    for inst in registry.collect():
        name = _name(inst.name)
        if name not in seen_types:
            seen_types.add(name)
            lines.append(f"# TYPE {name} {inst.kind}")
        if isinstance(inst, Histogram):
            snap = inst.snapshot()
            cum = 0
            for le, c in zip(snap["le"], snap["counts"]):
                cum += c
                extra = 'le="%s"' % _fmt(le)
                lines.append(f"{name}_bucket{_labels(inst.labels, extra)} "
                             f"{cum}")
            cum += snap["counts"][-1]
            inf_extra = 'le="+Inf"'
            lines.append(f"{name}_bucket{_labels(inst.labels, inf_extra)} "
                         f"{cum}")
            lines.append(f"{name}_sum{_labels(inst.labels)} "
                         f"{_fmt(snap['sum'])}")
            lines.append(f"{name}_count{_labels(inst.labels)} "
                         f"{snap['count']}")
        else:
            lines.append(f"{name}{_labels(inst.labels)} "
                         f"{_fmt(inst.value)}")
    return "\n".join(lines) + "\n"


class _MetricsHandler(BaseHTTPRequestHandler):
    registry: MetricsRegistry  # set by start_metrics_server

    def do_GET(self):  # noqa: N802 (http.server API)
        path, _, query = self.path.partition("?")
        status = 200
        if path == "/metrics":
            body = render_prometheus(self.registry).encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/metrics.json":
            # The registry snapshot verbatim:
            # NON-cumulative bucket counts + exemplars, i.e. the exact
            # shape merge_histograms consumes. The fleet collector
            # prefers this over re-deriving it from the lossier
            # cumulative text rendering.
            body = json.dumps(self.registry.snapshot()).encode()
            ctype = "application/json"
        elif path == "/healthz":
            # Readiness semantics: with a cluster
            # monitor attached, an active CRITICAL alert flips the probe
            # to 503 with a body naming the offenders — a k8s/LB can now
            # rotate a server whose cluster is on fire, not just one whose
            # HTTP thread died. A broken monitor degrades to 200 (losing
            # the readiness signal must not take down serving traffic).
            payload: dict = {"ok": True}
            from .cluster import get_cluster_monitor
            monitor = get_cluster_monitor()
            if monitor is not None:
                try:
                    critical = [
                        {"rule": a["rule"], "worker": a["worker"],
                         "message": a["message"]}
                        for a in monitor.active_alerts()
                        if a["severity"] == "critical"]
                    if critical:
                        status = 503
                        payload = {"ok": False, "critical": critical}
                except Exception as e:  # noqa: BLE001
                    payload = {"ok": True, "monitor_error": repr(e)}
            body = json.dumps(payload).encode()
            ctype = "application/json"
        elif path == "/cluster":
            # Live cluster health view: the
            # ClusterMonitor's worker table + active alerts, evaluated
            # fresh per request; `cli status` renders this payload.
            from .cluster import get_cluster_monitor
            monitor = get_cluster_monitor()
            if monitor is None:
                status = 404
                body = json.dumps(
                    {"error": "no cluster monitor in this process "
                              "(serve runs one unless --no-health-monitor)"}
                ).encode()
            else:
                try:
                    body = json.dumps(monitor.cluster_view()).encode()
                except Exception as e:  # noqa: BLE001
                    status = 500
                    body = json.dumps({"error": repr(e)}).encode()
            ctype = "application/json"
        elif path == "/debug/trace":
            # On-demand flight-recorder dump: the
            # same payload a SIGTERM post-mortem writes, served live.
            # ``?n=100`` limits to the most recent N spans.
            from .trace import get_recorder, trace_enabled
            n = None
            for part in query.split("&"):
                if part.startswith("n="):
                    try:
                        n = max(0, int(part[2:]))
                    except ValueError:
                        pass
            payload = get_recorder().dump_payload(reason="on_demand", n=n)
            payload["enabled"] = trace_enabled()
            body = json.dumps(payload).encode()
            ctype = "application/json"
        else:
            self.send_error(404)
            return
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # scrapes must not spam stdout —
        pass                       # METRICS_JSON lines live there


def start_metrics_server(registry: MetricsRegistry | None = None,
                         port: int = 0, addr: str = "0.0.0.0"
                         ) -> tuple[ThreadingHTTPServer, int]:
    """Start the exposition endpoint on a daemon thread.

    Returns (server, bound_port) — pass ``port=0`` to pick a free port
    (tests), a fixed one for real deployments. Callers own shutdown
    (``server.shutdown()``).
    """
    handler = type("BoundMetricsHandler", (_MetricsHandler,),
                   {"registry": registry or get_registry()})
    server = ThreadingHTTPServer((addr, port), handler)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="telemetry-http").start()
    return server, server.server_address[1]
