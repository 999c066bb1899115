"""A journal and an incident bundle for the forensics tests, written by
either package's telemetry (its ``JournalWriter``, ``IncidentCapture``,
``GoodputAccount``, registry and snapshot payloads) on an injected
clock: a seeded fault, two minutes of snapshots of a server's RPC
latencies and a worker's goodput ledger, a critical alert whose edge
freezes the bundle, then the directive, the remediation and the
resolution that follow the edge in the journal's later records."""

from __future__ import annotations

import os
import random
import types

T0 = 1_700_000_000.0
RULE = "nonfinite_loss"


class Clock:
    def __init__(self, t: float = T0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def telemetry(package: str) -> types.SimpleNamespace:
    """The telemetry modules of ``package`` the writer needs."""
    import importlib
    mods = {m: importlib.import_module(f"{package}.telemetry.{m}")
            for m in ("goodput", "incidents", "journal", "registry",
                      "snapshot")}
    return types.SimpleNamespace(**mods)


def write_forensics(root: str, t: types.SimpleNamespace,
                    seed: int = 11) -> dict:
    """The journal under ``root/journal`` and the bundle under
    ``root/incidents``. Returns their directories and the bundle's
    path."""
    clk = Clock()
    rng = random.Random(seed)
    jdir = os.path.join(root, "journal")
    idir = os.path.join(root, "incidents")
    own = t.registry.MetricsRegistry()
    journal = t.journal.JournalWriter(jdir, role="server", registry=own,
                                      clock=clk)
    capture = t.incidents.IncidentCapture(
        idir, journal=journal,
        views_fn=lambda: {"cluster": {"workers": [{"worker": 1}],
                                      "alerts": [{"rule": RULE}]}},
        window_s=60.0, cooldown_s=120.0, role="server", registry=own,
        clock=clk)
    live = t.registry.MetricsRegistry()
    hists = {m: live.histogram("dps_rpc_server_latency_seconds",
                               buckets=t.registry.LATENCY_BUCKETS_S,
                               method=m)
             for m in ("FetchParameters", "PushGradrients")}
    errors = live.counter("dps_rpc_server_errors_total",
                          method="FetchParameters")
    account = t.goodput.GoodputAccount(registry=live, clock=clk)
    account.start_wall()
    journal.append("fault", {"spec": "seed=7;push.drop_reply@n=2"})
    bundle = None
    for k in range(24):
        clk.advance(5.0)
        for method, h in hists.items():
            for _ in range(rng.randint(4, 12)):
                slow = method == "FetchParameters" and 8 <= k <= 12
                h.observe(rng.uniform(0.15, 0.6) if slow
                          else rng.uniform(0.002, 0.04))
        if k == 10:
            errors.inc(3)
        account.add("compute", 3.0 + rng.random())
        account.add("fetch_wait", 0.5 + rng.random())
        account.add("startup" if k == 0 else "push_wait", 0.25)
        account.tick_wall()
        snap = live.snapshot()
        journal.append("snapshot", t.snapshot.SnapshotEmitter
                       ._journal_payload({"kind": "snapshot",
                                          "uptime_seconds": 5.0 * (k + 1),
                                          **snap}))
        if k == 12:
            edge = {"state": "fired", "severity": "critical", "rule": RULE,
                    "worker": 1, "value": "nan"}
            journal.append("alert", {k2: v for k2, v in edge.items()})
            capture.on_alert_events([edge])
            bundle = os.path.join(idir, sorted(os.listdir(idir))[0])
        if k == 13:
            journal.append("directive", {"action": "skip_push",
                                         "worker": 1, "seq": 1})
            journal.append("remediation", {"action": "quarantine_worker",
                                           "outcome": "applied",
                                           "rule": RULE, "worker": 1})
        if k == 17:
            journal.append("alert", {"state": "resolved",
                                     "severity": "critical", "rule": RULE,
                                     "worker": 1})
    journal.seal()
    return {"journal": jdir, "incidents": idir, "bundle": bundle,
            "live": live}
