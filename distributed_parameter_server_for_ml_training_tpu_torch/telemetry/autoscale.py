"""Replica autoscaler: measured fetch load -> replica fleet size.

The JAX package's ``telemetry/autoscale.py``, carried over whole (plain
Python; the port keeps its own copy over the port's registry and
remediation counter). The serve tier made read capacity HORIZONTAL
(docs/SHARDING.md: replicas are cheap byte-caches) but left its size an
operator constant. This module closes that loop at the
shard primary — the one process that already measures the two signals
that matter:

- **fetch QPS** at the primary (``dps_rpc_handler_calls_total{rpc=
  FetchParameters}`` plus any colocated replica's serve counter), read as
  counter DELTAS between ticks — the same snapshot-delta discipline the
  ETL uses, so the autoscaler sees exactly what dashboards see;
- **replica lag** (``dps_replica_lag_steps`` via ShardInfo's view): a
  fleet that cannot keep up with the delta-feed is a reason to stop
  shrinking, not to grow — more replicas multiply the primary's feed
  fan-out, they don't speed it up.

Decisions follow the remediation engine's discipline (telemetry/
remediation.py): rate-limited by a cooldown, bounded by [min, max],
dry-runnable, every decision counted in
``dps_remediation_actions_total{action=replica_grow|replica_shrink}``
and kept in a bounded event list the cluster view serves. The EXECUTE
half lives in :class:`~..ps.supervisor.ReplicaPool` (spawning ``cli
replica`` children); the autoscaler stays a pure policy head so tests
drive it with a fake pool and a fake QPS source.

Ticked from the :class:`~.cluster.ClusterMonitor` background loop
(``monitor.autoscaler = ...``; ``cli serve --autoscale`` wires it) — the
monitor already owns the "periodically look at the cluster" thread, and
a tick that raises must never take the serve loop down, so the monitor's
swallow-and-continue loop is exactly the right host.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

from .registry import get_registry
from .remediation import note_action

__all__ = ["AutoscalePolicy", "ReplicaAutoscaler"]

#: Decisions kept for the cluster view (the remediation EVENTS_KEPT idiom).
EVENTS_KEPT = 128


@dataclass
class AutoscalePolicy:
    """Scaling knobs (documented in docs/SHARDING.md "Serve tier")."""

    #: Grow when windowed fetch QPS exceeds this.
    qps_high: float = 50.0
    #: Shrink when windowed fetch QPS falls below this. Must sit well
    #: under ``qps_high`` — the gap is the hysteresis band that keeps a
    #: load hovering at one threshold from flapping the fleet.
    qps_low: float = 5.0
    #: A replica this many steps behind blocks shrinking (losing a
    #: replica while the fleet lags only concentrates the feed).
    lag_high_steps: float = 10.0
    min_replicas: int = 0
    max_replicas: int = 4
    #: Minimum seconds between consecutive scaling actions.
    cooldown_s: float = 10.0
    #: Compute and record every decision; touch the pool never.
    dry_run: bool = False
    #: Deepest tier a new replica may land at. 1 = flat star (every
    #: replica a direct child of the primary — the pre-tree behavior);
    #: >1 lets a grow spawn under the hottest eligible interior node
    #: (docs/SHARDING.md "Fan-out trees").
    max_tier: int = 1
    #: Per-node child budget: a node already feeding this many children
    #: is not an eligible parent — growth spreads across the tree
    #: instead of piling onto one hot interior node.
    fanout: int = 2

    def __post_init__(self):
        if self.qps_low >= self.qps_high:
            raise ValueError(f"qps_low ({self.qps_low}) must be < "
                             f"qps_high ({self.qps_high})")
        if not 0 <= self.min_replicas <= self.max_replicas:
            raise ValueError(f"need 0 <= min ({self.min_replicas}) <= "
                             f"max ({self.max_replicas})")
        if self.max_tier < 1 or self.fanout < 1:
            raise ValueError(f"need max_tier >= 1 (got {self.max_tier}) "
                             f"and fanout >= 1 (got {self.fanout})")


class ReplicaAutoscaler:
    """QPS/lag policy head over a :class:`~..ps.supervisor.ReplicaPool`."""

    def __init__(self, pool, policy: AutoscalePolicy | None = None,
                 sharding=None, registry=None, clock=time.time,
                 fetch_total_fn=None):
        self.pool = pool
        self.policy = policy or AutoscalePolicy()
        #: Optional ShardInfo — supplies the replica-lag view.
        self.sharding = sharding
        self.clock = clock
        self._reg = registry or get_registry()
        self._fetch_total_fn = fetch_total_fn or self._fetch_total
        self._lock = threading.Lock()
        # QPS window anchor: (ts, fetch_total). guarded by: self._lock
        self._window: tuple[float, float] | None = None
        # -inf: the FIRST action is never cooldown-held (a fresh
        # autoscaler facing real load must act now, not in cooldown_s).
        self._last_action_ts = float("-inf")  # guarded by: self._lock
        self._events: deque = deque(maxlen=EVENTS_KEPT)  # guarded by: self._lock
        self.actions = {"replica_grow": 0, "replica_shrink": 0}
        self._tm_qps = self._reg.gauge("dps_autoscale_fetch_qps")
        self._tm_target = self._reg.gauge("dps_autoscale_target_replicas")

    # -- signals --------------------------------------------------------------

    def _fetch_total(self) -> float:
        """Sum of every fetch-serving counter this process hosts. Read
        from the registry SNAPSHOT (not held instrument handles): the
        serving instruments belong to the service/replica objects, and a
        label-blind prefix scan keeps this correct when new fetch-shaped
        series appear."""
        total = 0.0
        counters = self._reg.snapshot()["counters"]
        for key, value in counters.items():
            if (key.startswith("dps_rpc_handler_calls_total")
                    and "rpc=FetchParameters" in key) \
                    or key.startswith("dps_replica_fetches_total"):
                total += float(value)
        return total

    def _max_lag_steps(self) -> float:
        if self.sharding is None:
            return 0.0
        try:
            replicas = self.sharding.view().get("replicas") or []
            return max((float(r.get("lag_steps") or 0.0)
                        for r in replicas), default=0.0)
        except Exception:  # noqa: BLE001 — lag is advisory, never fatal
            return 0.0

    def _tier_rollup(self) -> dict:
        """Per-tier {replicas, max_lag_steps, fetch_qps} from the shard
        view — recorded on every decision so the event stream shows the
        tree shape the policy acted on."""
        if self.sharding is None:
            return {}
        try:
            return dict(self.sharding.view().get("tiers") or {})
        except Exception:  # noqa: BLE001 — advisory, never fatal
            return {}

    def _pick_parent(self, qps: float) -> str | None:
        """Tree-aware grow placement (docs/SHARDING.md "Fan-out trees"):
        rank every node that may still take children — the primary
        (tier 0, by its windowed QPS) and each replica at a tier below
        ``max_tier`` with fewer than ``fanout`` children (by its
        announced per-node ``fetch_qps``) — and spawn under the HOTTEST
        one; the new child drains polls from exactly where the serve
        load concentrates. Returns an address, or None for the primary
        (the flat-star behavior, and the whole story when
        ``max_tier == 1``)."""
        p = self.policy
        if p.max_tier <= 1 or self.sharding is None:
            return None
        try:
            view = self.sharding.view()
            rows = view.get("replicas") or []
        except Exception:  # noqa: BLE001 — placement is advisory
            return None
        primaries = view.get("primaries") or []
        children: dict[str, int] = {}
        for r in rows:
            parent = r.get("parent") or "<primary>"
            if parent in primaries:
                parent = "<primary>"
            children[parent] = children.get(parent, 0) + 1
        best_addr, best_qps = None, float(qps) \
            if children.get("<primary>", 0) < p.fanout else None
        for r in rows:
            addr = r.get("address")
            if not addr or int(r.get("tier") or 1) >= p.max_tier \
                    or children.get(addr, 0) >= p.fanout:
                continue
            node_qps = float(r.get("fetch_qps") or 0.0)
            if best_qps is None or node_qps > best_qps:
                best_addr, best_qps = str(addr), node_qps
        return best_addr

    # -- control --------------------------------------------------------------

    def tick(self) -> dict | None:
        """One control pass; returns the decision record when one was
        made (incl. holds for cooldown/bounds), None while the first
        window anchors or nothing changed."""
        now = self.clock()
        total = float(self._fetch_total_fn())
        with self._lock:
            anchor = self._window
            self._window = (now, total)
        if anchor is None:
            return None
        dt = now - anchor[0]
        if dt <= 0:
            return None
        qps = max(0.0, total - anchor[1]) / dt
        self._tm_qps.set(qps)
        live = int(self.pool.count())
        lag = self._max_lag_steps()
        p = self.policy
        action = None
        if live < p.min_replicas:
            action = "replica_grow"
        elif qps > p.qps_high and live < p.max_replicas:
            action = "replica_grow"
        elif qps < p.qps_low and live > p.min_replicas \
                and lag <= p.lag_high_steps:
            action = "replica_shrink"
        if action is None:
            self._tm_target.set(live)
            return None
        with self._lock:
            if now - self._last_action_ts < p.cooldown_s:
                outcome = "rate_limited"
            elif p.dry_run:
                outcome = "dry_run"
            else:
                self._last_action_ts = now
                outcome = "ok"
        parent = None
        if outcome == "ok":
            try:
                if action == "replica_grow":
                    parent = self._pick_parent(qps)
                    # Positional-free call keeps 1-arg pools (tests,
                    # legacy fakes) working when placement is flat.
                    if parent is None:
                        self.pool.grow()
                    else:
                        self.pool.grow(parent=parent)
                    live += 1
                elif self.pool.shrink() is not None:
                    live -= 1
            except Exception:  # noqa: BLE001 — a failed spawn is an
                outcome = "error"  # outcome, not a monitor-loop crash
        self._tm_target.set(live)
        note_action(action, outcome, registry=self._reg)
        if outcome == "ok":
            self.actions[action] += 1
        event = {"ts": round(now, 3), "action": action,
                 "outcome": outcome, "qps": round(qps, 1),
                 "max_lag_steps": lag, "live": live}
        if parent is not None:
            event["parent"] = parent
        tiers = self._tier_rollup()
        if tiers:
            event["tiers"] = tiers
        with self._lock:
            self._events.append(event)
        return event

    # -- read side ------------------------------------------------------------

    def view(self) -> dict:
        with self._lock:
            events = list(self._events)
        return {"live": int(self.pool.count()),
                "min": self.policy.min_replicas,
                "max": self.policy.max_replicas,
                "qps_high": self.policy.qps_high,
                "qps_low": self.policy.qps_low,
                "dry_run": self.policy.dry_run,
                "max_tier": self.policy.max_tier,
                "fanout": self.policy.fanout,
                "actions": dict(self.actions),
                "events": events[-16:]}
