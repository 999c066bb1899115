"""Delta-fed read replica: the wide cheap tier of the sharded topology.

The JAX package's ``comms/replica.py``, carried over whole (host code
over grpc; the port keeps its own copy, with the port's registry,
journal and tracing). A replica of either package mirrors a primary of
either package: both speak the same bytes.

A :class:`ReplicaServer` speaks the same four RPCs as a shard primary
(docs/WIRE_PROTOCOL.md) but holds no store at all — it subscribes to its
primary over the delta-fetch protocol (a background loop polls
``FetchParameters`` with ``have_step``; an idle primary answers with the
cached header-only NOT_MODIFIED reply, so an up-to-date replica costs the
primary a few bytes per poll) and serves fetch traffic from **cached
bytes**:

- the primary's tensor payload is kept VERBATIM — never decoded — and the
  full fetch reply is pre-encoded once per step, so serving a fetch is a
  dict lookup plus a socket write (this, times N replicas, is the
  serve tier's fetch-QPS lever);
- ``have_step`` fetches at the replica's current step get the pre-encoded
  NOT_MODIFIED reply — the delta protocol composes through the tier.

Writes don't belong here: RegisterWorker / PushGradrients / JobFinished
answer a ``redirect`` to the primary (docs/SHARDING.md "Routing rules").

**Staleness contract**: every successful poll (including NOT_MODIFIED —
the primary confirming "your step is current" is freshness) stamps
``last_sync``; once that stamp ages past ``staleness_bound_s`` the
replica REFUSES fetches (UNAVAILABLE, redirect in the detail) instead of
serving arbitrarily old params. A replica can be behind by at most one
poll interval of real data, and a partitioned replica fails loud.

Each poll announces ``replica: {shard_id, address, parent, tier, ...}``
in the fetch meta; the primary's ShardInfo (ps/sharding.py) turns that
plus ``have_step`` into the published replica membership and the
``dps_replica_lag_*`` gauges.

**Fan-out trees** (docs/SHARDING.md "Fan-out trees"): a replica can
subscribe to ANOTHER replica instead of the primary (``parent=``), so
the serve tier forms a tree — the primary feeds a few interior nodes,
each interior node re-serves the same delta protocol to its children.
Three mechanisms make the tree honest:

- **tiers**: each node learns its tier from its parent's reply head
  (primary replies are tier 0's, a parent replica stamps ``tier`` in
  its re-packed head), and the default staleness bound scales with it
  (``tier_staleness_bound``) — edge tiers tolerate proportionally more
  lag, while an explicit ``staleness_bound_s`` stays a per-node
  override. Child announces are cached and forwarded UPSTREAM as
  ``descendants``, so the whole subtree reaches the primary's shard
  view; the primary's topology flows DOWNSTREAM as a delta-gated
  ``topology`` attachment (``have_topology`` versioning, same
  discipline as the shard map).
- **coalescing**: identical delta polls (``have_step == current``)
  arriving while an upstream refresh is in flight park on a
  single-flight latch and are all answered from the one refreshed
  payload — the same pre-encoded bytes, zero extra encodes
  (``dps_replica_coalesced_total`` / ``dps_coalesce_ratio``).
- **re-parenting**: after ``reparent_after`` consecutive refresh
  failures the node picks a new subscribe source from its cached
  topology (prefer the dead parent's tier, i.e. own tier minus one;
  fall back to the primary), guarded by a ``reparent_cooldown_s``
  hysteresis window so a flapping parent cannot make children ricochet
  around the tree. Writes always redirect to the PRIMARY regardless of
  who feeds the subscription.

**Inference serving (canary-gated)**: with ``canary=True`` the replica
keeps a short HISTORY of per-step reply bytes instead of only the
latest, and splits ``infer`` fetches across two pinned steps — the
STABLE step serves ~95% of requests, the newest candidate (CANARY)
~5%. Clients report a quality score for responses they served
(``quality`` request meta); once both arms have enough samples the
:class:`CanaryController` either PROMOTES the candidate (its quality is
within tolerance of stable's) or ROLLS IT BACK (marks the step bad, so
it is never offered again). Training-path fetches are untouched — they
always serve the newest synced step (docs/SHARDING.md "Serve tier").
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent import futures

import grpc

from ..telemetry.journal import journal_event
from .service import GRPC_OPTIONS, SERVICE_NAME, pack_msg, unpack_msg

__all__ = ["CanaryController", "ReplicaServer", "tier_staleness_bound"]

#: Base staleness bound (tier 1 — a direct child of the primary keeps
#: the pre-tree default of 5 s).
DEFAULT_STALENESS_BOUND_S = 5.0

#: A child that stops polling is dropped from the forwarded
#: ``descendants`` after this long — same horizon as the primary's
#: ShardInfo replica expiry, so the two views age out together.
CHILD_EXPIRE_S = 30.0


def tier_staleness_bound(tier: int,
                         base: float = DEFAULT_STALENESS_BOUND_S) -> float:
    """Default staleness bound for a node at ``tier`` (docs/SHARDING.md
    "Fan-out trees"): bound = base × tier. Every hop adds at most one
    poll interval of real data lag plus one refresh of clock skew, so
    the tolerated announce age must grow linearly with depth — an edge
    node rejecting fetches because its *grandparent* was one base-bound
    late would make deep trees fail exactly when they are healthy."""
    return float(base) * max(1, int(tier))


class CanaryController:
    """Promote/rollback state machine over (stable_step, canary_step).

    Pure decision logic — no wire, no locks (the owner serializes calls
    under its own lock). Steps flow in via :meth:`offer` (each newer
    primary step becomes the candidate, unless previously rolled back),
    quality samples via :meth:`note_quality`, and :meth:`decide` resolves
    the race once BOTH arms have ``min_samples``: promote when the
    canary's mean quality is no worse than stable's minus ``tolerance``,
    roll back otherwise. Rolled-back steps land in ``bad_steps`` and are
    never re-offered — the regression stays fenced even though the
    training run that produced it keeps publishing newer steps."""

    def __init__(self, fraction: float = 0.05, min_samples: int = 20,
                 tolerance: float = 0.0, window: int = 256):
        if not 0.0 < fraction <= 0.5:
            raise ValueError(f"canary fraction must be in (0, 0.5], "
                             f"got {fraction}")
        #: Every ``period``-th infer request serves the canary arm —
        #: deterministic, so a test (or an operator reading loadgen
        #: percentiles) sees exactly the configured split.
        self.period = max(2, round(1.0 / float(fraction)))
        self.min_samples = max(1, int(min_samples))
        self.tolerance = float(tolerance)
        self.stable_step: int | None = None
        self.canary_step: int | None = None
        self.bad_steps: set[int] = set()
        self.promotions = 0
        self.rollbacks = 0
        self._requests = 0
        self._quality = {"stable": deque(maxlen=window),
                         "canary": deque(maxlen=window)}

    def offer(self, step: int) -> None:
        """A newly synced step: first ever becomes stable outright;
        anything newer becomes (or replaces) the canary candidate, with
        a fresh quality window — samples for an older candidate say
        nothing about this one."""
        step = int(step)
        if self.stable_step is None:
            self.stable_step = step
            return
        if step <= max(self.stable_step, self.canary_step or 0) \
                or step in self.bad_steps:
            return
        self.canary_step = step
        self._quality["canary"].clear()

    def pick_arm(self) -> str:
        """Route one infer request. Counter-based: request k goes to the
        canary iff a candidate exists and k % period == 0."""
        self._requests += 1
        if self.canary_step is not None \
                and self._requests % self.period == 0:
            return "canary"
        return "stable"

    def note_quality(self, arm: str, step: int, value: float) -> None:
        """Ingest one client-reported score. Stamped with the step the
        client was SERVED — feedback for a step that is no longer the
        arm's current step is dropped (it would pollute the window that
        decides a different step's fate)."""
        current = (self.stable_step if arm == "stable"
                   else self.canary_step)
        if current is not None and int(step) == current:
            self._quality[arm].append(float(value))

    def decide(self) -> str | None:
        """Resolve the candidate once both windows are full enough.
        Returns "promote" / "rollback" / None (still collecting)."""
        if self.canary_step is None:
            return None
        sq, cq = self._quality["stable"], self._quality["canary"]
        if len(sq) < self.min_samples or len(cq) < self.min_samples:
            return None
        stable_mean = sum(sq) / len(sq)
        canary_mean = sum(cq) / len(cq)
        if canary_mean >= stable_mean - self.tolerance:
            self.stable_step = self.canary_step
            self._quality["stable"] = deque(cq, maxlen=cq.maxlen)
            self.promotions += 1
            outcome = "promote"
        else:
            self.bad_steps.add(self.canary_step)
            self.rollbacks += 1
            outcome = "rollback"
        self.canary_step = None
        self._quality["canary"].clear()
        return outcome

    def view(self) -> dict:
        return {"stable_step": self.stable_step,
                "canary_step": self.canary_step,
                "promotions": self.promotions,
                "rollbacks": self.rollbacks,
                "bad_steps": sorted(self.bad_steps),
                "period": self.period}


class ReplicaServer:
    """Read-only cache of one shard primary, behind the PS wire."""

    def __init__(self, primary: str, port: int = 0, shard_id: int = 0,
                 advertise: str | None = None,
                 metrics_advertise: str | None = None,
                 poll_interval: float = 0.05,
                 staleness_bound_s: float | None = None,
                 rpc_timeout: float = 10.0,
                 clock=time.time,
                 canary: bool = False,
                 canary_fraction: float = 0.05,
                 canary_min_samples: int = 20,
                 canary_tolerance: float = 0.0,
                 history: int = 8,
                 faults=None,
                 parent: str | None = None,
                 reparent_after: int = 3,
                 reparent_cooldown_s: float = 5.0,
                 coalesce: bool = True,
                 coalesce_wait_s: float | None = None):
        self.primary = primary
        #: Subscribe source — the primary itself, or an interior replica
        #: when this node is a deeper tier of a fan-out tree. Writes
        #: ALWAYS redirect to ``primary``; only the refresh subscription
        #: follows ``parent`` (and re-parenting moves it).
        self.parent = parent or primary
        self.port = int(port)
        self.shard_id = int(shard_id)
        #: The address announced to the primary (what the shard map
        #: publishes to clients); filled from the bound port at start()
        #: when not given.
        self.advertise = advertise
        #: The metrics-endpoint address announced alongside it (host:port
        #: of this process's /metrics server, when one is running) — how
        #: the fleet collector (telemetry/fleet.py) discovers replicas as
        #: scrape targets from the primary's /cluster view.
        self.metrics_advertise = metrics_advertise
        self.poll_interval = float(poll_interval)
        #: Tier = parent's tier + 1, learned from the parent's reply
        #: head each poll (a primary reply carries no ``replica`` flag,
        #: so its children land at tier 1). Provisional until the first
        #: successful poll.
        self.tier = 1 if self.parent == self.primary else 2
        #: Explicit bound = per-node override; None = derived from the
        #: tier (``tier_staleness_bound``), re-derived when it changes.
        self._staleness_override = staleness_bound_s is not None
        self.staleness_bound_s = (float(staleness_bound_s)
                                  if self._staleness_override
                                  else tier_staleness_bound(self.tier))
        self.rpc_timeout = float(rpc_timeout)
        self.clock = clock
        self.reparent_after = max(1, int(reparent_after))
        self.reparent_cooldown_s = float(reparent_cooldown_s)
        self.coalesce = bool(coalesce)
        #: How long an identical delta poll parks on the single-flight
        #: latch before giving up and serving the (still valid) cached
        #: NOT_MODIFIED reply — bounded so a slow parent can never turn
        #: coalescing into consumer-visible hangs.
        self._coalesce_wait_s = (float(coalesce_wait_s)
                                 if coalesce_wait_s is not None
                                 else min(1.0, max(0.05,
                                                   4 * self.poll_interval)))
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._step: int | None = None     # guarded by: self._lock
        self._reply: bytes = b""          # guarded by: self._lock
        self._nm_reply: bytes = b""       # guarded by: self._lock
        self._last_sync: float | None = None  # guarded by: self._lock
        #: Single-flight refresh latch state: inflight is True while a
        #: poll RPC is on the wire; gen bumps when it lands (success OR
        #: failure), releasing parked fetches.
        self._refresh_inflight = False  # guarded by: self._lock
        self._refresh_gen = 0       # guarded by: self._lock
        self._poll_rounds = 0       # guarded by: self._lock
        self._coalesced_count = 0   # guarded by: self._lock
        self._serves = 0            # guarded by: self._lock
        #: address -> child announce row — the subtree this node
        #: forwards upstream as ``descendants``.
        self._children: dict[str, dict] = {}  # guarded by: self._lock
        #: Last adopted topology view + the head of the last content
        #: re-pack. ``_nm_topo_reply`` is the pre-encoded NOT_MODIFIED
        #: variant with the topology attached, served to children whose
        #: ``have_topology`` is behind.
        self._topology: dict | None = None  # guarded by: self._lock
        self._head: dict | None = None      # guarded by: self._lock
        self._nm_topo_reply: bytes = b""    # guarded by: self._lock
        #: Re-parent hysteresis stamp (poll-thread only).
        self._last_reparent = float("-inf")
        #: Canary serve state (all guarded by: self._lock). ``canary``
        #: is the controller or None (training-path replicas carry no
        #: history and serve infer fetches like plain fetches).
        self.canary = CanaryController(
            fraction=canary_fraction, min_samples=canary_min_samples,
            tolerance=canary_tolerance) if canary else None
        self._history = max(2, int(history))
        # step -> primary payload; guarded by: self._lock
        self._payloads: dict[int, bytes] = {}
        self._arm_replies: dict[str, bytes] = {}  # guarded by: self._lock
        # Deterministic replica-tier fault injection (comms/faults.py):
        # ``refresh.*`` rules wrap the subscription poll (this replica as
        # a client of its primary), ``subscribe.*`` rules its own serving
        # handler. Env DPS_FAULTS_REPLICA applies when the caller passes
        # nothing — autoscaler-spawned replicas inherit the environment,
        # so one seeded schedule covers the whole elastic tier.
        if faults is None:
            faults = os.environ.get("DPS_FAULTS_REPLICA") or None
        if faults is not None and isinstance(faults, str):
            from .faults import FaultInjector
            faults = FaultInjector(faults, side="replica")
        self.faults = faults
        #: Refresh backoff ceiling: a dead primary is polled at most this
        #: often instead of hammered at poll_interval (the worker
        #: heartbeat's discipline applied to the replica tier).
        self._backoff_cap = max(1.0, 20.0 * self.poll_interval)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._server: grpc.Server | None = None
        self._channel = None
        self._fetch_stub = None
        from ..telemetry import LATENCY_BUCKETS, get_registry
        reg = get_registry()
        self._tm_fetches = reg.counter("dps_replica_fetches_total")
        self._tm_refreshes = reg.counter("dps_replica_refreshes_total")
        # Refresh DURATION (wire transfer + re-pack) on the shared
        # LATENCY_BUCKETS scheme — distinct from dps_replica_lag_seconds,
        # which is an AGE gauge (time since last sync), not a duration.
        self._tm_refresh_hist = reg.histogram(
            "dps_replica_refresh_seconds", buckets=LATENCY_BUCKETS)
        self._tm_refresh_errors = reg.counter(
            "dps_replica_refresh_errors_total")
        # Serve-path latency (this replica answering client fetches,
        # incl. infer) on the SLO-grade scheme, with head-sampled trace
        # exemplars — the replica-tier half of the fleet observatory's
        # p99 -> trace join (docs/OBSERVABILITY.md "Fleet observatory").
        self._tm_serve_hist = reg.histogram(
            "dps_replica_serve_seconds", buckets=LATENCY_BUCKETS)
        from ..telemetry.registry import ExemplarSampler
        self._exemplars = ExemplarSampler(rate=0.1, seed=os.getpid())
        self._tm_stale = reg.counter("dps_replica_stale_rejects_total")
        self._tm_redirects = reg.counter("dps_replica_redirects_total")
        self._tm_step = reg.gauge("dps_replica_step")
        # Fan-out tree + coalescing surface (docs/SHARDING.md "Fan-out
        # trees"): polls counts every completed refresh round trip
        # (incl. NOT_MODIFIED — the denominator of the coalesce ratio),
        # coalesced counts delta polls answered off someone else's
        # refresh, and the ratio gauge is their cumulative quotient.
        self._tm_polls = reg.counter("dps_replica_polls_total")
        self._tm_coalesced = reg.counter("dps_replica_coalesced_total")
        self._tm_coalesce_ratio = reg.gauge("dps_coalesce_ratio")
        self._tm_reparents = reg.counter("dps_replica_reparents_total")
        self._tm_tier = reg.gauge("dps_replica_tier")
        self._tm_tier.set(self.tier)
        self._tm_infer = {arm: reg.counter("dps_infer_requests_total",
                                           arm=arm)
                          for arm in ("stable", "canary")}
        self._tm_promote = reg.counter("dps_canary_promotions_total")
        self._tm_rollback = reg.counter("dps_canary_rollbacks_total")
        self._tm_stable_step = reg.gauge("dps_canary_stable_step")

    # -- subscription (replica -> primary) -----------------------------------

    # dpslint: hot-path — one refresh per primary step; re-pack only
    def _poll_once(self) -> None:
        """One refresh poll. The raw reply BYTES are the cache — the
        tensor payload is never decoded here, so a replica's refresh
        cost is the wire transfer plus one envelope re-pack, regardless
        of model size. While the RPC is on the wire the single-flight
        latch is raised: identical delta polls from children park on it
        and are all answered from this one refresh."""
        t0 = time.perf_counter()
        with self._lock:
            have = self._step
            serves = self._serves
            desc = self._descendant_rows_locked()
            topo_have = int((self._topology or {}).get("version", 0))
            self._refresh_inflight = True
        try:
            announce = {"shard_id": self.shard_id,
                        "address": self.advertise,
                        # parent/tier: poll-thread-only writes; other
                        # threads only ever read the atomic reference.
                        "parent": self.parent, "tier": self.tier,  # dpslint: ignore[thread-shared]
                        "fetches": serves}
            if self.metrics_advertise:
                # Adopted by the fleet collector's discovery pass via the
                # primary's sharding view (docs/OBSERVABILITY.md).
                announce["metrics"] = self.metrics_advertise
            if desc:
                # Forward the cached subtree so announces compose through
                # interior nodes — the primary's shard view sees every
                # tier, not just its direct children.
                announce["descendants"] = desc
            meta: dict = {"replica": announce, "have_topology": topo_have}
            if have is not None:
                meta["have_step"] = int(have)
            raw = self._fetch_stub(pack_msg(meta),
                                   timeout=self.rpc_timeout)
            rmeta, payload = unpack_msg(raw)
        except Exception:  # noqa: BLE001 — release the latch, re-raise
            with self._lock:
                self._refresh_done_locked()
            raise
        now = self.clock()
        # Tier = parent's tier + 1. A primary reply carries no
        # ``replica`` flag; a pre-tree parent replica stamps the flag
        # but no ``tier`` — assume tier 1 (it only ever fed off a
        # primary).
        ptier = int(rmeta.get("tier") or 1) if rmeta.get("replica") else 0
        self._set_tier(ptier + 1)
        topo = rmeta.get("topology")
        if rmeta.get("not_modified"):
            with self._lock:
                self._last_sync = now
                if isinstance(topo, dict):
                    self._adopt_topology_locked(topo)
                self._refresh_done_locked()
            self._tm_polls.inc()
            self._tm_refresh_hist.observe(time.perf_counter() - t0)
            return
        step = int(rmeta["global_step"])
        # Re-pack with the replica's own envelope over the primary's
        # payload bytes, once per step; every client fetch then serves
        # these exact bytes.
        head = {"global_step": step, "replica": True,
                "shard_id": self.shard_id, "tier": self.tier}
        reply = pack_msg(head, bytes(payload))
        nm_reply = pack_msg({**head, "not_modified": True})
        with self._lock:
            self._step = step
            self._reply = reply
            self._nm_reply = nm_reply
            self._head = head
            self._last_sync = now
            if isinstance(topo, dict):
                self._adopt_topology_locked(topo)
            elif self._topology is not None:
                self._repack_topo_reply_locked()
            if self.canary is not None:
                self._payloads[step] = bytes(payload)
                self.canary.offer(step)
                self._evict_history_locked()
                self._repack_arms_locked()
            self._refresh_done_locked()
        self._tm_refreshes.inc()
        self._tm_polls.inc()
        self._tm_step.set(step)
        self._tm_refresh_hist.observe(time.perf_counter() - t0)

    def _set_tier(self, tier: int) -> None:
        """Adopt a (possibly changed) tier: re-derive the staleness
        bound unless this node pinned an explicit override. Cached reply
        heads keep the old tier until the next content refresh — a
        transient that only delays children's own tier update by one
        step (docs/SHARDING.md "Fan-out trees")."""
        tier = max(1, int(tier))
        if tier == self.tier:
            return
        self.tier = tier
        if not self._staleness_override:
            # Poll-thread-only write of an atomic float reference; the
            # serve gate reads whichever bound is current.
            self.staleness_bound_s = tier_staleness_bound(tier)  # dpslint: ignore[thread-shared]
        self._tm_tier.set(tier)

    def _refresh_done_locked(self) -> None:
        """Lower the single-flight latch (success or failure) and
        release every parked delta poll — on failure they fall back to
        the still-valid cached reply rather than waiting out a backoff
        cycle."""
        self._refresh_inflight = False
        self._refresh_gen += 1
        self._poll_rounds += 1
        self._cond.notify_all()

    def _adopt_topology_locked(self, topo: dict) -> None:
        """Adopt a newer topology view from upstream and pre-encode the
        NOT_MODIFIED + topology variant children hydrate from."""
        have = int((self._topology or {}).get("version", 0))
        if int(topo.get("version", 0)) <= have:
            return
        self._topology = topo
        self._repack_topo_reply_locked()

    def _repack_topo_reply_locked(self) -> None:
        if self._head is not None and self._topology is not None:
            self._nm_topo_reply = pack_msg(
                {**self._head, "not_modified": True,
                 "topology": self._topology})

    def _descendant_rows_locked(self) -> list[dict]:
        """Flatten the cached child announces (plus THEIR descendants)
        into the rows forwarded upstream; silent children age out on
        the shared expiry horizon. Bounded — a malformed subtree cannot
        balloon the announce envelope."""
        now = self.clock()
        for addr in [a for a, row in self._children.items()
                     if now - row.get("ts", now) > CHILD_EXPIRE_S]:
            del self._children[addr]
        rows: list[dict] = []
        for row in self._children.values():
            rows.append({k: row[k]
                         for k in ("address", "shard_id", "parent",
                                   "tier", "step", "fetches", "metrics")
                         if row.get(k) is not None})
            rows.extend(row.get("descendants") or [])
        return rows[:64]

    def _note_child(self, meta: dict) -> None:
        """Ingest a child replica's announce (this node as its subscribe
        source): cache the row + its forwarded subtree so the next
        upstream poll relays the whole branch. Mirrors the primary's
        ShardInfo.note_replica, tier-tagged and keyed by address so a
        re-announce replaces rather than duplicates."""
        rep = meta.get("replica")
        if not isinstance(rep, dict) or not rep.get("address"):
            return
        row = {"address": str(rep["address"]),
               "shard_id": rep.get("shard_id", self.shard_id),
               "parent": rep.get("parent") or self.advertise,
               "tier": int(rep.get("tier") or self.tier + 1),
               "step": meta.get("have_step", 0),
               "fetches": rep.get("fetches"),
               "metrics": rep.get("metrics"),
               "descendants": rep.get("descendants") or [],
               "ts": self.clock()}
        with self._lock:
            self._children[row["address"]] = row

    def _evict_history_locked(self) -> None:
        """Cap the step history, never evicting a step an arm is pinned
        to — the stable payload must survive arbitrarily many newer
        steps."""
        pinned = {self.canary.stable_step, self.canary.canary_step}
        for step in sorted(self._payloads):
            if len(self._payloads) <= self._history:
                break
            if step not in pinned:
                del self._payloads[step]

    def _repack_arms_locked(self) -> None:
        """Pre-encode one full reply PER ARM (same once-per-change
        discipline as the train-path cache): serving an infer request is
        then a dict lookup regardless of model size."""
        arms: dict[str, bytes] = {}
        for arm, step in (("stable", self.canary.stable_step),
                          ("canary", self.canary.canary_step)):
            payload = self._payloads.get(step) if step is not None else None
            if payload is not None:
                arms[arm] = pack_msg(
                    {"global_step": step, "serving_step": step,
                     "arm": arm, "replica": True,
                     "shard_id": self.shard_id}, payload)
        self._arm_replies = arms
        if self.canary.stable_step is not None:
            self._tm_stable_step.set(self.canary.stable_step)

    def _poll_loop(self) -> None:
        """Refresh forever, backing off a dead primary. Consecutive
        failures double the wait up to ``_backoff_cap`` (capped
        exponential — an unreachable primary sees a few polls per
        second-ish, not a poll_interval-rate hammer), one log line per
        FAILING/RECOVERED transition, every failure counted. The
        staleness stamp keeps aging throughout, so the serve gate still
        fails loud."""
        failing = False
        failures = 0
        delay = self.poll_interval
        while not self._stop.is_set():
            try:
                self._poll_once()
            except Exception as e:  # noqa: BLE001 — any refresh failure backs off
                self._tm_refresh_errors.inc()
                failures += 1
                if not failing:
                    failing = True
                    print(f"REPLICA_REFRESH_FAILING shard={self.shard_id} "
                          f"primary={self.primary} parent={self.parent} "
                          f"error={type(e).__name__}", flush=True)
                if failures >= self.reparent_after \
                        and self._maybe_reparent():
                    failures = 0
                    delay = self.poll_interval
                    continue
                self._stop.wait(delay)
                delay = min(delay * 2.0, self._backoff_cap)
                continue
            if failing:
                failing = False
                print(f"REPLICA_REFRESH_RECOVERED shard={self.shard_id} "
                      f"primary={self.primary} parent={self.parent}",
                      flush=True)
            failures = 0
            delay = self.poll_interval
            self._stop.wait(self.poll_interval)

    def _maybe_reparent(self) -> bool:
        """Sustained refresh failure: re-point the subscription at a new
        source picked from the cached topology, preferring the dead
        parent's own tier (our tier minus one) and falling back to the
        primary. The cooldown is the hysteresis guard — a flapping
        parent cannot make a child ricochet around the tree faster than
        once per window. Returns True when the stub was re-pointed."""
        now = time.monotonic()
        if now - self._last_reparent < self.reparent_cooldown_s:
            return False
        target = self._pick_parent()
        if target is None or target == self.parent:
            if self.parent == self.primary:
                return False
            target = self.primary
        self._last_reparent = now
        old, self.parent = self.parent, target
        self._connect()
        self._tm_reparents.inc()
        journal_event("reparent", shard=self.shard_id, old=old,
                      new=target, tier=self.tier)
        print(f"REPLICA_REPARENTED shard={self.shard_id} old={old} "
              f"new={target} tier={self.tier}", flush=True)
        return True

    def _pick_parent(self) -> str | None:
        """Choose a re-parent target from the cached topology: nodes at
        tier (own − 1) that are not us, not the dead parent, and not in
        our own subtree (adopting a descendant would close a cycle);
        lowest announced lag wins, address as the deterministic tie
        break. None = no candidate (caller falls back to the primary)."""
        with self._lock:
            topo = self._topology
            subtree = set(self._children)
        if not isinstance(topo, dict):
            return None
        nodes = [n for n in (topo.get("nodes") or [])
                 if isinstance(n, dict) and n.get("address")]
        by_addr = {str(n["address"]): n for n in nodes}
        # Close the subtree over the topology's parent pointers: any
        # node whose ancestry walks through us is ours.
        for addr in by_addr:
            a, seen = addr, set()
            while a in by_addr and a not in seen:
                seen.add(a)
                a = by_addr[a].get("parent")
                if a == self.advertise:
                    subtree.add(addr)
                    break
        want = max(1, self.tier - 1)
        pool = sorted(
            (float(n.get("lag_steps") or 0.0), str(n["address"]))
            for n in nodes
            if int(n.get("tier") or 1) == want
            and str(n["address"]) not in subtree
            and n["address"] not in (self.advertise, self.parent))
        if not pool:
            return str(topo.get("primary") or self.primary)
        return pool[0][1]

    def _connect(self) -> None:
        """(Re)build the subscription channel + stub to ``self.parent``,
        re-applying the refresh-side fault wrapper (the injector object
        is shared, so deterministic ``n=``/``every=`` schedules keep
        counting across a re-parent)."""
        ident = lambda b: b  # noqa: E731
        # stop() join()s the poll thread before touching _channel — the
        # join is the happens-before edge, no lock needed.
        if self._channel is not None:  # dpslint: ignore[thread-shared]
            self._channel.close()
        self._channel = grpc.insecure_channel(self.parent,
                                              options=GRPC_OPTIONS)
        stub = self._channel.unary_unary(
            f"/{SERVICE_NAME}/FetchParameters",
            request_serializer=ident, response_deserializer=ident)
        if self.faults is not None:
            from .faults import REFRESH_OP, _FaultyCall
            stub = _FaultyCall(stub, self.faults, REFRESH_OP)
        self._fetch_stub = stub

    # -- serving (client -> replica) -----------------------------------------

    def _fresh_or_abort(self, ctx):
        now = self.clock()
        with self._lock:
            last = self._last_sync
        if last is None or now - last > self.staleness_bound_s:
            self._tm_stale.inc()
            ctx.abort(grpc.StatusCode.UNAVAILABLE,
                      f"replica stale (last sync "
                      f"{'never' if last is None else round(now - last, 2)}"
                      f"); use primary {self.primary}")

    # dpslint: hot-path — the fetch-QPS lever: dict lookup + write
    def _fetch_parameters(self, request: bytes, ctx) -> bytes:
        self._fresh_or_abort(ctx)
        meta, _ = unpack_msg(request)
        if self.canary is not None and meta.get("infer"):
            return self._serve_infer(meta)
        self._note_child(meta)
        have = meta.get("have_step")
        topo_have = meta.get("have_topology")
        self._tm_fetches.inc()
        with self._lock:
            self._serves += 1
            if have is not None and self._step is not None \
                    and int(have) == self._step:
                if self.coalesce and self._refresh_inflight:
                    # Single-flight latch: an identical delta poll
                    # arriving mid-refresh parks here; when the refresh
                    # lands every parked poll is answered from the one
                    # refreshed payload — the same pre-encoded bytes,
                    # zero extra encodes or upstream RPCs.
                    gen = self._refresh_gen
                    self._cond.wait_for(lambda: self._refresh_gen != gen,
                                        timeout=self._coalesce_wait_s)
                    self._coalesced_count += 1
                    self._tm_coalesced.inc()
                    self._tm_coalesce_ratio.set(
                        self._coalesced_count
                        / max(1, self._poll_rounds))
                    if self._step is not None \
                            and int(have) != self._step:
                        return self._reply
                if topo_have is not None and self._nm_topo_reply \
                        and self._topology is not None \
                        and int(topo_have) < int(
                            self._topology.get("version", 0)):
                    # Child behind on topology: serve the pre-encoded
                    # NOT_MODIFIED + topology variant so the view
                    # propagates down the tree (delta-gated — an
                    # up-to-date child gets the bare NM bytes).
                    return self._nm_topo_reply
                return self._nm_reply
            return self._reply

    def _serve_infer(self, meta: dict) -> bytes:
        """One inference request against the canary-split serve tier
        (docs/SHARDING.md "Serve tier"): ingest any piggybacked quality
        feedback, resolve the candidate if both windows filled, then
        route this request to an arm and answer its pre-encoded reply.
        Freshness was already gated by the caller."""
        q = meta.get("quality")
        with self._lock:
            if isinstance(q, dict):
                try:
                    self.canary.note_quality(str(q["arm"]),
                                             int(q["step"]),
                                             float(q["value"]))
                except (KeyError, TypeError, ValueError):
                    pass  # malformed feedback never fails the serve
                outcome = self.canary.decide()
                if outcome is not None:
                    (self._tm_promote if outcome == "promote"
                     else self._tm_rollback).inc()
                    self._evict_history_locked()
                    self._repack_arms_locked()
            arm = self.canary.pick_arm()
            reply = self._arm_replies.get(arm) \
                or self._arm_replies.get("stable")
            if arm == "canary" and "canary" not in self._arm_replies:
                arm = "stable"  # candidate vanished between pick and pack
            self._tm_infer[arm].inc()
            return reply if reply is not None else self._reply

    def _timed_serve(self, fn):
        """Wrap the (possibly fault-wrapped) serve handler with the
        serve-latency histogram + head-sampled trace exemplars. Installed
        OUTSIDE the fault injector so injected serve-path latency lands
        in the histogram the fleet rollups merge — the observability
        plane must see the faults it exists to surface. Tracing off:
        one perf_counter pair + an observe."""
        from ..telemetry import trace_enabled, trace_span

        def wrapped(request: bytes, ctx) -> bytes:
            t0 = time.perf_counter()
            if not trace_enabled():
                try:
                    return fn(request, ctx)
                finally:
                    self._tm_serve_hist.observe(time.perf_counter() - t0)
            sp = None
            try:
                with trace_span("rpc.replica_serve",
                                shard=self.shard_id) as sp:
                    return fn(request, ctx)
            finally:
                dur = time.perf_counter() - t0
                tid = getattr(getattr(sp, "ctx", None), "trace_id", None)
                if tid is not None and self._exemplars.sample():
                    self._tm_serve_hist.observe(dur, exemplar=tid)
                else:
                    self._tm_serve_hist.observe(dur)
        return wrapped

    def _redirect(self, request: bytes, ctx) -> bytes:
        self._tm_redirects.inc()
        return pack_msg({"accepted": False, "received": False,
                         "acknowledged": False, "replica": True,
                         "redirect": self.primary,
                         "shard_id": self.shard_id})

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> int:
        """Bind, start serving and polling. Returns the bound port."""
        ident = lambda b: b  # noqa: E731
        fetch_handler = self._fetch_parameters
        if self.faults is not None:
            # The serving direction decides under its own pseudo-op so a
            # schedule can fail serve traffic without touching the
            # subscription (and vice versa).
            from .faults import SUBSCRIBE_OP
            fetch_handler = self.faults.wrap_handler(SUBSCRIBE_OP,
                                                     fetch_handler)
        fetch_handler = self._timed_serve(fetch_handler)
        handlers = grpc.method_handlers_generic_handler(SERVICE_NAME, {
            name: grpc.unary_unary_rpc_method_handler(
                fn, request_deserializer=ident, response_serializer=ident)
            for name, fn in [("FetchParameters", fetch_handler),
                             ("RegisterWorker", self._redirect),
                             ("PushGradrients", self._redirect),
                             ("JobFinished", self._redirect)]
        })
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=20),
            options=GRPC_OPTIONS)
        self._server.add_generic_rpc_handlers((handlers,))
        # The JAX server's wildcard ``[::]``; where the host has no IPv6,
        # IPv4's ``0.0.0.0`` (as ``comms/service.py:serve`` does).
        try:
            bound = self._server.add_insecure_port(f"[::]:{self.port}")
        except RuntimeError:
            bound = 0
        if not bound:
            bound = self._server.add_insecure_port(f"0.0.0.0:{self.port}")
        if not bound:
            raise RuntimeError(f"could not bind port {self.port}")
        self.port = bound
        if self.advertise is None:
            self.advertise = f"localhost:{bound}"
        self._server.start()
        self._connect()
        self._thread = threading.Thread(target=self._poll_loop,
                                        name="replica-poll", daemon=True)
        self._thread.start()
        return bound

    def stop(self, grace: float = 0.5) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._server is not None:
            self._server.stop(grace).wait()
        if self._channel is not None:
            self._channel.close()

    def view(self) -> dict:
        """Local status (cli replica logs it; tests poke it)."""
        now = self.clock()
        with self._lock:
            last = self._last_sync
            out = {"primary": self.primary, "parent": self.parent,
                   "tier": self.tier, "shard_id": self.shard_id,
                   "address": self.advertise, "step": self._step,
                   "synced": last is not None,
                   "sync_age_s": (None if last is None
                                  else round(max(0.0, now - last), 3)),
                   "staleness_bound_s": self.staleness_bound_s,
                   "children": len(self._children),
                   "coalesced": self._coalesced_count,
                   "polls": self._poll_rounds}
            if self.canary is not None:
                out["canary"] = self.canary.view()
            return out
