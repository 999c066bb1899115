"""Consistent-hash parameter sharding and the shard map.

The JAX package's ``ps/sharding.py``, carried over whole (it is plain
Python; the port keeps its own copy). The single parameter server holds
every canonical tensor, the ceiling on both training fan-in and any
serve-path read load. This module is the partitioning layer under the
sharded topology: parameter NAMES are consistent-hashed into a fixed
slot space, slot ranges are owned by N primary shards, and each shard
may publish read-only replicas that subscribe to it over the
delta-fetch protocol.

Everything that routes (the worker's push/fetch fan-out in
``comms/sharded.py``, each shard's key-subset filter in ``cli serve
--shard-index``, the replica announce path, the checkpoint identity
check) derives from the same two pure functions here
(:func:`shard_for_key` / :func:`partition_keys`), so no two layers can
disagree about who owns a tensor.

The **shard map** is the wire artifact, a JAX server's byte for byte:
published in the registration reply when a server runs sharded,
refreshed via fetch-reply meta exactly like the qscale table (the
client sends ``have_shard_map``, the server attaches the map only when
its version is newer), and capability-gated: an unsharded server never
advertises it, an old client never asks, and either pairing degrades to
the single-server wire.
"""

from __future__ import annotations

import threading
import time
import zlib

__all__ = [
    "SHARD_MAP_FIELDS",
    "SHARD_SLOTS",
    "ShardInfo",
    "key_slot",
    "partition_keys",
    "shard_for_key",
    "shard_for_slot",
    "slot_range",
    "validate_ranges",
    "validate_shard_map",
]

#: Fixed consistent-hash slot space. Key -> slot assignment NEVER moves
#: when the shard count changes; only the slot-range -> shard ownership
#: does — so a rebalance remaps whole contiguous ranges instead of
#: rehashing every tensor (docs/SHARDING.md "Rebalance semantics").
SHARD_SLOTS = 64

#: The shard-map wire schema: field name -> one-line meaning, the field
#: table of docs/SHARDING.md (``tests/test_torch_sharding.py`` holds it
#: equal to the JAX package's table, which the docs test pins).
SHARD_MAP_FIELDS = {
    "version": "monotonic map revision; refresh is delta-gated on it "
               "(have_shard_map handshake)",
    "slots": "size of the consistent-hash slot space (SHARD_SLOTS)",
    "shard_count": "number of primary shards owning slot ranges",
    "shards": "one entry per shard: shard_id, slot_range, primary, "
              "replicas",
    "shard_id": "this entry's shard index in [0, shard_count)",
    "slot_range": "[lo, hi) slot interval this shard owns",
    "primary": "the shard primary's host:port (push + authoritative "
               "fetch)",
    "replicas": "host:port list of live delta-fed read replicas behind "
                "this shard",
}


def key_slot(name: str, slots: int = SHARD_SLOTS) -> int:
    """The consistent-hash slot a parameter name lives in — forever.
    Every routing decision (canonical or live-resharded) starts here."""
    return zlib.crc32(str(name).encode("utf-8")) % slots


def shard_for_key(name: str, shard_count: int,
                  slots: int = SHARD_SLOTS) -> int:
    """Owning shard index for a parameter name under the CANONICAL
    launch-time partition (equal contiguous ranges).

    crc32 over the name, folded into the fixed slot space, then mapped to
    the shard owning that slot's range. Pure and stable: every layer
    (worker fan-out, shard key filter, checkpoint identity) computes the
    same answer forever, and adding shards moves only whole slot ranges.
    After a live reshard the authoritative answer is the published map's
    ranges (:func:`shard_for_slot`); this stays the boot-time seed.
    """
    if shard_count < 1:
        raise ValueError(f"shard_count must be >= 1, got {shard_count}")
    slot = key_slot(name, slots)
    # Contiguous ranges: shard i owns [i*slots//N, (i+1)*slots//N).
    return min(shard_count - 1, slot * shard_count // slots)


def shard_for_slot(slot: int, ranges) -> int:
    """Owning shard index for a slot under LIVE (possibly resharded)
    ranges — one ``[lo, hi)`` pair per shard, contiguous and ordered
    (what :func:`validate_ranges` guarantees). Raises ``ValueError`` if
    no range covers the slot (a malformed map that validation rejects
    anyway)."""
    for i, (lo, hi) in enumerate(ranges):
        if lo <= slot < hi:
            return i
    raise ValueError(f"slot {slot} not covered by ranges {list(ranges)}")


def validate_ranges(ranges, shard_count: int,
                    slots: int = SHARD_SLOTS) -> list[tuple[int, int]]:
    """Validate a live slot-range partition: one ``[lo, hi)`` per shard,
    ordered, contiguous (entry i starts where i-1 ended), first at 0,
    last at ``slots`` — together: disjoint and covering. Empty ranges
    (``lo == hi``) are legal: a merge can leave a shard owning nothing.
    Returns normalized tuples; raises ``ValueError`` on anything else."""
    if len(ranges) != shard_count:
        raise ValueError(f"need one slot range per shard: got "
                         f"{len(ranges)} for shard_count={shard_count}")
    norm: list[tuple[int, int]] = []
    prev_hi = 0
    for i, pair in enumerate(ranges):
        try:
            lo, hi = (int(x) for x in pair)
        except (TypeError, ValueError) as e:
            raise ValueError(f"bad slot range {i}: {pair!r}") from e
        if lo != prev_hi or hi < lo:
            raise ValueError(f"slot ranges must be an ordered contiguous "
                             f"partition: entry {i} is [{lo}, {hi}) after "
                             f"[.., {prev_hi})")
        norm.append((lo, hi))
        prev_hi = hi
    if prev_hi != slots:
        raise ValueError(f"slot ranges cover [0, {prev_hi}), "
                         f"want [0, {slots})")
    return norm


def slot_range(shard_id: int, shard_count: int,
               slots: int = SHARD_SLOTS) -> tuple[int, int]:
    """The [lo, hi) slot interval shard ``shard_id`` owns."""
    if not 0 <= shard_id < shard_count:
        raise ValueError(f"shard_id {shard_id} outside "
                         f"[0, {shard_count})")
    return (shard_id * slots // shard_count,
            (shard_id + 1) * slots // shard_count)


def partition_keys(keys, shard_count: int) -> list[list[str]]:
    """Split parameter names into per-shard key lists (deterministic:
    input order preserved within each shard). Every shard's serve process
    and every worker derive the same partition from the same two
    arguments — there is no partition state to distribute."""
    out: list[list[str]] = [[] for _ in range(shard_count)]
    for k in keys:
        out[shard_for_key(k, shard_count)].append(k)
    return out


def validate_shard_map(m) -> dict:
    """Validate a wire shard map; returns it normalized. Raises
    ``ValueError`` on anything malformed — the CLIENT calls this before
    adopting a refresh, so a garbled map degrades to the cached one
    (the caller swallows the error), never to misrouted pushes."""
    if not isinstance(m, dict):
        raise ValueError("shard map must be an object")
    try:
        version = int(m["version"])
        slots = int(m.get("slots", SHARD_SLOTS))
        shard_count = int(m["shard_count"])
        shards = m["shards"]
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"bad shard map: {e}") from e
    if shard_count < 1 or slots < shard_count:
        raise ValueError(f"bad shard map: shard_count={shard_count} "
                         f"slots={slots}")
    if not isinstance(shards, list) or len(shards) != shard_count:
        raise ValueError("bad shard map: shards list does not match "
                         "shard_count")
    norm = []
    for i, s in enumerate(shards):
        if not isinstance(s, dict):
            raise ValueError(f"bad shard entry {i}")
        try:
            sid = int(s["shard_id"])
            primary = str(s["primary"])
            lo, hi = (int(x) for x in s["slot_range"])
            replicas = [str(r) for r in s.get("replicas", [])]
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"bad shard entry {i}: {e}") from e
        if sid != i:
            raise ValueError(f"bad shard entry {i}: id mismatch")
        norm.append({"shard_id": sid, "slot_range": [lo, hi],
                     "primary": primary, "replicas": replicas})
    # Ranges need not be the canonical equal split — live resharding
    # moves boundaries — but they MUST still tile the slot space: any
    # gap/overlap would orphan or double-own keys.
    validate_ranges([s["slot_range"] for s in norm], shard_count, slots)
    return {"version": version, "slots": slots,
            "shard_count": shard_count, "shards": norm}


class ShardInfo:
    """One shard primary's live sharding state (held by the
    ``ParameterService`` when ``cli serve`` runs sharded).

    Owns the authoritative copy of this server's shard map — the static
    topology (``--shard-peers``) plus the LIVE replica membership learned
    from replica announces riding fetch meta — and the replica lag
    bookkeeping behind the ``dps_replica_lag_*`` gauges and the
    ``GET /cluster`` / ``cli status`` shard rows.

    Thread-safety: announces arrive on gRPC handler threads; the map and
    the lag table are read by every registration/fetch reply and by the
    monitor's view. One small lock covers both.
    """

    #: A replica silent for this long drops out of the published map (and
    #: its lag gauges stop updating) — liveness is announce-driven, there
    #: is no replica heartbeat channel.
    REPLICA_EXPIRE_S = 30.0

    def __init__(self, shard_id: int, shard_count: int,
                 primaries: list[str], clock=time.time):
        if len(primaries) != shard_count:
            raise ValueError(
                f"need one primary address per shard: got "
                f"{len(primaries)} for shard_count={shard_count}")
        if not 0 <= shard_id < shard_count:
            raise ValueError(f"shard_id {shard_id} outside "
                             f"[0, {shard_count})")
        self.shard_id = int(shard_id)
        self.shard_count = int(shard_count)
        self.primaries = [str(p) for p in primaries]
        self.clock = clock
        self._lock = threading.Lock()
        self._version = 1
        # Live slot ownership, seeded canonical; a reshard moves these
        # boundaries (adopt_ranges) and bumps the version so every
        # cached client map refreshes. guarded by: self._lock
        self._ranges: list[tuple[int, int]] = [
            slot_range(i, self.shard_count) for i in range(self.shard_count)]
        #: replica address -> {"step": int, "ts": float, "lag_steps": int}
        self._replicas: dict[str, dict] = {}
        from ..telemetry import get_registry
        reg = get_registry()
        self._tm_id = reg.gauge("dps_shard_id")
        self._tm_count = reg.gauge("dps_shard_count")
        self._tm_map_version = reg.gauge("dps_shard_map_version")
        self._tm_replicas = reg.gauge("dps_shard_replicas")
        self._tm_id.set(self.shard_id)
        self._tm_count.set(self.shard_count)
        self._tm_map_version.set(self._version)
        self._reg = reg
        self._tm_lag: dict[str, tuple] = {}
        #: parent address -> child-count gauge (guarded by: self._lock;
        #: removed via registry.remove when a node loses its last child).
        self._tm_children: dict[str, object] = {}
        #: Optional zero-arg callable returning the in-flight migration
        #: block for ``view()`` (or None when idle). The owning service
        #: installs its ``migration_view`` here so ``GET /cluster``
        #: surfaces live reshard state without sharding importing comms.
        self.migration_provider = None

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def my_range(self) -> tuple[int, int]:
        """The ``[lo, hi)`` slot interval THIS shard currently owns."""
        with self._lock:
            return self._ranges[self.shard_id]

    def owns_slot(self, slot: int) -> bool:
        with self._lock:
            lo, hi = self._ranges[self.shard_id]
        return lo <= slot < hi

    def ranges(self) -> list[tuple[int, int]]:
        with self._lock:
            return list(self._ranges)

    def adopt_ranges(self, ranges, version: int | None = None) -> int:
        """Install a new live slot partition (a reshard commit or the
        admin's post-migration broadcast). ``version``, when given, is
        the coordinator-chosen map revision — floored at one past the
        current version so the map NEVER goes backwards and every
        ``have_shard_map`` client refreshes. Returns the new version.
        Raises ``ValueError`` on a malformed partition (nothing adopted).
        """
        norm = validate_ranges(ranges, self.shard_count)
        with self._lock:
            self._ranges = norm
            bump = self._version + 1
            self._version = max(bump, int(version or 0))
            self._tm_map_version.set(self._version)
            return self._version

    def note_replica(self, address: str, step, global_step: int,
                     metrics: str | None = None,
                     parent: str | None = None,
                     tier=None, fetches=None) -> None:
        """Ingest one replica announce (rides the replica's refresh fetch
        meta). A NEW address bumps the map version so subscribed clients
        refresh; a known one just updates lag — EXCEPT when its
        ``parent`` changed (a re-parent), which is a topology edit and
        bumps the version too, REPLACING the row in place (announce
        dedup: rows are keyed by address, so a re-parented replica never
        duplicates itself). ``metrics`` is the replica's /metrics
        endpoint when it announces one — published in :meth:`view` so
        the fleet collector (telemetry/fleet.py) can adopt the replica
        as a scrape target. ``tier``/``fetches`` feed the fan-out-tree
        rollups: consecutive announces of the cumulative serve count
        become the per-node ``fetch_qps`` the tree-aware autoscaler
        ranks parents by. Never raises — a garbled announce must not
        fail the fetch that carried it."""
        try:
            addr = str(address)
            have = int(step)
        except (TypeError, ValueError):
            return
        now = self.clock()
        lag = max(0, int(global_step) - have)
        with self._lock:
            prev = self._replicas.get(addr)
            fresh = prev is None
            row = {"step": have, "ts": now, "lag_steps": lag,
                   "tier": max(1, int(tier or 1))}
            if metrics:
                row["metrics"] = str(metrics)
            if parent:
                row["parent"] = str(parent)
            if fetches is not None:
                try:
                    row["fetches"] = int(fetches)
                    if prev is not None and "fetches" in prev \
                            and now > prev["ts"]:
                        row["fetch_qps"] = round(
                            max(0, row["fetches"] - prev["fetches"])
                            / (now - prev["ts"]), 2)
                except (TypeError, ValueError):
                    pass
            moved = prev is not None \
                and prev.get("parent") != row.get("parent")
            self._replicas[addr] = row
            if fresh or moved:
                self._version += 1
                self._tm_map_version.set(self._version)
            self._expire_locked(now)
            self._tm_replicas.set(len(self._replicas))
            self._sync_children_locked()
        if addr not in self._tm_lag:
            self._tm_lag[addr] = (
                self._reg.gauge("dps_replica_lag_steps", replica=addr),
                self._reg.gauge("dps_replica_lag_seconds", replica=addr))
        self._tm_lag[addr][0].set(lag)
        self._tm_lag[addr][1].set(0.0)  # fresh announce = just synced

    def _sync_children_locked(self) -> None:
        """Recompute the per-node child-count gauges from the live rows.
        A node that LOST all its children (re-parent, expiry) gets its
        ``dps_replica_children`` series removed outright — a frozen
        child count on a dead interior node reads as a live subtree."""
        my_primary = self.primaries[self.shard_id]
        counts: dict[str, int] = {}
        for r in self._replicas.values():
            p = r.get("parent") or my_primary
            counts[p] = counts.get(p, 0) + 1
        for node in set(self._tm_children) - set(counts):
            self._tm_children.pop(node, None)
            self._reg.remove("dps_replica_children", node=node)
        for node, n in counts.items():
            if node not in self._tm_children:
                self._tm_children[node] = self._reg.gauge(
                    "dps_replica_children", node=node)
            self._tm_children[node].set(n)

    def _expire_locked(self, now: float) -> None:
        dead = [a for a, r in self._replicas.items()
                if now - r["ts"] > self.REPLICA_EXPIRE_S]
        for a in dead:
            del self._replicas[a]
            # The departed replica's lag series must go with it — a
            # frozen dps_replica_lag_* gauge reads as a live replica
            # that stopped syncing, the opposite of what happened.
            self._tm_lag.pop(a, None)
            self._reg.remove("dps_replica_lag_steps", replica=a)
            self._reg.remove("dps_replica_lag_seconds", replica=a)
        if dead:
            self._version += 1
            self._tm_map_version.set(self._version)
            self._sync_children_locked()

    def shard_map(self) -> dict:
        """The current wire shard map (docs/SHARDING.md schema). Only
        THIS shard's replica list is live-tracked here; peer shards'
        replica lists are published by their own primaries — a client
        merges maps per shard_id by version."""
        now = self.clock()
        with self._lock:
            self._expire_locked(now)
            shards = []
            for i, primary in enumerate(self.primaries):
                lo, hi = self._ranges[i]
                shards.append({
                    "shard_id": i, "slot_range": [lo, hi],
                    "primary": primary,
                    "replicas": (sorted(self._replicas)
                                 if i == self.shard_id else []),
                })
            return {"version": self._version, "slots": SHARD_SLOTS,
                    "shard_count": self.shard_count, "shards": shards}

    def topology(self) -> dict:
        """The fan-out-tree view shipped DOWN the tree as the delta-gated
        ``topology`` fetch attachment (docs/SHARDING.md "Fan-out trees"):
        version + primary + one row per live replica with its parent
        edge. This is what a child re-parents from when its own parent
        dies — deliberately small and flat."""
        now = self.clock()
        with self._lock:
            self._expire_locked(now)
            nodes = [{"address": a, "tier": r.get("tier", 1),
                      "parent": r.get("parent"),
                      "step": r["step"], "lag_steps": r["lag_steps"]}
                     for a, r in sorted(self._replicas.items())]
            return {"version": self._version,
                    "primary": self.primaries[self.shard_id],
                    "nodes": nodes}

    def view(self) -> dict:
        """The ``GET /cluster`` sharding block (rendered by
        ``cli status``): identity, map version, and per-replica lag."""
        now = self.clock()
        with self._lock:
            self._expire_locked(now)
            replicas = []
            tiers: dict[int, dict] = {}
            for a, r in sorted(self._replicas.items()):
                row = {"address": a, "step": r["step"],
                       "lag_steps": r["lag_steps"],
                       "announce_age_s": round(max(0.0, now - r["ts"]),
                                               3)}
                for k in ("metrics", "parent", "tier", "fetch_qps"):
                    if k in r:
                        row[k] = r[k]
                replicas.append(row)
                t = tiers.setdefault(int(r.get("tier", 1)),
                                     {"replicas": 0, "max_lag_steps": 0,
                                      "fetch_qps": 0.0})
                t["replicas"] += 1
                t["max_lag_steps"] = max(t["max_lag_steps"],
                                         r["lag_steps"])
                t["fetch_qps"] = round(t["fetch_qps"]
                                       + r.get("fetch_qps", 0.0), 2)
            out = {"shard_id": self.shard_id,
                   "shard_count": self.shard_count,
                   "map_version": self._version,
                   "slot_range": list(self._ranges[self.shard_id]),
                   "primaries": list(self.primaries),
                   "replicas": replicas,
                   "tiers": {str(t): v
                             for t, v in sorted(tiers.items())}}
        if self.migration_provider is not None:
            try:
                mig = self.migration_provider()
            except Exception:  # noqa: BLE001 — view is observability only
                mig = None
            if mig is not None:
                out["migration"] = mig
        return out
