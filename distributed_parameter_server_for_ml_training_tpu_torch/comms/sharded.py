"""Sharded remote store: per-shard fan-out behind the RemoteStore API.

The JAX package's ``comms/sharded.py``, carried over whole.
:class:`ShardedRemoteStore` duck-types :class:`~.client.RemoteStore`'s
worker-facing surface, so :class:`~..ps.worker.PSWorker` trains against a
consistent-hash-partitioned parameter tier unchanged. One
:class:`~.client.RemoteStore` per shard primary underneath; this layer
only routes and reassembles:

- **push** partitions the gradient dict by slot owner (through the live
  shard map once one is adopted, else the canonical
  :func:`~..ps.sharding.shard_for_key` partition) and sends each shard
  its slice, empty slices included, with that shard's OWN last-fetched
  step (staleness is per shard) and that store's OWN push token (each
  shard keeps its own exactly-once journal). Companion keys
  (``name::int8scale``) route with their tensor.
- **fetch** fans out with per-shard ``have_step`` (an idle shard answers
  NOT_MODIFIED while a busy one ships params) and reassembles from the
  per-shard param cache.
- **session resume** reuses the single-server machinery: a
  SessionLostError from any shard escalates to PSWorker, whose recovery
  calls reset_channel / register_worker / repush_last here, each fanned
  out.

The topology bootstraps from the shard map: construct with a single seed
address and the registration reply's map supplies the peer primaries, or
pass the full primary list (``cli worker --shards``).
"""

from __future__ import annotations

import threading

import numpy as np

from ..ps.sharding import key_slot, shard_for_key, shard_for_slot
from .client import RemoteStore


class ShardedRemoteStore:
    """N per-shard RemoteStores behind the one-store client API."""

    decompresses_fetches = True

    def __init__(self, addresses, **remote_kwargs):
        """``addresses``: either the full ordered primary list (index =
        shard id), or a single seed address whose registration reply's
        shard map supplies the rest (deferred to register_worker)."""
        if isinstance(addresses, str):
            addresses = [a for a in addresses.split(",") if a]
        self._remote_kwargs = dict(remote_kwargs)
        self._stores: list[RemoteStore] = [
            RemoteStore(a, **self._remote_kwargs) for a in addresses]
        self._seeded = len(self._stores) == 1  # may grow from the map
        self._lock = threading.Lock()
        self._wids: list[int] = []  # guarded by: self._lock
        # guarded by: self._lock
        self._shard_steps: list[int | None] = [None] * len(self._stores)
        # guarded by: self._lock
        self._param_cache: list[dict] = [{} for _ in self._stores]
        self._health_provider = None
        self._health_revision = None

    # -- topology ------------------------------------------------------------

    @property
    def shard_count(self) -> int:
        return len(self._stores)

    @property
    def address(self) -> str:
        return ",".join(s.address for s in self._stores)

    @property
    def shard_map(self):
        return self._stores[0].shard_map

    def _adopt_map_locked(self) -> None:
        """Grow from seed: after the first registration, the published
        shard map's primary list replaces the single seed store with the
        full fan-out (new stores for the peers, the seed kept for its
        own shard)."""
        m = self._stores[0].shard_map
        if not self._seeded or m is None or m["shard_count"] == 1:
            return
        seed = self._stores[0]
        primaries = [s["primary"] for s in m["shards"]]
        try:
            seed_idx = primaries.index(seed.address)
        except ValueError:
            seed_idx = 0  # seed spoke for a shard under another name
        stores = []
        for i, addr in enumerate(primaries):
            stores.append(seed if i == seed_idx
                          else RemoteStore(addr, **self._remote_kwargs))
        self._stores = stores
        self._shard_steps = [None] * len(stores)
        self._param_cache = [{} for _ in stores]
        self._seeded = False

    # -- capability / config passthrough (all shards run one config) ---------

    def __getattr__(self, name):
        if name in {"push_codec", "fetch_codec", "supports_delta_fetch",
                    "supports_trace_context", "supports_health_report",
                    "supports_compressed_domain", "supports_directives",
                    "supports_checksum", "config"}:
            return getattr(self._stores[0], name)
        raise AttributeError(name)

    @property
    def health_provider(self):
        return self._health_provider

    @health_provider.setter
    def health_provider(self, fn):
        self._health_provider = fn
        for s in self._stores:
            s.health_provider = fn

    @property
    def health_revision(self):
        return self._health_revision

    @health_revision.setter
    def health_revision(self, fn):
        self._health_revision = fn
        for s in self._stores:
            s.health_revision = fn

    # -- lifecycle -----------------------------------------------------------

    def register_worker(self, worker_name: str = "",
                        retries: int | None = None) -> tuple[int, int]:
        """Register with every shard primary (seed first, so its map can
        grow the fan-out). Returns shard 0's (worker_id, total_workers) —
        the identity PSWorker logs; the per-shard ids live here."""
        wid0, total = self._stores[0].register_worker(worker_name,
                                                      retries=retries)
        with self._lock:
            self._adopt_map_locked()
            stores = list(self._stores)
        wids = [wid0]
        for s in stores[1:]:
            wid, _ = s.register_worker(worker_name, retries=retries)
            wids.append(wid)
        with self._lock:
            self._wids = wids
            self._shard_steps = [None] * len(stores)
            # Health plumbing installed before the map grew the fan-out
            # must reach the new stores too.
            for s in stores:
                s.health_provider = self._health_provider
                s.health_revision = self._health_revision
        return wid0, total

    def fetch(self, worker_id: int | None = None,
              have_step: int | None = None
              ) -> tuple[dict[str, np.ndarray], int]:
        """Fan out, delta-gated PER SHARD (each shard is asked against
        its own last-seen step — a global ``have_step`` would force full
        refetches from idle shards whenever one shard advanced). Returns
        the caller's NOT_MODIFIED contract unchanged: ``({}, have_step)``
        only when EVERY shard stood still; otherwise the merged full
        dict at the minimum shard step (the conservative basis for
        staleness accounting)."""
        with self._lock:
            stores = list(self._stores)
            wids = list(self._wids) or [None] * len(stores)
            shard_steps = list(self._shard_steps)
        parts: list[tuple[int, dict, int]] = []
        all_nm = have_step is not None
        for i, s in enumerate(stores):
            hs = shard_steps[i] if have_step is not None else None
            params, step = s.fetch(wids[i], have_step=hs)
            nm = hs is not None and not params and step == hs
            if not nm:
                all_nm = False
            parts.append((i, params, step))
        with self._lock:
            for i, params, step in parts:
                self._shard_steps[i] = step
                if params:
                    self._param_cache[i] = params
            steps = [p[2] for p in parts]
            gstep = min(steps) if steps else 0
            if all_nm and gstep == have_step:
                return {}, int(have_step)
            merged: dict[str, np.ndarray] = {}
            for cache in self._param_cache:
                merged.update(cache)
            return merged, gstep

    def _route_ranges(self) -> list | None:
        """Slot ranges from the freshest adopted shard map, or None when
        no usable map exists (pre-registration, or a map whose shard
        count disagrees with the fan-out). With None the router falls
        back to the canonical boot-time partition — correct until the
        first live migration, which always publishes a map first."""
        best = None
        for s in self._stores:
            m = s.shard_map
            if m is not None and (best is None
                                  or m["version"] > best["version"]):
                best = m
        if best is None or best["shard_count"] != len(self._stores):
            return None
        return [tuple(sh["slot_range"]) for sh in best["shards"]]

    def _owner(self, name, n: int, ranges) -> int:
        """Key -> shard id, through the LIVE map when one is adopted
        (slot ranges move under migration; docs/SHARDING.md). Companion
        keys (``w::int8scale`` etc.) route on the base tensor name so a
        quantized slice never splits from its scales."""
        if ranges is None:
            return shard_for_key(name, n)
        base = str(name).split("::", 1)[0]
        return shard_for_slot(key_slot(base), ranges)

    def push(self, worker_id: int, gradients: dict,
             fetched_step: int) -> bool:
        """Partition by key owner (live map when adopted, canonical
        otherwise) and push each shard its slice against that shard's own
        fetched step. Every shard gets a push even when its slice is
        empty — in sync mode a round only closes when all workers report,
        so skipping a keyless shard would wedge its rounds behind
        everyone else's. A slice the target DISOWNED (it pushed on a map
        that moved mid-flight) is re-routed once to the new owner under a
        fresh token in async mode; in sync mode it is dropped — a second
        push into the new owner's round would double-report this worker
        and skew the round barrier, and a dropped async-equivalent slice
        costs the same as one staleness reject."""
        with self._lock:
            stores = list(self._stores)
            wids = list(self._wids) or [worker_id] * len(stores)
            shard_steps = list(self._shard_steps)
        n = len(stores)
        ranges = self._route_ranges()
        slices: list[dict] = [{} for _ in range(n)]
        for name, g in gradients.items():
            slices[self._owner(name, n, ranges)][name] = g
        ok = True
        for i, s in enumerate(stores):
            step = shard_steps[i] if shard_steps[i] is not None \
                else fetched_step
            ok = s.push(wids[i], slices[i], int(step)) and ok
            disowned = s.last_disowned
            if disowned:
                s.last_disowned = []
                ok = self._reroute_disowned(
                    i, disowned, slices[i], stores, wids, shard_steps,
                    fetched_step) and ok
        return ok

    def _reroute_disowned(self, src: int, disowned, src_slice: dict,
                          stores, wids, shard_steps,
                          fetched_step: int) -> bool:
        """One re-route attempt for a disowned slice, against the map
        the reply carried (already adopted by the per-shard client). No
        recursion: a slice disowned AGAIN mid-re-route is dropped, the
        same worst case as a stale async push. Sync mode drops outright
        (see push's docstring)."""
        if getattr(self.config, "mode", "sync") != "async":
            return True
        ranges = self._route_ranges()
        if ranges is None:
            return True
        regroup: dict[int, dict] = {}
        for k in disowned:
            if k in src_slice:
                j = self._owner(k, len(stores), ranges)
                if j != src:
                    regroup.setdefault(j, {})[k] = src_slice[k]
        ok = True
        for j, grads in regroup.items():
            step = shard_steps[j] if shard_steps[j] is not None \
                else fetched_step
            ok = stores[j].push(wids[j], grads, int(step)) and ok
        return ok

    def repush_last(self, worker_id: int):
        """Session-resume reconciliation, fanned out: every shard replays
        its own last push token verbatim — restarted shards apply from
        scratch or answer from their restored journal, survivors answer
        ``duplicate``. Outcome is AND-ed like push's."""
        with self._lock:
            stores = list(self._stores)
            wids = list(self._wids) or [worker_id] * len(stores)
        outcomes = [s.repush_last(wids[i]) for i, s in enumerate(stores)]
        known = [o for o in outcomes if o is not None]
        return all(known) if known else None

    def job_finished(self, worker_id: int) -> None:
        with self._lock:
            stores = list(self._stores)
            wids = list(self._wids) or [worker_id] * len(stores)
        for i, s in enumerate(stores):
            s.job_finished(wids[i])

    def reset_channel(self) -> None:
        for s in self._stores:
            s.reset_channel()

    def close(self) -> None:
        for s in self._stores:
            s.close()

    # -- piggybacked state (merged views) ------------------------------------

    def take_directives(self) -> list[dict]:
        out: list[dict] = []
        for s in self._stores:
            out.extend(s.take_directives())
        return out

    def gradient_scales(self) -> tuple[dict[str, float], int]:
        """Per-shard tables merged (key sets are disjoint by
        construction); the version is the minimum so a stale shard keeps
        refreshing."""
        merged: dict[str, float] = {}
        steps = []
        for s in self._stores:
            scales, step = s.gradient_scales()
            merged.update(scales)
            steps.append(step)
        return merged, (min(steps) if steps else 0)

    def membership_snapshot(self) -> list[int]:
        return self._stores[0].membership_snapshot()

    def wire_stats(self) -> dict:
        out = {"wire_bytes_out": 0, "wire_bytes_in": 0, "rpc_counts": {}}
        for s in self._stores:
            st = s.wire_stats()
            out["wire_bytes_out"] += st["wire_bytes_out"]
            out["wire_bytes_in"] += st["wire_bytes_in"]
            for k, v in st["rpc_counts"].items():
                out["rpc_counts"][k] = out["rpc_counts"].get(k, 0) + v
        return out
