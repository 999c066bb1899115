"""Durable append-only telemetry journal: segmented JSONL time-series.

The JAX package's ``telemetry/journal.py``, carried over whole (it is
framework-neutral) with the port's registry. In the port, alert edges,
directives, checkpoints, incidents and profiles journal through
:func:`journal_event`, a no-op until a writer is set (``--journal-dir``
on any verb), and the snapshot stream journals each snapshot; ``cli
query``, ``cli top --replay`` and ``cli incident report``
(``analysis/incidents.py``) read a journal.

Every live surface this repo grew — ``/metrics``, ``/cluster``,
``/fleet``, the flight recorder, SLO burn — keeps its history in bounded
in-memory deques that die with the process. The reference answered
"what happened at 03:12?" by regex-scraping CloudWatch
(parse_cloudwatch_logs.py); this module is the native replacement: every
process (``cli serve/replica/worker/observe``) streams its typed events
into an on-disk journal that survives a SIGKILL and is queryable after
the fact (``cli query``, ``cli incident report``, ``cli top --replay``).

Layout (one directory per run, shared by all local processes)::

    journal/
      journal-<ms>-<pid>-<n>.jsonl          # raw segments, append-only
      journal-<ms>-<pid>-<n>.coarse.jsonl   # downsampled old segments

Record envelope — one JSON object per line::

    {"v": 1, "type": "alert", "ts": 1724.5, "role": "server",
     "pid": 1234, "seq": 17, ...payload}

``type`` must be a key of :data:`EVENT_CATALOG` (drift-pinned against
docs/OBSERVABILITY.md by dpslint's ``catalog_drift`` check). Payload keys
never override the envelope.

Durability model, in order of the failure modes it survives:

- **Torn tail**: every ``append`` writes one full line and flushes; a
  SIGKILL can tear at most the final line of the active segment, and
  :class:`JournalReader` skips a torn tail (counted, never fatal).
- **Rotation** by size (``max_segment_bytes``) and age
  (``max_segment_age_s``): a sealed segment is fsync'd, so only the
  active segment is ever at risk.
- **Retention**: when sealed raw segments exceed ``retention_bytes``
  the oldest are not deleted but *downsampled* into a coarse tier —
  every ``coarse_keep_every``-th cumulative snapshot per (role, pid)
  stream plus the stream's first and last, and ALL non-snapshot events
  (alerts, remediations, ... are the forensic record; only the dense
  metric samples thin out). Because snapshots are cumulative, the kept
  samples stay *exact* — downsampling coarsens time resolution, never
  the counts. The coarse tier has its own ``coarse_retention_bytes``
  cap after which the oldest coarse segments finally drop.

Writes are cheap by design — one ``json.dumps`` + buffered write +
``flush`` per record, fsync only at seal time — so journaling rides the
serving path at well under the 2% overhead budget (bench.py measures
``journal_write_us`` / ``journal_bytes_per_tick``; benchwatch tracks
both as lower-is-better series).

A process-global hub (:func:`set_journal` / :func:`journal_event`) lets
subsystem chokepoints (alert edges, remediation actions, directives,
migration phases, re-parents, checkpoints) journal in one line each,
compiling to a no-op when no journal is configured.
"""

from __future__ import annotations

import json
import os
import threading
import time

from .registry import MetricsRegistry, get_registry

__all__ = [
    "EVENT_CATALOG",
    "JournalReader",
    "JournalWriter",
    "get_journal",
    "journal_event",
    "read_journal",
    "set_journal",
]

#: Typed record catalog: type -> one-line meaning. Drift-pinned BOTH
#: directions against the docs/OBSERVABILITY.md "Event catalog" table by
#: dpslint's ``catalog_drift.check_event_catalog`` — adding a type here
#: without documenting it (or vice versa) fails lint and tier-1. Must
#: stay a pure literal (the drift engine ``ast.literal_eval``'s it).
EVENT_CATALOG = {
    "snapshot": "cumulative per-process metrics registry snapshot "
                "(SnapshotEmitter tick; counters/gauges/histograms)",
    "fleet_tick": "one FleetCollector scrape tick: the merged /fleet "
                  "view minus its history rings (replay source)",
    "alert": "health-rule edge from ClusterMonitor: fired, refired, or "
             "resolved, with rule/severity/worker/value",
    "slo_burn": "fleet-scope SLO burn-rate breach edge from the "
                "collector windows (objective, window_s, burn)",
    "remediation": "remediation engine action outcome "
                   "(quorum_exclude, rebalance, quarantine, refetch, ...)",
    "respawn": "supervisor worker respawn attempt and its outcome "
               "(ok, crash_loop)",
    "directive": "coordinator posted a control-plane directive to a "
                 "worker mailbox (action, seq)",
    "migration": "live shard-migration phase transition "
                 "(export, import, apply_ranges, commit) with role",
    "reparent": "edge replica re-parented to a new upstream feed "
                "(shard, old, new, tier)",
    "checkpoint": "checkpoint manager published an atomic store "
                  "snapshot (step, path)",
    "fault": "a seeded fault-injection plan was armed on this process "
             "(spec string, comms/faults.py grammar)",
    "incident": "incident capture engine froze a forensic bundle "
                "(id, rule, path)",
    "profile": "profile trigger engine captured and attributed a "
               "device-profile window (id, rule, path)",
}

_SNAPSHOT_TYPES = ("snapshot", "fleet_tick")


def _now_ms(ts: float) -> int:
    return int(ts * 1000.0)


class JournalWriter:
    """Append-only segmented JSONL writer for one process.

    Thread-safe; every public method takes the internal lock. Failures
    to write (disk full, directory removed) raise to the caller —
    :func:`journal_event` is the swallow-everything wrapper used on
    serving paths.
    """

    def __init__(self, directory: str, role: str = "process",
                 max_segment_bytes: int = 4 * 1024 * 1024,
                 max_segment_age_s: float = 300.0,
                 retention_bytes: int = 64 * 1024 * 1024,
                 coarse_keep_every: int = 10,
                 coarse_retention_bytes: int = 16 * 1024 * 1024,
                 registry: MetricsRegistry | None = None,
                 clock=time.time):
        if max_segment_bytes <= 0 or retention_bytes <= 0:
            raise ValueError("segment/retention byte caps must be > 0")
        if coarse_keep_every < 1:
            raise ValueError(
                f"coarse_keep_every must be >= 1, got {coarse_keep_every}")
        self.directory = directory
        self.role = role
        self.max_segment_bytes = int(max_segment_bytes)
        self.max_segment_age_s = float(max_segment_age_s)
        self.retention_bytes = int(retention_bytes)
        self.coarse_keep_every = int(coarse_keep_every)
        self.coarse_retention_bytes = int(coarse_retention_bytes)
        self.clock = clock
        self._pid = os.getpid()
        os.makedirs(directory, exist_ok=True)
        reg = registry or get_registry()
        self._tm_records = reg.counter("dps_journal_records_total")
        self._tm_bytes = reg.counter("dps_journal_bytes_total")
        self._tm_segments = reg.counter("dps_journal_segments_total")
        self._lock = threading.Lock()
        self._fh = None            # guarded by: self._lock
        self._seg_path = None      # guarded by: self._lock
        self._seg_bytes = 0        # guarded by: self._lock
        self._seg_opened = 0.0     # guarded by: self._lock
        self._seg_n = 0            # guarded by: self._lock
        self._seq = 0              # guarded by: self._lock

    # -- segment lifecycle -------------------------------------------------

    def _open_segment_locked(self, now: float) -> None:
        self._seg_n += 1
        name = (f"journal-{_now_ms(now):013d}-{self._pid}-"
                f"{self._seg_n:04d}.jsonl")
        self._seg_path = os.path.join(self.directory, name)
        self._fh = open(self._seg_path, "a", encoding="utf-8")
        self._seg_bytes = 0
        self._seg_opened = now
        self._tm_segments.inc()

    def _seal_locked(self) -> None:
        if self._fh is None:
            return
        try:
            self._fh.flush()
            os.fsync(self._fh.fileno())
        finally:
            self._fh.close()
            self._fh = None
            self._seg_path = None

    def seal(self) -> None:
        """Flush + fsync + close the active segment (crash-consistent
        tail). The next ``append`` opens a fresh segment. Called from
        ``SnapshotEmitter.stop(final=True)`` and the SIGTERM
        shutdown-flush path so a killed process's journal ends clean."""
        with self._lock:
            self._seal_locked()

    close = seal

    # -- writes ------------------------------------------------------------

    def append(self, type: str, payload: dict | None = None) -> dict:
        """Validate against the catalog, write one line, maybe rotate.
        Returns the full record as written (tests, incident capture)."""
        if type not in EVENT_CATALOG:
            raise ValueError(
                f"unknown journal event type {type!r}; "
                f"known: {sorted(EVENT_CATALOG)}")
        with self._lock:
            now = self.clock()
            self._seq += 1
            rec = dict(payload or {})
            rec.setdefault("ts", round(now, 3))
            rec.update({"v": 1, "type": type, "role": self.role,
                        "pid": self._pid, "seq": self._seq})
            line = json.dumps(rec, separators=(",", ":"), default=str)
            data = line + "\n"
            if (self._fh is None
                    or (self._seg_bytes > 0
                        and (self._seg_bytes + len(data)
                             > self.max_segment_bytes
                             or now - self._seg_opened
                             > self.max_segment_age_s))):
                self._seal_locked()
                self._enforce_retention_locked()
                self._open_segment_locked(now)
            self._fh.write(data)
            self._fh.flush()
            self._seg_bytes += len(data)
            self._tm_records.inc()
            self._tm_bytes.inc(len(data))
            return rec

    # -- retention / downsampling -----------------------------------------

    def _list_locked(self, coarse: bool) -> list:
        """Sorted (path, size) for sealed segments of one tier; raw tier
        excludes the active segment."""
        out = []
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return out
        for name in names:
            is_coarse = name.endswith(".coarse.jsonl")
            if (not name.startswith("journal-")
                    or not name.endswith(".jsonl")
                    or is_coarse is not coarse):
                continue
            path = os.path.join(self.directory, name)
            if path == self._seg_path:
                continue
            try:
                out.append((path, os.path.getsize(path)))
            except OSError:
                continue
        return out

    def _enforce_retention_locked(self) -> None:
        raw = self._list_locked(coarse=False)
        total = sum(size for _, size in raw)
        while raw and total > self.retention_bytes:
            path, size = raw.pop(0)
            self._compact_segment(path)
            total -= size
        coarse = self._list_locked(coarse=True)
        ctotal = sum(size for _, size in coarse)
        while coarse and ctotal > self.coarse_retention_bytes:
            path, size = coarse.pop(0)
            try:
                os.remove(path)
            except OSError:
                pass
            ctotal -= size

    def _compact_segment(self, path: str) -> None:
        """Downsample one sealed raw segment into the coarse tier, then
        drop the raw file. Keeps all non-snapshot events; snapshots thin
        to every k-th per (role, pid) stream plus first and last —
        cumulative payloads make the kept samples exact."""
        stats = {"torn_tails": 0, "corrupt_lines": 0}
        records = list(_iter_segment(path, stats))
        streams: dict = {}
        for rec in records:
            if rec.get("type") in _SNAPSHOT_TYPES:
                key = (rec.get("role"), rec.get("pid"), rec.get("type"))
                streams.setdefault(key, []).append(rec)
        keep_ids = set()
        for stream in streams.values():
            n = len(stream)
            for i, rec in enumerate(stream):
                if i % self.coarse_keep_every == 0 or i == n - 1:
                    keep_ids.add(id(rec))
        out_path = path[:-len(".jsonl")] + ".coarse.jsonl"
        tmp_path = out_path + ".tmp"
        with open(tmp_path, "w", encoding="utf-8") as f:
            for rec in records:
                if (rec.get("type") not in _SNAPSHOT_TYPES
                        or id(rec) in keep_ids):
                    f.write(json.dumps(rec, separators=(",", ":"),
                                       default=str) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_path, out_path)
        try:
            os.remove(path)
        except OSError:
            pass


def _iter_segment(path: str, stats: dict):
    """Yield decodable records from one segment, tolerating torn tails
    and corrupt mid-file lines (each counted, never fatal)."""
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            data = f.read()
    except OSError:
        stats["corrupt_lines"] += 1
        return
    lines = data.split("\n")
    last_idx = max((i for i, ln in enumerate(lines) if ln.strip()),
                   default=-1)
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            if i == last_idx and not data.endswith("\n"):
                stats["torn_tails"] += 1
            else:
                stats["corrupt_lines"] += 1
            continue
        if not isinstance(rec, dict) or "type" not in rec \
                or "ts" not in rec:
            stats["corrupt_lines"] += 1
            continue
        yield rec


class JournalReader:
    """Merged, time-ordered view over a journal directory (raw + coarse
    tiers) or a single segment file. Read-only; safe against torn tails
    and corrupt lines (``self.stats`` reports what was skipped)."""

    def __init__(self, path: str):
        self.path = path
        self.stats = {"segments": 0, "records": 0, "torn_tails": 0,
                      "corrupt_lines": 0}

    def segments(self) -> list:
        if os.path.isfile(self.path):
            return [self.path]
        try:
            names = sorted(os.listdir(self.path))
        except OSError:
            return []
        return [os.path.join(self.path, n) for n in names
                if n.startswith("journal-") and n.endswith(".jsonl")]

    def records(self, types=None, start_ts: float | None = None,
                end_ts: float | None = None, roles=None) -> list:
        """All matching records across every segment, sorted by
        ``(ts, pid, seq)``. ``types``/``roles`` are iterables of exact
        names; time bounds are inclusive."""
        types = set(types) if types is not None else None
        roles = set(roles) if roles is not None else None
        out = []
        for path in self.segments():
            self.stats["segments"] += 1
            for rec in _iter_segment(path, self.stats):
                if types is not None and rec.get("type") not in types:
                    continue
                if roles is not None and rec.get("role") not in roles:
                    continue
                ts = rec.get("ts")
                if not isinstance(ts, (int, float)):
                    self.stats["corrupt_lines"] += 1
                    continue
                if start_ts is not None and ts < start_ts:
                    continue
                if end_ts is not None and ts > end_ts:
                    continue
                out.append(rec)
        out.sort(key=lambda r: (r.get("ts", 0.0), r.get("pid", 0),
                                r.get("seq", 0)))
        self.stats["records"] += len(out)
        return out


def read_journal(path: str, **kwargs) -> list:
    """One-shot convenience: ``JournalReader(path).records(**kwargs)``."""
    return JournalReader(path).records(**kwargs)


# -- process-global hub ----------------------------------------------------

_hub_lock = threading.Lock()
_JOURNAL: JournalWriter | None = None


def set_journal(writer: JournalWriter | None) -> None:
    """Install (or clear, with ``None``) the process-global journal that
    :func:`journal_event` chokepoints write through."""
    global _JOURNAL
    with _hub_lock:
        _JOURNAL = writer


def get_journal() -> JournalWriter | None:
    with _hub_lock:
        return _JOURNAL


def journal_event(type: str, **payload) -> None:
    """Fire-and-forget chokepoint append: a cheap no-op when no journal
    is configured, and never raises — subsystem hot paths (alert edges,
    directives, migrations) must not fail because forensics did."""
    writer = _JOURNAL
    if writer is None:
        return
    try:
        writer.append(type, payload)
    except Exception:  # noqa: BLE001 — forensics never breaks serving
        pass
