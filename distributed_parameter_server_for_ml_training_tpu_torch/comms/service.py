"""gRPC parameter service of the port: the reference wire protocol.

The JAX package's ``comms/service.py``, carried over: a single-job or a
multi-job server, unsharded or as one shard primary, with the same four
unary-unary RPCs under the same service name, including the load-bearing
wire-protocol typo ``PushGradrients`` (ps.proto:12)::

    /ps.ParameterServer/RegisterWorker
    /ps.ParameterServer/PushGradrients
    /ps.ParameterServer/FetchParameters
    /ps.ParameterServer/JobFinished

Messages are a JSON envelope plus an optional tensor frame
(``comms/wire.py``), served through gRPC generic handlers. A default
service of either package answers the same request with the same bytes:
the same capability advertisement at registration, the same exactly-once
``nonce:count`` push dedupe with its checksum gate, the same
version-gated fetch with its cached ``not_modified`` reply, the
store's fetch codec and elastic membership (the live membership on
register and fetch replies, expiry run on push and registration
activity), and the push-token journal that store checkpoints persist
(``journal_snapshot``/``load_journal``), so a restored server still
answers a pre-crash push's retry as a duplicate.

Self-healing, as the JAX service does it: with a cluster ``monitor``
(``telemetry/cluster.py``) the register reply advertises
``health_report``, and the health report a worker piggybacks on each
fetch and push is fed to the monitor, as are refused corrupt frames and
expired workers. The remediation engine (``telemetry/remediation.py``)
posts directives (:data:`DIRECTIVE_CATALOG`) that ride the replies to
workers that advertised the capability until they ack them, and
quarantines a worker: its NEW pushes are acknowledged and never applied.
With ``reject_nonfinite`` a push whose own report flags a non-finite
loss or gradient norm is refused the same way, before the apply.

Over the device-resident store (``ps/device_store.py``) a fetch brings
the params to the host in one staged copy, and a push's decoded arrays
(read-only views into the request) are uploaded to the store's device by
the store, one copy each; the replies are a JAX service's over a JAX
``DeviceParameterStore``.

Sharded (``sharding=ShardInfo``, ``ps/sharding.py``), the service is one
primary of a consistent-hash partition, as the JAX service is: the
registration reply publishes the shard map, fetch replies refresh it
only when it is newer than the client's ``have_shard_map``, replica
announces riding fetch meta feed the live replica membership, and a
push's keys whose slot this primary does not own are dropped from the
apply and named in the reply (``disowned``) beside the fresh map.

Live resharding, as the JAX service does it (docs/SHARDING.md
"Migration protocol", docs/ROBUSTNESS.md "Migration failure matrix"): a
shard primary answers the admin-plane ``Reshard`` RPC with its six ops
(:data:`RESHARD_OPS`), driven by ``cli reshard``. ``export`` freezes a
slot range (a push touching it is disowned from then on) and hands back
the range's tensors with the push-token journal; ``import`` grafts them
and seeds the recipient's dedupe table from that journal; ``apply_ranges``
installs the coordinator's partition, idempotently; ``commit`` drops the
donor's copy; ``status`` and ``abort`` are the crash-safety pair. Each
primary keeps a durable ledger record of the migration it takes part in
(``migration_snapshot``/``load_migration``, persisted by store
checkpoints), and the donor's freeze holds a wall-clock lease
(:data:`DEFAULT_MIGRATION_LEASE_S`): a coordinator that dies before the
map publishes leaves a range that unfreezes itself.

Multi-job tenancy, as the JAX service does it (docs/TENANCY.md): with a
``jobs`` table (``ps/tenancy.py:JobManager``) every envelope routes by
its ``job`` meta key to that job's own store, worker ids stride per job
(``global = index * WID_STRIDE + local``), the push-token nonces are
job-scoped (identical tokens under two jobs both apply; each job's
checkpoint journals only its own), the cached ``not_modified`` reply is
keyed by the job, and pushes and fetches pass the weighted-fair
admission (:class:`WeightedFairAdmission`), throttled with
RESOURCE_EXHAUSTED. The admin-plane ``SubmitJob`` RPC submits and drains
jobs. Without ``jobs`` the server is the single-job wire, byte for byte.

Deterministic fault injection (``faults=``, ``comms/faults.py``) wraps
every RPC body, ``Reshard`` and ``SubmitJob`` included, inside its
instrumentation, as the JAX service does, so injected delays and aborts
land in the handler histograms like real ones.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
from collections import OrderedDict
from concurrent import futures

import grpc

from ..ps.sharding import key_slot
from ..ps.tenancy import DEFAULT_JOB, WID_STRIDE, job_key, \
    normalize_job_id, parse_jobs_spec, split_job_key
from ..telemetry import LATENCY_BUCKETS, get_registry, journal_event, \
    now, trace_enabled, trace_span
from ..telemetry.registry import ExemplarSampler
from ..telemetry.trace import use_wire_context
from .wire import decode_tensor_dict, encode_tensor_dict, \
    frame_checksum_ok, peek_trace

SERVICE_NAME = "ps.ParameterServer"

#: Completed push-token outcomes kept for dedupe. One entry per client
#: nonce; 4x the 32-worker cap leaves room for reconnecting clients' fresh
#: nonces without evicting live ones.
PUSH_SEEN_CAP = 128

#: Ceiling on how long a duplicate push waits for its original's outcome
#: when the caller carries no deadline. With a deadline, the wait is
#: bounded by ``ctx.time_remaining()`` minus a reply margin instead.
DUP_WAIT_CAP_S = 30.0

#: Ceiling on how long an RPC queues for weighted-fair admission
#: (docs/TENANCY.md "QoS semantics") before it is throttled with
#: RESOURCE_EXHAUSTED, which the client retries with backoff. Short on
#: purpose: backpressure is bounded handler queueing plus client-side
#: backoff, never pinned pool threads.
ADMISSION_WAIT_CAP_S = 2.0

#: Handler slots the admission scheduler hands out concurrently, kept
#: below the 20-thread gRPC pool so a saturated job throttles at
#: admission while threads remain to answer the throttles and serve
#: other jobs.
ADMISSION_CAPACITY = 16

#: Server->worker control directives (docs/ROBUSTNESS.md "Self-healing"):
#: the remediation layer posts these and the fetch/push reply envelope
#: meta carries them to capable workers, which act at step boundaries.
#: The names are a wire contract, the JAX service's.
DIRECTIVE_CATALOG = {
    "refetch_params": "drop the delta-fetch basis and take a full fresh "
                      "fetch at the next step boundary",
    "quarantine": "skip gradient pushes for `steps` boundary windows and "
                  "reset error-feedback residuals (suspected-poisoned "
                  "local state)",
    "rebalance_shard": "finish the current epoch early and recompute the "
                       "data shard from live membership at the next epoch",
    "drain": "finish cleanly at the next step boundary (flush the pending "
             "window, then JobFinished)",
}

#: Outstanding directives kept per worker; older ones are dropped first
#: (a worker that never fetches must not grow server memory).
DIRECTIVES_PER_WORKER_CAP = 16

#: The RPC names of the JAX service, in its order. The last two are its
#: admin plane: ``Reshard`` (shard primaries) and ``SubmitJob`` (tenancy
#: servers; FAILED_PRECONDITION on a single-job server).
RPC_NAMES = ("RegisterWorker", "PushGradrients", "FetchParameters",
             "JobFinished", "Reshard", "SubmitJob")

#: Admin reshard sub-operations (docs/SHARDING.md "Migration protocol").
#: ``status`` and ``abort`` are the crash-safety pair: status exposes the
#: primary's durable migration record so a resumed coordinator can decide
#: roll-forward vs roll-back; abort unwinds a half-done handoff (donor
#: unfreezes, recipient drops the adopted range) with the live map
#: untouched.
RESHARD_OPS = ("export", "import", "commit", "apply_ranges", "status",
               "abort")

#: Default TTL on the donor's export freeze (docs/ROBUSTNESS.md
#: "Migration failure matrix"): a coordinator that dies between export
#: and map publish would otherwise leave ``[lo, hi)`` frozen forever.
#: Once the lease expires the donor auto-unfreezes and clears its
#: migration record — the map never moved, so nothing else needs
#: unwinding. After the new map publishes the lease no longer applies:
#: that migration is roll-forward-only.
DEFAULT_MIGRATION_LEASE_S = 30.0


def parse_push_token(token) -> tuple[str, int]:
    """Split a ``nonce:count`` push token. The count orders a client's
    pushes, so the dedupe table can refuse ZOMBIE tokens — a
    deadline-expired first attempt executing after its retry succeeded and
    newer pushes landed (any ``count <=`` last-seen is a duplicate, and a
    lower count never evicts a higher one). A token without a parsable
    counter degrades to exact-match semantics: the whole token becomes the
    nonce, count -1."""
    s = str(token)
    nonce, sep, cnt = s.rpartition(":")
    if sep and cnt.isdigit():
        return nonce, int(cnt)
    return s, -1


# server.py:372-378 / worker.py:203-209
GRPC_OPTIONS = [
    ("grpc.max_send_message_length", 500 * 1024 * 1024),
    ("grpc.max_receive_message_length", 500 * 1024 * 1024),
    ("grpc.keepalive_time_ms", 30_000),
    ("grpc.keepalive_timeout_ms", 5_000),
    ("grpc.keepalive_permit_without_calls", 1),
    # Client-channel reconnect pacing (ignored by servers): gRPC's default
    # backoff grows to ~2 minutes; 2 s keeps a reconnect prompt.
    ("grpc.initial_reconnect_backoff_ms", 250),
    ("grpc.max_reconnect_backoff_ms", 2_000),
]


class RawJSON(str):
    """A pre-encoded JSON fragment. :func:`pack_msg` splices a RawJSON
    value into the envelope verbatim instead of re-serializing it. The
    value MUST be a complete, valid JSON document; nothing re-validates
    it here."""

    __slots__ = ()


def pack_msg(meta: dict, payload: bytes = b"") -> bytes:
    raw = {k: v for k, v in meta.items() if isinstance(v, RawJSON)}
    if raw:
        base = json.dumps({k: v for k, v in meta.items()
                           if not isinstance(v, RawJSON)})
        frag = ",".join(f'"{k}":{v}' for k, v in raw.items())
        header = (base[:-1] + ("," if len(base) > 2 else "")
                  + frag + "}").encode("utf-8")
    else:
        header = json.dumps(meta).encode("utf-8")
    return struct.pack("<I", len(header)) + header + payload


def unpack_msg(data: bytes) -> tuple[dict, memoryview]:
    """Split the envelope WITHOUT copying the payload: the returned
    memoryview aliases ``data``, and the zero-copy tensor decode builds
    array views directly over it."""
    (hlen,) = struct.unpack_from("<I", data, 0)
    mv = memoryview(data)
    meta = json.loads(bytes(mv[4:4 + hlen]).decode("utf-8"))
    return meta, mv[4 + hlen:]


class WeightedFairAdmission:
    """Weighted-fair admission over the push/fetch handler path
    (docs/TENANCY.md "QoS semantics"): one job's storm cannot starve
    another's trickle.

    Each job holds at most ``max_inflight`` admitted RPCs (its spec's
    hard cap), and once the shared ``capacity`` is contended, at most its
    *fair share*, ``capacity * weight / total_weight``, floored at 1 so
    every live job always makes progress. Under the cap an RPC waits
    (bounded by the caller's deadline and :data:`ADMISSION_WAIT_CAP_S`)
    for a slot; on timeout it is throttled and the handler aborts
    RESOURCE_EXHAUSTED. Per-job instruments: ``dps_job_queue_depth{job}``
    (admitted + waiting), ``dps_job_admitted_total{job}``,
    ``dps_job_throttled_total{job}``; ``JobManager.drain`` removes them.
    """

    def __init__(self, jobs, capacity: int = ADMISSION_CAPACITY,
                 registry=None):
        self.jobs = jobs  # JobManager: live weight/max_inflight source
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._inflight: dict[str, int] = {}  # guarded by: self._lock
        self._waiting: dict[str, int] = {}  # guarded by: self._lock
        self._reg = registry or get_registry()
        # job -> (depth gauge, admitted ctr, throttled ctr); created on a
        # job's first admission, removed at drain.
        self._instr: dict[str, tuple] = {}  # guarded by: self._lock

    def _instruments_locked(self, job: str) -> tuple:
        tup = self._instr.get(job)
        if tup is None:
            tup = (self._reg.gauge("dps_job_queue_depth", job=job),
                   self._reg.counter("dps_job_admitted_total", job=job),
                   self._reg.counter("dps_job_throttled_total", job=job))
            self._instr[job] = tup
        return tup

    def _limits(self, job: str) -> tuple[int, int]:
        """(fair share, hard max-inflight) from the live job table."""
        table = self.jobs.qos_table()
        weight, max_inflight = table.get(job, (1.0, 8))
        total_w = sum(w for w, _ in table.values()) or 1.0
        fair = max(1, int(self.capacity * weight / total_w))
        return fair, int(max_inflight)

    def _depth_locked(self, job: str, gauge) -> None:
        gauge.set(self._inflight.get(job, 0) + self._waiting.get(job, 0))

    def admit(self, job: str, budget_s: float) -> bool:
        """Take an admission slot for ``job``, waiting up to
        ``budget_s``; False means throttled (counted)."""
        deadline = time.monotonic() + max(0.0, float(budget_s))
        with self._lock:
            depth_g, admitted_c, throttled_c = self._instruments_locked(job)
            self._waiting[job] = self._waiting.get(job, 0) + 1
            self._depth_locked(job, depth_g)
            try:
                while True:
                    fair, cap = self._limits(job)
                    mine = self._inflight.get(job, 0)
                    total = sum(self._inflight.values())
                    if mine < cap and (total < self.capacity
                                       or mine < fair):
                        self._inflight[job] = mine + 1
                        admitted_c.inc()
                        return True
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        throttled_c.inc()
                        return False
                    self._cond.wait(remaining)
            finally:
                self._waiting[job] -= 1
                self._depth_locked(job, depth_g)

    def release(self, job: str) -> None:
        with self._lock:
            n = self._inflight.get(job, 0)
            if n <= 1:
                self._inflight.pop(job, None)
            else:
                self._inflight[job] = n - 1
            tup = self._instr.get(job)
            if tup is not None:
                self._depth_locked(job, tup[0])
            self._cond.notify_all()

    def forget_job(self, job: str) -> None:
        """Drop a drained job's scheduler state (its metric series are
        removed by ``JobManager.drain``)."""
        with self._lock:
            self._inflight.pop(job, None)
            self._waiting.pop(job, None)
            self._instr.pop(job, None)
            self._cond.notify_all()

    def view(self) -> dict:
        """Per-job admission state for /cluster and cli status."""
        with self._lock:
            names = (set(self._inflight) | set(self._waiting)
                     | set(self._instr))
            out = {}
            for j in sorted(names):
                fair, cap = self._limits(j)
                out[j] = {"inflight": self._inflight.get(j, 0),
                          "waiting": self._waiting.get(j, 0),
                          "fair_share": fair, "max_inflight": cap}
            return out


class ParameterService:
    """Generic-handler implementation of the 4-RPC lifecycle over the
    port's NumPy :class:`~..ps.store.ParameterStore` (or any store with
    its worker-facing API)."""

    def __init__(self, store, faults=None, monitor=None,
                 reject_nonfinite: bool = False, sharding=None,
                 jobs=None):
        self.store = store
        # Tenancy (ps/tenancy.JobManager): every envelope routes by its
        # ``job`` meta key to that job's own store, worker ids stride per
        # job, and push/fetch pass the weighted-fair admission below.
        # None is the single-job server, byte-identical to a JAX one
        # without jobs.
        self.jobs = jobs
        # Deterministic fault injection (comms/faults.py): a spec string
        # becomes a server-side injector that wraps the worker RPC bodies
        # in handlers(); None = no faults.
        if isinstance(faults, str):
            from .faults import FaultInjector
            faults = FaultInjector(faults, side="server")
        self.faults = faults
        # Sharding state (ps/sharding.py ShardInfo): when set, this server
        # is ONE shard primary of a consistent-hash partition. None = the
        # single-server wire, byte-identical to an unsharded JAX server.
        self.sharding = sharding
        # A push whose OWN health report flags a non-finite loss or grad
        # norm is refused synchronously: the evidence and the poison ride
        # the same envelope, so this is the only reaction that beats the
        # apply. Off by default (the reference applied NaN); cli serve
        # turns it on with the remediation engine.
        self.reject_nonfinite = reject_nonfinite
        # Cluster health monitor (telemetry/cluster.py): when attached,
        # registration advertises health_report and the fetch/push
        # handlers feed it the piggybacked reports. None = the capability
        # is never advertised and clients stay silent.
        self.monitor = monitor
        # Activity-coupled membership expiry, throttled (_expire_tick).
        self._expire_lock = threading.Lock()
        self._last_expire_check = 0.0  # guarded by: self._expire_lock
        # Push dedupe: nonce -> [count, outcome (None while in flight),
        # done event, worker_id, step_at_completion]; LRU-bounded. A retry
        # of the same token replays the recorded outcome, a lower count is
        # a zombie, and a retry of a still-in-flight original waits for
        # its outcome (bounded by the caller's deadline).
        self._push_seen: OrderedDict[str, list] = OrderedDict()  # guarded by: self._push_seen_lock
        self._push_seen_lock = threading.Lock()
        # Directive channel: per-worker outstanding server->worker
        # directives, attached to every fetch/push reply until the worker
        # acks them (at-least-once; the client dedupes by seq). Only
        # workers that advertised the capability at registration get them.
        self._directive_lock = threading.Lock()
        self._directives: dict[int, list[dict]] = {}  # guarded by: self._directive_lock
        self._directive_seq = 0  # guarded by: self._directive_lock
        self._directive_capable: set[int] = set()  # guarded by: self._directive_lock
        # Server-side push quarantine (remediation action): worker id ->
        # wall-clock ts until which its NEW pushes are refused
        # (acknowledged, never applied), so even a worker that cannot
        # hear the quarantine directive cannot poison the aggregate.
        self._quarantined: dict[int, float] = {}  # guarded by: self._directive_lock
        # Handler-side telemetry: per-RPC span + request/reply bytes.
        reg = get_registry()
        self._tm_rpc = {
            name: (reg.histogram("dps_rpc_handler_seconds", rpc=name),
                   reg.counter("dps_rpc_handler_bytes_total", rpc=name,
                               direction="in"),
                   reg.counter("dps_rpc_handler_bytes_total", rpc=name,
                               direction="out"),
                   reg.counter("dps_rpc_handler_calls_total", rpc=name),
                   reg.histogram("dps_rpc_server_latency_seconds",
                                 buckets=LATENCY_BUCKETS, method=name),
                   reg.counter("dps_rpc_server_errors_total", method=name))
            for name in RPC_NAMES
        }
        self._tm_exemplars = ExemplarSampler(rate=0.1, seed=os.getpid())
        # Per-job QoS, built on the job table so a drain also tears down
        # the job's scheduler state.
        self.qos = None
        if jobs is not None:
            self.qos = WeightedFairAdmission(jobs, registry=reg)
            jobs.qos = self.qos
        # Pushes refused because their frame failed the CRC trailer check
        # or did not decode.
        self._tm_wire_corrupt = reg.counter("dps_wire_corrupt_total")
        # Pushes refused while their worker was quarantined.
        self._tm_quarantined = reg.counter(
            "dps_service_quarantined_pushes_total")
        # Encoded header-only NOT_MODIFIED reply cache (single entry: the
        # current step), built single-flight: identical delta polls racing
        # a step transition wait for the one reply being encoded.
        self._nm_cache: tuple | None = None  # guarded by: self._nm_lock
        self._nm_lock = threading.Lock()
        self._nm_building = None  # guarded by: self._nm_lock
        self._nm_cond = threading.Condition(self._nm_lock)
        self._tm_nm_cache_hits = reg.counter(
            "dps_fetch_nm_cache_hits_total")
        self._tm_disowned = reg.counter("dps_push_disowned_keys_total")
        # Live-reshard state (docs/SHARDING.md "Migration protocol"):
        # slots this primary froze at export and is handing away. A push
        # touching a draining slot is disowned — dropped from the apply
        # and named in the reply so the client re-routes it — which is
        # what makes the exported snapshot authoritative: nothing can
        # land on the donor's copy after export.
        self._reshard_lock = threading.Lock()
        self._draining: set[int] = set()  # guarded by: self._reshard_lock
        # Durable migration ledger (docs/ROBUSTNESS.md "Migration failure
        # matrix"): this primary's record of the in-flight handoff it is
        # donor or recipient of, persisted into store snapshots
        # (checkpoint/manager.py migration_fn) and restored with them.
        # None = no migration in flight.
        self._migration: dict | None = None  # guarded by: self._reshard_lock
        self._tm_reshard = {
            op: reg.counter("dps_reshard_events_total", op=op)
            for op in RESHARD_OPS}
        self._tm_lease_expired = reg.counter(
            "dps_reshard_lease_expired_total")
        # Surface the in-flight migration in the shard map's /cluster
        # view (servers without the provider publish no "migration"
        # block).
        if sharding is not None:
            sharding.migration_provider = self.migration_view

    # -- directive channel ---------------------------------------------------

    def post_directive(self, worker_id: int, action: str,
                       **params) -> int | None:
        """Queue a server->worker directive; returns its seq, or None when
        the worker never advertised the capability (a legacy peer: the
        caller records the remediation as skipped). Delivery is
        at-least-once: the directive rides every fetch/push reply to that
        worker until acked; the client dedupes by seq."""
        if action not in DIRECTIVE_CATALOG:
            raise ValueError(f"unknown directive {action!r} (catalog: "
                             f"{sorted(DIRECTIVE_CATALOG)})")
        wid = int(worker_id)
        with self._directive_lock:
            if wid not in self._directive_capable:
                return None
            self._directive_seq += 1
            seq = self._directive_seq
            box = self._directives.setdefault(wid, [])
            box.append({"seq": seq, "action": action, **params})
            del box[:-DIRECTIVES_PER_WORKER_CAP]
        journal_event("directive", worker=wid, action=action, seq=seq)
        return seq

    def directives_for(self, worker_id) -> list[dict]:
        with self._directive_lock:
            return [dict(d) for d in self._directives.get(worker_id, [])]

    def _note_ack(self, worker_id, meta: dict) -> None:
        ack = meta.get("directives_ack")
        if ack is None:
            return
        try:
            ack = int(ack)
        except (TypeError, ValueError):
            return
        with self._directive_lock:
            box = self._directives.get(worker_id)
            if box:
                box[:] = [d for d in box if d["seq"] > ack]

    def _directive_fields(self, worker_id, meta: dict) -> dict:
        """Reply-meta fields for the directive channel: process the
        request's ack, then attach whatever is still outstanding."""
        if worker_id is None:
            return {}
        self._note_ack(worker_id, meta)
        out = self.directives_for(worker_id)
        return {"directives": out} if out else {}

    # -- server-side push quarantine (remediation action) --------------------

    def quarantine(self, worker_id: int, seconds: float) -> None:
        """Refuse this worker's new pushes (acknowledged, never applied)
        for ``seconds`` — the server-side half of the quarantine
        remediation; it holds even against a worker that cannot hear the
        directive."""
        with self._directive_lock:
            self._quarantined[int(worker_id)] = time.time() + float(seconds)

    def unquarantine(self, worker_id: int) -> None:
        with self._directive_lock:
            self._quarantined.pop(int(worker_id), None)

    def is_quarantined(self, worker_id) -> bool:
        with self._directive_lock:
            until = self._quarantined.get(worker_id)
            if until is None:
                return False
            if time.time() >= until:
                del self._quarantined[worker_id]
                return False
            return True

    def quarantine_view(self) -> dict[int, float]:
        """worker id -> seconds remaining (the remediation view)."""
        now = time.time()
        with self._directive_lock:
            return {w: round(until - now, 3)
                    for w, until in self._quarantined.items()
                    if until > now}

    # -- activity-coupled membership expiry ---------------------------------

    def _expire_tick(self) -> None:
        """Run membership expiry on push and registration activity,
        throttled, so an elastic round stalled on a dead worker unsticks
        as soon as a LIVE worker shows up; the reaped ids feed the
        monitor. A no-op without a ``worker_timeout``."""
        timeout = getattr(self.store.config, "worker_timeout", None)
        if not timeout:
            return
        now = time.time()
        with self._expire_lock:
            if now - self._last_expire_check < min(1.0, timeout / 4.0):
                return
            self._last_expire_check = now
        try:
            # Tenancy sweeps every job's store and reports GLOBAL ids.
            expired = self.store.expire_stale_workers() \
                if self.jobs is None else self.jobs.expire_stale_workers()
        except Exception:  # noqa: BLE001 — expiry must not fail the RPC
            return
        if expired:
            print(f"expired silent workers: {expired}", flush=True)
            if self.monitor is not None:
                try:
                    self.monitor.note_expired(expired)
                except Exception:  # noqa: BLE001
                    pass

    # -- RPC bodies (request bytes -> reply bytes) --------------------------

    def _job_of(self, meta: dict) -> str:
        """The envelope's job id. Tenancy off: always the default job,
        the ``job`` key never read. Garbled ids degrade to the default
        job, never fail the RPC."""
        if self.jobs is None:
            return DEFAULT_JOB
        return normalize_job_id(meta.get("job"))

    def _route(self, meta: dict):
        """``(job, store, local_worker_id)`` for an envelope: the job from
        the ``job`` meta key (else from the global id's stride), its store
        from the job table, and the LOCAL worker id with the per-job
        stride taken off. Tenancy off routes everything to the primary
        store with ids untouched."""
        wid = meta.get("worker_id")
        wid = None if wid is None else int(wid)
        if self.jobs is None:
            return DEFAULT_JOB, self.store, wid
        job = normalize_job_id(meta.get("job"))
        if job == DEFAULT_JOB and wid is not None:
            job = self.jobs.job_name_of(wid)
        lwid = None if wid is None else wid % WID_STRIDE
        return job, self.jobs.store_for(job), lwid

    def _membership_fields(self, store=None) -> dict:
        """Live membership for elastic remote workers; empty unless the
        store is elastic. ``store`` is a job's own store under tenancy
        (membership is per job, in local ids)."""
        store = self.store if store is None else store
        if not getattr(store.config, "elastic", False):
            return {}
        return {"active_workers": store.membership_snapshot()}

    def _qscale_fields(self, have_step: int | None = None,
                       store=None) -> dict:
        """Shared-scale table fields for a reply: the store's per-layer
        gradient absmax table + version, attached when the store publishes
        one AND the client's known version (``have_qscales``) is older.
        ``store`` is a job's own store under tenancy."""
        store = self.store if store is None else store
        fn = getattr(store, "gradient_scales", None)
        if not callable(fn):
            return {}
        try:
            have = None if have_step is None else int(have_step)
        except (TypeError, ValueError):
            have = None  # garbled version: resend the table, never fail
        scales, step = fn()
        if not scales or (have is not None and have >= step):
            return {}
        return {"qscales": scales, "qscale_step": step}

    def _shard_fields(self, have_version=None) -> dict:
        """Shard-map fields for a reply: the full map at registration
        (``have_version`` None; its presence there IS the capability
        advertisement), then refreshed via fetch replies only when the
        client's known version (``have_shard_map``) is older. An
        unsharded server contributes nothing."""
        if self.sharding is None:
            return {}
        try:
            have = None if have_version is None else int(have_version)
        except (TypeError, ValueError):
            have = None  # garbled version: resend the map, never fail
        m = self.sharding.shard_map()
        if have is not None and have >= m["version"]:
            return {}
        return {"shard_map": m}

    def _note_replica(self, meta: dict) -> None:
        """Ingest a replica announce riding fetch meta: ``replica:
        {shard_id, address}`` plus the fetch's own ``have_step`` gives the
        primary this replica's applied step (the ``dps_replica_lag_*``
        gauges and the published replica list). An interior node forwards
        its subtree as ``descendants`` rows, at most 64. Never fails the
        fetch."""
        rep = meta.get("replica")
        if self.sharding is None or not isinstance(rep, dict):
            return
        try:
            self.sharding.note_replica(rep.get("address"),
                                       meta.get("have_step", 0),
                                       self.store.global_step,
                                       metrics=rep.get("metrics"),
                                       parent=rep.get("parent"),
                                       tier=rep.get("tier"),
                                       fetches=rep.get("fetches"))
            for d in (rep.get("descendants") or [])[:64]:
                if isinstance(d, dict):
                    self.sharding.note_replica(
                        d.get("address"), d.get("step", 0),
                        self.store.global_step,
                        metrics=d.get("metrics"),
                        parent=d.get("parent"), tier=d.get("tier"),
                        fetches=d.get("fetches"))
        except Exception:  # noqa: BLE001
            pass

    def _topology_fields(self, have_version=None) -> dict:
        """Fan-out-tree topology fields for a reply: attached only for
        replica polls that sent ``have_topology`` with a version older
        than the live one, so steady-state NM replies stay
        attachment-free and cacheable."""
        if self.sharding is None \
                or not callable(getattr(self.sharding, "topology", None)):
            return {}
        try:
            have = None if have_version is None else int(have_version)
        except (TypeError, ValueError):
            have = None  # garbled version: resend the view, never fail
        topo = self.sharding.topology()
        if have is not None and have >= topo["version"]:
            return {}
        return {"topology": topo}

    def _disowned_keys(self, names) -> list[str]:
        """Pushed keys whose slot this primary does not currently own
        (map moved under the client) or is draining away (mid-handoff).
        Routed on the BASE tensor name, so codec companions
        (``name::int8scale``) travel with their tensor."""
        if self.sharding is None:
            return []
        lo, hi = self.sharding.my_range()
        with self._reshard_lock:
            if self._draining:
                # Lazy lease check on the hot path's cold branch: a
                # frozen range must not keep disowning pushes after its
                # donor lease lapsed.
                self._lease_expired_locked()
            draining = set(self._draining)
        out = []
        for k in names:
            slot = key_slot(str(k).split("::", 1)[0])
            if not lo <= slot < hi or slot in draining:
                out.append(k)
        return out

    def _keys_in_slots(self, lo: int, hi: int) -> list[str]:
        """This store's parameter names living in ``[lo, hi)``: the
        donor's export subset, derived from slots at call time so the
        admin never has to know key names."""
        return [k for k in self.store.param_names()
                if lo <= key_slot(k) < hi]

    # -- durable migration ledger + lease (docs/ROBUSTNESS.md) ---------------

    @staticmethod
    def _migration_plan(plan) -> dict | None:
        """Normalized coordinator plan from the request's ``migration``
        field; None for a ledger-less coordinator or a garbled plan."""
        if not isinstance(plan, dict):
            return None
        try:
            return {
                "id": str(plan["id"]),
                "slot_lo": int(plan["slot_lo"]),
                "slot_hi": int(plan["slot_hi"]),
                "ranges": [[int(a), int(b)]
                           for a, b in (plan.get("ranges") or [])],
                "map_version": int(plan.get("map_version") or 0),
                "lease_ttl": float(plan.get("lease_ttl")
                                   or DEFAULT_MIGRATION_LEASE_S),
            }
        except (KeyError, TypeError, ValueError):
            return None

    def _lease_expired_locked(self) -> bool:
        """Lazy lease enforcement (requires ``_reshard_lock``): a donor
        whose pre-publish freeze outlived its TTL auto-unfreezes and
        clears its record — the map never moved, so the abort is local
        and complete. Returns True when it fired. Checked wherever the
        frozen range could wedge traffic: reshard ops, the push
        ownership filter, the status/cluster views, and snapshot
        restore. Deadlines are wall-clock (``time.time``), so a record
        persisted by a checkpoint keeps its meaning across a restart.
        After ``apply_ranges`` publishes the new map the phase is no
        longer ``export`` and the lease stops applying."""
        rec = self._migration
        if rec is None or rec.get("role") != "donor" \
                or rec.get("phase") != "export":
            return False
        if time.time() <= float(rec.get("lease_deadline", 0.0)):
            return False
        self._draining.clear()
        self._migration = None
        self._tm_lease_expired.inc()
        print(f"RESHARD_LEASE_EXPIRED migration={rec.get('id')} "
              f"slots=[{rec.get('slot_lo')},{rec.get('slot_hi')}) "
              f"frozen range auto-unfrozen, map untouched", flush=True)
        return True

    def migration_view(self) -> dict | None:
        """Compact in-flight-migration block for ``GET /cluster`` /
        ``cli status`` (riding the sharding view via the provider hook);
        None when no migration is in flight."""
        with self._reshard_lock:
            self._lease_expired_locked()
            rec = self._migration
            if rec is None:
                return None
            out = {"id": rec["id"], "role": rec["role"],
                   "phase": rec["phase"],
                   "slot_lo": rec["slot_lo"], "slot_hi": rec["slot_hi"],
                   "map_version": rec["map_version"],
                   # The full target partition: a resumed coordinator
                   # rebuilds its plan from this block.
                   "ranges": [list(r)
                              for r in (rec.get("ranges") or [])],
                   "frozen_slots": len(self._draining)}
            if rec["role"] == "donor" and rec["phase"] == "export":
                out["lease_remaining_s"] = round(
                    float(rec.get("lease_deadline", 0.0)) - time.time(), 3)
            return out

    def migration_snapshot(self) -> dict | None:
        """The full migration record for checkpoint persistence
        (checkpoint/manager.py ``migration_fn``), or None."""
        with self._reshard_lock:
            self._lease_expired_locked()
            return None if self._migration is None \
                else dict(self._migration)

    def load_migration(self, rec) -> bool:
        """Restore a persisted migration record (server restart mid-
        migration). A donor still in its ``export`` phase re-freezes its
        range — unless the lease lapsed while the server was down, in
        which case the restore IS the auto-abort (map untouched).
        Malformed records are ignored: a garbled ledger degrades to
        status=absent, not a refused restore. Returns True when a record
        was installed."""
        if not isinstance(rec, dict):
            return False
        try:
            rec = {
                "id": str(rec["id"]), "role": str(rec["role"]),
                "phase": str(rec["phase"]),
                "slot_lo": int(rec["slot_lo"]),
                "slot_hi": int(rec["slot_hi"]),
                "ranges": [[int(a), int(b)]
                           for a, b in (rec.get("ranges") or [])],
                "map_version": int(rec.get("map_version") or 0),
                "lease_ttl": float(rec.get("lease_ttl")
                                   or DEFAULT_MIGRATION_LEASE_S),
                "lease_deadline": float(rec.get("lease_deadline", 0.0)),
                "started_at": float(rec.get("started_at", 0.0)),
            }
        except (KeyError, TypeError, ValueError):
            return False
        with self._reshard_lock:
            self._migration = rec
            if rec["role"] == "donor" and rec["phase"] == "export":
                self._draining.update(range(rec["slot_lo"],
                                            rec["slot_hi"]))
                if self._lease_expired_locked():
                    return False
        print(f"RESHARD_RESTORED migration={rec['id']} "
              f"role={rec['role']} phase={rec['phase']}", flush=True)
        return True

    def _in_flight_refusal(self, rec: dict, ctx):
        """Refuse an export/import of another migration while ``rec`` is
        in flight."""
        if ctx is not None:
            ctx.abort(grpc.StatusCode.FAILED_PRECONDITION,
                      f"reshard: migration {rec['id']} already in flight")
        raise ValueError("migration already in flight")

    def reshard(self, request: bytes, ctx) -> bytes:
        """Admin-plane slot-range handoff (docs/SHARDING.md "Migration
        protocol"), driven by ``cli reshard``:

        - ``export``: freeze ``[slot_lo, slot_hi)`` (pushes touching it
          are disowned from this instant) and return a consistent params
          subset + the completed push-token journal + the step — the
          donor half. Nothing is dropped yet.
        - ``import``: graft a transferred subset + journal into this
          store — the recipient half. Exactly-once survives the handoff
          because the donor's journal seeds this service's dedupe table
          BEFORE any client is re-routed here.
        - ``apply_ranges``: install the coordinator's new slot partition
          + map version (every primary converges to the same revision);
          clears any draining slots.
        - ``commit``: drop the donor's copy of the migrated range after
          the recipient confirmed adoption; clears the drain markers.
        - ``status`` / ``abort``: the ledger read and the roll-back.

        Every reply carries the CURRENT map (full, never delta-gated):
        the coordinator derives the new partition from the donor's live
        ranges instead of trusting its own stale picture."""
        meta, payload = unpack_msg(request)
        if self.sharding is None:
            if ctx is not None:
                ctx.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "reshard: this server is not a shard primary")
            raise ValueError("reshard on unsharded server")
        op = str(meta.get("op"))
        if op not in RESHARD_OPS:
            if ctx is not None:
                ctx.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"reshard: unknown op {op!r}")
            raise ValueError(f"unknown reshard op {op!r}")
        self._tm_reshard[op].inc()
        plan = self._migration_plan(meta.get("migration"))
        if op == "status":
            # Read-only: the resumed coordinator's crash-point oracle.
            return pack_msg({"migration": self.migration_view(),
                             "global_step": self.store.global_step,
                             **self._shard_fields()})
        if op == "abort":
            return self._reshard_abort(plan)
        if op == "export":
            return self._reshard_export(meta, plan, ctx)
        if op == "import":
            return self._reshard_import(meta, payload, plan, ctx)
        if op == "apply_ranges":
            return self._reshard_apply(meta, plan)
        return self._reshard_commit(meta, plan)

    def _reshard_export(self, meta: dict, plan: dict | None, ctx) -> bytes:
        lo, hi = int(meta["slot_lo"]), int(meta["slot_hi"])
        with self._reshard_lock:
            self._lease_expired_locked()
            rec = self._migration
            if rec is not None and (plan is None
                                    or rec["id"] != plan["id"]):
                self._in_flight_refusal(rec, ctx)
            self._draining.update(range(lo, hi))
            if plan is not None:
                # Same id re-export is idempotent (resume replays the
                # phase): the range got no applies while frozen, so a
                # second export snapshot is byte-equivalent.
                now = time.time()
                self._migration = {**plan, "role": "donor",
                                   "phase": "export",
                                   "lease_deadline":
                                       now + plan["lease_ttl"],
                                   "started_at": now}
        if plan is not None:
            journal_event("migration", id=plan["id"], phase="export",
                          mig_role="donor", slot_lo=lo, slot_hi=hi)
        keys = self._keys_in_slots(lo, hi)
        # A device store hands back host copies, made on its stream.
        params, step = self.store.export_params(keys)
        return pack_msg({"export_step": step,
                         "journal": self.journal_snapshot(),
                         "exported": len(params),
                         **self._shard_fields()},
                        encode_tensor_dict(params))

    def _reshard_import(self, meta: dict, payload, plan: dict | None,
                        ctx) -> bytes:
        with self._reshard_lock:
            rec = self._migration
            if rec is not None and (plan is None
                                    or rec["id"] != plan["id"]):
                self._in_flight_refusal(rec, ctx)
        params = decode_tensor_dict(payload)
        # The adopted names land at the end of the store's dict, in both
        # packages, so fetch replies stay byte-equal to a JAX primary's.
        adopted = self.store.adopt_params(params)
        loaded = self.load_journal(meta.get("journal"))
        if plan is not None:
            now = time.time()
            with self._reshard_lock:
                self._migration = {**plan, "role": "recipient",
                                   "phase": "import",
                                   "lease_deadline":
                                       now + plan["lease_ttl"],
                                   "started_at": now}
            journal_event("migration", id=plan["id"], phase="import",
                          mig_role="recipient")
        return pack_msg({"adopted": adopted, "journal_loaded": loaded,
                         **self._shard_fields()})

    def _reshard_apply(self, meta: dict, plan: dict | None) -> bytes:
        version = self._apply_ranges(meta)
        # The adopted map is now the sole ownership authority: drain
        # markers for slots handed away are redundant (the range check
        # disowns), and markers for slots the map says we KEEP would
        # contradict it (an aborted handoff must un-freeze).
        applied = None
        with self._reshard_lock:
            self._draining.clear()
            rec = self._migration
            if rec is not None and (plan is None
                                    or rec["id"] == plan["id"]):
                if rec["role"] == "donor":
                    # Map published: the lease stops applying and the
                    # only exit is forward (commit).
                    rec["phase"] = "apply_ranges"
                else:
                    # The recipient now OWNS the adopted range: its half
                    # of the migration is complete.
                    self._migration = None
                applied = (rec["id"], rec["role"])
        if applied is not None:
            journal_event("migration", id=applied[0],
                          phase="apply_ranges", mig_role=applied[1])
        return pack_msg({"map_version": version, **self._shard_fields()})

    def _reshard_commit(self, meta: dict, plan: dict | None) -> bytes:
        """The recipient holds the range; release the donor copy."""
        lo, hi = int(meta["slot_lo"]), int(meta["slot_hi"])
        dropped = self.store.drop_params(self._keys_in_slots(lo, hi))
        committed = None
        with self._reshard_lock:
            self._draining -= set(range(lo, hi))
            rec = self._migration
            if rec is not None and (plan is None
                                    or rec["id"] == plan["id"]):
                committed = rec["id"]
                self._migration = None
        if committed is not None:
            journal_event("migration", id=committed, phase="commit",
                          mig_role="donor", dropped=dropped)
        return pack_msg({"dropped": dropped, **self._shard_fields()})

    def _apply_ranges(self, meta: dict) -> int:
        """Adopt the coordinator's partition — idempotently. A resumed
        coordinator re-applies the SAME plan to every primary; an exact
        match (ranges AND version already at-or-past the plan's) is a
        no-op rather than a version bump that churns every client's
        cached map."""
        ranges = meta["ranges"]
        want = meta.get("map_version")
        try:
            want_i = None if want is None else int(want)
            norm = [(int(a), int(b)) for a, b in ranges]
        except (TypeError, ValueError):
            want_i, norm = None, None
        if want_i is not None and norm is not None \
                and self.sharding.version >= want_i \
                and self.sharding.ranges() == norm:
            return self.sharding.version
        return self.sharding.adopt_ranges(ranges, want)

    def _reshard_abort(self, plan: dict | None) -> bytes:
        """Roll back this primary's half of a migration: donor
        unfreezes; a recipient that never came to own the range drops
        its adopted copies (the donor still owns and serves them). The
        live map is untouched either way."""
        dropped = 0
        with self._reshard_lock:
            rec = self._migration
            if rec is not None and (plan is None
                                    or rec["id"] == plan["id"]):
                if rec["role"] == "recipient":
                    lo, hi = rec["slot_lo"], rec["slot_hi"]
                    my_lo, my_hi = self.sharding.my_range()
                    if not (my_lo <= lo and hi <= my_hi):
                        dropped = self.store.drop_params(
                            self._keys_in_slots(lo, hi))
                self._draining.clear()
                self._migration = None
                print(f"RESHARD_ABORT migration={rec['id']} "
                      f"role={rec['role']} phase={rec['phase']} "
                      f"dropped={dropped}", flush=True)
        return pack_msg({"aborted": True, "dropped": dropped,
                         **self._shard_fields()})

    def register_worker(self, request: bytes, ctx) -> bytes:
        meta, _ = unpack_msg(request)
        self._expire_tick()
        # Under tenancy: register into the job's own store, then stride
        # the local id so the cluster keeps one flat worker-id space. A
        # legacy peer sends no ``job`` and lands in the default job,
        # whose ids are the local ids.
        job = self._job_of(meta)
        store = self.store if self.jobs is None \
            else self.jobs.store_for(job)
        worker_id, total = store.register_worker(
            meta.get("worker_name", ""))
        if self.jobs is not None:
            worker_id = self.jobs.to_global(job, worker_id)
        # Directive capability is advertised by the WORKER. A reused id
        # slot must not inherit its predecessor's undelivered directives,
        # quarantine or capability — a legacy replacement must not stay
        # quarantined for its predecessor's sins.
        caps = meta.get("capabilities")
        capable = isinstance(caps, (list, tuple)) and "directives" in caps
        with self._directive_lock:
            self._directives.pop(worker_id, None)
            self._quarantined.pop(worker_id, None)
            if capable:
                self._directive_capable.add(worker_id)
            else:
                self._directive_capable.discard(worker_id)
        # The keys and their order are a JAX server's; ``jobs`` and the
        # job the peer landed in only on a tenancy server, the shard map
        # last, only on a shard primary.
        return pack_msg({
            "worker_id": worker_id,
            "total_workers": total,
            "push_codec": store.push_codec,
            "fetch_codec": getattr(store, "fetch_codec", "none"),
            "mode": store.config.mode,
            "learning_rate": store.config.learning_rate,
            "staleness_bound": int(getattr(store.config,
                                           "staleness_bound", 5)),
            "elastic": bool(getattr(store.config, "elastic", False)),
            "delta_fetch": bool(getattr(store, "supports_delta_fetch",
                                        False)),
            "trace_context": True,
            "health_report": self.monitor is not None,
            "compressed_domain": bool(getattr(
                store, "supports_compressed_domain", False)),
            "directives": True,
            "checksum": True,
            **({"jobs": True, "job": job} if self.jobs is not None
               else {}),
            **self._qscale_fields(store=store),
            **self._membership_fields(store),
            **self._shard_fields(),
        })

    def _ingest_health(self, worker_id, meta: dict) -> None:
        """Feed a piggybacked health report to the cluster monitor.
        Observability only: any failure (garbled report, monitor bug) is
        swallowed — it must never fail the RPC that carried it."""
        if self.monitor is None:
            return
        health = meta.get("health")
        if worker_id is None or not isinstance(health, dict):
            return
        try:
            self.monitor.ingest(worker_id, health)
        except Exception:  # noqa: BLE001
            pass

    def _refuse_corrupt(self, wid, meta: dict, store=None) -> bytes:
        """Refuse a push whose payload failed integrity verification (CRC
        trailer mismatch, or a frame the decoder rejects): counted, fed to
        the monitor's ``wire_corrupt`` rule, never applied, and never
        recorded in the dedupe table, so the client's clean retry of the
        same token can still apply."""
        store = self.store if store is None else store
        self._tm_wire_corrupt.inc()
        if self.monitor is not None:
            try:
                self.monitor.note_corrupt_frame()
            except Exception:  # noqa: BLE001 — observability only
                pass
        print(f"WIRE_CORRUPT push refused worker={wid}", flush=True)
        return pack_msg({"received": False, "accepted": False,
                         "corrupt": True,
                         "global_step": store.global_step,
                         **self._directive_fields(wid, meta)})

    def _admit(self, job: str, ctx, rpc: str) -> None:
        """Weighted-fair admission of one push or fetch (tenancy only):
        a throttled RPC aborts RESOURCE_EXHAUSTED, which the client
        retries with backoff."""
        if self.qos.admit(job, self._admission_budget(ctx)):
            return
        if ctx is not None:
            ctx.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                      f"job {job!r} throttled (weighted-fair "
                      f"admission); retry with backoff")
        raise TimeoutError(f"{rpc} throttled for job {job!r}")

    @staticmethod
    def _admission_budget(ctx) -> float:
        """The admission wait, bounded by the caller's remaining deadline
        minus a reply margin: a server-side wait must never outlive the
        client's patience."""
        budget = ADMISSION_WAIT_CAP_S
        if ctx is not None and callable(getattr(ctx, "time_remaining",
                                                None)):
            remaining = ctx.time_remaining()
            if remaining is not None:
                budget = max(0.0, min(budget, remaining - 1.0))
        return budget

    def push_gradrients(self, request: bytes, ctx) -> bytes:
        meta, payload = unpack_msg(request)
        job, store, lwid = self._route(meta)
        if self.qos is not None:
            self._admit(job, ctx, "push")
        try:
            return self._push_body(meta, payload, ctx, job, store, lwid)
        finally:
            if self.qos is not None:
                self.qos.release(job)

    def _push_body(self, meta: dict, payload, ctx, job: str, store,
                   lwid: int) -> bytes:
        wid = int(meta["worker_id"])
        # Integrity gate FIRST — before the dedupe records anything for
        # this token. None (no trailer) passes; only an explicit False
        # refuses.
        if len(payload) and frame_checksum_ok(payload) is False:
            return self._refuse_corrupt(wid, meta, store)
        self._ingest_health(wid, meta)
        self._expire_tick()
        health = meta.get("health")
        nonfinite = (self.reject_nonfinite and isinstance(health, dict)
                     and (health.get("loss_finite") is False
                          or health.get("grad_finite") is False))
        # Quarantine (and its synchronous non-finite half) is decided here
        # but gated AFTER the dedupe lookup: a retry of a token whose
        # original was already applied replays its outcome even while its
        # worker is quarantined. Only NEW pushes are refused, and without
        # a dedupe entry, so the same token retried after the quarantine
        # lifts applies normally.
        blocked = nonfinite or self.is_quarantined(wid)
        token = meta.get("push_token")
        entry = None
        if token is not None:
            nonce, count = parse_push_token(token)
            # Job-scoped dedupe namespace: identical tokens under two jobs
            # are distinct entries, and the journal filters per job. The
            # default job's nonces stay bare.
            nonce = job_key(job, nonce)
            with self._push_seen_lock:
                prev = self._push_seen.get(nonce)
                if prev is not None and count <= prev[0]:
                    dup, stale = prev, count < prev[0]
                else:
                    # New push (or the first with a HIGHER count): record
                    # it, unless quarantine refuses it below. A lower count
                    # never replaces a higher one.
                    dup, stale = None, False
                    if not blocked:
                        entry = [count, None, threading.Event(), wid,
                                 None]
                        self._push_seen[nonce] = entry
                        self._push_seen.move_to_end(nonce)
                        while len(self._push_seen) > PUSH_SEEN_CAP:
                            self._push_seen.popitem(last=False)
            if dup is not None:
                if stale:
                    # ZOMBIE: a deadline-expired attempt executing after
                    # newer pushes from the same client already landed.
                    # Answer terminally; never re-apply.
                    return pack_msg({
                        "received": True, "accepted": False,
                        "duplicate": True, "stale_token": True,
                        "global_step": store.global_step})
                # Retry of the push most recently seen from this client:
                # wait for the original's outcome, bounded by the caller's
                # remaining deadline minus a margin for the reply.
                budget = DUP_WAIT_CAP_S
                remaining = None
                if ctx is not None and callable(
                        getattr(ctx, "time_remaining", None)):
                    remaining = ctx.time_remaining()
                if remaining is not None:
                    budget = max(0.0, min(budget, remaining - 1.0))
                dup[2].wait(timeout=budget)
                if dup[1] is None:
                    # Still running, or refused and undone: fail
                    # retryably so the client's next attempt re-checks.
                    if ctx is not None:
                        ctx.abort(grpc.StatusCode.UNAVAILABLE,
                                  "push still in flight; retry")
                    raise TimeoutError("push still in flight")
                return pack_msg({
                    "received": True, "accepted": bool(dup[1]),
                    "duplicate": True,
                    "global_step": store.global_step})
        if blocked:
            # A NEW push of a quarantined (or self-reported non-finite)
            # worker: acknowledged, so the worker does not die retrying,
            # and never applied.
            self._tm_quarantined.inc()
            return pack_msg({"received": True, "accepted": False,
                             "quarantined": True,
                             "global_step": store.global_step,
                             **self._directive_fields(wid, meta)})
        try:
            grads = decode_tensor_dict(payload)
        except ValueError:
            # A garbled frame that carried no trailer: refuse it like a
            # CRC failure and UNDO the in-flight dedupe entry, so a clean
            # retry of the same token applies instead of replaying a
            # refusal. Waiters on the entry wake (outcome None) and fail
            # retryably.
            if entry is not None:
                with self._push_seen_lock:
                    if self._push_seen.get(nonce) is entry:
                        del self._push_seen[nonce]
                entry[2].set()
            return self._refuse_corrupt(wid, meta, store)
        # Ownership filter: keys whose slot this primary does not own are
        # dropped from the apply and NAMED in the reply beside a fresh
        # map, so the client re-routes that slice to the current owner.
        # The rest applies: round accounting sees the worker either way.
        disowned = self._disowned_keys(grads)
        shard_extra: dict = {}
        if disowned:
            for k in disowned:
                grads.pop(k, None)
            self._tm_disowned.inc(len(disowned))
            shard_extra = {"disowned": disowned, **self._shard_fields()}
        accepted = False
        try:
            accepted = store.push(lwid, grads, int(meta["fetched_step"]))
        finally:
            # On an exception the event still fires (outcome False), so a
            # waiting retry is never stranded until its timeout.
            if entry is not None:
                entry[1] = accepted
                entry[4] = store.global_step
                entry[2].set()
        return pack_msg({"received": True, "accepted": accepted,
                         "global_step": store.global_step,
                         **shard_extra,
                         **self._directive_fields(wid, meta)})

    # -- durable push-token journal ------------------------------------------

    def journal_snapshot(self, job: str | None = None) -> list[dict]:
        """COMPLETED push-token outcomes, oldest first: the bounded
        journal a store snapshot persists (checkpoint/manager.py), so a
        restarted server still dedupes in-flight push retries from before
        the crash. In-flight entries are skipped: their outcome is
        unknown. ``job`` filters to one job's namespace (nonces carry the
        job prefix), so each job's checkpoint lineage journals only its
        own tokens."""
        with self._push_seen_lock:
            return [
                {"nonce": nonce, "count": e[0], "accepted": bool(e[1]),
                 "worker_id": e[3], "step": e[4]}
                for nonce, e in self._push_seen.items()
                if e[2].is_set()
                and (job is None or split_job_key(nonce)[0] == job)
            ]

    def load_journal(self, entries) -> int:
        """Seed the dedupe table from a persisted journal (server
        restart). Returns the number of entries loaded. Entries arrive
        completed (their events are pre-set); malformed records are
        skipped, so a corrupt journal degrades to weaker dedupe, not a
        refused restore."""
        loaded = 0
        with self._push_seen_lock:
            for rec in entries or []:
                try:
                    nonce = str(rec["nonce"])
                    count = int(rec["count"])
                    accepted = bool(rec["accepted"])
                    wid = int(rec.get("worker_id", -1))
                    step = rec.get("step")
                except (KeyError, TypeError, ValueError):
                    continue
                prev = self._push_seen.get(nonce)
                if prev is not None and count <= prev[0]:
                    continue  # never downgrade to a lower count
                ev = threading.Event()
                ev.set()
                self._push_seen[nonce] = [count, accepted, ev, wid, step]
                self._push_seen.move_to_end(nonce)
                loaded += 1
            while len(self._push_seen) > PUSH_SEEN_CAP:
                self._push_seen.popitem(last=False)
        return loaded

    def fetch_parameters(self, request: bytes, ctx) -> bytes:
        meta, _ = unpack_msg(request)
        job, store, lwid = self._route(meta)
        if self.qos is not None:
            self._admit(job, ctx, "fetch")
        try:
            return self._fetch_body(meta, job, store, lwid)
        finally:
            if self.qos is not None:
                self.qos.release(job)

    # dpslint: hot-path — every worker ping; NM replies serve a cached encode
    def _fetch_body(self, meta: dict, job: str, store, lwid) -> bytes:
        wid = None if meta.get("worker_id") is None \
            else int(meta["worker_id"])
        # Heartbeat pings are fetches: the report rides the ping's meta,
        # so a delta-gated ping still refreshes the monitor's view.
        self._ingest_health(wid, meta)
        self._note_replica(meta)
        have = meta.get("have_step")
        # The scale-table refresh rides the same reply, delta-gated on the
        # client's known version.
        qfields = self._qscale_fields(meta["have_qscales"], store=store) \
            if "have_qscales" in meta else {}
        dfields = self._directive_fields(wid, meta)
        sfields = self._shard_fields(meta["have_shard_map"]) \
            if "have_shard_map" in meta else {}
        tfields = self._topology_fields(meta["have_topology"]) \
            if "have_topology" in meta else {}
        if have is not None \
                and getattr(store, "supports_delta_fetch", False):
            params, step = store.fetch(lwid, have_step=int(have))
            if not params and step == int(have):
                # Version-gated delta fetch: the step hasn't advanced past
                # what the client holds — the reply is a header.
                mfields = self._membership_fields(store)
                if qfields or dfields or sfields or tfields:
                    return pack_msg({"global_step": step,
                                     "not_modified": True, **qfields,
                                     **dfields, **sfields, **tfields,
                                     **mfields})
                # Attachment-free NM reply: serve the cached encode. The
                # key holds the job, so two jobs idling at the same step
                # never serve each other's cached header.
                key = (job, step, repr(mfields))
                with self._nm_lock:
                    if self._nm_cache is not None \
                            and self._nm_cache[0] == key:
                        self._tm_nm_cache_hits.inc()
                        return self._nm_cache[1]
                    if self._nm_building == key:
                        # Single-flight: another handler is encoding this
                        # exact reply; wait briefly and serve its bytes.
                        self._nm_cond.wait_for(
                            lambda: self._nm_building != key
                            or (self._nm_cache is not None
                                and self._nm_cache[0] == key),
                            timeout=0.25)
                        if self._nm_cache is not None \
                                and self._nm_cache[0] == key:
                            self._tm_nm_cache_hits.inc()
                            return self._nm_cache[1]
                    else:
                        self._nm_building = key
                reply = pack_msg({"global_step": step,
                                  "not_modified": True, **mfields})
                with self._nm_lock:
                    self._nm_cache = (key, reply)
                    if self._nm_building == key:
                        self._nm_building = None
                    self._nm_cond.notify_all()
                return reply
        else:
            params, step = store.fetch(lwid)
        if getattr(store, "keeps_device_arrays", False):
            params = store.to_host(params)
        return pack_msg({"global_step": step, **qfields, **dfields,
                         **sfields, **tfields,
                         **self._membership_fields(store)},
                        encode_tensor_dict(params))

    def job_finished(self, request: bytes, ctx) -> bytes:
        meta, _ = unpack_msg(request)
        _, store, lwid = self._route(meta)
        store.job_finished(int(lwid))
        return pack_msg({"acknowledged": True})

    def submit_job(self, request: bytes, ctx) -> bytes:
        """Admin-plane job control (docs/TENANCY.md): submit a job from a
        one-entry ``--jobs``-grammar spec (``job_spec``), or drain one
        (``drain_job``). A single-job server answers
        FAILED_PRECONDITION."""
        meta, _ = unpack_msg(request)
        if self.jobs is None:
            if ctx is not None:
                ctx.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          "submit_job: tenancy is not enabled on this "
                          "server (start it with --jobs)")
            raise ValueError("submit_job on a single-job server")
        drain = meta.get("drain_job")
        if drain is not None:
            try:
                drained = self.jobs.drain(str(drain))
            except ValueError as e:
                if ctx is not None:
                    ctx.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
                raise
            return pack_msg({"drained": bool(drained),
                             "jobs": self.jobs.names()})
        try:
            specs = parse_jobs_spec(str(meta.get("job_spec") or ""))
            if len(specs) != 1:
                raise ValueError(
                    "job_spec must declare exactly one job")
            state = self.jobs.submit(specs[0])
        except ValueError as e:
            if ctx is not None:
                ctx.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            raise
        return pack_msg({"submitted": state.name, "index": state.index,
                         "jobs": self.jobs.names()})

    # -- wiring --------------------------------------------------------------

    def _instrumented(self, name: str, fn):
        """Wrap an RPC body with its span + byte counters. The span covers
        the full handler (decode + store work + encode); durations record
        even when the body raises or aborts. With tracing on, the wrapper
        adopts the client's propagated trace context (fetch meta or push
        frame header) and opens an ``rpc.server`` span under it."""
        hist, b_in, b_out, calls, slo_hist, errors = self._tm_rpc[name]

        def wrapped(request: bytes, ctx) -> bytes:
            t0 = now()
            b_in.inc(len(request))
            calls.inc()
            wire_ctx = None
            if trace_enabled():
                try:
                    meta, payload = unpack_msg(request)
                    wire_ctx = meta.get("trace") or \
                        (peek_trace(payload) if len(payload) else None)
                except Exception:  # noqa: BLE001
                    wire_ctx = None  # malformed request fails in fn, not here
            sp = None
            try:
                with use_wire_context(wire_ctx), \
                        trace_span("rpc.server", rpc=name) as sp:
                    reply = fn(request, ctx)
            except Exception:  # noqa: BLE001 — counted, then re-raised
                errors.inc()
                raise
            finally:
                dur = now() - t0
                hist.observe(dur)
                tid = getattr(getattr(sp, "ctx", None), "trace_id", None)
                if tid is not None and self._tm_exemplars.sample():
                    slo_hist.observe(dur, exemplar=tid)
                else:
                    slo_hist.observe(dur)
            b_out.inc(len(reply))
            return reply

        return wrapped

    def handlers(self) -> grpc.GenericRpcHandler:
        ident = lambda b: b  # noqa: E731 — bytes pass through untouched
        method_map = {
            "RegisterWorker": self.register_worker,
            "PushGradrients": self.push_gradrients,  # quirk 1, on purpose
            "FetchParameters": self.fetch_parameters,
            "JobFinished": self.job_finished,
            "Reshard": self.reshard,
            "SubmitJob": self.submit_job,
        }

        def wire(name, fn):
            # Fault injection sits INSIDE the instrumentation wrapper, so
            # injected delays/aborts land in the handler latency histogram
            # and call counters like real ones.
            if self.faults is not None:
                fn = self.faults.wrap_handler(name, fn)
            return self._instrumented(name, fn)

        return grpc.method_handlers_generic_handler(SERVICE_NAME, {
            name: grpc.unary_unary_rpc_method_handler(
                wire(name, fn),
                request_deserializer=ident, response_serializer=ident)
            for name, fn in method_map.items()
        })


def serve(store, port: int = 8000, max_rpc_workers: int = 20,
          service: ParameterService | None = None, host: str = "[::]"
          ) -> tuple[grpc.Server, int]:
    """Start the service (server.py:370-393). Returns (server, bound_port)
    — pass port=0 to pick a free port. Callers own shutdown. A pool of 20
    threads reproduces the reference's cap. ``host`` defaults to the JAX
    function's wildcard ``[::]``; where the host has no IPv6 the wildcard
    is IPv4's ``0.0.0.0``. Tests bind ``127.0.0.1``."""
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_rpc_workers),
        options=GRPC_OPTIONS)
    svc = service if service is not None else ParameterService(store)
    server.add_generic_rpc_handlers((svc.handlers(),))
    try:
        bound = server.add_insecure_port(f"{host}:{port}")
    except RuntimeError:
        bound = 0
    if not bound and host == "[::]":
        bound = server.add_insecure_port(f"0.0.0.0:{port}")
    if not bound:
        raise RuntimeError(f"could not bind {host}:{port}")
    server.start()
    return server, bound
