"""Multi-job tenancy of the port: job-scoped namespaces over one
parameter server.

The JAX package's ``ps/tenancy.py``, carried over (plain Python over the
port's NumPy :class:`~.store.ParameterStore`; the port keeps its own
copy). One server, several jobs (docs/TENANCY.md):

- a **job id** rides the wire at registration and on every push/fetch
  envelope, capability-gated: a legacy peer that never negotiated the
  ``jobs`` capability lands in the ``default`` job and sees the exact
  pre-tenancy wire;
- each job owns its OWN store: its parameters, aggregation config (sync
  quorum for job A, async staleness for job B, on the same server),
  membership and checkpoint lineage (snapshot meta v4 carries ``job``;
  restore refuses cross-job as ``check_shard_identity`` refuses
  cross-shard);
- worker ids are made globally unique by striding the per-job local id
  (``global = job_index * WID_STRIDE + local``), so the cluster monitor,
  directives and quarantine keep one flat id space;
- sharding composes: a job's key names are prefixed (:func:`job_key`)
  before the consistent hash, so *a job is a set of slots* in the same
  64-slot space (:func:`job_slots` reuses ``ps/sharding.py``'s slot
  math).

``JOB_SPEC_FIELDS`` is the ``--jobs`` spec grammar's field table, the JAX
package's, key for key.
"""

from __future__ import annotations

import re
import threading
import time
from dataclasses import dataclass, replace

__all__ = [
    "DEFAULT_JOB",
    "JOB_SPEC_FIELDS",
    "is_valid_job_id",
    "JobManager",
    "JobSpec",
    "WID_STRIDE",
    "job_key",
    "job_slots",
    "normalize_job_id",
    "parse_jobs_spec",
    "split_job_key",
    "split_wid",
]

#: The job every legacy peer (and every unlabeled envelope) lands in.
#: The default job IS the pre-tenancy server: bare key names, worker ids
#: starting at 0, the primary store — byte-identical behavior.
DEFAULT_JOB = "default"

#: Worker-id stride between jobs: ``global = index * WID_STRIDE +
#: local``. Far above any per-store membership cap (MAX_WORKERS = 32),
#: so global ids never collide and ``split_wid`` is pure arithmetic.
WID_STRIDE = 4096

#: Job ids are path/label-safe: they name metric label values, checkpoint
#: directories, and key prefixes.
_JOB_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_\-]{0,63}$")

#: ``--jobs`` / ``SubmitJob`` spec field -> meaning (docs/TENANCY.md's
#: "Job spec fields" table, key for key).
JOB_SPEC_FIELDS = {
    "weight": "relative share of serve capacity under contention "
              "(float > 0, default 1.0)",
    "max_inflight": "hard cap on the job's concurrently admitted RPCs "
                    "(int >= 1, default 8)",
    "mode": "aggregation mode override for the job's store "
            "(sync | async; default: inherit the server's)",
    "learning_rate": "server-side SGD learning rate override (float > 0)",
    "staleness_bound": "async staleness bound override (int >= 0)",
    "sync_quorum": "sync quorum override (int >= 1; implies strict "
                   "rounds, ps/store.py)",
    "total_workers": "expected worker count for the job's store "
                     "(int >= 1; default: inherit the server's)",
    "min_workers": "worker-autoscaler floor for the job (int >= 0, "
                   "default 1)",
    "max_workers": "worker-autoscaler ceiling for the job "
                   "(int >= min_workers, default 4)",
}


def is_valid_job_id(value) -> bool:
    """True when ``value`` is a well-formed job id (the grammar in
    :data:`_JOB_ID_RE`; label/path/prefix-safe)."""
    return isinstance(value, str) and bool(_JOB_ID_RE.match(value))


def normalize_job_id(value) -> str:
    """Coerce a wire job id to a valid one; garbled/absent degrades to
    :data:`DEFAULT_JOB`. Never raises — the tenancy layer follows the
    health-report discipline: a bad value from a buggy peer lands in the
    default namespace, it does not fail the RPC that carried it."""
    return value if is_valid_job_id(value) else DEFAULT_JOB


def job_key(job: str, name: str) -> str:
    """Canonical namespaced key for a parameter of ``job``. The default
    job keeps BARE names (pre-tenancy compatibility: its checkpoints,
    journals, and shard routing are byte-identical); other jobs prefix
    with ``job::`` — ``::`` never appears in flax param paths, so the
    mapping is unambiguous both ways."""
    return name if job == DEFAULT_JOB else f"{job}::{name}"


def split_job_key(key: str) -> tuple[str, str]:
    """Inverse of :func:`job_key`: ``(job, bare_name)``."""
    job, sep, name = key.partition("::")
    if sep and _JOB_ID_RE.match(job):
        return job, name
    return DEFAULT_JOB, key


def job_slots(job: str, names) -> list[int]:
    """The consistent-hash slots a job's parameters occupy — *a job is a
    set of slots* in the same space shards partition, so tenancy composes
    with sharding instead of inventing a second routing scheme
    (ps/sharding.py:key_slot over the namespaced keys)."""
    from .sharding import key_slot
    return sorted({key_slot(job_key(job, n)) for n in names})


def split_wid(global_wid: int) -> tuple[int, int]:
    """``global worker id -> (job_index, local_wid)``."""
    gw = int(global_wid)
    return gw // WID_STRIDE, gw % WID_STRIDE


@dataclass
class JobSpec:
    """One job's declaration (``--jobs`` spec / ``SubmitJob``).

    Fields documented in :data:`JOB_SPEC_FIELDS` (docs/TENANCY.md).
    ``None`` overrides inherit the server's primary store config.
    """

    name: str
    weight: float = 1.0
    max_inflight: int = 8
    mode: str | None = None
    learning_rate: float | None = None
    staleness_bound: int | None = None
    sync_quorum: int | None = None
    total_workers: int | None = None
    min_workers: int = 1
    max_workers: int = 4

    def __post_init__(self):
        if not _JOB_ID_RE.match(self.name or ""):
            raise ValueError(f"invalid job name {self.name!r} (want "
                             f"[A-Za-z0-9][A-Za-z0-9_-]*, <= 64 chars)")
        if not self.weight > 0:
            raise ValueError(f"job {self.name}: weight must be > 0, "
                             f"got {self.weight}")
        if self.max_inflight < 1:
            raise ValueError(f"job {self.name}: max_inflight must be "
                             f">= 1, got {self.max_inflight}")
        if self.mode not in (None, "sync", "async"):
            raise ValueError(f"job {self.name}: mode must be sync|async, "
                             f"got {self.mode!r}")
        if not 0 <= self.min_workers <= self.max_workers:
            raise ValueError(f"job {self.name}: need 0 <= min_workers "
                             f"({self.min_workers}) <= max_workers "
                             f"({self.max_workers})")


#: Spec-field parsers; unknown keys raise (a typo'd field must fail the
#: launch, not silently become a no-op).
_FIELD_CASTS = {
    "weight": float,
    "max_inflight": int,
    "mode": str,
    "learning_rate": float,
    "staleness_bound": int,
    "sync_quorum": int,
    "total_workers": int,
    "min_workers": int,
    "max_workers": int,
}


def parse_jobs_spec(spec: str) -> list[JobSpec]:
    """Parse the ``--jobs`` grammar (docs/TENANCY.md):

    ``name[:field=value[,field=value...]]`` entries separated by ``;`` —
    e.g. ``vision:weight=3,mode=sync,sync_quorum=2;ranker:weight=1``.
    Raises ``ValueError`` on any malformed entry; duplicate or
    ``default`` names are rejected (the default job always exists)."""
    jobs: list[JobSpec] = []
    seen: set[str] = set()
    for entry in (e.strip() for e in str(spec).split(";")):
        if not entry:
            continue
        name, _, rest = entry.partition(":")
        name = name.strip()
        fields: dict = {}
        if rest:
            for kv in rest.split(","):
                key, sep, value = kv.partition("=")
                key = key.strip()
                if not sep or key not in _FIELD_CASTS:
                    raise ValueError(
                        f"jobs spec: bad field {kv!r} in {entry!r} "
                        f"(known: {', '.join(sorted(_FIELD_CASTS))})")
                try:
                    fields[key] = _FIELD_CASTS[key](value.strip())
                except ValueError as e:
                    raise ValueError(f"jobs spec: bad value for "
                                     f"{key!r}: {value!r}") from e
        if name == DEFAULT_JOB:
            raise ValueError("jobs spec: 'default' is implicit and "
                             "cannot be redeclared")
        if name in seen:
            raise ValueError(f"jobs spec: duplicate job {name!r}")
        seen.add(name)
        jobs.append(JobSpec(name=name, **fields))
    return jobs


class _JobState:
    """One job's server-side state (store + bookkeeping)."""

    def __init__(self, name: str, index: int, spec: JobSpec | None,
                 store, created_ts: float):
        self.name = name
        self.index = index
        self.spec = spec
        self.store = store
        self.created_ts = created_ts


class JobManager:
    """Registry of live jobs and their per-job stores.

    The default job wraps the server's PRIMARY store (index 0) so a
    tenancy-enabled server with no extra jobs behaves byte-identically
    to a pre-tenancy one. Non-default jobs get their own
    :class:`~.store.ParameterStore`, built from the primary's config
    with the spec's overrides and the primary's CURRENT parameters as
    the init point (a job submitted mid-run starts from the warmest
    available basis; docs/TENANCY.md).

    Thread-safety: ``submit``/``drain`` run on gRPC handler threads
    (the ``SubmitJob`` op) while every push/fetch resolves
    ``store_for``; one small lock guards the table.
    """

    def __init__(self, store, specs=(), registry=None, clock=time.time):
        self.clock = clock
        self._lock = threading.Lock()
        from ..telemetry import get_registry
        self._reg = registry or get_registry()
        #: Optional WeightedFairAdmission (comms/service.py); wired by
        #: ``cli serve`` so drain() can drop the job's QoS series too.
        self.qos = None
        self._jobs: dict[str, _JobState] = {}  # guarded by: self._lock
        self._by_index: list[str] = []  # guarded by: self._lock
        with self._lock:
            self._jobs[DEFAULT_JOB] = _JobState(
                DEFAULT_JOB, 0, None, store, self.clock())
            self._by_index.append(DEFAULT_JOB)
        for spec in specs:
            self.submit(spec)

    # -- lifecycle ------------------------------------------------------------

    def submit(self, spec: JobSpec):
        """Create a job from its spec; returns its ``_JobState``.
        Raises ``ValueError`` on a duplicate name."""
        from .store import ParameterStore
        with self._lock:
            primary = self._jobs[DEFAULT_JOB].store
        cfg = primary.config
        overrides = {"job_id": spec.name}
        if spec.mode is not None:
            overrides["mode"] = spec.mode
        if spec.learning_rate is not None:
            overrides["learning_rate"] = spec.learning_rate
        if spec.staleness_bound is not None:
            overrides["staleness_bound"] = spec.staleness_bound
        if spec.sync_quorum is not None:
            overrides["sync_quorum"] = spec.sync_quorum
        if spec.total_workers is not None:
            overrides["total_workers"] = spec.total_workers
        # Codec sentinel: the primary already resolved push_codec; carry
        # the RESOLVED value so the job store never re-defaults.
        overrides["push_codec"] = primary.push_codec
        job_cfg = replace(cfg, **overrides)
        params, _ = primary.snapshot()
        store = ParameterStore(params, job_cfg)
        with self._lock:
            if spec.name in self._jobs:
                raise ValueError(f"job {spec.name!r} already exists")
            state = _JobState(spec.name, len(self._by_index), spec, store,
                              self.clock())
            self._jobs[spec.name] = state
            self._by_index.append(spec.name)
        print(f"JOB_SUBMITTED job={spec.name} index={state.index} "
              f"mode={store.config.mode}", flush=True)
        return state

    def drain(self, name: str) -> bool:
        """Remove a drained job and its per-job ``dps_job_*`` metric
        series (a drained job's frozen series must not read as a
        live-but-idle job, as a departed replica's lag gauges). The
        default job cannot drain. Returns True when the job existed."""
        if name == DEFAULT_JOB:
            raise ValueError("the default job cannot be drained")
        with self._lock:
            state = self._jobs.pop(name, None)
            # Index slots are NOT reused: a later job must never inherit
            # a drained job's worker-id range (stale global wids would
            # alias into the newcomer).
        if state is None:
            return False
        for series in ("dps_job_queue_depth", "dps_job_admitted_total",
                       "dps_job_throttled_total", "dps_job_workers",
                       "dps_job_autoscale_target_workers"):
            self._reg.remove(series, job=name)
        if self.qos is not None:
            try:
                self.qos.forget_job(name)
            except Exception:  # noqa: BLE001 — drain must not fail late
                pass
        print(f"JOB_DRAINED job={name}", flush=True)
        return True

    # -- resolution -----------------------------------------------------------

    def names(self) -> list[str]:
        with self._lock:
            return [n for n in self._by_index if n in self._jobs]

    def store_for(self, job: str):
        """The job's store; unknown jobs degrade to the default store
        (the namespace discipline: a stray id must never fail an RPC,
        and the default namespace is where unlabeled traffic lands)."""
        with self._lock:
            state = self._jobs.get(job) or self._jobs[DEFAULT_JOB]
            return state.store

    def has_job(self, job: str) -> bool:
        with self._lock:
            return job in self._jobs

    def index_of(self, job: str) -> int:
        with self._lock:
            state = self._jobs.get(job) or self._jobs[DEFAULT_JOB]
            return state.index

    def job_name_of(self, global_wid) -> str:
        """Job name for a strided global worker id (unknown index
        degrades to the default job — e.g. a drained job's last rows)."""
        try:
            idx, _ = split_wid(global_wid)
        except (TypeError, ValueError):
            return DEFAULT_JOB
        with self._lock:
            if 0 <= idx < len(self._by_index):
                name = self._by_index[idx]
                if name in self._jobs:
                    return name
        return DEFAULT_JOB

    def to_global(self, job: str, local_wid: int) -> int:
        return self.index_of(job) * WID_STRIDE + int(local_wid)

    def qos_table(self) -> dict[str, tuple[float, int]]:
        """``job -> (weight, max_inflight)`` for the admission scheduler
        (comms/service.py WeightedFairAdmission). The spec-less default
        job gets the spec defaults (weight 1.0, max_inflight 8)."""
        with self._lock:
            return {name: ((1.0, 8) if st.spec is None
                           else (st.spec.weight, st.spec.max_inflight))
                    for name, st in self._jobs.items()}

    def spec_for(self, job: str) -> JobSpec | None:
        with self._lock:
            state = self._jobs.get(job)
            return state.spec if state is not None else None

    # -- membership (monitor-facing, global worker ids) -----------------------

    def membership_snapshot(self) -> list[int]:
        """Union of every job's live membership as GLOBAL worker ids —
        the ``ClusterMonitor`` reads this instead of the primary store's
        snapshot when tenancy is on, so ``/cluster`` rows span jobs."""
        out: list[int] = []
        with self._lock:
            states = list(self._jobs.values())
        for st in states:
            base = st.index * WID_STRIDE
            try:
                out.extend(base + int(w)
                           for w in st.store.membership_snapshot())
            except Exception:  # noqa: BLE001 — any backend, any failure
                continue
        return sorted(out)

    @property
    def last_seen(self) -> dict[int, float]:
        """Merged ``last_seen`` across jobs, keyed by global wid."""
        out: dict[int, float] = {}
        with self._lock:
            states = list(self._jobs.values())
        for st in states:
            base = st.index * WID_STRIDE
            for w, ts in (getattr(st.store, "last_seen", {}) or {}).items():
                out[base + int(w)] = float(ts)
        return out

    def expire_stale_workers(self) -> list[int]:
        """Run membership expiry on every job store; returns reaped
        GLOBAL worker ids (the serve loop feeds these to
        ``monitor.note_expired``)."""
        reaped: list[int] = []
        with self._lock:
            states = list(self._jobs.values())
        for st in states:
            fn = getattr(st.store, "expire_stale_workers", None)
            if not callable(fn):
                continue
            base = st.index * WID_STRIDE
            try:
                reaped.extend(base + int(w) for w in fn() or [])
            except Exception:  # noqa: BLE001 — expiry is best-effort
                continue
        return reaped

    # -- read side ------------------------------------------------------------

    def view(self) -> dict:
        """The ``"jobs"`` block of ``GET /cluster`` (docs/TENANCY.md):
        per-job config, live workers (global ids), step, and — when a
        QoS scheduler is attached — admission counters."""
        with self._lock:
            states = list(self._jobs.values())
        qos_view = {}
        if self.qos is not None:
            try:
                qos_view = self.qos.view()
            except Exception:  # noqa: BLE001 — view must render regardless
                qos_view = {}
        jobs = {}
        for st in states:
            base = st.index * WID_STRIDE
            try:
                members = [base + int(w)
                           for w in st.store.membership_snapshot()]
            except Exception:  # noqa: BLE001
                members = []
            cfg = st.store.config
            row = {
                "index": st.index,
                "mode": cfg.mode,
                "global_step": int(getattr(st.store, "global_step", 0)),
                "workers": sorted(members),
                "slots": job_slots(st.name, st.store.param_names()),
            }
            if st.spec is not None:
                row["weight"] = st.spec.weight
                row["max_inflight"] = st.spec.max_inflight
                row["min_workers"] = st.spec.min_workers
                row["max_workers"] = st.spec.max_workers
            if st.name in qos_view:
                row.update(qos_view[st.name])
            self._reg.gauge("dps_job_workers", job=st.name).set(
                len(members))
            jobs[st.name] = row
        return jobs
