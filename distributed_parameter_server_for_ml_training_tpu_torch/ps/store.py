"""In-process parameter store with the reference server's exact semantics.

The JAX package's ``ps/store.py``, carried over to the port: sync rounds,
async staleness weighting and its bound, compressed-domain rounds over
quantized pushes, elastic membership and expiry, quorum and deadline
rounds, the fetch codecs, and the snapshot and migration surface. The
store is NumPy on the host and framework-neutral, so these are the
reference's line for line. ``shard_index`` and ``shard_count`` are the
identity a shard primary's snapshots carry (``cli serve --shard-index``,
``checkpoint/manager.py:check_shard_identity``); ``job_id`` is the job
a tenancy server's store belongs to (``ps/tenancy.py``), validated as
the JAX store validates it. The device-resident store (``ps/device_store.py``) shares
the orchestration of :class:`AggregationBase`, and the C++ arena
(``native/store.py``) its membership and instruments.

The re-hosting of ``src/parameter_server/server.py``: canonical
parameters live on the host CPU as a flat ``{name: np.ndarray}`` dict
(server.py:96), guarded by the same three-lock structure — ``param_lock``
(apply + fetch-serialize, server.py:97), ``sync_lock`` (pending-gradient
barrier, server.py:114), ``registration_lock`` (id assignment, server.py:103).

Faithful behaviors reproduced deliberately (SURVEY.md appendix):

- quirk 2: sync push returns immediately — no worker-side barrier; the round
  completes whenever the count reaches ``total_workers`` (server.py:264-288),
- quirk 3: a double push before the round completes OVERWRITES that worker's
  pending entry while still incrementing ``gradients_received`` — a round can
  complete with fewer than N distinct contributions (server.py:267-268).
  ``strict_rounds=True`` opts into the corrected behavior (count distinct
  workers instead),
- quirk 4: ``fetched_step`` is the global step the worker last fetched, so
  staleness = versions-behind (server.py:293-294, worker.py:299),
- worker-count validation 1..32 (server.py:424-426),
- ``last_seen`` tracked on fetch/push but never expired (server.py:219, 251)
  unless ``worker_timeout`` asks for the corrected behaviour,
- final stats printed when the active-worker set empties (server.py:315-316).

Wire codec: pushes are fp16-compressed by default and fetches are fp32,
matching the reference's asymmetry (push: worker.py:264-268 casts fp16;
fetch: server.py:222 pickles fp32); ``fetch_codec`` opts into bf16/fp16
fetches.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Mapping

import numpy as np

from ..ops.compression import (  # hot-path imports hoisted: no import-lock
    PUSH_CODECS,                 # checks inside push/fetch
    QUANTIZED_PUSH_CODECS,
    bf16_compress,
    fp16_compress,
    fp16_decompress,
    homomorphic_mean,
    is_quantized_payload,
    payload_logical_shapes,
    wire_decompress,
)
from ..telemetry import now as _tnow, trace_span
from .semantics import (
    DEFAULT_STALENESS_BOUND,
    mean_gradients,
    sgd_apply,
    staleness_weight,
)

MAX_WORKERS = 32  # server.py:424-426

@dataclass
class StoreConfig:
    mode: str = "sync"  # 'sync' | 'async' (server.py --mode)
    total_workers: int = 4
    learning_rate: float = 0.1  # server.py:84, 413
    staleness_bound: int = DEFAULT_STALENESS_BOUND
    # 'none' | 'fp16' | 'int8' | 'int4' | 'topk' | 'adaptive' | None =
    # the reference's default, 'fp16' (the worker-side cast,
    # worker.py:264-268). The quantized codecs (int8 per-tensor symmetric,
    # int4 packed nibbles, topk sparse triples, adaptive per-layer choice
    # from link pressure) decode here on the host; workers pair them with
    # error feedback. The store resolves the sentinel at construction.
    push_codec: str | None = None
    # Compressed-domain sync aggregation: quantized pushes are held as-is
    # and summed in per-layer int32 accumulators, dequantized ONCE per
    # round at apply time. False decodes each push on arrival; numerics
    # agree to float rounding either way.
    compressed_domain: bool = True
    # Fetch-side wire codec. 'none' (default) = reference parity: fetches
    # are fp32 (server.py:222). 'bf16'/'fp16' halve the params-in wire
    # term; workers/clients decompress after fetch.
    fetch_codec: str = "none"
    strict_rounds: bool = False  # True = corrected double-push semantics
    # Membership expiry. The reference tracks last_seen but never expires
    # workers (server.py:219, 251). None reproduces that; a number of
    # seconds turns on expire_stale_workers().
    worker_timeout: float | None = None
    # Elastic membership: a registering worker takes the LOWEST free id
    # slot (a replacement adopts the dead worker's shard), sync rounds
    # complete at the CURRENT active-worker count, and expiry purges the
    # dead worker's pending gradients and completes the round if the
    # survivors already cover it.
    elastic: bool = False
    # Quorum rounds: a sync round completes once this many DISTINCT
    # workers of the live round target have pushed — an int >= 1 is a
    # count, 0 < f < 1 a fraction of the target (ceil). A late push
    # reconciles through the async staleness semantics. None keeps the
    # full barrier (reference behaviour).
    sync_quorum: float | None = None
    # Per-round deadline in seconds, armed when the round's FIRST gradient
    # lands: when it fires, the round completes with whatever has arrived.
    # Composable with sync_quorum; None disables.
    round_deadline: float | None = None
    # Shard and job identity, validated as the JAX store validates them;
    # a shard primary's snapshots carry the shard's, a tenancy job's
    # store its job's (ps/tenancy.py).
    shard_index: int = 0
    shard_count: int = 1
    job_id: str = "default"

    def __post_init__(self):
        from .tenancy import is_valid_job_id  # cold path
        if not is_valid_job_id(self.job_id):
            raise ValueError(
                f"job_id must match [A-Za-z0-9][A-Za-z0-9_-]* "
                f"(<= 64 chars), got {self.job_id!r}")
        if self.mode not in ("sync", "async"):
            raise ValueError(f"mode must be sync|async, got {self.mode!r}")
        if not 1 <= self.total_workers <= MAX_WORKERS:
            raise ValueError(
                f"total_workers must be 1..{MAX_WORKERS} (server.py:424-426),"
                f" got {self.total_workers}")
        if self.fetch_codec not in ("none", "fp16", "bf16"):
            raise ValueError(f"fetch_codec must be none|fp16|bf16, got "
                             f"{self.fetch_codec!r}")
        if self.sync_quorum is not None:
            q = float(self.sync_quorum)
            if q <= 0:
                raise ValueError(f"sync_quorum must be > 0, got {q}")
            if q >= 1.0 and q != int(q):
                raise ValueError(
                    f"sync_quorum >= 1 is a worker COUNT and must be "
                    f"whole, got {q} (use a value < 1 for a fraction)")
        if self.round_deadline is not None and self.round_deadline <= 0:
            raise ValueError(
                f"round_deadline must be > 0 seconds, got "
                f"{self.round_deadline}")
        if self.sync_quorum is not None or self.round_deadline is not None:
            # Quorum counting must count DISTINCT workers: under quirk 3
            # one worker double-pushing could satisfy a 2-worker quorum
            # alone. A quorum therefore implies strict_rounds.
            self.strict_rounds = True
        if self.shard_count < 1 or not \
                0 <= self.shard_index < self.shard_count:
            raise ValueError(
                f"shard_index must be in [0, shard_count) with "
                f"shard_count >= 1; got index={self.shard_index} "
                f"count={self.shard_count}")


@dataclass
class _Stats:
    gradients_processed: int = 0
    gradients_rejected: int = 0
    total_parameter_updates: int = 0
    staleness_values: list = field(default_factory=list)
    update_times: deque = field(default_factory=lambda: deque(maxlen=100))
    start_time: float = field(default_factory=time.time)


class TelemetryMixin:
    """Store-side live instruments shared by the three backends (host
    NumPy, device, C++ arena), as the JAX package's mixin of that name."""

    def _init_telemetry(self) -> None:
        """Store-side live instruments, created ONCE at construction and
        held as attributes (the registry dict is never touched on the hot
        path). A process's stores share instruments (identical
        name+labels), so counters aggregate across them."""
        from ..telemetry import STALENESS_BUCKETS, get_registry
        reg = get_registry()
        b = self.store_backend
        self._tm_push_s = reg.histogram("dps_store_push_seconds", backend=b)
        self._tm_fetch_s = reg.histogram("dps_store_fetch_seconds",
                                         backend=b)
        self._tm_apply_s = reg.histogram("dps_store_apply_seconds",
                                         backend=b)
        self._tm_push_ok = reg.counter("dps_store_pushes_total", backend=b,
                                       outcome="accepted")
        self._tm_push_rej = reg.counter("dps_store_pushes_total", backend=b,
                                        outcome="rejected")
        self._tm_fetches = reg.counter("dps_store_fetches_total", backend=b)
        # Version-gated delta fetches answered with an empty NOT_MODIFIED
        # payload (fetch(have_step=...) when the step hasn't advanced).
        self._tm_fetch_nm = reg.counter("dps_store_fetch_not_modified_total",
                                        backend=b)
        # Observed for EVERY arriving async push (accepted or not);
        # stats.staleness_values keeps the reference's accepted-only
        # semantics for the exit line.
        self._tm_staleness = reg.histogram("dps_store_staleness_versions",
                                           buckets=STALENESS_BUCKETS,
                                           backend=b)
        self._tm_step = reg.gauge("dps_store_global_step", backend=b)
        self._tm_rounds = reg.counter("dps_store_sync_rounds_total",
                                      backend=b)
        # Pushes held in the quantized domain (summed in int32
        # accumulators at round completion).
        self._tm_compressed = reg.counter(
            "dps_store_compressed_accum_total", backend=b)
        # What closed each sync round (full barrier / quorum / deadline),
        # stragglers' late pushes reconciled through the staleness path,
        # and the live quorum-exclusion set size.
        self._tm_round_trigger = {
            trig: reg.counter("dps_store_round_completions_total",
                              backend=b, trigger=trig)
            for trig in ("full", "quorum", "deadline")
        }
        self._tm_late = reg.counter("dps_store_late_pushes_total",
                                    backend=b)
        self._tm_excluded = reg.gauge("dps_store_excluded_workers",
                                      backend=b)


class MembershipMixin:
    """Worker-lifecycle surface shared by the stores, as the JAX
    package's mixin of that name. Membership (server.py:190-211,
    306-318): sequential ids under the registration lock (the lowest free
    slot under ``elastic``); JobFinished removes a worker and the final
    stats fire when the active set empties; ``worker_timeout`` expires
    silent workers. The host class provides ``config``,
    ``_registration_lock``, ``_next_worker_id``, ``active_workers``,
    ``last_seen`` and ``_finished_event``, and may override the two
    hooks."""

    _next_worker_id: int  # guarded by: self._registration_lock
    active_workers: set  # guarded by: self._registration_lock
    last_seen: dict  # guarded by: self._registration_lock

    def register_worker(self, worker_name: str = "") -> tuple[int, int]:
        """Returns (worker_id, total_workers). Faithful mode assigns
        strictly sequential ids (server.py:193-194); elastic mode reuses
        the lowest free slot, so a replacement adopts the departed
        worker's shard."""
        with self._registration_lock:
            if self.config.elastic:
                worker_id = next(i for i in range(len(self.active_workers) + 1)
                                 if i not in self.active_workers)
                self._next_worker_id = max(self._next_worker_id, worker_id + 1)
            else:
                worker_id = self._next_worker_id
                self._next_worker_id += 1
            self.active_workers.add(worker_id)
            self.last_seen[worker_id] = time.time()
        return worker_id, self.config.total_workers

    def job_finished(self, worker_id: int) -> None:
        """Remove from the active set; final stats fire when it empties.
        Elastic: the departure shrinks the round target, so the pending
        round is re-evaluated (without purging: a clean departure's final
        push is a valid contribution)."""
        with self._registration_lock:
            self.active_workers.discard(worker_id)
            empty = not self.active_workers
        self._on_worker_departed(worker_id)
        if empty:
            self._finished_event.set()

    def wait_all_finished(self, timeout: float | None = None) -> bool:
        return self._finished_event.wait(timeout)

    def membership_snapshot(self) -> list[int]:
        """Sorted copy of the live worker ids, taken under the registration
        lock."""
        with self._registration_lock:
            return sorted(self.active_workers)

    def _round_target(self) -> int:
        """Sync-round completion size: the fixed total (server.py:271-274)
        or, in elastic mode, the live membership count (lock order sync ->
        registration; no path takes them the other way round). Workers
        excluded by ``exclude_worker`` leave the target either way."""
        # A store without quorum exclusion (the C++ arena) has no set.
        excluded = getattr(self, "_excluded", None)
        if self.config.elastic:
            with self._registration_lock:
                if excluded:
                    return max(1, len(self.active_workers - excluded))
                return max(1, len(self.active_workers))
        if excluded:
            return max(1, self.config.total_workers - len(excluded))
        return self.config.total_workers

    def expire_stale_workers(self) -> list[int]:
        """Failure detection: drop workers not seen within the timeout —
        liveness comes from pushes, fetches and the heartbeat ping."""
        if self.config.worker_timeout is None:
            return []
        cutoff = time.time() - self.config.worker_timeout
        with self._registration_lock:
            stale = [w for w in self.active_workers
                     if self.last_seen.get(w, 0.0) < cutoff]
            for w in stale:
                self.active_workers.discard(w)
            empty = not self.active_workers
        if stale:
            self._on_workers_expired(stale)
        if stale and empty:
            self._finished_event.set()
        return stale

    def _on_workers_expired(self, stale: list[int]) -> None:
        """Hook for stores to clean round state after expiry."""

    def _on_worker_departed(self, worker_id: int) -> None:
        """Hook after a clean JobFinished departure."""


class AggregationBase(TelemetryMixin, MembershipMixin):
    """Sync-round and async-apply orchestration of an in-process store,
    over the membership of :class:`MembershipMixin`. A subclass supplies
    ``_round_update(grad_dicts, lr)`` and ``_apply(grads, lr, weight)``
    and the state they use, and may override ``_after_apply()``."""

    store_backend = "python"

    # Cross-thread contracts: pusher threads, the round-deadline timer and
    # the reaper meet on this state.
    parameters: dict  # guarded by: self._param_lock
    global_step: int  # guarded by: self._param_lock
    _pending: dict  # guarded by: self._sync_lock
    _gradients_received: int  # guarded by: self._sync_lock
    _round_serial: int  # guarded by: self._sync_lock
    _deadline_timer: object  # guarded by: self._sync_lock
    _last_round_trigger: object  # guarded by: self._sync_lock
    _excluded: set  # guarded by: self._registration_lock

    def _init_round_state(self) -> None:
        """Quorum-round bookkeeping, called from each concrete
        ``__init__``: the exclusion set, the round serial that fences
        stale deadline timers, and the armed timer itself."""
        self._excluded: set[int] = set()
        self._round_serial = 0
        self._deadline_timer: threading.Timer | None = None
        self._last_round_trigger: str | None = None

    def _after_apply(self):
        """Hook after an update is issued. Return contract: anything but
        ``False`` means the hook synchronized with (or is) the real
        completion of the update, and the caller records an update_times
        entry; ``False`` declines (the device store samples its waits, so
        only every Nth update blocks on the device)."""

    def _on_workers_expired(self, stale: list[int]) -> None:
        """Elastic: purge DEAD workers' pending gradients and complete the
        round if the survivors already cover the reduced target. An
        expired worker also leaves the exclusion set."""
        # Emptiness pre-check dodging the lock in the common case; the
        # mutation below is a blind difference_update.
        if self._excluded:  # dpslint: ignore[lock-guard]
            with self._registration_lock:
                self._excluded.difference_update(stale)
                n = len(self._excluded)
            self._tm_excluded.set(n)
        if not self.config.elastic:
            return
        with self._sync_lock:
            finish = None
            for w in stale:
                self._pending.pop(w, None)
            if self._pending or self._gradients_received:
                self._gradients_received = len(self._pending)
                finish = self._maybe_complete_round_locked()
        if finish is not None:
            finish()

    def _on_worker_departed(self, worker_id: int) -> None:
        """Elastic: a clean departure only shrinks the round target — its
        own final push (if any) stays in the round."""
        if self._excluded:  # dpslint: ignore[lock-guard]
            self.include_worker(worker_id)
        if not self.config.elastic:
            return
        with self._sync_lock:
            finish = (self._maybe_complete_round_locked()
                      if self._gradients_received else None)
        if finish is not None:
            finish()

    # -- sync rounds (full, quorum, deadline) and async applies ----------

    def _quorum_mode(self) -> bool:
        return (self.config.sync_quorum is not None
                or self.config.round_deadline is not None)

    def _quorum_target(self, full: int) -> int:
        """Contributions that complete a round: the full target, or the
        configured quorum (count, or ceil of a fraction of the target),
        clamped to [1, full]."""
        q = self.config.sync_quorum
        if q is None:
            return full
        q = float(q)
        n = math.ceil(q * full - 1e-9) if q < 1.0 else int(q)
        return max(1, min(full, n))

    def _push_sync(self, worker_id: int, grads: dict,
                   fetched_step: int | None = None) -> bool:
        """server.py:264-288: stash under sync_lock; when the round hits
        its (quorum) target, mean + apply + reset. No barrier — returns
        immediately. In quorum mode a LATE push (its basis round already
        closed under quorum/deadline) reconciles through the async
        staleness semantics."""
        # Routing pre-check only: the late path re-checks staleness under
        # _param_lock, and a push routed into the round was on time.
        if self._quorum_mode() and fetched_step is not None \
                and fetched_step < self.global_step:  # dpslint: ignore[lock-guard]
            return self._push_late(worker_id, grads, fetched_step)
        with self._sync_lock:
            self._pending[worker_id] = grads
            if self.config.strict_rounds:
                # Corrected semantics: count distinct workers.
                self._gradients_received = len(self._pending)
            else:
                # Faithful quirk 3 (server.py:267-268): overwrite the entry,
                # increment the count anyway.
                self._gradients_received += 1
            self._arm_deadline_locked()
            finish = self._maybe_complete_round_locked()
            self.stats.gradients_processed += 1
        self._tm_push_ok.inc()
        if finish is not None:
            finish()
        return True

    def _push_late(self, worker_id: int, grads: dict,
                   fetched_step: int) -> bool:
        """A straggler's push that missed its round: applied through the
        async staleness semantics (down-weighted, rejected past the
        bound), neither double-counted into the next round nor dropped."""
        self._tm_late.inc()
        if is_quantized_payload(grads):
            # The hold-as-is path is a round optimization; a late single
            # payload applies in fp32.
            grads = wire_decompress(grads)
        return self._push_async(worker_id, grads, fetched_step)

    def _arm_deadline_locked(self) -> None:
        """Arm the per-round deadline timer on the round's first gradient
        (caller holds ``_sync_lock``). The timer captures the round
        serial, so a stale timer firing after its round completed does
        nothing."""
        deadline = self.config.round_deadline
        if not deadline or self._deadline_timer is not None \
                or not self._gradients_received:
            return
        t = threading.Timer(deadline, self._round_deadline_fired,
                            args=(self._round_serial,))
        t.daemon = True
        self._deadline_timer = t
        t.start()

    def _round_deadline_fired(self, serial: int) -> None:
        """Deadline expiry: complete the round with whatever arrived,
        fenced by the round serial."""
        with self._sync_lock:
            if serial != self._round_serial:
                return
            self._deadline_timer = None
            finish = (self._complete_round_locked("deadline")
                      if self._gradients_received else None)
        if finish is not None:
            finish()

    def _cancel_deadline_locked(self) -> None:
        t, self._deadline_timer = self._deadline_timer, None
        if t is not None:
            t.cancel()

    def _maybe_complete_round_locked(self):
        """Complete the round if it reached its (quorum) target (caller
        holds ``_sync_lock``); returns :meth:`_complete_round_locked`'s
        completion callable, or None."""
        full = self._round_target()
        if self._gradients_received >= self._quorum_target(full):
            return self._complete_round_locked(
                "full" if self._gradients_received >= full else "quorum")
        return None

    def _complete_round_locked(self, trigger: str):
        """Aggregate + apply + reset (caller holds ``_sync_lock``).
        Returns a completion callable the CALLER invokes after releasing
        the sync lock: it waits for the device (``_after_apply``) and
        records the update time, so a device wait never convoys the other
        workers' pushes behind the lock. The update itself (dispatch and
        step bump) stays inside, so ordering and staleness accounting
        are unchanged."""
        t0 = time.time()
        try:
            # The apply span parents on the span of the push that
            # COMPLETED the round (trace context is thread-local; the last
            # pusher's thread runs the aggregation).
            with trace_span("store.apply", backend=self.store_backend,
                            mode="sync",
                            n_grads=self._gradients_received):
                self._round_update(list(self._pending.values()),
                                   self.config.learning_rate)
            self.stats.total_parameter_updates += 1
        finally:
            # The round MUST reset even if aggregation raises — otherwise
            # every later push re-triggers the failure and the store is
            # wedged permanently.
            self._pending.clear()
            self._gradients_received = 0
            self._round_serial += 1
            self._cancel_deadline_locked()
            self._last_round_trigger = trigger
        self._tm_rounds.inc()
        self._tm_round_trigger[trigger].inc()
        self._tm_step.set(self.global_step)  # dpslint: ignore[lock-guard]

        def finish() -> None:
            # Only a timing that measured real completion is recorded
            # (_after_apply may decline a sampled device wait).
            if self._after_apply() is not False:
                dt = time.time() - t0
                self.stats.update_times.append(dt)
                self._tm_apply_s.observe(dt)

        return finish

    # -- quorum exclusion and round status ---------------------------------

    def exclude_worker(self, worker_id: int) -> None:
        """Quorum-exclude a worker: rounds stop waiting for it (it leaves
        the round target and the quorum denominator) while its own pushes
        still land. Re-evaluates the pending round, since shrinking the
        target may complete it."""
        with self._registration_lock:
            self._excluded.add(int(worker_id))
            n = len(self._excluded)
        self._tm_excluded.set(n)
        with self._sync_lock:
            finish = (self._maybe_complete_round_locked()
                      if self._gradients_received else None)
        if finish is not None:
            finish()

    def include_worker(self, worker_id: int) -> None:
        """Lift a quorum exclusion: the worker counts toward round targets
        again."""
        with self._registration_lock:
            self._excluded.discard(int(worker_id))
            n = len(self._excluded)
        self._tm_excluded.set(n)

    def excluded_workers(self) -> list[int]:
        with self._registration_lock:
            return sorted(self._excluded)

    def round_status(self) -> dict:
        """Live sync-round/quorum state: target vs received, who has
        pushed, who is excluded, and what closed the last round."""
        with self._sync_lock:
            received = self._gradients_received
            pending = sorted(self._pending)
            serial = self._round_serial
            armed = self._deadline_timer is not None
            trigger = self._last_round_trigger
        full = self._round_target()
        return {
            "mode": self.config.mode,
            "target": full,
            "quorum": self._quorum_target(full),
            "received": received,
            "pushed_workers": pending,
            "excluded": self.excluded_workers(),
            "round_serial": serial,
            "deadline_s": self.config.round_deadline,
            "deadline_armed": armed,
            "last_trigger": trigger,
        }

    def _push_async(self, worker_id: int, grads: dict,
                    fetched_step: int) -> bool:
        """server.py:290-304 + 171-186: bounded staleness with down-weighted
        immediate apply.

        The staleness check and the apply run under ONE ``_param_lock``
        hold: with an unlocked pre-check, a concurrent apply could bump
        ``global_step`` between check and apply, admitting a push that
        was already past the bound — and weighting it as fresher than it
        is.
        """
        t0 = time.time()
        step = 0
        with self._param_lock:
            staleness = self.global_step - fetched_step
            accepted = staleness <= self.config.staleness_bound
            if accepted:
                weight = staleness_weight(staleness)
                with trace_span("store.apply", backend=self.store_backend,
                                mode="async", staleness=staleness,
                                weight=round(weight, 4)):
                    self._apply(grads, self.config.learning_rate, weight)
                    self.global_step += 1
                step = self.global_step
        self._tm_staleness.observe(staleness)
        if not accepted:
            self.stats.gradients_rejected += 1
            self._tm_push_rej.inc()
            return False
        self._tm_step.set(step)
        measured = self._after_apply() is not False
        self.stats.gradients_processed += 1
        self.stats.total_parameter_updates += 1
        self.stats.staleness_values.append(staleness)
        self._tm_push_ok.inc()
        if measured:
            dt = time.time() - t0
            self.stats.update_times.append(dt)
            self._tm_apply_s.observe(dt)
        return True

    # -- snapshot and migration surface ------------------------------------

    #: Whether ``parameters`` holds torch tensors on the store's device
    #: (the device store) rather than NumPy arrays; fetch and push then
    #: hand tensors over and the snapshot surface converts at its edge.
    keeps_device_arrays = False

    def to_host(self, params: dict) -> dict[str, np.ndarray]:
        """Host NumPy copies of a device store's tensors (its override),
        made outside the lock."""
        raise NotImplementedError

    def _to_store(self, params: Mapping[str, np.ndarray]) -> dict:
        """Incoming params as the store keeps them: fp32 NumPy copies
        here, fp32 tensors on its device in the device store."""
        return {k: np.array(v, np.float32) for k, v in params.items()}

    def snapshot(self) -> tuple[dict[str, np.ndarray], int]:
        """Consistent (host-NumPy params copy, global_step) pair. A device
        store's tensors come to the host outside the lock."""
        device_arrays = self.keeps_device_arrays
        with self._param_lock:
            params = {k: (v if device_arrays else v.copy())
                      for k, v in self.parameters.items()}
            step = self.global_step
        if device_arrays:
            params = self.to_host(params)
        return params, step

    def load_snapshot(self, params: Mapping[str, np.ndarray],
                      step: int) -> None:
        """Restore a (params, step) snapshot; conversion happens outside the
        lock, the swap inside it."""
        new = self._to_store(params)
        with self._param_lock:
            self.parameters = new
            self.global_step = int(step)

    def param_names(self) -> list[str]:
        """Current parameter names (no tensor copies)."""
        with self._param_lock:
            return list(self.parameters.keys())

    def export_params(self, names) -> tuple[dict[str, np.ndarray], int]:
        """Consistent (subset copy, global_step) for a handoff — the donor
        half of a migration. Unknown names are skipped."""
        wanted = set(names)
        device_arrays = self.keeps_device_arrays
        with self._param_lock:
            params = {k: (v if device_arrays else v.copy())
                      for k, v in self.parameters.items() if k in wanted}
            step = self.global_step
        if device_arrays:
            params = self.to_host(params)
        return params, step

    def adopt_params(self, params: Mapping[str, np.ndarray]) -> int:
        """Graft migrated tensors into this store (the recipient half);
        existing names are overwritten. Returns how many were adopted."""
        new = self._to_store(params)
        with self._param_lock:
            self.parameters.update(new)
        return len(new)

    def drop_params(self, names) -> int:
        """Release tensors this store no longer owns (the donor's commit
        step). Returns how many were dropped."""
        wanted = set(names)
        with self._param_lock:
            mine = [k for k in self.parameters if k in wanted]
            for k in mine:
                del self.parameters[k]
        return len(mine)

    # -- observability ----------------------------------------------------

    def metrics(self) -> dict:
        """Final-statistics fields, matching the server's METRICS_JSON
        (server.py:349-366; SURVEY.md §5.5)."""
        elapsed = time.time() - self.stats.start_time
        out = {
            "mode": self.config.mode,
            "total_workers": self.config.total_workers,
            "total_training_time_seconds": round(elapsed, 2),
            # Unlocked read: a final-stats row tolerates being one
            # concurrent apply behind.
            "global_steps_completed": self.global_step,  # dpslint: ignore[lock-guard]
            "total_parameter_updates": self.stats.total_parameter_updates,
            "gradients_processed": self.stats.gradients_processed,
            "average_update_time_seconds": (
                round(float(np.mean(self.stats.update_times)), 6)
                if self.stats.update_times else 0.0),
            "updates_per_second": (
                round(self.stats.total_parameter_updates / elapsed, 3)
                if elapsed > 0 else 0.0),
            "learning_rate": self.config.learning_rate,
            "store_backend": self.store_backend,
        }
        # Sampled device waits (ps/device_store.py wait_every): each
        # recorded update time measured the completion of up to
        # wait_every queued updates, so the interval is published.
        we = getattr(self, "wait_every", 1)
        if we and we > 1:
            out["update_time_wait_every"] = int(we)
        if self.config.mode == "async":
            sv = self.stats.staleness_values
            out.update({
                "staleness_bound": self.config.staleness_bound,
                "gradients_rejected": self.stats.gradients_rejected,
                "average_staleness": (round(float(np.mean(sv)), 3)
                                      if sv else 0.0),
                "max_staleness": int(max(sv)) if sv else 0,
            })
        return out


class ParameterStore(AggregationBase):
    """Thread-safe canonical parameter holder + sync/async aggregator."""

    def __init__(self, initial_params: Mapping[str, np.ndarray],
                 config: StoreConfig | None = None):
        self.config = config or StoreConfig()
        # Resolve the backend-default sentinel LOCALLY — a StoreConfig may
        # be shared across stores, so the resolution must not leak into it.
        self._push_codec = (self.config.push_codec
                            if self.config.push_codec is not None
                            else "fp16")  # reference default
        if self._push_codec not in PUSH_CODECS:
            raise ValueError(
                f"push_codec must be one of {'|'.join(PUSH_CODECS)}, "
                f"got {self._push_codec!r}")
        self.parameters: dict[str, np.ndarray] = {
            k: np.array(v, np.float32) for k, v in initial_params.items()
        }
        self.global_step = 0
        # Per-layer gradient ABSMAX estimates — the shared quantization
        # basis workers read before each push, so a round's int8/int4
        # pushes land in ONE accumulator group. _qscale_step bumps on
        # every refresh.
        self._qscales: dict[str, float] = {}  # guarded by: self._param_lock
        self._qscale_step = 0  # guarded by: self._param_lock

        self._param_lock = threading.Lock()
        self._sync_lock = threading.Lock()
        self._registration_lock = threading.Lock()

        self._next_worker_id = 0
        self.active_workers: set[int] = set()
        self.last_seen: dict[int, float] = {}

        self._pending: dict[int, dict[str, np.ndarray]] = {}
        self._gradients_received = 0
        self._init_round_state()

        self.stats = _Stats()
        self._finished_event = threading.Event()
        self._init_telemetry()

    @property
    def push_codec(self) -> str:
        """Codec workers must apply before pushing (worker.py:264-268 did the
        fp16 cast on the worker side)."""
        return self._push_codec

    @property
    def fetch_codec(self) -> str:
        """Codec applied to fetched payloads; workers must decompress
        (the reference always fetched fp32, server.py:222)."""
        return self.config.fetch_codec

    #: ``fetch(have_step=...)`` answers NOT_MODIFIED when the step has not
    #: moved. The gRPC service reads this (and the flag below) with
    #: ``getattr`` to answer delta fetches and to advertise the
    #: capabilities at registration, as the JAX store declares them.
    supports_delta_fetch = True

    #: This store aggregates quantized pushes without decoding them and
    #: publishes per-layer gradient scales.
    supports_compressed_domain = True

    def gradient_scales(self) -> tuple[dict[str, float], int]:
        """The server's per-layer gradient ABSMAX table + its version.
        Workers quantize against these (int8 scale = absmax/127, int4 =
        absmax/7) so a sync round's pushes share one scale group. Empty
        until the first round refreshes it — workers fall back to
        per-push scales, which the aggregation handles as extra groups."""
        with self._param_lock:
            return dict(self._qscales), self._qscale_step

    def _refresh_qscales_locked(self, grads: Mapping[str, np.ndarray]
                                ) -> None:
        """Update the shared-scale table from an applied aggregate
        (caller holds ``_param_lock``). EMA toward 2x the aggregate's
        absmax — individual workers' gradients run hotter than the round
        mean, and error feedback absorbs what still clips."""
        if self._push_codec not in QUANTIZED_PUSH_CODECS:
            return
        changed = False
        for name, g in grads.items():
            g = np.asarray(g)
            m = float(np.max(np.abs(g))) if g.size else 0.0
            if not np.isfinite(m) or m <= 0.0:
                continue
            target = 2.0 * m
            old = self._qscales.get(name)
            new = target if old is None else 0.5 * old + 0.5 * target
            if old is None or abs(new - old) > 1e-12:
                self._qscales[name] = new
                changed = True
        if changed:
            self._qscale_step += 1

    # dpslint: hot-path — every worker, every step; ONE sanctioned copy
    def fetch(self, worker_id: int | None = None,
              have_step: int | None = None
              ) -> tuple[dict[str, np.ndarray], int]:
        """Copy of the canonical params + current global step
        (server.py:213-237); fp32 and uncompressed as in the reference
        unless ``fetch_codec`` is bf16 or fp16.

        ``have_step`` opts into the version-gated delta protocol: when it
        equals the canonical step, the reply is NOT_MODIFIED — ``({}, step)``
        with ``step == have_step`` — and the caller keeps the params it
        already holds. The comparison happens under the param lock, so a
        concurrent apply can never slip between the check and the reply:
        either the reply step equals ``have_step`` (and the params are
        byte-identical to what the caller fetched at that step) or the full
        fresh payload is returned. Steps only ever advance, so equality is
        exactly "nothing changed".
        """
        t0 = _tnow()
        with trace_span("store.fetch", backend=self.store_backend) as sp:
            with self._param_lock:
                if have_step is not None and have_step == self.global_step:
                    payload, step, modified = {}, self.global_step, False
                else:
                    payload = {k: v.copy()
                               for k, v in self.parameters.items()}
                    step = self.global_step
                    modified = True
            if worker_id is not None:
                # Under the registration lock: the reaper iterates it.
                with self._registration_lock:
                    self.last_seen[worker_id] = time.time()
            if not modified:
                sp.attrs["not_modified"] = True
                self._tm_fetch_nm.inc()
            elif self.config.fetch_codec == "fp16":
                payload = fp16_compress(payload)
            elif self.config.fetch_codec == "bf16":
                payload = bf16_compress(payload)
            self._tm_fetch_s.observe(_tnow() - t0)
            self._tm_fetches.inc()
            return payload, step

    def push(self, worker_id: int, gradients: Mapping[str, np.ndarray],
             fetched_step: int) -> bool:
        """Push gradients (PushGradrients, ps.proto:12 — typo preserved in
        the reference wire protocol; here the API is just named push).

        ``fetched_step`` is the global step the worker last fetched — the
        reference's ``local_step`` field actually carries this
        (worker.py:299), making staleness = versions-behind.
        Returns True iff the gradients were accepted (sync mode always
        accepts, matching PushReply(received=True), server.py:286-288).
        """
        t0 = _tnow()
        with trace_span("store.push", backend=self.store_backend) as sp:
            try:
                accepted = self._push_timed(worker_id, gradients,
                                            fetched_step)
                sp.attrs["accepted"] = accepted
                return accepted
            finally:
                self._tm_push_s.observe(_tnow() - t0)

    # dpslint: hot-path — per-push; quantized payloads stay encoded
    def _push_timed(self, worker_id: int,
                    gradients: Mapping[str, np.ndarray],
                    fetched_step: int) -> bool:
        gradients = dict(gradients)
        quantized = is_quantized_payload(gradients)
        # Compressed-domain fast path (sync only): hold the quantized
        # payload AS-IS — no per-push fp32 decode; the round completion
        # sums int8/int4 entries in int32 accumulators and dequantizes
        # once (homomorphic_mean). Async, legacy codecs, and
        # compressed_domain=False decode here as before; async applies
        # dequantize the single incoming payload with its carried scale.
        keep_quantized = (quantized and self.config.mode == "sync"
                          and self.config.compressed_domain)
        with self._registration_lock:
            self.last_seen[worker_id] = time.time()

        # Reject malformed/mismatched pushes up front (e.g. a worker
        # built with a different head size than the server, a missing
        # scale companion, an out-of-range sparse index): the reference
        # would crash mid-apply on the broadcast; here the bad push is
        # refused and the round state stays clean. Quantized payloads are
        # checked on their LOGICAL shapes — carried in the wire headers,
        # no decode needed — and the sparse/scale validation runs at THIS
        # push, never deferred into the round completion where it would
        # fail a different worker's RPC.
        try:
            if keep_quantized:
                shapes = payload_logical_shapes(gradients)
            else:
                if quantized:
                    gradients = wire_decompress(gradients)
                elif self._push_codec == "fp16":
                    gradients = fp16_decompress(gradients)
                else:
                    gradients = {k: np.asarray(v, np.float32)
                                 for k, v in gradients.items()}
                shapes = {k: g.shape for k, g in gradients.items()}
        except ValueError as e:
            self.stats.gradients_rejected += 1
            self._tm_push_rej.inc()
            print(f"rejecting push from worker {worker_id}: {e}")
            return False
        # The expected shapes, read under the lock (a concurrent
        # load_snapshot may swap the dict).
        with self._param_lock:
            param_shapes = {k: v.shape for k, v in self.parameters.items()}
        for name, shape in shapes.items():
            p_shape = param_shapes.get(name)
            if p_shape is not None and p_shape != tuple(shape):
                self.stats.gradients_rejected += 1
                self._tm_push_rej.inc()
                print(f"rejecting push from worker {worker_id}: {name} "
                      f"shape {tuple(shape)} != server {p_shape} "
                      f"(model/dataset mismatch?)")
                return False
        if keep_quantized:
            # Counted only once the push is actually ACCEPTED into the
            # quantized-domain round (the metric claims int32-accumulated
            # pushes; a rejected payload never was).
            self._tm_compressed.inc()

        if self.config.mode == "sync":
            return self._push_sync(worker_id, gradients, fetched_step)
        return self._push_async(worker_id, gradients, fetched_step)

    # -- aggregation kernels (orchestration in AggregationBase) --------------

    def _round_update(self, grad_dicts: list, lr: float) -> None:
        """Sync-round update, compressed-domain aware: quantized payloads
        aggregate via :func:`homomorphic_mean` (int32 accumulate, one
        dequantize per layer per round); all-dense rounds keep the
        reference's :func:`mean_gradients` path. Either way the applied
        aggregate refreshes the shared scale table under the param lock,
        so the next fetches publish fresh scales."""
        if any(is_quantized_payload(g) for g in grad_dicts):
            mean = homomorphic_mean(grad_dicts)
        else:
            mean = mean_gradients(grad_dicts)
        with self._param_lock:
            self._apply(mean, lr)
            self.global_step += 1
            self._refresh_qscales_locked(mean)

    def _apply(self, grads: dict, lr: float, weight: float = 1.0) -> None:
        # Kernel contract (AggregationBase): callers hold _param_lock.
        sgd_apply(self.parameters, grads, lr, weight=weight)  # dpslint: ignore[lock-guard]
