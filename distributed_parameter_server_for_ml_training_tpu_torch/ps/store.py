"""In-process parameter store with the reference server's exact semantics.

The JAX package's ``ps/store.py``, carried over to the port for what this
slice runs: sync rounds, async staleness weighting and its bound, and
compressed-domain rounds over quantized pushes. The store is NumPy on the
host and framework-neutral, so these are the reference's line for line.
Elastic membership and expiry, quorum and deadline rounds, sharding,
tenancy, fetch-side codecs, checkpoints and the device-resident store
come with later slices.

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
- ``last_seen`` tracked on fetch/push but never expired (server.py:219, 251).

Wire codec: pushes are fp16-compressed by default and fetches are fp32,
matching the reference's asymmetry (push: worker.py:264-268 casts fp16;
fetch: server.py:222 pickles fp32).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Mapping

import numpy as np

from ..ops.compression import (  # hot-path imports hoisted: no import-lock
    PUSH_CODECS,                 # checks inside push/fetch
    QUANTIZED_PUSH_CODECS,
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
    strict_rounds: bool = False  # True = corrected double-push semantics

    def __post_init__(self):
        if self.mode not in ("sync", "async"):
            raise ValueError(f"mode must be sync|async, got {self.mode!r}")
        if not 1 <= self.total_workers <= MAX_WORKERS:
            raise ValueError(
                f"total_workers must be 1..{MAX_WORKERS} (server.py:424-426),"
                f" got {self.total_workers}")


@dataclass
class _Stats:
    gradients_processed: int = 0
    gradients_rejected: int = 0
    total_parameter_updates: int = 0
    staleness_values: list = field(default_factory=list)
    update_times: deque = field(default_factory=lambda: deque(maxlen=100))
    start_time: float = field(default_factory=time.time)


class AggregationBase:
    """Membership, sync-round and async-apply orchestration of an
    in-process store. A subclass supplies ``_round_update(grad_dicts,
    lr)`` and ``_apply(grads, lr, weight)`` and the state they use.

    Membership (server.py:190-211, 306-318): sequential ids under the
    registration lock; JobFinished removes a worker and the final stats
    fire when the active set empties."""

    store_backend = "python"

    # Cross-thread contracts: the pusher threads meet on this state.
    parameters: dict  # guarded by: self._param_lock
    global_step: int  # guarded by: self._param_lock
    _pending: dict  # guarded by: self._sync_lock
    _gradients_received: int  # guarded by: self._sync_lock
    _next_worker_id: int  # guarded by: self._registration_lock
    active_workers: set  # guarded by: self._registration_lock
    last_seen: dict  # guarded by: self._registration_lock

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

    # -- membership -------------------------------------------------------

    def register_worker(self, worker_name: str = "") -> tuple[int, int]:
        """Returns (worker_id, total_workers); ids are strictly sequential
        (server.py:193-194)."""
        with self._registration_lock:
            worker_id = self._next_worker_id
            self._next_worker_id += 1
            self.active_workers.add(worker_id)
            self.last_seen[worker_id] = time.time()
        return worker_id, self.config.total_workers

    def job_finished(self, worker_id: int) -> None:
        """Remove from the active set; final stats fire when it empties."""
        with self._registration_lock:
            self.active_workers.discard(worker_id)
            empty = not self.active_workers
        if empty:
            self._finished_event.set()

    def wait_all_finished(self, timeout: float | None = None) -> bool:
        return self._finished_event.wait(timeout)

    # -- sync rounds and async applies ----------------------------------

    def _push_sync(self, worker_id: int, grads: dict) -> bool:
        """server.py:264-288: stash under sync_lock; when the round reaches
        ``total_workers``, mean + apply + reset. No barrier — returns
        immediately."""
        with self._sync_lock:
            self._pending[worker_id] = grads
            if self.config.strict_rounds:
                # Corrected semantics: count distinct workers.
                self._gradients_received = len(self._pending)
            else:
                # Faithful quirk 3 (server.py:267-268): overwrite the entry,
                # increment the count anyway.
                self._gradients_received += 1
            if self._gradients_received >= self.config.total_workers:
                self._complete_round_locked()
            self.stats.gradients_processed += 1
        self._tm_push_ok.inc()
        return True

    def _complete_round_locked(self) -> None:
        """Aggregate + apply + reset (caller holds ``_sync_lock``)."""
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
        self._tm_rounds.inc()
        self._tm_step.set(self.global_step)  # dpslint: ignore[lock-guard]
        dt = time.time() - t0
        self.stats.update_times.append(dt)
        self._tm_apply_s.observe(dt)

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
        self.stats.gradients_processed += 1
        self.stats.total_parameter_updates += 1
        self.stats.staleness_values.append(staleness)
        self._tm_push_ok.inc()
        dt = time.time() - t0
        self.stats.update_times.append(dt)
        self._tm_apply_s.observe(dt)
        return True

    def snapshot(self) -> tuple[dict[str, np.ndarray], int]:
        """Consistent (params copy, global_step) pair."""
        with self._param_lock:
            params = {k: v.copy() for k, v in self.parameters.items()}
            step = self.global_step
        return params, step

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

        self.stats = _Stats()
        self._finished_event = threading.Event()
        self._init_telemetry()

    @property
    def push_codec(self) -> str:
        """Codec workers must apply before pushing (worker.py:264-268 did the
        fp16 cast on the worker side)."""
        return self._push_codec

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
        (server.py:213-237), fp32 and uncompressed as in the reference.

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
                with self._registration_lock:
                    self.last_seen[worker_id] = time.time()
            if not modified:
                sp.attrs["not_modified"] = True
                self._tm_fetch_nm.inc()
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
        # The expected shapes, read under the lock.
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
            return self._push_sync(worker_id, gradients)
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
