"""Parameter store over the C++ arena (``native/ps_core.cpp``).

The JAX package's ``native/store.py``, carried over. API-compatible with
:class:`~..ps.store.ParameterStore` for the worker-facing surface
(register_worker / fetch / push / job_finished / metrics), so
:class:`~..ps.worker.PSWorker`, the gRPC service and the trainers accept
it interchangeably. The arena layout (one flat float buffer + a
name->slice index) is what lets C++ do the whole push in one
multithreaded pass.

Both modes run native bulk passes: async pushes are a fused decode +
staleness-weighted SGD (server.py:171-186 semantics in ps_core.cpp) with
fp32/fp16/int8 codecs (the int8 kernel dequantizes per-tensor symmetric
scales segment-wise in the same pass); sync rounds stash each worker's
gradients into a C++ slot buffer (same three codecs) and complete with
one fused mean+apply pass (server.py:264-288 + 145-169 + 126-143). Round
orchestration (locks, counts, elastic targets, quirk-3 double-push
semantics) stays in Python, on the membership and instruments the host
store has (:class:`~..ps.store.MembershipMixin`,
:class:`~..ps.store.TelemetryMixin`).

Restriction vs the Python store: pushes must carry the FULL parameter set
(the arena is contiguous); the reference's partial-push averaging is a
Python-store behavior. The library is built from the checkout's source at
first use (``native/bindings.py``); a failed build raises.
"""

from __future__ import annotations

import threading
import time
from typing import Mapping

import numpy as np


from ..ops.compression import _SCALE_SUFFIX
from ..ps.store import MembershipMixin, StoreConfig, TelemetryMixin, _Stats
from ..telemetry import now as _tnow, trace_span
from .bindings import _f32p, _i8p, _i64p, _u16p, load_library


class NativeParameterStore(TelemetryMixin, MembershipMixin):
    """ParameterStore drop-in with the C++ core under the hot path."""

    store_backend = "native"

    def __init__(self, initial_params: Mapping[str, np.ndarray],
                 config: StoreConfig | None = None):
        self.config = config or StoreConfig(mode="async")
        # Resolve the sentinel locally; never mutate a (possibly shared)
        # StoreConfig.
        self._push_codec = (self.config.push_codec
                            if self.config.push_codec is not None
                            else "fp16")  # reference default
        if self._push_codec not in ("none", "fp16", "int8"):
            raise ValueError(
                f"push_codec must be none|fp16|int8, got "
                f"{self._push_codec!r}")
        if self.config.fetch_codec not in ("none", "fp16", "bf16"):
            raise ValueError(f"fetch_codec must be none|fp16|bf16, got "
                             f"{self.config.fetch_codec!r}")
        # Raises, naming the compiler's error, when the arena cannot be
        # built: there is no fallback to the NumPy store.
        lib = load_library()
        self._lib = lib

        # Flat arena + index.
        self._index: dict[str, tuple[int, tuple[int, ...]]] = {}
        offset = 0
        for name, arr in initial_params.items():
            arr = np.asarray(arr, np.float32)
            self._index[name] = (offset, arr.shape)
            offset += arr.size
        self._size = offset
        # Per-tensor segment boundaries in index (= arena) order, for the
        # int8 kernels' per-tensor scales (ps_core.cpp segment walk).
        self._names = list(self._index)
        self._offsets = np.fromiter(
            (self._index[n][0] for n in self._names), np.int64,
            count=len(self._names))
        self._offsets = np.append(self._offsets, np.int64(self._size))
        arena = np.empty(self._size, np.float32)
        for name, arr in initial_params.items():
            off, shape = self._index[name]
            arena[off:off + int(np.prod(shape, dtype=np.int64))] = np.asarray(
                arr, np.float32).reshape(-1)
        self._handle = lib.dps_store_create(
            self._size, _f32p(arena), float(self.config.learning_rate))

        self._registration_lock = threading.Lock()
        self._next_worker_id = 0
        self.active_workers: set[int] = set()
        self.last_seen: dict[int, float] = {}
        self.stats = _Stats()
        self._finished_event = threading.Event()

        # Sync-round state (orchestrated here, bulk work in C++): worker id
        # -> C++ slot holding its stashed gradients this round. Slots of
        # departed/expired workers are RELEASED (C++ buffer freed) and their
        # indices recycled — membership churn must not grow memory without
        # bound (each slot is a full arena, ~45 MB at ResNet-18 scale).
        self._sync_lock = threading.Lock()
        self._slot_of: dict[int, int] = {}
        self._free_slots: list[int] = []
        self._next_slot = 0
        self._pending: dict[int, int] = {}      # worker_id -> slot
        self._gradients_received = 0
        self._init_telemetry()

    # -- properties mirroring ParameterStore ---------------------------------

    @property
    def push_codec(self) -> str:
        return self._push_codec

    @property
    def fetch_codec(self) -> str:
        return self.config.fetch_codec

    @property
    def global_step(self) -> int:
        return int(self._lib.dps_store_step(self._handle))

    @property
    def parameters(self) -> dict[str, np.ndarray]:
        """Name->array view of a consistent snapshot (copy)."""
        flat, _ = self._fetch_flat()
        return self._unpack(flat)

    # -- lifecycle (register/finish/expire inherited) ------------------------

    def _fetch_flat(self) -> tuple[np.ndarray, int]:
        out = np.empty(self._size, np.float32)
        step = int(self._lib.dps_store_fetch(self._handle, _f32p(out)))
        return out, step

    def _unpack(self, flat: np.ndarray) -> dict[str, np.ndarray]:
        out = {}
        for name, (off, shape) in self._index.items():
            n = int(np.prod(shape, dtype=np.int64))
            out[name] = flat[off:off + n].reshape(shape)
        return out

    def fetch(self, worker_id: int | None = None
              ) -> tuple[dict[str, np.ndarray], int]:
        t0 = _tnow()
        with trace_span("store.fetch", backend=self.store_backend):
            return self._fetch_traced(worker_id, t0)

    def _fetch_traced(self, worker_id: int | None, t0: float
                      ) -> tuple[dict[str, np.ndarray], int]:
        flat, step = self._fetch_flat()
        if worker_id is not None:
            with self._registration_lock:
                self.last_seen[worker_id] = time.time()
        codec = self.config.fetch_codec
        if codec == "fp16":
            # C++ multithreaded cast over the whole arena, then slice views.
            from .bindings import fp32_to_fp16
            flat = fp32_to_fp16(flat)
        elif codec == "bf16":
            from .bindings import fp32_to_bf16
            flat = fp32_to_bf16(flat)
        out = self._unpack(flat), step
        self._tm_fetch_s.observe(_tnow() - t0)
        self._tm_fetches.inc()
        return out

    # -- checkpoint surface (same contract as AggregationBase.snapshot) ------

    def snapshot(self) -> tuple[dict[str, np.ndarray], int]:
        """Consistent (params, step) via the seqlock fetch — pushes are never
        blocked while a snapshot copies the arena."""
        flat, step = self._fetch_flat()
        return self._unpack(flat), step

    def load_snapshot(self, params: Mapping[str, np.ndarray],
                      step: int) -> None:
        """Write a snapshot back into the C++ arena under its write lock
        (dps_store_load brackets the copy with the seqlock, so concurrent
        fetches retry rather than observe a half-restored arena)."""
        flat = self._pack(params, np.float32)
        self._lib.dps_store_load(self._handle, _f32p(flat), int(step))

    def _pack(self, gradients: Mapping[str, np.ndarray],
              dtype) -> np.ndarray:
        flat = np.empty(self._size, dtype)
        for name, (off, shape) in self._index.items():
            g = np.ascontiguousarray(gradients[name], dtype)
            n = int(np.prod(shape, dtype=np.int64))
            flat[off:off + n] = g.reshape(-1)
        return flat

    def _pack_int8(self, gradients: Mapping[str, np.ndarray]
                   ) -> tuple[np.ndarray, np.ndarray] | None:
        """(int8 arena-ordered values, per-tensor fp32 scales) from an
        int8-wire payload ({name: int8, name::int8scale: fp32[1]},
        ops/compression.py). Returns None for an uncompressed payload
        (in-process pushes may skip the wire codec; like the Python
        store's decompressor, fp32 passes through — via the fp32 kernel).
        """
        if not any(isinstance(v, np.ndarray) and v.dtype == np.int8
                   for v in gradients.values()):
            return None
        flat = np.empty(self._size, np.int8)
        scales = np.empty(len(self._names), np.float32)
        for t, name in enumerate(self._names):
            g = np.ascontiguousarray(gradients[name])
            if g.dtype != np.int8:
                raise ValueError(f"mixed int8 payload: {name} is {g.dtype}")
            scale = gradients.get(name + _SCALE_SUFFIX)
            if scale is None:
                raise ValueError(f"int8 wire entry {name!r} missing its "
                                 f"{_SCALE_SUFFIX} companion")
            off, seg_end = int(self._offsets[t]), int(self._offsets[t + 1])
            if g.size != seg_end - off:
                # Must reject BEFORE the kernel: a short tensor would leave
                # np.empty garbage in its segment and a long one would
                # bleed into the next (the Python store's shape check,
                # ps/store.py, is this guard's twin).
                raise ValueError(
                    f"push size mismatch for {name}: got {g.size} elements,"
                    f" server segment holds {seg_end - off} (model/dataset "
                    f"mismatch?)")
            flat[off:seg_end] = g.reshape(-1)
            scales[t] = np.float32(np.asarray(scale).reshape(-1)[0])
        return flat, scales

    def _pack_push(self, gradients: Mapping[str, np.ndarray]) -> tuple:
        """Compact a push payload into arena order: ('int8', values, scales)
        or ('fp16'|'fp32', flat). Raises ValueError/KeyError on malformed
        payloads (wrong sizes, missing tensors/scales) — callers reject."""
        if self._push_codec == "int8":
            packed = self._pack_int8(gradients)
            if packed is not None:
                return ("int8",) + packed
        if self._push_codec == "fp16":
            return ("fp16", self._pack(gradients, np.float16))
        return ("fp32", self._pack(gradients, np.float32))

    def push(self, worker_id: int, gradients: Mapping[str, np.ndarray],
             fetched_step: int) -> bool:
        t_push = _tnow()
        with trace_span("store.push", backend=self.store_backend) as sp:
            try:
                accepted = self._push_timed(worker_id, gradients,
                                            fetched_step)
                sp.attrs["accepted"] = accepted
                return accepted
            finally:
                self._tm_push_s.observe(_tnow() - t_push)

    def _push_timed(self, worker_id: int,
                    gradients: Mapping[str, np.ndarray],
                    fetched_step: int) -> bool:
        with self._registration_lock:
            self.last_seen[worker_id] = time.time()
        try:
            # Pack OUTSIDE any lock (pure host compaction) — and reject
            # malformed payloads up front, like the Python store's shape
            # check: the C++ kernels must never see a mis-sized buffer.
            packed = self._pack_push(gradients)
        except (ValueError, KeyError) as e:
            self.stats.gradients_rejected += 1
            self._tm_push_rej.inc()
            print(f"rejecting push from worker {worker_id}: {e}")
            return False
        if self.config.mode == "sync":
            self._push_sync(worker_id, packed)
            return True
        t0 = time.time()
        bound = int(self.config.staleness_bound)
        before = self.global_step
        self._tm_staleness.observe(before - int(fetched_step))
        with trace_span("store.apply", backend=self.store_backend,
                        mode="async",
                        staleness=before - int(fetched_step)):
            if packed[0] == "int8":
                _, flat, scales = packed
                new_step = int(self._lib.dps_store_push_int8(
                    self._handle, _i8p(flat), _f32p(scales),
                    _i64p(self._offsets), len(self._names),
                    int(fetched_step), bound))
            elif packed[0] == "fp16":
                new_step = int(self._lib.dps_store_push_fp16(
                    self._handle, _u16p(packed[1].view(np.uint16)),
                    int(fetched_step), bound))
            else:
                new_step = int(self._lib.dps_store_push_fp32(
                    self._handle, _f32p(packed[1]), int(fetched_step),
                    bound))
        if new_step < 0:
            self.stats.gradients_rejected += 1
            self._tm_push_rej.inc()
            return False
        self.stats.gradients_processed += 1
        self.stats.total_parameter_updates += 1
        self.stats.staleness_values.append(before - int(fetched_step))
        dt = time.time() - t0
        self.stats.update_times.append(dt)
        self._tm_apply_s.observe(dt)
        self._tm_push_ok.inc()
        self._tm_step.set(new_step)
        return True

    # -- sync rounds (orchestration mirrors AggregationBase; _round_target
    #    and the elastic hooks' call sites are inherited) --------------------

    def _push_sync(self, worker_id: int, packed: tuple) -> None:
        """server.py:264-288 semantics: stash (C++ decode into the worker's
        slot), count, and complete the round with one fused mean+apply.
        ``packed`` comes from :meth:`_pack_push` (payload already validated
        and arena-ordered, no shared state touched yet).

        The WHOLE stash happens under ``_sync_lock`` — exactly like the
        Python store, whose pushes hold the lock for the full stash —
        otherwise apply_mean could read a slot mid-overwrite (quirk-3
        double pushes make that reachable, not just theoretical).
        """
        with self._sync_lock:
            slot = self._slot_of.get(worker_id)
            if slot is None:
                if self._free_slots:
                    slot = self._free_slots.pop()
                else:
                    slot = self._next_slot
                    self._next_slot += 1
                self._slot_of[worker_id] = slot
            if packed[0] == "int8":
                _, flat, scales = packed
                self._lib.dps_store_stash_int8(
                    self._handle, slot, _i8p(flat), _f32p(scales),
                    _i64p(self._offsets), len(self._names))
            elif packed[0] == "fp16":
                self._lib.dps_store_stash_fp16(
                    self._handle, slot, _u16p(packed[1].view(np.uint16)))
            else:
                self._lib.dps_store_stash_fp32(self._handle, slot,
                                               _f32p(packed[1]))
            if self.config.strict_rounds:
                self._pending[worker_id] = slot
                self._gradients_received = len(self._pending)
            else:
                # Faithful quirk 3: a double push overwrites the slot (the
                # stash above already did) but still counts.
                self._pending[worker_id] = slot
                self._gradients_received += 1
            self._maybe_complete_round_locked()
            self.stats.gradients_processed += 1
        self._tm_push_ok.inc()

    def _maybe_complete_round_locked(self) -> None:
        if self._gradients_received >= self._round_target() and self._pending:
            t0 = time.time()
            try:
                slots = np.fromiter(self._pending.values(), np.int64)
                with trace_span("store.apply", backend=self.store_backend,
                                mode="sync", n_grads=len(slots)):
                    self._lib.dps_store_apply_mean(
                        self._handle, _i64p(slots), len(slots))
                self.stats.total_parameter_updates += 1
                dt = time.time() - t0
                self.stats.update_times.append(dt)
                self._tm_apply_s.observe(dt)
                self._tm_rounds.inc()
                self._tm_step.set(self.global_step)
            finally:
                # Workers that departed/expired while this round was still
                # pending had their slot release deferred (their stash was a
                # live contribution) — sweep them now that it is consumed.
                departed = [w for w in self._pending
                            if w not in self.active_workers]
                self._pending.clear()
                self._gradients_received = 0
                for w in departed:
                    self._release_slot_locked(w)

    def _release_slot_locked(self, worker_id: int) -> None:
        """Free the worker's C++ slot buffer and recycle its index (safe:
        apply_mean and stashes all serialize on _sync_lock, which the
        caller holds)."""
        slot = self._slot_of.pop(worker_id, None)
        if slot is not None:
            self._lib.dps_store_free_slot(self._handle, slot)
            self._free_slots.append(slot)

    def _on_workers_expired(self, stale) -> None:
        """Purge dead workers' stashed slots from the round (elastic) and
        release their C++ buffers (always)."""
        with self._sync_lock:
            elastic = getattr(self.config, "elastic", False)
            for w in stale:
                if elastic:
                    self._pending.pop(w, None)
                if w not in self._pending:  # never free a pending slot
                    self._release_slot_locked(w)
            if elastic and (self._pending or self._gradients_received):
                self._gradients_received = len(self._pending)
                self._maybe_complete_round_locked()

    def _on_worker_departed(self, worker_id: int) -> None:
        with self._sync_lock:
            if getattr(self.config, "elastic", False) \
                    and self._gradients_received:
                self._maybe_complete_round_locked()
            # The departure's own final push (if any) was consumed by the
            # round check above or stays pending for the faithful path —
            # only release the slot once it is no longer pending.
            if worker_id not in self._pending:
                self._release_slot_locked(worker_id)

    def metrics(self) -> dict:
        elapsed = time.time() - self.stats.start_time
        out = {
            "mode": self.config.mode,
            # Same key as AggregationBase.metrics so the ETL can filter
            # records from all three backends uniformly.
            "store_backend": self.store_backend,
            "total_workers": self.config.total_workers,
            "total_training_time_seconds": round(elapsed, 2),
            "global_steps_completed": self.global_step,
            "total_parameter_updates": self.stats.total_parameter_updates,
            "gradients_processed": self.stats.gradients_processed,
            "average_update_time_seconds": (
                round(float(np.mean(self.stats.update_times)), 6)
                if self.stats.update_times else 0.0),
            "updates_per_second": (
                round(self.stats.total_parameter_updates / elapsed, 3)
                if elapsed > 0 else 0.0),
            "learning_rate": self.config.learning_rate,
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

    def __del__(self):
        try:
            self._lib.dps_store_destroy(self._handle)
        except Exception:  # noqa: BLE001 — __del__ during interpreter teardown
            pass
