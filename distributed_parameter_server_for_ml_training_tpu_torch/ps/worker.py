"""Worker runtime of the port: threads driving local steps on the card
against a parameter store.

Counterpart of the JAX package's ``ps/worker.py`` (the reference worker
loop, src/workers/worker.py:350-403): register -> shard data by worker id
-> per batch [fetch params if step%K==0] -> local fwd/bwd on the card ->
[push gradients if step%K==0] -> per-epoch full-test-set eval ->
finished. Fetches are version-gated (delta fetch) as the store
negotiates. A quantized push codec (int8/int4/topk/adaptive) always
goes through the device codec, with error feedback — its wire quantize is
kernel K1 on the card and the plain version on a CPU worker; the fp16 and
uncompressed pushes are cast on the host, as the reference does.

K-step ("--sync-steps") semantics: ``k_step_mode='faithful'`` pushes only
the boundary batch's gradients (the reference's quirk 7);
``'accumulate'`` pushes the window's mean; ``'local_sgd'`` walks a local
parameter trajectory with the fused step (``train/steps.py:
make_fused_local_step``: grads, plain SGD apply and window accumulator,
in place on the card) and pushes the window's mean at the boundary.

``overlap=True`` runs pushes and the following prefetch on a single-slot
comms thread (:class:`_CommsPipeline`) while the training thread computes
the window's remaining batches. The heartbeat pings the store every
``heartbeat_interval`` seconds; ``reconnect_timeout`` turns on session
resume against a remote store that lost its session. Host batches are
uploaded ``prefetch_batches`` ahead of the step
(``train/device_loop.py:prefetch_to_device``).

The store is the in-process ``ParameterStore`` or a
``comms/client.py:RemoteStore``, which duck-types its worker-facing API
over gRPC (``cli worker``); the worker reads the codecs, the shared
scales, the delta-fetch capability and the elastic membership from
whichever it is given.

Against a server that advertised ``health_report``, the worker refreshes
a health report at every push boundary (:meth:`PSWorker._note_health`:
step, loss, the pushed gradients' global norm, their finite flags,
throughput, codec; one device->host copy for loss and norm together),
and the RemoteStore piggybacks it on every fetch, push and heartbeat.
Server directives (``comms/service.py:DIRECTIVE_CATALOG``) arriving on
replies are acted on at step boundaries: ``refetch_params`` takes a full
fresh fetch, ``quarantine`` skips the next ``steps`` pushes and drops the
error-feedback carry, ``rebalance_shard`` ends the epoch early and
``drain`` ends the run after the epoch's bookkeeping.
"""

from __future__ import annotations

import copy
import math
import os
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from ..data.cifar import Dataset, make_batches, shard_range
from ..ops.compression import QUANTIZED_PUSH_CODECS, ErrorFeedback, \
    compress_push, fp16_compress, fp16_decompress
from ..ops.device_codec import DeviceCodec, DevicePayload
from ..telemetry import GoodputAccount, now as _tnow, trace_span
from ..telemetry.trace import current_wire_trace, use_wire_context
from ..train.device_loop import prefetch_to_device
from ..train.steps import make_eval_step, make_fused_local_step, \
    make_grad_step
from ..utils.device import resolve_device
from ..utils.pytree import flax_names
from .semantics import DEFAULT_STALENESS_BOUND
from .store import ParameterStore

_NULL_GP = nullcontext()

#: Ceiling of the reconnect backoff, doubling from ``reconnect_backoff``.
RECONNECT_BACKOFF_CAP_S = 10.0


@dataclass
class WorkerConfig:
    batch_size: int = 128      # worker.py:474-482 distributed defaults
    num_epochs: int = 3
    sync_steps: int = 1        # K; CLI default 1 (worker.py:468)
    # 'faithful' | 'accumulate' | 'local_sgd'. local_sgd runs the fused
    # step (grads + plain-SGD apply + window accumulation, params updated
    # in place on the card) and pushes the window's gradient MEAN at the
    # boundary; with K=1 it matches 'faithful' up to +0/-0 on exactly-zero
    # gradient entries.
    k_step_mode: str = "faithful"
    augment: bool = True
    eval_batch_size: int = 1000
    eval_each_epoch: bool = True   # worker.py:393-394
    seed: int = 0
    # Liveness ping via a periodic (delta-gated) fetch: the reference's
    # 30 s FetchParameters ping (worker.py:112-119), which it wrote but
    # never ran. 0 disables.
    heartbeat_interval: float = 0.0
    # Overlapped comms pipeline: pushes (and the following prefetch) run
    # on a single-slot background thread while the training thread
    # computes the window's remaining batches. The per-worker RPC ORDER is
    # the serial loop's; with a single worker every fetched_step is too,
    # and the store's params match the serial run bit for bit. With
    # several workers the prefetch runs up to K-1 batches earlier than the
    # serial boundary fetch, within the store's staleness model.
    overlap: bool = False
    # Version-gated delta fetches: refetches send have_step so a store
    # whose step hasn't advanced answers NOT_MODIFIED and the worker keeps
    # the params it already holds.
    delta_fetch: bool = True
    # Session resume: when a remote store loses its session
    # (SessionLostError), re-register, re-fetch at the restored server
    # step and reconcile the in-flight gradient, within this many
    # seconds; 0 keeps the terminal failure.
    reconnect_timeout: float = 0.0
    # First reconnect retry delay; doubles per attempt (capped at 10 s).
    reconnect_backoff: float = 0.5
    # Deterministic compute-fault injection: at this 0-based local step
    # the batch's loss and gradients (the window accumulator under
    # local_sgd) are poisoned with NaN. Env DPS_NAN_STEP does the same for
    # subprocess workers. None disables.
    nan_inject_step: int | None = None
    # Error feedback for the quantized push codecs: each push's
    # quantization residual is carried into the next step's gradient.
    error_feedback: bool = True
    # Fraction of entries a 'topk' push keeps per tensor.
    topk_frac: float = 0.01
    # Device-resident push codec (ops/device_codec.py, K1 on a card):
    # quantize/pack on the worker's device and pull only the packed wire
    # bytes. Bit-identical to the NumPy compress_push; engages when a
    # quantized codec was negotiated. False forces the NumPy encode.
    device_codec: bool = True
    device: str = "cuda"
    # Host->device input double buffering: this many batches' uploads in
    # flight ahead of the step (train/device_loop.py prefetch_to_device);
    # 0 feeds host batches directly.
    prefetch_batches: int = 2
    # 'local_sgd' mode: the worker-local SGD learning rate; None adopts
    # the store's configured learning_rate.
    local_lr: float | None = None

    def __post_init__(self):
        if self.k_step_mode not in ("faithful", "accumulate", "local_sgd"):
            raise ValueError(self.k_step_mode)
        if self.sync_steps < 1:
            raise ValueError("sync_steps must be >= 1")
        if self.prefetch_batches < 0:
            raise ValueError("prefetch_batches must be >= 0")
        resolve_device(self.device)


@dataclass
class WorkerResult:
    worker_id: int = -1
    worker_name: str = ""
    epoch_times: list = field(default_factory=list)
    test_accuracies: list = field(default_factory=list)
    # Mean train loss of each epoch's local steps (one host sync per
    # epoch).
    train_loss_per_epoch: list = field(default_factory=list)
    local_steps_completed: int = 0
    pushes_accepted: int = 0
    pushes_rejected: int = 0
    heartbeats: int = 0
    heartbeat_errors: int = 0
    # Session resumes survived (server restarts the reconnect state
    # machine rode through).
    reconnects: int = 0
    # Server->worker control directives acted on, by action name; empty
    # when none arrived.
    directives_applied: dict = field(default_factory=dict)
    # Push windows skipped under a quarantine directive.
    pushes_quarantined: int = 0
    # Client-side wire accounting (RemoteStore.wire_stats); empty for the
    # in-process store, which crosses no wire.
    wire: dict = field(default_factory=dict)
    error: Exception | None = None

    def metrics(self, total_workers: int, learning_rate: float,
                config: WorkerConfig) -> dict:
        """METRICS_JSON field parity with worker.py:421-434 (+ wire
        accounting when the store is remote)."""
        out = {
            "worker_id": self.worker_id,
            "worker_name": self.worker_name,
            "total_workers": total_workers,
            "total_training_time_seconds": round(sum(self.epoch_times), 2),
            "average_epoch_time_seconds": (
                round(float(np.mean(self.epoch_times)), 2)
                if self.epoch_times else 0.0),
            "epoch_times_seconds": [round(t, 2) for t in self.epoch_times],
            "final_test_accuracy": (self.test_accuracies[-1]
                                    if self.test_accuracies else 0.0),
            "all_test_accuracies": self.test_accuracies,
            "train_loss_per_epoch": [round(v, 4)
                                     for v in self.train_loss_per_epoch],
            "local_steps_completed": self.local_steps_completed,
            "batch_size": config.batch_size,
            "learning_rate": learning_rate,
            "num_epochs": config.num_epochs,
            "reconnects": self.reconnects,
        }
        if self.directives_applied:
            out["directives_applied"] = dict(self.directives_applied)
        if self.pushes_quarantined:
            out["pushes_quarantined"] = self.pushes_quarantined
        out.update(self.wire)
        return out


def _window_mean(accum: dict, n: int) -> dict:
    """Mean of an accumulated K-step gradient window: a true division by
    ``n`` (a tensor divisor, never a host scalar's reciprocal). One
    definition shared by the serial and overlapped push paths."""
    return {k: a / torch.tensor(n, dtype=torch.float32, device=a.device)
            for k, a in accum.items()}


@dataclass
class _StagedGrads:
    """An uncompressed or fp16 push whose device->host copies were started
    on the training thread: pinned host tensors, and the event after the
    copies (None when the gradients already were on the host)."""
    host: dict
    ready: object = None

    def numpy(self) -> dict:
        if self.ready is not None:
            self.ready.synchronize()
        return {k: v.numpy() for k, v in self.host.items()}


def _stage_to_host(grads: dict) -> _StagedGrads:
    """Start the device->host copies of a push's gradients now, on the
    calling (training) thread, so they run behind the next window's
    compute: the counterpart of the JAX worker's ``copy_to_host_async``."""
    first = next(iter(grads.values()), None)
    if first is None or first.device.type != "cuda":
        return _StagedGrads({k: v.detach() for k, v in grads.items()})
    host = {}
    for k, v in grads.items():
        h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        h.copy_(v.detach(), non_blocking=True)
        host[k] = h
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(first.device))
    return _StagedGrads(host, ready)


class _BitwidthController:
    """Per-layer push-codec chooser for the quantized codec family (the
    JAX package's controller, unchanged).

    Fixed codecs (``int8``/``int4``/``topk``) pin the aggressiveness
    level; ``adaptive`` moves the level with measured LINK PRESSURE — the
    fraction of wall time the push spends on the wire. Sustained pressure
    above ``hi`` escalates int8 -> int4 -> +topk; sustained pressure below
    ``lo`` de-escalates, after ``patience`` consecutive windows either way.
    Tiny tensors stay int8 at any level; topk applies only above
    ``min_topk_size``.
    """

    LEVEL_NAMES = ("int8", "int4", "topk")

    def __init__(self, codec: str, hi: float = 0.25, lo: float = 0.05,
                 patience: int = 2, min_int4_size: int = 256,
                 min_topk_size: int = 4096):
        self.adaptive = codec == "adaptive"
        self.level = 0 if self.adaptive \
            else {"int8": 0, "int4": 1, "topk": 2}.get(codec, 0)
        self.hi, self.lo, self.patience = hi, lo, patience
        self.min_int4_size = min_int4_size
        self.min_topk_size = min_topk_size
        self._hot = self._cold = 0

    def note_push(self, push_seconds: float, window_seconds: float) -> None:
        """Feed one push's timing (adaptive only): RPC seconds vs the
        wall-clock window since the previous push completed."""
        if not self.adaptive or window_seconds <= 0:
            return
        pressure = push_seconds / window_seconds
        if pressure > self.hi:
            self._hot += 1
            self._cold = 0
            if self._hot >= self.patience and self.level < 2:
                self.level += 1
                self._hot = 0
        elif pressure < self.lo:
            self._cold += 1
            self._hot = 0
            if self._cold >= self.patience and self.level > 0:
                self.level -= 1
                self._cold = 0
        else:
            self._hot = self._cold = 0

    def plan(self, flat: dict) -> dict:
        """{tensor name: 'int8'|'int4'|'topk'} for this push."""
        out = {}
        for name, a in flat.items():
            size = int(a.numel() if isinstance(a, torch.Tensor) else a.size)
            if self.level >= 2 and size >= self.min_topk_size:
                out[name] = "topk"
            elif self.level >= 1 and size >= self.min_int4_size:
                out[name] = "int4"
            else:
                out[name] = "int8"
        return out

    def describe(self) -> str:
        name = self.LEVEL_NAMES[self.level]
        return f"adaptive({name})" if self.adaptive else name


class _CommsPipeline:
    """Bounded single-slot comms thread for one worker.

    Executes (push, then optional prefetch) work items in submission order
    on ONE background thread, so a worker's pushes stay strictly sequential
    — the RemoteStore push-token dedupe contract ("a retry always precedes
    that worker's next distinct push") holds as in the serial loop — and a
    prefetch can never overtake the push it follows. At most ONE item is
    in flight: ``submit`` blocks until the previous item completed (the
    depth gauge is therefore 0 or 1).

    The training thread's contract:

    - ``submit(grads, fetched_step, prefetch_current)`` — push ``grads``
      (a DevicePayload encoded at dispatch, or gradients whose host copies
      were started at dispatch) with ``fetched_step``; if
      ``prefetch_current`` is not None, follow with a params fetch
      (``have_step=fetched_step``, delta-gated) that ``await_params``
      later returns.
    - ``await_params()`` — block until the pending prefetch result is
      available and take it.
    - ``flush()`` — block until the pipeline is idle (epoch boundaries).

    On a card the prefetch's upload runs on a side stream of the comms
    thread (it overlaps the training thread's compute on the default
    stream); ``await_params`` makes the training thread's stream wait on
    an event recorded after the upload and ``record_stream``s the
    uploaded tensors there, so the caching allocator does not reuse their
    memory while that stream still reads them.

    Comms-thread exceptions surface on the NEXT training-thread call (with
    the original as ``__cause__``), so a dead server fails the worker
    instead of hanging it.
    """

    def __init__(self, worker: "PSWorker", worker_id: int):
        self._worker = worker
        self._worker_id = worker_id
        self._item = None
        self._error: Exception | None = None
        # The (grads, fetched_step) of a PUSH that died on the comms
        # thread — what the session-resume reconciliation must decide
        # about. A failed PREFETCH leaves this None: its push landed.
        self._failed_push = None
        self._go = threading.Event()
        self._done = threading.Event()
        self._done.set()
        self._stop = False
        self._result = None            # (params, step, event) of a prefetch
        self._result_ready = threading.Event()
        self._pending_prefetch = False  # training thread only
        self._last_comms_s = 0.0
        dev = worker.device
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" \
            else None
        from ..telemetry import get_registry
        reg = get_registry()
        w = str(worker_id)
        self._tm_depth = reg.gauge("dps_worker_pipeline_depth", worker=w)
        # Comms seconds the training thread did NOT spend blocked: the
        # item's comms-thread duration minus the time await/flush waited.
        self._tm_saved = reg.histogram("dps_worker_overlap_saved_seconds",
                                       worker=w)
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"comms-pipeline-{worker_id}")
        self._thread.start()

    # -- comms thread --------------------------------------------------------

    def _prefetch(self, fetched_step: int, current):
        """The prefetch and, on a card, the event after its upload."""
        event = None
        with torch.cuda.stream(self._stream) if self._stream is not None \
                else nullcontext():
            params, step = self._worker._fetch_params(
                self._worker_id, have_step=fetched_step, current=current)
            if self._stream is not None:
                event = torch.cuda.Event()
                event.record(self._stream)
        return params, step, event

    def _loop(self) -> None:
        while True:
            self._go.wait()
            self._go.clear()
            if self._stop:
                return
            grads, fetched_step, prefetch_current, wctx = self._item
            self._item = None
            t0 = _tnow()
            try:
                # Adopt the submitting step's trace context, so this
                # item's spans attach to the step whose window hides them.
                with use_wire_context(wctx), \
                        trace_span("pipeline.comms",
                                   worker=self._worker_id,
                                   prefetch=prefetch_current is not None):
                    if grads is not None:
                        try:
                            self._worker._push(self._worker_id, grads,
                                               fetched_step)
                        except Exception:  # noqa: BLE001 — stash, re-raise
                            self._failed_push = (grads, fetched_step)
                            raise
                    if prefetch_current is not None:
                        result = self._prefetch(fetched_step,
                                                prefetch_current)
                        # Duration published BEFORE the ready flag: a
                        # waiter that wakes at once must see THIS item's
                        # comms time.
                        self._last_comms_s = _tnow() - t0
                        self._result = result
                        self._result_ready.set()
            except Exception as e:  # noqa: BLE001 — surfaced via await_params
                self._error = e
                self._result_ready.set()  # wake a blocked await_params
            finally:
                self._last_comms_s = _tnow() - t0
                self._tm_depth.set(0)
                self._done.set()

    # -- training thread -----------------------------------------------------

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            raise RuntimeError("comms pipeline failed") from self._error

    def submit(self, grads, fetched_step: int, prefetch_current) -> None:
        self._done.wait()  # single-slot bound: previous item must be done
        self._raise_if_failed()
        # Start the device->host copies of an uncompressed or fp16 push
        # NOW, on the training thread, in program order; a DevicePayload
        # started its own copies at encode time, and a device-resident
        # store takes the tensors themselves.
        if grads is not None and not isinstance(grads, DevicePayload) \
                and not getattr(self._worker.store, "keeps_device_arrays",
                                False):
            grads = _stage_to_host(grads)
        self._item = (grads, fetched_step, prefetch_current,
                      current_wire_trace())
        self._pending_prefetch = prefetch_current is not None
        self._done.clear()
        self._tm_depth.set(1)
        self._go.set()

    def params_pending(self) -> bool:
        return self._pending_prefetch

    def await_params(self):
        """Take the pending prefetch result; records the overlap saving
        (comms time hidden behind compute) for this window."""
        t0 = _tnow()
        self._result_ready.wait()
        waited = _tnow() - t0
        self._raise_if_failed()
        params, step, event = self._result
        self._result = None
        self._result_ready.clear()
        self._pending_prefetch = False
        if event is not None:
            consumer = torch.cuda.current_stream(self._worker.device)
            consumer.wait_event(event)
            for t in params.values():
                t.record_stream(consumer)
        self._tm_saved.observe(max(0.0, self._last_comms_s - waited))
        return params, step

    def flush(self) -> None:
        """Epoch barrier: wait until the in-flight item (if any) finished.
        A pending prefetch RESULT survives a flush — the next epoch's
        opening fetch consumes it."""
        self._done.wait()
        self._raise_if_failed()

    def take_failed_item(self):
        """The (grads, fetched_step) of the push that killed this
        pipeline, if any — consumed once by the session-resume
        reconciliation."""
        item, self._failed_push = self._failed_push, None
        return item

    def close(self) -> None:
        # Bounded wait: a comms thread stuck deep in RPC retries must not
        # wedge teardown; it is a daemon and observes _stop when its RPC
        # returns.
        self._done.wait(timeout=120.0)
        self._stop = True
        self._go.set()
        self._thread.join(timeout=10.0)


class PSWorker(threading.Thread):
    """One logical worker. Runs as a thread over its OWN copy of the model
    (an ``nn.Module`` is not thread-safe), on ``config.device``."""

    def __init__(self, store: ParameterStore, model: torch.nn.Module,
                 dataset: Dataset, config: WorkerConfig | None = None,
                 worker_name: str = ""):
        super().__init__(daemon=True)
        self.store = store
        self.dataset = dataset
        self.config = config or WorkerConfig()
        self.device = resolve_device(self.config.device)
        self.model = copy.deepcopy(model).to(self.device)
        self.worker_name = worker_name
        self.result = WorkerResult()
        # Step of the last successful fetch; the heartbeat thread reads it
        # to delta-gate its pings.
        self._last_fetched_step: int | None = None
        # The overlapped comms pipeline (set in _run when overlap=True); an
        # attribute so the session-resume path can drain and rebuild it.
        self._pipe: _CommsPipeline | None = None
        self._done = threading.Event()
        self._bitwidth: _BitwidthController | None = None
        self._device_codec: DeviceCodec | None = None
        # The NumPy encode's error-feedback residuals (device_codec=False).
        self._ef: ErrorFeedback | None = None
        self._prev_push_done: float | None = None
        self._goodput: GoodputAccount | None = None
        self._tm_reconnect = None  # created at _init_telemetry
        self._tm_hb_err = None
        self._test_cache = None
        # Health report: built at push boundaries by _note_health, shipped
        # by a RemoteStore on every fetch/push/heartbeat through the
        # provider installed in _run. The lock covers training-thread
        # writes against heartbeat and comms-thread reads; the revision
        # lets the store reuse its cached JSON encode between boundaries.
        self._health_lock = threading.Lock()
        self._health: dict = {}  # guarded by: self._health_lock
        self._health_rev = 0  # guarded by: self._health_lock
        self._health_enabled = False
        self._health_rate: tuple[float, int] | None = None
        # Directive state, acted on at step boundaries by the training
        # thread.
        self._force_full_fetch = False     # refetch_params
        self._quarantine_windows = 0       # quarantine: windows to skip
        self._epoch_break = False          # rebalance_shard
        self._draining = False             # drain
        # Injected per-step compute slowdown (comms/faults.py COMPUTE_OP):
        # set in _run from the store's fault injector, if any.
        self._compute_faults = None
        ns = self.config.nan_inject_step
        if ns is None:
            env = os.environ.get("DPS_NAN_STEP")
            ns = int(env) if env else None
        self._nan_step = ns
        self._grad_step = make_grad_step(self.model,
                                         augment=self.config.augment)
        self._fused_step = make_fused_local_step(
            self.model, augment=self.config.augment) \
            if self.config.k_step_mode == "local_sgd" else None
        self._eval_step = make_eval_step(self.model)

    # -- the training loop (worker.py:350-403) ------------------------------

    def run(self) -> None:
        try:
            self._run()
        except Exception as e:  # noqa: BLE001 — surfaced via .result
            self.result.error = e
        finally:
            self._done.set()
            if self.result.worker_id >= 0:
                try:
                    self.store.job_finished(self.result.worker_id)
                except Exception as e:  # noqa: BLE001
                    # A dead server at goodbye time must not erase an
                    # otherwise complete run.
                    print(f"JobFinished failed for worker "
                          f"{self.result.worker_id}: {e!r}", flush=True)
            # After JobFinished, so the last RPC is counted too.
            ws = getattr(self.store, "wire_stats", None)
            if callable(ws):
                self.result.wire = ws()

    def _heartbeat_loop(self, interval: float) -> None:
        """Liveness ping: a periodic fetch (the reference's intended
        health_check_loop, worker.py:112-119), delta-gated when the store
        supports it, so a ping costs a header while the step has not moved
        past the training thread's last fetch. The worker id is re-read
        every tick, so after a session resume the same thread keeps the
        NEW registration alive. Failed ticks are counted
        (``heartbeat_errors``, dps_worker_heartbeat_errors_total) and
        logged once per transition into and out of the failing state."""
        failing = False
        while not self._done.wait(interval):
            try:
                worker_id = self.result.worker_id
                have = self._last_fetched_step
                if (have is not None and self.config.delta_fetch
                        and getattr(self.store, "supports_delta_fetch",
                                    False)):
                    self.store.fetch(worker_id, have_step=have)
                else:
                    self.store.fetch(worker_id)
                self.result.heartbeats += 1
                if failing:
                    failing = False
                    print(f"HEARTBEAT_RECOVERED worker={self.worker_name} "
                          f"id={self.result.worker_id}", flush=True)
            except Exception as e:  # noqa: BLE001 — next tick retries
                self.result.heartbeat_errors += 1
                if self._tm_hb_err is not None:
                    self._tm_hb_err.inc()
                with self._health_lock:
                    self._health["heartbeat_errors"] = \
                        self._health.get("heartbeat_errors", 0) + 1
                    self._health_rev += 1
                if not failing:
                    failing = True
                    print(f"HEARTBEAT_FAILING worker={self.worker_name} "
                          f"id={self.result.worker_id} err={e!r}",
                          flush=True)

    def _compute_shard(self, worker_id: int, total_workers: int):
        """This worker's contiguous data shard. Faithful mode: a fixed
        split by registration id (worker.py:166-179), ids wrapping into
        range. Elastic mode: a split over the LIVE membership by rank, so
        at each epoch boundary coverage rebalances as workers come and go
        (a RemoteStore caches the membership off its replies)."""
        n = len(self.dataset.x_train)
        cfg = getattr(self.store, "config", None)
        rank, total = worker_id % total_workers, total_workers
        if getattr(cfg, "elastic", False) \
                and hasattr(self.store, "membership_snapshot"):
            active = self.store.membership_snapshot()
            if worker_id in active:
                rank, total = active.index(worker_id), len(active)
        lo, hi = shard_range(n, rank, total)
        return self.dataset.x_train[lo:hi], self.dataset.y_train[lo:hi]

    def _init_telemetry(self, worker_id: int) -> None:
        """Per-worker live instruments, labeled by worker id (the JAX
        worker's names)."""
        from ..telemetry import get_registry
        reg = get_registry()
        w = str(worker_id)
        self._tm_step_s = reg.histogram("dps_worker_step_seconds", worker=w)
        self._tm_steps = reg.counter("dps_worker_steps_total", worker=w)
        self._tm_epochs = reg.counter("dps_worker_epochs_total", worker=w)
        self._tm_acc = reg.gauge("dps_worker_test_accuracy", worker=w)
        self._tm_push_pre = reg.counter("dps_worker_push_bytes_total",
                                        stage="precodec", worker=w)
        self._tm_push_wire = reg.counter("dps_worker_push_bytes_total",
                                         stage="wire", worker=w)
        self._tm_fetch_post = reg.counter("dps_worker_fetch_bytes_total",
                                          stage="postcodec", worker=w)
        self._tm_fetch_nm = reg.counter(
            "dps_worker_fetch_not_modified_total", worker=w)
        # Labeled by the INITIAL registration id: the logical worker's
        # identity for the run, even if a resume registers a fresh id.
        self._tm_reconnect = reg.counter("dps_worker_reconnect_total",
                                         worker=w)
        self._tm_hb_err = reg.counter("dps_worker_heartbeat_errors_total",
                                      worker=w)
        self._tm_push_saved = reg.counter(
            "dps_worker_push_bytes_saved_total", worker=w)
        self._tm_push_bits = reg.gauge("dps_worker_push_bitwidth", worker=w)
        self._tm_codec_s = reg.histogram("dps_worker_codec_seconds",
                                         worker=w)
        # Device->host gradient-pull seconds that ran on the comms thread
        # instead of blocking the training thread.
        self._tm_d2h_saved = reg.histogram(
            "dps_worker_d2h_overlap_saved_seconds", worker=w)
        # Server->worker directives acted on, one series per catalog
        # action.
        from ..comms.service import DIRECTIVE_CATALOG
        self._tm_directives = {
            a: reg.counter("dps_worker_directives_total", worker=w,
                           action=a)
            for a in DIRECTIVE_CATALOG
        }
        self._goodput = GoodputAccount(reg)

    def _gp(self, category: str):
        """Goodput bracket for the TRAINING thread's wall. The comms
        thread's overlapped work is not charged: those seconds run under
        the window's compute."""
        gp = self._goodput
        if gp is None:
            return _NULL_GP
        pipe = self._pipe
        if pipe is not None and threading.current_thread() is pipe._thread:
            return _NULL_GP
        return gp.span(category)

    def _compute_category(self) -> str:
        """Quarantined windows still burn device seconds, but their pushes
        are dropped at the boundary: that wall is idle by directive, not
        goodput."""
        return "quarantine_idle" if self._quarantine_windows > 0 \
            else "compute"

    # -- health report --------------------------------------------------------

    def _health_snapshot(self) -> dict | None:
        """Provider installed on the RemoteStore: the current report, or
        None before the first boundary note (a report-less heartbeat is a
        valid legacy ping)."""
        with self._health_lock:
            return dict(self._health) if self._health else None

    def _health_revision(self) -> int:
        """The report's revision, so the store reuses its cached encode
        while the report is unchanged."""
        with self._health_lock:
            return self._health_rev

    @staticmethod
    def _loss_and_norm(loss, grads: dict) -> tuple[float, float]:
        """The loss and the global L2 norm of ``grads`` (fp32), read back
        together in ONE device->host copy: per-tensor norms in one
        multi-tensor launch, their norm, and the loss beside it."""
        gs = [g if g.dtype == torch.float32 else g.float()
              for g in grads.values()]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
        loss_t = torch.as_tensor(loss, dtype=torch.float32,
                                 device=norm.device).reshape(())
        lval, gval = torch.stack([loss_t, norm]).cpu().tolist()
        return lval, gval

    def _note_health(self, loss, grads: dict, epoch: int,
                     grad_scale: float = 1.0) -> None:
        """Refresh the health report at a push boundary. Skipped entirely
        unless the store advertised the health_report capability.

        ``grads`` must be (proportional to) what is PUSHED: in accumulate
        and local_sgd mode the window's gradient sum with
        ``grad_scale=1/n`` (the norm of the pushed mean; a NaN from ANY
        batch of the window is in the sum, so the finite flag marks
        exactly the payload that would poison the server)."""
        if not self._health_enabled:
            return
        try:
            lval, gval = self._loss_and_norm(loss, grads)
            gval *= float(grad_scale)
        except (TypeError, ValueError):
            lval = gval = float("nan")
        loss_finite = math.isfinite(lval)
        grad_finite = math.isfinite(gval)
        now = time.time()
        steps = self.result.local_steps_completed
        eps = None
        prev = self._health_rate
        if prev is not None and now > prev[0] and steps > prev[1]:
            eps = (steps - prev[1]) * self.config.batch_size \
                / (now - prev[0])
        self._health_rate = (now, steps)
        pipe = self._pipe
        depth = 0 if pipe is None or pipe._done.is_set() else 1
        gpf = self._goodput.fraction() if self._goodput is not None \
            else None
        ef = self._ef is not None or (self._device_codec is not None
                                      and self._device_codec.error_feedback)
        with self._health_lock:
            h = self._health
            h["step"] = steps
            h["epoch"] = epoch
            # Non-finite values travel as null + a false finite flag, so
            # NaN never rides a JSON hop (telemetry/cluster.py schema).
            h["loss"] = round(lval, 6) if loss_finite else None
            h["loss_finite"] = loss_finite
            h["grad_norm"] = round(gval, 6) if grad_finite else None
            h["grad_finite"] = grad_finite
            if eps is not None:
                h["examples_per_s"] = round(eps, 3)
            h["pipeline_depth"] = depth
            h["reconnects"] = self.result.reconnects
            codec = self._bitwidth.describe() if self._bitwidth \
                else getattr(self.store, "push_codec", "none")
            h["push_codec"] = codec + ("+ef" if ef else "")
            if gpf is not None:
                h["goodput_fraction"] = round(gpf, 4)
            h.setdefault("heartbeat_errors", 0)
            self._health_rev += 1

    # -- directive channel ----------------------------------------------------

    def _poll_directives(self) -> None:
        """Drain and act on server->worker directives (step boundaries,
        where the loop already talks to the server). A no-op against
        stores without the channel (the in-process stores)."""
        take = getattr(self.store, "take_directives", None)
        if not callable(take):
            return
        try:
            directives = take()
        except Exception:  # noqa: BLE001 — directives must not kill a run
            return
        for d in directives:
            self._apply_directive(d)

    def _apply_directive(self, d: dict) -> None:
        action = d.get("action")
        if action == "refetch_params":
            # Drop the delta basis: the next boundary fetch is a full
            # fresh fetch even if the step did not advance.
            self._force_full_fetch = True
        elif action == "quarantine":
            try:
                steps = max(1, int(d.get("steps", 3)))
            except (TypeError, ValueError):
                steps = 3
            self._quarantine_windows = max(self._quarantine_windows, steps)
            # The residual carry may hold the same poison the server
            # quarantined us for: restart it clean, on either route.
            if self._ef is not None:
                self._ef = ErrorFeedback()
            if self._device_codec is not None:
                self._device_codec.reset()
            self._force_full_fetch = True
        elif action == "rebalance_shard":
            # Finish the current epoch early; the next epoch recomputes
            # the shard from live membership.
            self._epoch_break = True
        elif action == "drain":
            self._draining = True
        else:
            return  # unknown directive from a newer server: ignore
        self.result.directives_applied[action] = \
            self.result.directives_applied.get(action, 0) + 1
        tm = getattr(self, "_tm_directives", None)
        if tm and action in tm:
            tm[action].inc()
        print(f"DIRECTIVE worker={self.worker_name} "
              f"id={self.result.worker_id} action={action} "
              f"seq={d.get('seq')}", flush=True)

    def _skip_quarantined_push(self) -> bool:
        """Quarantine directive: this window's push stays local (the
        server refuses it anyway); the window counts down, so pushing
        resumes by itself."""
        if self._quarantine_windows <= 0:
            return False
        self._quarantine_windows -= 1
        self.result.pushes_quarantined += 1
        return True

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _local_lr(self) -> float:
        """local_sgd's step size as an fp32 value: the config's, else the
        store's learning rate."""
        lr = self.config.local_lr
        if lr is None:
            lr = float(getattr(getattr(self.store, "config", None),
                               "learning_rate", 0.1) or 0.1)
        return float(np.float32(lr))

    def _inject_nan(self, grads, accum, loss):
        """Deterministic compute-fault injection at ``nan_inject_step``:
        poison this batch's loss and gradients — under local_sgd the
        window accumulator, which is what gets pushed."""
        if grads is None:
            torch._foreach_mul_(list(accum.values()), float("nan"))
        else:
            grads = {k: g * float("nan") for k, g in grads.items()}
        print(f"fault injection: NaN gradients/loss at worker="
              f"{self.worker_name} local_step="
              f"{self.result.local_steps_completed}", flush=True)
        return grads, loss * float("nan")

    def _run(self) -> None:
        t_run0 = _tnow()
        cfg = self.config
        worker_id, total_workers = self.store.register_worker(self.worker_name)
        self.result.worker_id = worker_id
        self.result.worker_name = self.worker_name
        self._init_telemetry(worker_id)
        # Quantized push codec (the store advertised it): the per-layer
        # bitwidth controller and the device codec, which carries the
        # error-feedback residuals on the worker's device.
        codec = self.store.push_codec
        if codec in QUANTIZED_PUSH_CODECS:
            self._bitwidth = _BitwidthController(codec)
            if cfg.device_codec:
                self._device_codec = DeviceCodec(
                    error_feedback=cfg.error_feedback,
                    topk_frac=cfg.topk_frac, device=self.device)
            elif cfg.error_feedback:
                self._ef = ErrorFeedback()
        if getattr(self.store, "keeps_device_arrays", False) \
                and self.store.device != self.device:
            raise ValueError(
                f"the device store keeps its params on "
                f"{self.store.device}; this worker trains on {self.device}")
        # Health reports ride fetch/push/heartbeat envelopes when the
        # server advertised the capability; otherwise the note stays off
        # and costs nothing.
        if getattr(self.store, "supports_health_report", False) \
                and hasattr(self.store, "health_provider"):
            self.store.health_provider = self._health_snapshot
            if hasattr(self.store, "health_revision"):
                self.store.health_revision = self._health_revision
            self._health_enabled = True
        # Injected compute slowdown (comms/faults.py 'compute' pseudo-op):
        # the same --faults spec that drives RPC chaos can make THIS
        # worker a deterministic straggler.
        injector = getattr(self.store, "faults", None)
        if injector is not None and hasattr(injector,
                                            "maybe_delay_compute"):
            self._compute_faults = injector
        if cfg.heartbeat_interval > 0:
            threading.Thread(target=self._heartbeat_loop,
                             args=(cfg.heartbeat_interval,),
                             daemon=True).start()

        # This worker's BatchNorm statistics start from the model's own
        # (zeros/ones) and stay local, as in the reference.
        _, snames = flax_names(self.model)
        buffers = dict(self.model.named_buffers())
        batch_stats = {f: buffers[t].detach().clone()
                       for t, f in snames.items()}
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed + worker_id)
        fetched_step = 0
        params = None
        k = cfg.sync_steps
        accum = None
        accum_n = 0
        # local_sgd: the fused step walks a LOCAL trajectory between push
        # boundaries, in place. local_params is a COPY of the fetched
        # params, which stay intact as the delta-fetch basis.
        local_sgd = cfg.k_step_mode == "local_sgd"
        local_params = None
        local_lr = self._local_lr() if local_sgd else None
        self._pipe = _CommsPipeline(self, worker_id) if cfg.overlap else None

        gp = self._goodput
        gp.add("startup", _tnow() - t_run0)
        gp.start_wall(t_run0)
        try:
            for epoch in range(cfg.num_epochs):
                t_epoch = time.time()
                self._epoch_break = False
                # The epoch's first fetch comes BEFORE the shard, so a
                # remote store's membership cache is fresh when the shard
                # is computed; a pipeline's pending prefetch serves the
                # same role.
                with trace_span("worker.step", root=True, worker=worker_id,
                                step=self.result.local_steps_completed,
                                epoch=epoch, epoch_open=True):
                    with trace_span("worker.fetch_wait"):
                        params, fetched_step = self._boundary_fetch(
                            worker_id, fetched_step, params)
                # A session resume may have re-registered under a fresh id.
                worker_id = self.result.worker_id
                x_shard, y_shard = self._compute_shard(worker_id,
                                                       total_workers)
                batches = prefetch_to_device(
                    make_batches(x_shard, y_shard, cfg.batch_size,
                                 seed=cfg.seed * 1000 + epoch),
                    depth=cfg.prefetch_batches, device=self.device)
                loss_sum, n_loss = None, 0
                for batch_idx, (xb, yb) in enumerate(batches):
                    boundary = batch_idx % k == 0
                    with trace_span("worker.step", root=True,
                                    worker=worker_id,
                                    step=self.result.local_steps_completed,
                                    epoch=epoch):
                        if boundary and batch_idx > 0:
                            with trace_span("worker.fetch_wait"):
                                params, fetched_step = self._boundary_fetch(
                                    worker_id, fetched_step, params)
                            worker_id = self.result.worker_id
                        t_step = _tnow()
                        grads = None
                        with trace_span("worker.compute") as _csp, \
                                self._gp(self._compute_category()):
                            if local_sgd:
                                if boundary:
                                    # Window open: a fresh copy of the
                                    # fetched params, a zero accumulator.
                                    local_params = {
                                        n: p.clone()
                                        for n, p in params.items()}
                                    accum = {n: torch.zeros_like(p)
                                             for n, p in params.items()}
                                    accum_n = 0
                                (local_params, accum, batch_stats, loss,
                                 _) = self._fused_step(
                                    local_params, accum, batch_stats, xb,
                                    yb, gen, local_lr)
                            else:
                                grads, batch_stats, loss, _ = \
                                    self._grad_step(params, batch_stats,
                                                    xb, yb, gen)
                            if _csp.ctx is not None:
                                # Tracing: attribute device time to THIS
                                # span, not to the codec's first sync.
                                self._sync_device()
                        if self._nan_step is not None and \
                                self.result.local_steps_completed \
                                == self._nan_step:
                            grads, loss = self._inject_nan(grads, accum,
                                                           loss)
                        if self._compute_faults is not None:
                            # Deterministic straggler injection: the sleep
                            # lands inside the step timing, so the health
                            # report's throughput and the straggler_lag
                            # rule see it like real slow compute.
                            self._compute_faults.maybe_delay_compute()
                        self._tm_step_s.observe(_tnow() - t_step)
                        self._tm_steps.inc()
                        self.result.local_steps_completed += 1
                        loss_sum = loss if loss_sum is None \
                            else loss_sum + loss
                        n_loss += 1

                        if local_sgd:
                            accum_n += 1
                            if accum_n == k:
                                self._note_health(loss, accum, epoch,
                                                  grad_scale=1.0 / accum_n)
                                params, fetched_step = \
                                    self._dispatch_push_mean(
                                        worker_id, accum, accum_n,
                                        fetched_step, params)
                                worker_id = self.result.worker_id
                                accum, accum_n = None, 0
                        elif cfg.k_step_mode == "accumulate" and k > 1:
                            accum = grads if accum is None else \
                                {n: accum[n] + g for n, g in grads.items()}
                            accum_n += 1
                            if accum_n == k:
                                self._note_health(loss, accum, epoch,
                                                  grad_scale=1.0 / accum_n)
                                params, fetched_step = \
                                    self._dispatch_push_mean(
                                        worker_id, accum, accum_n,
                                        fetched_step, params)
                                worker_id = self.result.worker_id
                                accum, accum_n = None, 0
                        elif boundary:
                            # Faithful: push THIS batch's gradients; the
                            # other K-1 batches' are dropped (quirk 7).
                            self._note_health(loss, grads, epoch)
                            params, fetched_step = self._dispatch_push(
                                worker_id, grads, fetched_step, params)
                            worker_id = self.result.worker_id
                    gp.tick_wall()
                    if self._draining or self._epoch_break:
                        # Directive: stop this epoch's batch loop at the
                        # step boundary (rebalance_shard resumes with a
                        # fresh shard next epoch; drain exits the run after
                        # the epoch's bookkeeping).
                        break

                # An epoch ending mid-window flushes the partial window,
                # divided by the ACTUAL number of accumulated batches.
                if accum is not None:
                    self._note_health(loss, accum, epoch,
                                      grad_scale=1.0 / accum_n)
                    params, fetched_step = self._dispatch_push_mean(
                        worker_id, accum, accum_n, fetched_step, params)
                    worker_id = self.result.worker_id
                    accum, accum_n = None, 0
                if self._pipe is not None:
                    # Epoch barrier: the epoch's last push is ON the
                    # server before the epoch closes; the prefetch RESULT
                    # survives into the next epoch's opening fetch.
                    try:
                        self._pipe.flush()
                    except Exception as e:  # noqa: BLE001 — session recovery
                        params, fetched_step = self._recover_session(e)
                        worker_id = self.result.worker_id
                self.result.epoch_times.append(time.time() - t_epoch)
                if n_loss:
                    self.result.train_loss_per_epoch.append(
                        float(loss_sum) / n_loss)
                self._tm_epochs.inc()
                if cfg.eval_each_epoch:
                    with trace_span("worker.eval", root=True,
                                    worker=worker_id, epoch=epoch), \
                            self._gp("compute"):
                        self.result.test_accuracies.append(
                            self.evaluate(params, batch_stats))
                    self._tm_acc.set(self.result.test_accuracies[-1])
                acc = (f", test_acc={self.result.test_accuracies[-1]:.4f}"
                       if self.result.test_accuracies else "")
                print(f"EPOCH_DONE worker={self.worker_name} id={worker_id} "
                      f"epoch={epoch + 1}/{cfg.num_epochs} "
                      f"time={self.result.epoch_times[-1]:.1f}s{acc}",
                      flush=True)
                gp.tick_wall()
                if self._draining:
                    print(f"DRAINED worker={self.worker_name} "
                          f"id={worker_id} epoch={epoch + 1}", flush=True)
                    break
        finally:
            gp.tick_wall()
            if self._pipe is not None:
                self._pipe.close()

    # -- session resume ------------------------------------------------------

    @staticmethod
    def _session_lost(exc):
        """The SessionLostError behind ``exc`` (direct, or carried as the
        ``__cause__`` of a comms-pipeline RuntimeError), else None."""
        from ..comms.client import SessionLostError
        if isinstance(exc, SessionLostError):
            return exc
        cause = getattr(exc, "__cause__", None)
        if isinstance(cause, SessionLostError):
            return cause
        return None

    def _repush_viable(self, old_fetched: int, server_step: int) -> bool:
        """Worker-side half of the staleness semantics for a gradient
        stranded by a session loss: never push one whose basis is AHEAD of
        the restored server, nor one the async staleness gate would reject
        anyway. Sync mode accepts any contribution (quirk 2)."""
        if server_step < old_fetched:
            return False
        cfg = getattr(self.store, "config", None)
        if getattr(cfg, "mode", "sync") == "async":
            bound = getattr(cfg, "staleness_bound", DEFAULT_STALENESS_BOUND)
            return server_step - old_fetched <= bound
        return True

    def _reconcile_inflight(self, worker_id: int, inflight,
                            server_step: int) -> str:
        """Decide the fate of the gradient that was mid-push when the
        session died: discard (stale or rewound basis) or re-push. The
        re-push prefers the client's recorded request — the SAME
        exactly-once token, so a push the server already applied replays
        as a duplicate instead of applying twice."""
        grads, old_fetched = inflight
        if not self._repush_viable(old_fetched, server_step):
            return "discarded"
        repush = getattr(self.store, "repush_last", None)
        if callable(repush):
            accepted = repush(worker_id)
            if accepted is not None:
                if accepted:
                    self.result.pushes_accepted += 1
                else:
                    self.result.pushes_rejected += 1
                return "repushed"
        # No recorded request to replay (an in-process store): a fresh
        # push with the original basis step.
        self._push(worker_id, grads, old_fetched)
        return "repushed"

    def _recover_session(self, exc, inflight=None):
        """The reconnect state machine: on SessionLostError, drain the
        comms pipeline, re-register (under elastic membership the lowest
        free slot), re-fetch params at the restored server step, reconcile
        the in-flight gradient and rebuild the pipeline — each attempt on
        a fresh channel, within ``reconnect_timeout`` seconds, the backoff
        doubling from ``reconnect_backoff`` up to 10 s. With resume off
        (0) ``exc`` is re-raised unchanged. Returns the fresh ``(params,
        fetched_step)``."""
        lost = self._session_lost(exc)
        cfg = self.config
        if lost is None or cfg.reconnect_timeout <= 0:
            raise exc
        if self._pipe is not None:
            # Capture the failed push (if that is what died), then retire
            # the comms thread; a fresh one starts with the new session.
            failed = self._pipe.take_failed_item()
            if inflight is None:
                inflight = failed
            try:
                self._pipe.close()
            except Exception:  # noqa: BLE001 — teardown must not mask
                pass
            self._pipe = None
        old_id = self.result.worker_id
        deadline = time.time() + cfg.reconnect_timeout
        delay = cfg.reconnect_backoff
        attempts = 0
        with trace_span("worker.reconnect", root=True,
                        worker=old_id) as sp, \
                self._gp("reconnect_recovery"):
            while True:
                attempts += 1
                try:
                    reset = getattr(self.store, "reset_channel", None)
                    if callable(reset):
                        reset()
                    # One registration attempt per turn of THIS backoff
                    # loop (the client's own x5 would overrun the window).
                    if hasattr(self.store, "register_retries"):
                        worker_id, _ = self.store.register_worker(
                            self.worker_name, retries=1)
                    else:
                        worker_id, _ = self.store.register_worker(
                            self.worker_name)
                    # A FULL fetch: the old session's delta basis is gone.
                    params, fetched_step = self._fetch_params(worker_id)
                    outcome = "none"
                    if inflight is not None:
                        outcome = self._reconcile_inflight(
                            worker_id, inflight, fetched_step)
                    break
                except ConnectionError as e:
                    if time.time() + delay > deadline:
                        sp.attrs["outcome"] = "gave_up"
                        from ..comms.client import SessionLostError
                        raise SessionLostError(
                            f"reconnect window "
                            f"({cfg.reconnect_timeout:.0f}s) exhausted "
                            f"after {attempts} attempts: {e}") from lost
                    time.sleep(delay)
                    delay = min(delay * 2.0, RECONNECT_BACKOFF_CAP_S)
            self.result.worker_id = worker_id
            self.result.reconnects += 1
            self._tm_reconnect.inc()
            sp.attrs.update(attempts=attempts, new_worker_id=worker_id,
                            inflight=outcome)
            if cfg.overlap:
                self._pipe = _CommsPipeline(self, worker_id)
        print(f"RECONNECTED worker={self.worker_name} old_id={old_id} "
              f"new_id={worker_id} server_step={fetched_step} "
              f"attempts={attempts} inflight={outcome}", flush=True)
        return params, fetched_step

    # -- fetch and push dispatch ---------------------------------------------

    def _boundary_fetch(self, worker_id: int, fetched_step: int, params):
        """The (pipeline-aware) boundary params fetch, resuming the
        session on failure: the pending prefetch's result when the
        pipeline issued one, else a delta-gated fetch once params are
        held. A pending ``refetch_params`` directive bypasses the delta
        basis (and any prefetched result) with a full fresh fetch.
        Returns (params, fetched step)."""
        try:
            with self._gp("fetch_wait"):
                pipe = self._pipe
                if pipe is not None and pipe.params_pending():
                    # Issued right after the window's push: its latency
                    # ran under the window's compute.
                    result = pipe.await_params()
                    if not self._force_full_fetch:
                        self._poll_directives()
                        if not self._force_full_fetch:
                            return result
                elif pipe is not None:
                    pipe.flush()  # a fetch must never overtake a push
                if self._force_full_fetch:
                    self._force_full_fetch = False
                    result = self._fetch_params(worker_id)
                else:
                    result = self._fetch_params(
                        worker_id,
                        have_step=fetched_step if params is not None
                        else None,
                        current=params)
                self._poll_directives()
                return result
        except Exception as e:  # noqa: BLE001 — session recovery
            return self._recover_session(e)

    def _dispatch_push(self, worker_id: int, grads: dict,
                       fetched_step: int, params):
        """Push now (serial) or hand to the comms pipeline with a prefetch
        of the next params riding behind it (overlapped). Returns the
        (params, fetched_step) the loop continues with: unchanged on the
        happy path, the restored server state after a session resume.

        Overlapped, a quantized push is ENCODED here, on the training
        thread: K1 runs in program order before the next window's
        gradients touch the error-feedback residual, and the comms thread
        only waits for the packed bytes' copy (``finalize``). Under a
        quarantine directive the window's push is skipped."""
        if self._skip_quarantined_push():
            return params, fetched_step
        with trace_span("worker.push_wait"), self._gp("push_wait"):
            item = grads
            try:
                if self._pipe is None:
                    self._push(worker_id, grads, fetched_step)
                else:
                    payload = self._encode_device(grads)
                    if payload is not None:
                        item = payload
                    self._pipe.submit(item, fetched_step,
                                      prefetch_current=params)
                self._poll_directives()
                return params, fetched_step
            except Exception as e:  # noqa: BLE001 — push recovery
                return self._recover_push(e, item, fetched_step)

    def _dispatch_push_mean(self, worker_id: int, accum: dict, n: int,
                            fetched_step: int, params):
        """:meth:`_dispatch_push` of a window's mean."""
        return self._dispatch_push(worker_id, _window_mean(accum, n),
                                   fetched_step, params)

    def _recover_push(self, exc, grads, fetched_step: int):
        """Session recovery from a push dispatch. Serial: THIS push died
        mid-RPC and is the in-flight gradient to reconcile. Pipelined:
        ``submit`` surfaced a PREVIOUS item's failure (reconciled from the
        pipeline's failed slot) and this window's gradients never left —
        they are sent after the resume if still viable."""
        pipelined = self._pipe is not None
        inflight = None if pipelined else (grads, fetched_step)
        params, new_step = self._recover_session(exc, inflight=inflight)
        if pipelined and self._repush_viable(fetched_step, new_step):
            try:
                self._push(self.result.worker_id, grads, fetched_step)
            except Exception as e2:  # noqa: BLE001 — double-flap handoff
                # The server flapped AGAIN: this push is the in-flight
                # gradient of a new session loss.
                params, new_step = self._recover_session(
                    e2, inflight=(grads, fetched_step))
        return params, new_step

    def _fetch_params(self, worker_id: int, have_step: int | None = None,
                      current=None):
        """One FetchParameters round trip -> (flat params on the device,
        fetched step). A NOT_MODIFIED delta reply hands back ``current``
        unchanged — the params a full refetch would have returned, since
        the canonical step didn't move."""
        use_delta = (have_step is not None and current is not None
                     and self.config.delta_fetch
                     and getattr(self.store, "supports_delta_fetch", False))
        if use_delta:
            flat, fetched_step = self.store.fetch(worker_id,
                                                  have_step=have_step)
            if not flat and fetched_step == have_step:
                self._tm_fetch_nm.inc()
                return current, fetched_step
        else:
            flat, fetched_step = self.store.fetch(worker_id)
        with trace_span("worker.codec", stage="decode"), self._gp("codec"):
            if (getattr(self.store, "fetch_codec", "none")
                    in ("fp16", "bf16")
                    and not getattr(self.store, "decompresses_fetches",
                                    False)):
                # In-process compressed fetch (a RemoteStore decompressed
                # it already).
                flat = fp16_decompress(flat)
            if getattr(self.store, "keeps_device_arrays", False):
                # The store's tensors, already on this device: no bytes
                # moved, none counted.
                params = flat
            else:
                self._tm_fetch_post.inc(
                    sum(int(np.asarray(v).nbytes) for v in flat.values()))
                params = self._upload(flat)
        self._last_fetched_step = fetched_step
        return params, fetched_step

    def _upload(self, flat: dict) -> dict:
        """Fetched fp32 arrays as tensors on the worker's device. On a
        card each array is copied once into pinned host memory and
        uploaded with a non-blocking copy on the calling thread's current
        stream (the comms thread's side stream when pipelined); a
        RemoteStore's arrays are read-only views into the reply, which
        torch cannot wrap, so the CPU path copies those once."""
        if self.device.type != "cuda":
            out = {}
            for k, v in flat.items():
                a = np.asarray(v, np.float32)
                out[k] = torch.as_tensor(a if a.flags.writeable
                                         else a.copy())
            return out
        out = {}
        for k, v in flat.items():
            a = np.asarray(v, np.float32)
            h = torch.empty(a.shape, dtype=torch.float32, pin_memory=True)
            h.numpy()[...] = a
            out[k] = h.to(self.device, non_blocking=True)
        return out

    def _gradient_scales(self) -> dict:
        """The store's per-layer absmax table (shared-scale quantization);
        empty degrades to per-push scales."""
        scales, _ = self.store.gradient_scales()
        return scales

    def _encode_device(self, grads: dict) -> DevicePayload | None:
        """Device encode of a quantized push (K1 on the card), or None for
        the fp16 and uncompressed codecs."""
        if self._device_codec is None:
            return None
        return self._device_codec.encode(
            grads, plan=self._bitwidth.plan(grads),
            scales=self._gradient_scales())

    def _note_d2h_overlap(self, seconds: float) -> None:
        """Record device->host pull seconds that ran on the comms thread
        — time the training thread did NOT block on."""
        pipe = self._pipe
        if pipe is not None and threading.current_thread() is pipe._thread:
            self._tm_d2h_saved.observe(seconds)

    def _encode_for_wire(self, grads) -> dict:
        """The push's wire payload (NumPy arrays), with the push-byte
        counters."""
        t0 = _tnow()
        payload = grads if isinstance(grads, DevicePayload) \
            else None if isinstance(grads, _StagedGrads) \
            else self._encode_device(grads)
        if payload is not None:
            # Quantize/pack ran on the worker's device against the
            # store's shared scales, with error feedback; finalize
            # waits for the wire bytes' copy to the host.
            t1 = _tnow()
            flat = self._device_codec.finalize(payload)
            self._note_d2h_overlap(_tnow() - t1)
            self._tm_codec_s.observe(payload.encode_seconds
                                     + _tnow() - t1)
            pre_bytes = payload.pre_bytes
        else:
            # fp16 or uncompressed push: the reference's host cast
            # (worker.py:264-268); a quantized push with device_codec
            # off: the NumPy encode.
            staged = grads if isinstance(grads, _StagedGrads) \
                else _stage_to_host(grads)
            flat = staged.numpy()
            self._note_d2h_overlap(_tnow() - t0)
            pre_bytes = sum(int(v.nbytes) for v in flat.values())
            codec = self.store.push_codec
            t1 = _tnow()
            if codec == "fp16":
                flat = fp16_compress(flat)
                self._tm_codec_s.observe(_tnow() - t1)
            elif codec in QUANTIZED_PUSH_CODECS:
                flat = compress_push(
                    flat, self._bitwidth.plan(flat),
                    scales=self._gradient_scales(), ef=self._ef,
                    topk_frac=self.config.topk_frac)
                self._tm_codec_s.observe(_tnow() - t1)
        wire_bytes = sum(int(v.nbytes) for v in flat.values())
        self._tm_push_pre.inc(pre_bytes)
        self._tm_push_wire.inc(wire_bytes)
        self._tm_push_saved.inc(max(0, pre_bytes - wire_bytes))
        if pre_bytes:
            self._tm_push_bits.set(
                round(wire_bytes * 32.0 / pre_bytes, 3))
        return flat

    def _push(self, worker_id: int, grads, fetched_step: int) -> None:
        """Encode (unless done at dispatch) and push. ``grads`` is a dict
        of tensors, a DevicePayload encoded at dispatch, or gradients
        whose host copies were started at dispatch. A device-resident
        store takes the tensors untouched: no host round trip, no wire,
        no codec."""
        with trace_span("worker.codec", stage="encode"), self._gp("codec"):
            flat = grads if getattr(self.store, "keeps_device_arrays",
                                    False) \
                else self._encode_for_wire(grads)
        t0 = _tnow()
        if self.store.push(worker_id, flat, fetched_step):
            self.result.pushes_accepted += 1
        else:
            self.result.pushes_rejected += 1
        done = _tnow()
        if self._bitwidth is not None and self._prev_push_done is not None:
            self._bitwidth.note_push(done - t0, done - self._prev_push_done)
        self._prev_push_done = done

    def evaluate(self, params: dict, batch_stats: dict) -> float:
        """Full test-set top-1 (worker.py:313-331), the test set uploaded
        to the device once per worker."""
        if self._test_cache is None:
            self._test_cache = (
                torch.as_tensor(self.dataset.x_test, device=self.device),
                torch.as_tensor(self.dataset.y_test.astype(np.int64),
                                device=self.device))
        x_te, y_te = self._test_cache
        bs = self.config.eval_batch_size
        correct, total = None, 0
        for i in range(0, len(x_te), bs):
            c, t = self._eval_step(params, batch_stats, x_te[i:i + bs],
                                   y_te[i:i + bs])
            correct = c if correct is None else correct + c
            total += t
        return (int(correct) if correct is not None else 0) / max(total, 1)


def run_workers(store: ParameterStore, model: torch.nn.Module,
                dataset: Dataset, n_workers: int,
                config: WorkerConfig | None = None,
                timeout: float | None = None) -> list[WorkerResult]:
    """Spawn N worker threads, each over its own copy of ``model``; join
    them all. The in-process equivalent of launching N worker tasks
    (terraform/main.tf:387-435). With a ``worker_timeout`` a reaper
    expires silent workers, so elastic rounds shrink instead of wedging
    on a dead one. Raises the first worker error."""
    config = config or WorkerConfig()
    workers = [PSWorker(store, model, dataset, config,
                        worker_name=f"worker-{i}")
               for i in range(n_workers)]
    for w in workers:
        w.start()
    reaper_stop = threading.Event()
    wt = getattr(store.config, "worker_timeout", None)
    if wt:
        def _reap():
            while not reaper_stop.wait(wt / 2):
                expired = store.expire_stale_workers()
                if expired:
                    print(f"expired silent workers: {expired}")
        threading.Thread(target=_reap, daemon=True).start()
    try:
        for w in workers:
            w.join(timeout)
    finally:
        reaper_stop.set()
    for w in workers:
        if w.result.error is not None:
            raise w.result.error
    return [w.result for w in workers]
