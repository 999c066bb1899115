"""Async-mode worker runtime of the port: threads driving local steps on
the card against the in-process parameter store.

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
``'accumulate'`` pushes the window's mean.

Host batches are uploaded ``prefetch_batches`` ahead of the step
(``train/device_loop.py:prefetch_to_device``), bitwise the same batches.

Not in this slice, each refused with ``NotImplementedError`` when its
config field asks for it: the overlapped comms pipeline (``overlap``),
``local_sgd``, the heartbeat, session resume (``reconnect_timeout``) and
NaN injection. Health reports and server directives ride the gRPC store,
which a later slice ports.
"""

from __future__ import annotations

import copy
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from ..data.cifar import Dataset, make_batches, shard_range
from ..ops.compression import QUANTIZED_PUSH_CODECS, fp16_compress
from ..ops.device_codec import DeviceCodec
from ..telemetry import GoodputAccount, now as _tnow, trace_span
from ..train.device_loop import prefetch_to_device
from ..train.steps import make_eval_step, make_grad_step
from ..utils.device import resolve_device
from ..utils.pytree import flax_names
from .store import ParameterStore

_NULL_GP = nullcontext()


@dataclass
class WorkerConfig:
    batch_size: int = 128      # worker.py:474-482 distributed defaults
    num_epochs: int = 3
    sync_steps: int = 1        # K; CLI default 1 (worker.py:468)
    k_step_mode: str = "faithful"   # 'faithful' | 'accumulate'
    augment: bool = True
    eval_batch_size: int = 1000
    eval_each_epoch: bool = True   # worker.py:393-394
    seed: int = 0
    # Version-gated delta fetches: refetches send have_step so a store
    # whose step hasn't advanced answers NOT_MODIFIED and the worker keeps
    # the params it already holds.
    delta_fetch: bool = True
    # Error feedback for the quantized push codecs: each push's
    # quantization residual is carried into the next step's gradient.
    error_feedback: bool = True
    # Fraction of entries a 'topk' push keeps per tensor.
    topk_frac: float = 0.01
    device: str = "cuda"
    # Fields of the JAX worker whose features come with later slices;
    # any value but the default raises NotImplementedError.
    overlap: bool = False
    heartbeat_interval: float = 0.0
    reconnect_timeout: float = 0.0
    nan_inject_step: int | None = None
    # Host->device input double buffering: this many batches' uploads in
    # flight ahead of the step (train/device_loop.py prefetch_to_device);
    # 0 feeds host batches directly.
    prefetch_batches: int = 2

    def __post_init__(self):
        if self.k_step_mode == "local_sgd":
            raise NotImplementedError(
                "k_step_mode='local_sgd' is not ported yet")
        if self.k_step_mode not in ("faithful", "accumulate"):
            raise ValueError(self.k_step_mode)
        if self.sync_steps < 1:
            raise ValueError("sync_steps must be >= 1")
        later = {"overlap": self.overlap,
                 "heartbeat_interval": self.heartbeat_interval,
                 "reconnect_timeout": self.reconnect_timeout,
                 "nan_inject_step": self.nan_inject_step is not None}
        asked = [k for k, v in later.items() if v]
        if asked:
            raise NotImplementedError(
                f"worker option(s) {asked} are not ported yet")
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
    error: Exception | None = None

    def metrics(self, total_workers: int, learning_rate: float,
                config: WorkerConfig) -> dict:
        """METRICS_JSON field parity with worker.py:421-434."""
        return {
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
            "reconnects": 0,
        }


def _window_mean(accum: dict, n: int) -> dict:
    """Mean of an accumulated K-step gradient window: a true division by
    ``n`` (a tensor divisor, never a host scalar's reciprocal)."""
    return {k: a / torch.tensor(n, dtype=torch.float32, device=a.device)
            for k, a in accum.items()}


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
        self._bitwidth: _BitwidthController | None = None
        self._device_codec: DeviceCodec | None = None
        self._prev_push_done: float | None = None
        self._goodput: GoodputAccount | None = None
        self._test_cache = None
        self._grad_step = make_grad_step(self.model,
                                         augment=self.config.augment)
        self._eval_step = make_eval_step(self.model)

    # -- the training loop (worker.py:350-403) ------------------------------

    def run(self) -> None:
        try:
            self._run()
        except Exception as e:  # noqa: BLE001 — surfaced via .result
            self.result.error = e
        finally:
            if self.result.worker_id >= 0:
                self.store.job_finished(self.result.worker_id)

    def _compute_shard(self, worker_id: int, total_workers: int):
        """This worker's contiguous data shard (worker.py:166-179), split
        by registration id."""
        n = len(self.dataset.x_train)
        lo, hi = shard_range(n, worker_id % total_workers, total_workers)
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
        self._tm_push_saved = reg.counter(
            "dps_worker_push_bytes_saved_total", worker=w)
        self._tm_push_bits = reg.gauge("dps_worker_push_bitwidth", worker=w)
        self._tm_codec_s = reg.histogram("dps_worker_codec_seconds",
                                         worker=w)
        self._goodput = GoodputAccount(reg)

    def _gp(self, category: str):
        """Goodput bracket for the training thread's wall."""
        return _NULL_GP if self._goodput is None \
            else self._goodput.span(category)

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
            self._device_codec = DeviceCodec(
                error_feedback=cfg.error_feedback,
                topk_frac=cfg.topk_frac, device=self.device)

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

        gp = self._goodput
        gp.add("startup", _tnow() - t_run0)
        gp.start_wall(t_run0)
        try:
            for epoch in range(cfg.num_epochs):
                t_epoch = time.time()
                with trace_span("worker.step", root=True, worker=worker_id,
                                step=self.result.local_steps_completed,
                                epoch=epoch, epoch_open=True):
                    with trace_span("worker.fetch_wait"):
                        params, fetched_step = self._boundary_fetch(
                            worker_id, fetched_step, params)
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
                        t_step = _tnow()
                        with trace_span("worker.compute") as _csp, \
                                self._gp("compute"):
                            grads, batch_stats, loss, _ = self._grad_step(
                                params, batch_stats, xb, yb, gen)
                            if _csp.ctx is not None:
                                # Tracing: attribute device time to THIS
                                # span, not to the codec's first sync.
                                self._sync_device()
                        self._tm_step_s.observe(_tnow() - t_step)
                        self._tm_steps.inc()
                        self.result.local_steps_completed += 1
                        loss_sum = loss if loss_sum is None \
                            else loss_sum + loss
                        n_loss += 1

                        if cfg.k_step_mode == "accumulate" and k > 1:
                            accum = grads if accum is None else \
                                {n: accum[n] + g for n, g in grads.items()}
                            accum_n += 1
                            if accum_n == k:
                                self._dispatch_push(
                                    worker_id, _window_mean(accum, accum_n),
                                    fetched_step)
                                accum, accum_n = None, 0
                        elif boundary:
                            # Faithful: push THIS batch's gradients; the
                            # other K-1 batches' are dropped (quirk 7).
                            self._dispatch_push(worker_id, grads,
                                                fetched_step)
                    gp.tick_wall()

                # An epoch ending mid-window flushes the partial window,
                # divided by the ACTUAL number of accumulated batches.
                if accum is not None:
                    self._dispatch_push(worker_id,
                                        _window_mean(accum, accum_n),
                                        fetched_step)
                    accum, accum_n = None, 0
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
        finally:
            gp.tick_wall()

    def _boundary_fetch(self, worker_id: int, fetched_step: int, params):
        """The boundary params fetch (delta-gated once params are held)."""
        with self._gp("fetch_wait"):
            return self._fetch_params(
                worker_id,
                have_step=fetched_step if params is not None else None,
                current=params)

    def _dispatch_push(self, worker_id: int, grads: dict,
                       fetched_step: int) -> None:
        with trace_span("worker.push_wait"), self._gp("push_wait"):
            self._push(worker_id, grads, fetched_step)

    def _fetch_params(self, worker_id: int, have_step: int | None = None,
                      current=None):
        """One FetchParameters round trip -> (flat params on the device,
        fetched step). A NOT_MODIFIED delta reply hands back ``current``
        unchanged — the params a full refetch would have returned, since
        the canonical step didn't move."""
        use_delta = (have_step is not None and current is not None
                     and self.config.delta_fetch)
        if use_delta:
            flat, fetched_step = self.store.fetch(worker_id,
                                                  have_step=have_step)
            if not flat and fetched_step == have_step:
                self._tm_fetch_nm.inc()
                return current, fetched_step
        else:
            flat, fetched_step = self.store.fetch(worker_id)
        with trace_span("worker.codec", stage="decode"), self._gp("codec"):
            self._tm_fetch_post.inc(
                sum(int(np.asarray(v).nbytes) for v in flat.values()))
            params = {k: torch.as_tensor(np.asarray(v, np.float32),
                                         device=self.device)
                      for k, v in flat.items()}
            return params, fetched_step

    def _gradient_scales(self) -> dict:
        """The store's per-layer absmax table (shared-scale quantization);
        empty degrades to per-push scales."""
        scales, _ = self.store.gradient_scales()
        return scales

    def _push(self, worker_id: int, grads: dict, fetched_step: int) -> None:
        with trace_span("worker.codec", stage="encode"), self._gp("codec"):
            t0 = _tnow()
            if self._device_codec is not None:
                # Quantized codec: quantize/pack ran on the worker's device
                # against the store's shared scales, with error feedback;
                # finalize waits for the wire bytes' copy to the host.
                plan = self._bitwidth.plan(grads)
                payload = self._device_codec.encode(
                    grads, plan=plan, scales=self._gradient_scales())
                flat = self._device_codec.finalize(payload)
                self._tm_codec_s.observe(payload.encode_seconds
                                         + _tnow() - t0)
                pre_bytes = payload.pre_bytes
            else:
                # fp16 or uncompressed push: the reference's host cast
                # (worker.py:264-268).
                flat = {k: v.detach().to("cpu").numpy()
                        for k, v in grads.items()}
                pre_bytes = sum(int(v.nbytes) for v in flat.values())
                if self.store.push_codec == "fp16":
                    flat = fp16_compress(flat)
                    self._tm_codec_s.observe(_tnow() - t0)
            wire_bytes = sum(int(v.nbytes) for v in flat.values())
            self._tm_push_pre.inc(pre_bytes)
            self._tm_push_wire.inc(wire_bytes)
            self._tm_push_saved.inc(max(0, pre_bytes - wire_bytes))
            if pre_bytes:
                self._tm_push_bits.set(
                    round(wire_bytes * 32.0 / pre_bytes, 3))
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
    (terraform/main.tf:387-435). Raises the first worker error."""
    config = config or WorkerConfig()
    workers = [PSWorker(store, model, dataset, config,
                        worker_name=f"worker-{i}")
               for i in range(n_workers)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout)
    for w in workers:
        if w.result.error is not None:
            raise w.result.error
    return [w.result for w in workers]
