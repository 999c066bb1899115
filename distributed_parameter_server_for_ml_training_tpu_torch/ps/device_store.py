"""Device-resident parameter store: the async/sync PS with params on the card.

The JAX package's ``ps/device_store.py``, ported. :class:`~.store.
ParameterStore` keeps the canonical params on the host as NumPy, so every
in-process worker step moves the full ~45 MB of parameters and gradients
across the host link. This store keeps them on the store's device:

- canonical parameters are a flat ``{name: fp32 tensor}`` dict on the
  device;
- ``fetch`` returns *references* to the current tensors, zero bytes
  moved. Torch tensors are mutable where jax arrays are not, so the store
  never writes a tensor it has handed out: every update is computed out
  of place (``torch._foreach_add``, not ``_foreach_add_``) and the dict
  is rebound under ``_param_lock``. A fetched snapshot therefore stays
  consistent while later pushes apply, the JAX store's semantics, at the
  cost of one param-sized allocation an update (the caching allocator
  reuses it). Copying on fetch would move 44.9 MB a fetch instead;
- ``push`` takes the gradient tensors as the worker's step left them
  (NumPy arrays are uploaded once) and applies the update on the device,
  zero bytes moved.

The sync/async orchestration (rounds, bounded staleness, elastic expiry,
metrics) is :class:`~.store.AggregationBase`'s, shared with the host
store; only the update ops differ. The JAX store jits them; here they
are ``torch._foreach_*`` ops over the store's tensor list. ``p - scale *
g`` is one rounding (``_foreach_add`` with ``alpha``): XLA's CPU jit
contracts the JAX store's update into a fused multiply-add, and the
card's add kernel does the same. A full sync round sums the workers'
gradients in worker order and divides once, as ``jnp.mean`` does, with
no stacked copy. An update rebuilds the dict with its keys sorted, as a
jitted function's dict output is.

Streams: the store issues its work on a stream of its own. A push makes
that stream wait on an event recorded on the pusher's current stream (a
comms thread's side stream under ``overlap=True``) and
``record_stream``\\ s the gradients on it; a fetch makes the fetcher's
stream wait on the store's and ``record_stream``\\ s the tensors it hands
out, so the caching allocator reuses no memory another stream still
reads. Update times are sampled: every ``wait_every``-th update
synchronizes on an event after it (outside the lock), the other updates
record no timing.

No wire codec applies (``push_codec='none'``): nothing crosses a wire.
"""

from __future__ import annotations

import threading
import time
import warnings
from contextlib import nullcontext
from typing import Mapping

import numpy as np
import torch

from ..telemetry import now as _tnow, trace_span
from ..utils.device import resolve_device
from .store import AggregationBase, StoreConfig, _Stats


class DeviceParameterStore(AggregationBase):
    """Thread-safe parameter store whose tensors stay on ``device``.

    API-compatible with :class:`~.store.ParameterStore` for in-process
    workers (register/fetch/push/job_finished/metrics), with
    ``keeps_device_arrays = True`` advertising that fetch returns tensors
    and push takes them (PSWorker skips its host round trip). It runs on
    the card unless ``device="cpu"`` is asked for."""

    keeps_device_arrays = True
    store_backend = "device"
    push_codec = "none"
    fetch_codec = "none"
    supports_delta_fetch = False

    # AggregationBase's contracts re-declared, plus the sampling counter.
    parameters: dict  # guarded by: self._param_lock
    global_step: int  # guarded by: self._param_lock
    last_seen: dict  # guarded by: self._registration_lock
    _updates_since_wait: int  # guarded by: self._wait_lock

    #: Synchronize with the device every Nth update. Correctness never
    #: needs the wait (the store's stream orders its updates); the update
    #: times do. Each recorded entry measures the real completion of all
    #: updates queued since the last sample.
    wait_every = 8

    def __init__(self, initial_params: Mapping, config: StoreConfig | None
                 = None, device: str | torch.device = "cuda"):
        self.config = config or StoreConfig()
        if self.config.push_codec not in (None, "none"):
            # An EXPLICITLY requested codec cannot apply: nothing crosses a
            # wire, so gradients skip the fp16 quantization the python
            # backend applies. Said, not silently ignored.
            warnings.warn(
                f"DeviceParameterStore ignores push_codec="
                f"{self.config.push_codec!r}: device-resident pushes are "
                f"uncompressed fp32 (no wire); gradients skip the fp16 "
                f"quantization the python/native backends apply",
                stacklevel=2)
        if self.config.fetch_codec != "none":
            warnings.warn(
                f"DeviceParameterStore ignores fetch_codec="
                f"{self.config.fetch_codec!r}: fetches hand back device "
                f"arrays directly (no wire to compress)", stacklevel=2)
        self.device = resolve_device(device)
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self.parameters = self._to_store(initial_params)
        self.global_step = 0

        self._param_lock = threading.Lock()
        self._sync_lock = threading.Lock()
        self._registration_lock = threading.Lock()
        self._wait_lock = threading.Lock()
        self._updates_since_wait = 0

        self._next_worker_id = 0
        self.active_workers: set[int] = set()
        self.last_seen: dict[int, float] = {}

        self._pending: dict[int, dict[str, torch.Tensor]] = {}
        self._gradients_received = 0

        self.stats = _Stats()
        self._finished_event = threading.Event()
        self._init_telemetry()
        self._init_round_state()

    # -- streams and host edges -------------------------------------------

    def _on_stream(self):
        return torch.cuda.stream(self._stream) if self._stream is not None \
            else nullcontext()

    def _as_tensor(self, v) -> torch.Tensor:
        """``v`` as an fp32 tensor on the store's device, issued on the
        store's stream: a tensor on the device passes through (cast if it
        is not fp32); a NumPy array (a read-only view into a wire reply,
        say) is copied once, into pinned memory, then uploaded."""
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if v.device != self.device or v.dtype != torch.float32:
                v = v.to(self.device, torch.float32)
            return v
        a = np.asarray(v, np.float32)
        if self._stream is None:
            return torch.tensor(a)
        h = torch.empty(a.shape, dtype=torch.float32, pin_memory=True)
        h.numpy()[...] = a
        return h.to(self.device, non_blocking=True)

    def _to_store(self, params: Mapping) -> dict:
        # Private copies: the store never writes its tensors, but a
        # caller may write the tensor it handed in.
        with self._on_stream():
            return {k: (v.detach().to(self.device, torch.float32,
                                      copy=True)
                        if isinstance(v, torch.Tensor)
                        else self._as_tensor(v))
                    for k, v in params.items()}

    def to_host(self, params: Mapping[str, torch.Tensor]
                ) -> dict[str, np.ndarray]:
        """Host NumPy copies of the store's tensors. On a card: one
        device-side concatenation, one copy into pinned memory, then
        views of it, all on the store's stream, waited for here."""
        if self._stream is None:
            return {k: v.detach().clone().numpy() for k, v in params.items()}
        with self._on_stream():
            flat = torch.cat([v.reshape(-1) for v in params.values()]) \
                if params else torch.empty(0, device=self.device)
            host = torch.empty(flat.shape, dtype=torch.float32,
                               pin_memory=True)
            host.copy_(flat, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        done.synchronize()
        buf = host.numpy()
        out, off = {}, 0
        for k, v in params.items():
            n = v.numel()
            out[k] = buf[off:off + n].reshape(tuple(v.shape))
            off += n
        return out

    def _wait_for_pusher(self, grads: Mapping) -> None:
        """The store's stream waits for the pusher's gradient work, and
        the gradients' memory stays theirs until the store's reads."""
        if self._stream is None:
            return
        pusher = torch.cuda.current_stream(self.device)
        if pusher == self._stream:
            return
        ready = torch.cuda.Event()
        ready.record(pusher)
        self._stream.wait_event(ready)
        for g in grads.values():
            if isinstance(g, torch.Tensor) and g.device == self.device:
                g.record_stream(self._stream)

    def _hand_out(self, tensors) -> None:
        """The fetcher's stream waits for the store's updates, and the
        handed-out tensors' memory stays theirs until its reads."""
        if self._stream is None:
            return
        consumer = torch.cuda.current_stream(self.device)
        if consumer == self._stream:
            return
        ready = torch.cuda.Event()
        ready.record(self._stream)
        consumer.wait_event(ready)
        for t in tensors:
            t.record_stream(consumer)

    # -- hot path ------------------------------------------------------------

    # dpslint: hot-path — zero-byte fetch: references, never copies
    def fetch(self, worker_id: int | None = None
              ) -> tuple[dict[str, torch.Tensor], int]:
        """Consistent (params, step) snapshot: references, not copies (the
        store never writes a tensor in place, so the reference's
        copy-under-lock, server.py:222, is free here)."""
        t0 = _tnow()
        with trace_span("store.fetch", backend=self.store_backend):
            with self._param_lock:
                payload = dict(self.parameters)
                step = self.global_step
            self._hand_out(payload.values())
        if worker_id is not None:
            # Under the registration lock: the reaper iterates it.
            with self._registration_lock:
                self.last_seen[worker_id] = time.time()
        self._tm_fetch_s.observe(_tnow() - t0)
        self._tm_fetches.inc()
        return payload, step

    # dpslint: hot-path — device tensors in, device tensors applied
    def push(self, worker_id: int, gradients: Mapping,
             fetched_step: int) -> bool:
        """Accept gradients (tensors on the device, or NumPy arrays); apply
        per the configured mode. Same accept/reject contract as
        ParameterStore.push: sync always accepts, async rejects past the
        staleness bound, a shape mismatch is refused."""
        t0 = _tnow()
        with self._registration_lock:
            self.last_seen[worker_id] = time.time()
        with self._param_lock:
            param_shapes = {k: tuple(v.shape)
                            for k, v in self.parameters.items()}
        for name, g in gradients.items():
            p_shape = param_shapes.get(name)
            if p_shape is not None and p_shape != tuple(g.shape):
                self.stats.gradients_rejected += 1
                self._tm_push_rej.inc()
                print(f"rejecting push from worker {worker_id}: {name} "
                      f"shape {tuple(g.shape)} != server {p_shape}")
                return False
        try:
            with trace_span("store.push",
                            backend=self.store_backend) as sp:
                self._wait_for_pusher(gradients)
                with self._on_stream():
                    grads = {k: self._as_tensor(g)
                             for k, g in gradients.items()}
                if self.config.mode == "sync":
                    accepted = self._push_sync(worker_id, grads,
                                               fetched_step)
                else:
                    accepted = self._push_async(worker_id, grads,
                                                fetched_step)
                sp.attrs["accepted"] = accepted
                return accepted
        finally:
            self._tm_push_s.observe(_tnow() - t0)

    # -- update ops (orchestration in AggregationBase) -----------------------

    @staticmethod
    def _worker_sum(columns: list[list[torch.Tensor]]) -> list[torch.Tensor]:
        """``columns[i]`` is worker i's tensors; their sums, tensor by
        tensor, added in worker order (the order of XLA's reduction over
        the stacked worker axis), with no stacked copy."""
        if len(columns) == 1:
            return list(columns[0])
        total = torch._foreach_add(columns[0], columns[1])
        for col in columns[2:]:
            torch._foreach_add_(total, col)
        return total

    @staticmethod
    def _reciprocal(n: int) -> np.float32:
        """fp32 ``1 / n``: a jitted ``jnp.mean`` over n workers multiplies
        the sum by this constant rather than dividing by n."""
        return np.float32(1) / np.float32(n)

    def _mean(self, grad_dicts: list) -> dict:
        """Mean each parameter over the workers that supplied it
        (server.py:145-169: partial pushes average over their own
        supplier count), as ``jnp.mean`` computes it: the sum times the
        fp32 reciprocal of the count."""
        names = list(dict.fromkeys(n for g in grad_dicts for n in g))
        full = [n for n in names if all(n in g for g in grad_dicts)]
        with torch.no_grad(), self._on_stream():
            mean = {}
            if full:
                mean = dict(zip(full, torch._foreach_mul(
                    self._worker_sum([[g[n] for n in full]
                                      for g in grad_dicts]),
                    float(self._reciprocal(len(grad_dicts))))))
            for n in names:
                if n not in mean:
                    have = [[g[n]] for g in grad_dicts if n in g]
                    mean[n] = self._worker_sum(have)[0] \
                        * float(self._reciprocal(len(have)))
        return mean

    def _updated(self, grads: dict, scale: float) -> dict:
        """New params ``p - scale * g`` for the names in ``grads`` (one
        rounding), the others unchanged, keys sorted as a jitted
        function's dict output is. Caller holds ``_param_lock``."""
        params = self.parameters  # dpslint: ignore[lock-guard]
        names = [k for k in params if k in grads]
        new = dict(params)
        if names:
            with torch.no_grad(), self._on_stream():
                new.update(zip(names, torch._foreach_add(
                    [params[k] for k in names], [grads[k] for k in names],
                    alpha=-scale)))
        return {k: new[k] for k in sorted(new)}

    def _apply(self, grads: dict, lr: float, weight: float = 1.0) -> None:
        # Kernel contract (AggregationBase): callers hold _param_lock. The
        # scale is rounded to fp32 once, as jnp.float32(lr * weight).
        self.parameters = self._updated(  # dpslint: ignore[lock-guard]
            grads, float(np.float32(lr * weight)))

    def _round_update(self, grad_dicts: list, lr: float) -> None:
        """One sync-round update. The full round (every worker supplied
        every param) is the JAX store's fused program: the workers' sum,
        then ``p - (lr * (1/n)) * sum`` in one rounding (XLA folds the
        mean's reciprocal into the scale), no stacked copy. Ragged rounds
        (partial pushes) take the mean, then the apply."""
        names = list(dict.fromkeys(n for g in grad_dicts for n in g))
        if any(n not in g for n in names for g in grad_dicts):
            mean = self._mean(grad_dicts)
            with self._param_lock:
                self._apply(mean, lr)
                self.global_step += 1
            return
        with torch.no_grad(), self._on_stream():
            sums = dict(zip(names, self._worker_sum(
                [[g[n] for n in names] for g in grad_dicts])))
        scale = np.float32(lr) * self._reciprocal(len(grad_dicts))
        with self._param_lock:
            self.parameters = self._updated(sums, float(scale))
            self.global_step += 1

    def _after_apply(self):
        # The counter has its own lock: finish() callables and async
        # pushes run concurrently outside the sync lock.
        with self._wait_lock:
            self._updates_since_wait += 1
            if self._updates_since_wait < self.wait_every:
                return False  # declined: the caller records no timing
            self._updates_since_wait = 0
        if self._stream is not None:
            # Outside _param_lock: blocking on the device under the lock
            # would convoy every concurrent push behind the wait.
            done = torch.cuda.Event()
            done.record(self._stream)
            done.synchronize()
        return True
