"""Device-resident epochs, and input prefetch (counterpart of the JAX
package's ``train/device_loop.py``).

:func:`prefetch_to_device` keeps host batches' uploads in flight ahead of
the consumer: pinned staging buffers, copies on a side stream, and an
event the consumer's stream waits on before it reads a batch.

:class:`DeviceEpochLoop` is the JAX loop's one-program epoch on the card.
The dataset is uploaded once (CIFAR-100's 50,000 uint8 images are 153.6
MB) and each epoch is a device-side permutation of the whole set, then
one captured CUDA graph per step, replayed ``steps_per_epoch`` times with
no host work between replays: the graph reads its row of the
permutation at a device-side slot counter, gathers the uint8 batch,
augments, runs forward and backward, applies the optimizer (whose
learning rate it computes from the state's update count), updates
BatchNorm, and writes the step's loss, accuracy and learning rate (and
augment draws) into that slot. Top-1 on the test set, padded to a
multiple of the eval batch with label -1, runs eagerly on the card, and
the metrics come back once an epoch.

Epoch semantics match ``data/cifar.py``'s host iterator: the full set is
shuffled and ``n // batch_size`` full batches kept, so the ragged tail is
dropped at random each epoch.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..data.cifar import Dataset
from ..utils.device import resolve_device

# Eager iterations on a side stream before capture: cuDNN and cuBLAS pick
# their algorithms and allocate their workspaces outside the graph.
WARMUP_ITERS = 3

# The step metrics a loop records per step, in this order.
METRIC_COLUMNS = ("loss", "accuracy", "learning_rate")


def prefetch_to_device(batches: Iterable, depth: int = 2,
                       device: torch.device | str = "cuda") -> Iterator:
    """Keep ``depth`` host batches' uploads in flight ahead of the
    consumer; yields ``(xb, yb)`` tensors on ``device`` in the source's
    order, bitwise the source's values. ``depth=0`` passes the host
    batches through. On the CPU the batches are wrapped as tensors.

    On CUDA each batch is copied into a pinned staging buffer, then to
    the card on a side stream, and the consumer's stream waits on the
    copy's event before it reads the batch (``record_stream`` keeps the
    allocator from reusing the batch's memory before the consumer is
    done). Each staging buffer is reused only after its copy completed."""
    it = iter(batches)
    if depth <= 0:
        yield from it
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        put, wait = _cuda_uploader(dev, depth)
    else:
        def put(xb, yb):
            return torch.as_tensor(xb, device=dev), \
                torch.as_tensor(yb, device=dev), None

        def wait(event, tensors):
            pass
    buf: deque = deque()
    for xb, yb in it:
        buf.append(put(xb, yb))
        if len(buf) == depth:
            break
    while buf:
        x, y, event = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(*nxt))
        wait(event, (x, y))
        yield x, y


def _cuda_uploader(dev: torch.device, depth: int):
    """``(put, wait)`` for :func:`prefetch_to_device` on a card: ``put``
    stages a host batch in the next of ``depth + 1`` pinned buffer pairs
    (one more than are in flight, since the batch being consumed may
    still be copying) and starts its copy on a side stream."""
    stream = torch.cuda.Stream(dev)
    slots: list = [None] * (depth + 1)
    count = 0

    def pinned(old, src: torch.Tensor) -> torch.Tensor:
        if old is not None and old.shape == src.shape \
                and old.dtype == src.dtype:
            return old
        return torch.empty(src.shape, dtype=src.dtype, pin_memory=True)

    def put(xb, yb):
        nonlocal count
        i = count % len(slots)
        count += 1
        prev = slots[i] or (None, None, None)
        if prev[2] is not None:
            prev[2].synchronize()      # its last copy has left the buffer
        src = [torch.from_numpy(np.ascontiguousarray(a)) for a in (xb, yb)]
        host = [pinned(old, s) for old, s in zip(prev, src)]
        for h, s in zip(host, src):
            h.copy_(s)
        with torch.cuda.stream(stream):
            x, y = (h.to(dev, non_blocking=True) for h in host)
            event = torch.cuda.Event()
            event.record(stream)
        slots[i] = (*host, event)
        return x, y, event

    def wait(event, tensors):
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(event)
        for t in tensors:
            t.record_stream(consumer)

    return put, wait


class DeviceEpochLoop:
    """Device-resident epochs over ``dataset`` (module notes).

    ``step_fn(state, images_u8, labels, generator) -> (state, metrics)``
    is ``train/steps.py:make_train_step`` (or any step with its contract:
    in place, no host copies, 0-dim ``loss`` and ``accuracy`` metrics,
    optional ``learning_rate`` and ``augment_draws``). ``eval_fn(images_u8,
    labels)`` returns the count of correct top-1 predictions as a 0-dim
    tensor. ``generator`` (on the card, or the CPU) draws each epoch's
    permutation and the step's augmentation; its device is the loop's.

    ``graph=None`` captures the step in a CUDA graph on a card and runs it
    uncaptured on the CPU; ``graph=False`` runs it uncaptured on the card
    too (the eager reference the graph is held to). A capture that fails
    raises: the loop never continues eagerly in its place.
    """

    def __init__(self, dataset: Dataset, step_fn: Callable,
                 eval_fn: Callable, *, batch_size: int,
                 generator: torch.Generator, eval_batch_size: int = 1000,
                 graph: bool | None = None):
        self.device = dev = resolve_device(generator.device)
        self.graph = dev.type == "cuda" if graph is None else graph
        if self.graph and dev.type != "cuda":
            raise ValueError("a CUDA graph needs a CUDA generator")
        self.batch_size = bs = batch_size
        self.steps_per_epoch = steps = len(dataset.x_train) // bs
        if steps == 0:
            raise ValueError(f"{len(dataset.x_train)} training images are "
                             f"fewer than one batch of {bs}")
        self._step_fn, self._eval_fn, self._gen = step_fn, eval_fn, generator
        self._n_total = len(dataset.x_train)
        self._x_train = torch.as_tensor(
            np.ascontiguousarray(dataset.x_train), device=dev)
        self._y_train = torch.as_tensor(
            dataset.y_train.astype(np.int64), device=dev)
        # The test set padded to a multiple of the eval batch with label
        # -1: an argmax is never -1, so padding never counts as correct.
        n_te = len(dataset.x_test)
        pad = (-n_te) % eval_batch_size
        x_te = np.concatenate(
            [dataset.x_test,
             np.zeros((pad,) + dataset.x_test.shape[1:], np.uint8)])
        y_te = np.concatenate([dataset.y_test.astype(np.int64),
                               np.full((pad,), -1, np.int64)])
        self._x_test = torch.as_tensor(
            x_te.reshape(-1, eval_batch_size, *x_te.shape[1:]), device=dev)
        self._y_test = torch.as_tensor(y_te.reshape(-1, eval_batch_size),
                                       device=dev)
        self._n_test = n_te
        # What the step reads and writes, allocated once, before capture.
        self._perm = torch.zeros((steps, bs), dtype=torch.int64, device=dev)
        self._slot = torch.zeros((), dtype=torch.int64, device=dev)
        self._metrics = torch.zeros((steps, len(METRIC_COLUMNS)),
                                    dtype=torch.float32, device=dev)
        self._columns: tuple = ()
        # The augment draws of the last epoch's steps [steps, batch, 3]
        # (crop row, crop column, flip); zeros without augmentation.
        self.draws = torch.zeros((steps, bs, 3), dtype=torch.int64,
                                 device=dev)
        self._cuda_graph = None
        self._state = None

    def _body(self, state):
        """One step at the slot counter's row of the permutation."""
        slot = self._slot.view(1)
        idx = self._perm.index_select(0, slot).view(-1)
        xb = self._x_train.index_select(0, idx)
        yb = self._y_train.index_select(0, idx)
        state, m = self._step_fn(state, xb, yb, self._gen)
        self._columns = tuple(c for c in METRIC_COLUMNS if c in m)
        row = torch.stack([m[c].to(torch.float32) for c in self._columns])
        self._metrics[:, :len(row)].index_copy_(0, slot, row[None])
        if "augment_draws" in m:
            self.draws.index_copy_(0, slot, m["augment_draws"][None])
        self._slot.add_(1)
        return state

    def _capture(self, state) -> None:
        """Warm up on a side stream, put back every tensor the warm-up
        moved (state and generator), then capture one step with the
        generator registered, so each replay draws fresh numbers: the ones
        the eager step would draw from the same generator state."""
        tensors = state.tensors()
        saved = [t.clone() for t in tensors]
        gen_state, step = self._gen.get_state(), state.step

        def restore():
            with torch.no_grad():
                for t, s in zip(tensors, saved):
                    t.copy_(s)
            self._gen.set_state(gen_state)
            state.step = step

        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_ITERS):
                self._slot.zero_()
                self._body(state)
        torch.cuda.current_stream(self.device).wait_stream(side)
        restore()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._gen)
        with torch.cuda.graph(graph):
            self._body(state)
        restore()
        self._cuda_graph, self._state = graph, state

    def run_epoch(self, state) -> tuple:
        """One epoch over ``state`` (updated in place; a graphed loop
        always takes the state it captured). Returns ``(state, metrics)``
        with ``train_loss`` and ``train_accuracy`` (means over the steps),
        ``test_accuracy``, the per-step ``loss``, ``accuracy`` and
        ``learning_rate`` lists the step reported, and ``train_seconds``
        (to the end of the last step, eval excluded)."""
        if self._state is not None and state is not self._state:
            raise ValueError("a graphed loop runs the state it captured")
        t0 = time.perf_counter()
        perm = torch.randperm(self._n_total, generator=self._gen,
                              device=self.device)
        self._perm.copy_(perm[:self._perm.numel()].view_as(self._perm))
        steps = self.steps_per_epoch
        if self.graph:
            if self._cuda_graph is None:
                self._capture(state)
            self._slot.zero_()
            for _ in range(steps):
                self._cuda_graph.replay()
            state.step += steps
        else:
            self._slot.zero_()
            for _ in range(steps):
                state = self._body(state)
        per_step = self._metrics.cpu()
        train_seconds = time.perf_counter() - t0
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for xb, yb in zip(self._x_test, self._y_test):
            correct += self._eval_fn(xb, yb)
        out = {c: per_step[:, i].tolist()
               for i, c in enumerate(self._columns)}
        out.update(train_loss=float(np.mean(out["loss"])),
                   train_accuracy=float(np.mean(out["accuracy"])),
                   test_accuracy=int(correct) / self._n_test,
                   train_seconds=train_seconds)
        return state, out
