#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure makes the exit code 1):

1. the card's name and power limit (nvidia-smi), then the build of every
   kernel from the sources in the checkout (one nvcc per source, all
   started together), and the host's Python, torch and CUDA versions and
   optional modules (grpc, matplotlib, ml_dtypes, triton);
2. kernel K1 (wire quantize) against its plain PyTorch version on the
   card, tolerance 0 (torch.equal): the multi-tensor kernel
   (``wire_quantize_multi``, one launch per push of up to 64 tensors)
   over the 62 ResNet-18 parameter shapes at levels 127 and 7 with
   random, half-step and clipping inputs, each shape on its own through
   the one-tensor surface (``wire_quantize_flat``, a push of one tensor),
   over a push that mixes levels, one whose largest entry is a misaligned
   view x[1:] and one table of 124 entries (two launches). Times one
   whole push host-issued by CUDA events (before and after the plain
   version's runs), and the kernel's device time a push by
   torch.profiler, against the bound; and the wrapper's host time a
   push, step by step;
3. kernels K2, K3 and K4 (block-wise int8) against their plain versions,
   torch.equal at tolerance 0: the ResNet-18 ring chunk at N=4 as a batch
   of 4 rows of 2,805,033 values (rows 0, 4, 8 and 12 bytes past a
   16-byte boundary), 3 rows of 513, exactly 2 x 32,768, an all-zero
   block, an empty input, a 1000-valued outlier in block 0, 2 rows of
   32,769 (a last block 1 value deep), a view with an odd row stride,
   blocks that take the exact division (scales beyond 2^-40 and 2^40,
   values below scale * 2^-60), and one block of 4,096 C values for each
   cluster size C = 1..8; K3 at 3 seeds. On the chunk, K3's mean rounding
   error (in scales) must be near 0 and every code floor or floor + 1 of
   x / scale. Times each kernel on the chunk by CUDA events and by
   torch.profiler (K2 and K3 beside their first design's device times),
   and its plain version; K2's and K3's bound counts their SASS by pipe
   (cuobjdump) at the card's highest SM clock;
4. the CUDA device codec on a full-width ResNet-18 gradient tree: int8 and
   int4 with error feedback over 3 pushes, with and without shared
   scales, plus a top-k push, byte-for-byte against the NumPy
   ``compress_push``;
5. the async path: full ResNet-18 (100 classes, bf16 compute) trained by
   2 async workers through ``ParameterStore(push_codec="int8")`` for one
   epoch of synthetic CIFAR-100, eval on, host batches prefetched 2
   ahead (the worker's default). K1's launch count is reset
   just before and read just after: the multi-tensor kernel must have
   launched ceil(62 / 64) = 1 time per push made;
6. a shorter run of the async path under torch.profiler: device time by
   kernel, the multi-tensor K1's device time a push and the device's busy
   share of the wall;
7. the sync path: ``SyncTrainer`` with full ResNet-18 (bf16), 4 worker
   slots on the card, batch 128 per slot, ``compression="int8"``, one
   epoch of 16 steps, eval on 1,000 test images. K2-K4's counts are reset
   just before and read just after: K3 must have launched 4 times and K4
   7 times per step (one launch over all slots per hop), K2 never (the
   ring rounds stochastically; K2 is on no main path). Then, from the
   trained state, the ring on one step's real per-slot gradient rows
   ``[4, 11,220,132]`` on the card must equal, bit for bit, the same ring
   on a CPU copy (the plain versions), with the same seed; and one step
   each with ``compression="none"`` and with the int8 ring, whose params
   must be within rtol 0.05 / atol 1e-3 of each other;
8. a few sync steps under torch.profiler: device busy share and top
   device kernels;
9. the single-device baseline (``BaselineTrainer``, full ResNet-18 on
   ``compositional_cifar100(50_000, 10_000)``, batch 128, 390 steps an
   epoch): (a) one eager step, augment off, on the card against the
   same step on the CPU from the same weights: in float64 params, batch
   statistics and momentum within atol 1e-5 / rtol 1e-3; in fp32 the
   loss and batch statistics within it, the params' and momentum's
   differences reported beside each run's distance from float64; (b) the
   epoch loop captured in a CUDA graph against the same loop run eagerly
   on the card, fp32, augment on, cuDNN deterministic, 3 epochs of 4
   steps with milestones (1, 2): params, momentum and batch statistics
   within atol 1e-6 / rtol 1e-5 (bit equality reported), equal augment
   draws and generator states, and the graph's learning rate 0.1,
   0.010000001, 0.001 bit for bit;
   (c) the reference recipe in bf16 with augmentation, 2 epochs with the
   per-batch host loop and 2 with the captured loop: epoch seconds, img/s
   over the second epoch, loss, accuracies, peak memory, and 20 steps of
   each under torch.profiler; each must learn (test accuracy above 2 %
   after epoch 2, epoch 2's loss below epoch 1's);
10. the flash kernels against their plain versions: the wgmma forward
   ``flash_fwd_wgmma`` (K5 on bf16 inputs), the fused backward
   ``flash_bwd`` (K6 + K7 in one kernel, bf16 inputs) and the first
   versions of K5 (forward), K6 (dQ) and K7 (dK/dV), which the path runs
   on fp32 inputs. At the SP path's hop shape [192, 2048, 64] bf16 in,
   fp32 out, O, LSE, dQ, dK and dV within atol/rtol 5e-3 (2e-2 where the
   output is bf16); in fp32 within 2e-3; each case reports the mean
   magnitude its limit is compared against; T = 197 padded to 256
   (kv_len masking); causal with offsets (128, 0); two slots with their
   own offsets in one launch; D = 128; the wgmma forward and the fused
   backward on every bf16 case. A wholly-future block (0, 2048) must give
   O = 0, LSE <= -1e29 and all-zero gradients, in fp32 and in bf16 (the
   wgmma forward's too). Two launches on one input must give bit-equal O
   and LSE (wgmma forward) and dK and dV (fused backward; dQ's
   launch-to-launch difference is reported). Times each kernel, its plain
   version and the library call (``aten._scaled_dot_product_flash_
   attention`` and its backward) by CUDA events at the hop shape, each
   redesign in turns with its first version and the library's call;
11. the SP path: ``SPTrainer`` with ViT-B/16 (768 wide, 12 layers, 12
   heads, 1,000 classes, bf16) on synthetic ImageNet at 1024 x 1024
   (4,096 tokens) over 2 sequence slots of 2,048 tokens, batch 8, 2 steps
   and one eval batch. The flash counts are reset just before and read
   just after: the wgmma forward must have launched 24 x (steps + eval
   batches) times, the fused backward 24 x steps (12 layers x 2 hops, one
   launch over both slots a hop), the first versions of K5, K6 and K7
   never. Then one layer's ring on real
   activations with the kernels against the same ring with plain hops on
   the card, output and gradients (bf16) within atol 5e-3 and rtol 2^-7,
   one bf16 step;
12. one SP step under torch.profiler: device busy share, the flash
   kernels', the wgmma forward's and the fused backward's device time,
   top device kernels;
13. the CLI verb ``train`` in async mode at its default codec, in sync
   mode with the int8 ring, in baseline mode, and in sp mode on ViT-B/16
   at 1024 x 1024;
14. the gRPC path, phase 5's configuration over the wire: (a) in one
   process, the port's ``serve()`` on 127.0.0.1 at a free port and 2
   ``PSWorker`` threads on the card, each through its own ``RemoteStore``;
   K1's count reset just before and read just after: the multi-tensor
   kernel once a push; no push answered
   ``duplicate``, no frame refused as corrupt, every push frame carrying
   a valid CRC-32 trailer; the store's params moved; each worker's first
   push frame byte-equal to the port's ``encode_tensor_dict`` of the NumPy
   ``compress_push`` of the same gradients. Reports img/s, each RPC's
   median ms, bytes a push and a fetch, ``not_modified`` fetches, the
   store's staleness counts, and the device's idle share over a shorter
   profiled run; (b) across processes, ``cli serve --mode async
   --workers 2 --push-codec int8`` and 2 ``cli worker --synthetic
   --num-train 2048 --epochs 1`` on the card: every process exits 0
   within its timeout (one still alive then is killed, and the phase
   fails), and the server reports a step above 0;
15. the gRPC path with the store options and the worker's modes on: (a)
   ``serve()`` on 127.0.0.1 over ``StoreConfig(mode="async",
   total_workers=2, push_codec="int8", staleness_bound=5,
   fetch_codec="bf16", worker_timeout=30)`` and 2 ``PSWorker`` threads,
   each through its own ``RemoteStore``, with
   ``WorkerConfig(k_step_mode="local_sgd", sync_steps=4, overlap=True,
   heartbeat_interval=1.0)`` over 4,096 images (16 steps, 4 pushes a
   worker). K1's count reset just before and read just after: one launch
   a push (8); every push frame with a valid CRC-32 trailer and none a
   duplicate; every full fetch reply within 0.45-0.55 of phase 14's; one
   fetch decoded by a fresh client equal, bit for bit, to the store's
   params cast to bf16 and back; the comms pipeline's depth sampled
   never above 1 (and above 0 at times); heartbeats on both workers; the
   params moved. Reports img/s, the RPC medians, bytes a push and a
   fetch, the overlap-saved seconds (sum and median) and the device's
   idle share over a profiled shorter run, each beside phase 14 (a)'s
   from the same run, and img/s with overlap off and on in turns (off,
   on, on, off; eval off). (b) With ``cudnn.deterministic``, one worker:
   ``local_sgd`` with K=1 pushes an int8 frame byte-equal to
   ``faithful``'s at the same params and batch, and ``overlap=True``
   leaves the store's params bit-equal to ``overlap=False``'s. (c) A
   resume drill: one worker with ``reconnect_timeout=60``; the server is
   stopped just before the worker's 3rd push leaves, and a new one
   starts on the same port from ``load_snapshot`` of the old store's
   snapshot: the worker finishes with one reconnect, and each of its 4
   pushes is applied once (2 in the snapshot, 2 on the new server, the
   stranded one re-sent under its own token);
16. the device-resident store at full width: (a) phase 5's configuration
   with ``make_store("device", ...)`` on the card (async, staleness bound
   5, no codec). K1's count reset just before and read just after: 0
   launches. Reports img/s, the median grad step and the store's mean
   apply seconds (sampled every ``update_time_wait_every`` updates), each
   beside phase 5's python-store value from the same call, then img/s of
   the python and the device store again in turns with every cache warm
   (eval off); (b) a shorter run under torch.profiler: the device's idle
   share, the apply's device time against its byte bound (3 x 44,880,528
   bytes at 3.35 TB/s) and the host<->device bytes a step from the trace's
   memcpy events: host to device the batch's 393,216 bytes plus under 16
   KiB, device to host under 16 KiB, so no parameter or gradient crosses;
   (c) real gradients of one step drive two async pushes (the second one
   step stale) and one full sync round of 2 workers through the device
   store on the card and on the CPU: every return and param bit-equal;
17. checkpoints on the card: (a) ``serve()`` on 127.0.0.1 over a device
   store with a ``PeriodicStoreCheckpointer`` and one worker; after the
   server applies the worker's 2nd push its reply is lost: a snapshot
   (params and push-token journal) is flushed and the server stopped, and
   a new one on the same port is restored with ``restore_server_state``.
   The worker's retry under its old token must be answered as a duplicate
   at the restored step 2, the store's params equal to the snapshot's npz
   bit for bit, and each of the 4 pushes applied once; (b)
   ``BaselineTrainer(device_loop=True)`` (ResNet-18, bf16, deterministic
   cuDNN) for 2 epochs of 2,048 images with a checkpoint each epoch; a
   fresh trainer restored from epoch 1 (copied into the tensors its graph
   replays over) must end epoch 2 with params, momentum, BatchNorm
   statistics, step and loss bit-equal to the uninterrupted run's;
18. the cluster health layer on the main path: (a) phase 14 (a)'s run
   with the port's service wired as ``cli serve --remediate`` wires it (a
   ``ClusterMonitor`` with the JAX defaults and the SLO evaluator, a
   ``RemediationEngine`` that is not a dry run, ``reject_nonfinite``). K1's
   count reset just before and read just after: once a push; both
   workers in the monitor's view with step, loss, grad norm and push
   codec ``int8+ef``; every reported grad norm within 1e-4 (relative) of
   the pushed window's norm recomputed on the card in float64; no health
   rule fires, no directive is posted, no push is quarantined, and an SLO
   burn rule fires only where the evaluator's own fetch-latency numbers
   breach it (reported). Then img/s with the monitor off and on in turns
   (off, on, on, off; eval off), the health note's host µs a boundary,
   and the device->host copies it adds a boundary (at most 1) from two
   profiled runs' memcpy events. (b) The self-heal drill: fp16 pushes,
   worker 1 poisons its 3rd step with NaN; its push is answered
   ``accepted: false, quarantined: true`` and never applied, both
   non-finite rules fire against it alone, the engine quarantines it and
   posts ``quarantine`` (steps 3) and ``refetch_params``, which it
   applies, skipping 3 pushes; worker 0's pushes all apply, worker 1's
   after the windows apply again, every parameter stays finite; the
   seconds from the NaN push's reply to the directive being applied. (c)
   One int8 worker with error feedback and deterministic cuDNN gets a
   ``quarantine`` directive (steps 2) after its 2nd push: the next 2
   windows push nothing (K1 once a push sent), the device codec's
   residuals are empty right after the directive, and the first push
   after it is byte-equal to ``compress_push`` of its gradients under a
   fresh ``ErrorFeedback`` (and differs from the carried one's);
19. every registry model under the data-parallel modes, on
   ``synthetic_imagenet(1024, 256)`` at 224 x 224, 1,000 classes, bf16:
   (a) ResNet-50 (the ImageNet stem) through ``BaselineTrainer``, 2
   epochs of 8 steps of 128 eager and 2 graphed, each profiled over 8
   steps (img/s, step ms, idle share, peak GiB); one step at batch 2 on
   the card against the CPU in float64, params, batch statistics and
   momentum within atol 1e-5 / rtol 1e-3; ResNet-18 with the ImageNet
   stem for 4 eager steps. (b) ``SyncTrainer`` on ResNet-50, 4 slots of
   64, int8, 8 steps: K3 4 and K4 7 launches a step, replicas identical,
   each slot handing 6 payloads of ``ring_payload_bytes(6,389,258)`` a
   step; then K3 and K4 on one step's real gradient rows at the ring's
   first hop (4 x 6,389,258) against their plain versions on the card,
   torch.equal, timed against their bounds. (c) ``AsyncTrainer`` on
   ResNet-50 with an int8 store, 2 workers of 64, 4 pushes each: K1 3
   launches a push (161 tensors, at most 64 a launch); the first push K1
   quantized equal, byte for byte, to ``wire_quantize_multi_plain`` on
   the same inputs, and its device time against the 127,785,160-byte
   bound. (d) ViT-B/16: ``SyncTrainer`` with bf16 and with int8, 4
   slots of 32, 4 steps (K3/K4 as in (b) at 21,641,914 values a slot),
   then ``AsyncTrainer`` with int8 pushes, 2 workers of 32, 2 pushes
   each (K1 3 a push, 152 tensors); the flash kernels' counts reset
   before (d) and read after it must be 0 (197 tokens take the dense
   core). (e) phase 14 (a)'s topology with ResNet-50: ``serve()`` and 2
   ``PSWorker`` threads, int8 pushes, 2 pushes each, eval off: K1 3 a
   push, no duplicate, each RPC's median ms and the bytes of a push and a
   full fp32 fetch.

Then one JSON line of kernels and, last, the device line. Without a CUDA
device, or outside a checkout of the repo, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

H100_BYTES_PER_S = 3.35e12    # HBM3, NVIDIA's H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12   # fp32 outside the tensor cores, same sheet
# Results a clock an SM of compute capability 9.0, by the pipe that runs
# each SASS opcode (CUDA C++ Programming Guide, throughput table of the
# arithmetic instructions): fp32 add, multiply, FMA, min/max and compare
# 128; 32-bit integer add, multiply-add, logic, shift, compare and select
# 64; conversions and the special-function unit 16. Moves, loads,
# stores, barriers and branches are left out, so the bound stays a least
# time.
SASS_PIPES = {
    "fp32": (128, ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL",
                   "FSET")),
    "int32": (64, ("IADD3", "IADD", "IMAD", "IMUL", "LOP3", "LOP", "SHF",
                   "SHL", "SHR", "ISETP", "IMNMX", "VIMNMX", "LEA", "IABS",
                   "PRMT", "SEL", "I2FP", "BMSK", "SGXT")),
    "conversion": (16, ("MUFU", "F2I", "I2F", "FRND", "F2F")),
}
H100_BF16_OPS_PER_S = 989e12  # dense tensor-core bf16, same sheet


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def resnet18_shapes(num_classes: int = 100) -> dict:
    """Flax-layout shapes of ResNet-18's 62 parameter tensors."""
    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        import ResNet18
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .pytree import params_to_jax

    params, _ = params_to_jax(ResNet18(num_classes))
    return {k: v.shape for k, v in params.items()}


def cuda_time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after two warm-up runs."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build(state: dict) -> None:
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card, flush=True)
    state["card"] = card
    names = ["wire_quantize", "block_quantize", "flash_attention"]
    cached = {n: _build.library_path(n).exists() for n in names}
    t0 = time.perf_counter()
    # One nvcc per source, all started together.
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    seconds = round(time.perf_counter() - t0, 3)
    for n in names:
        _build.load(n)
    emit({"phase": "build", "kernels": names, "seconds": seconds,
          "cached": cached})
    emit({"phase": "environment", **host_environment()})


def host_environment() -> dict:
    """Versions of Python, torch and CUDA, and of the optional modules
    later slices need on this host (None where one is missing)."""
    import importlib
    import importlib.util
    import platform

    import torch

    def version(name):
        if importlib.util.find_spec(name) is None:
            return None
        return getattr(importlib.import_module(name), "__version__", "")

    return {"python": platform.python_version(), "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "modules": {m: version(m) for m in
                        ("grpc", "matplotlib", "ml_dtypes", "triton")}}


def device_ms_per_call(fn, reps: int, kernel: str) -> tuple[float, float]:
    """Device time of the kernels whose name holds ``kernel`` per call of
    ``fn``, from torch.profiler's kernel durations over ``reps`` calls
    after one warm-up call, and their launches per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in device_events(prof) if kernel in e.key]
    return (sum(e.self_device_time_total for e in events) / 1e3 / reps,
            sum(e.count for e in events) / reps)


def k1_push(gen, shapes: dict, levels: list) -> tuple[list, list]:
    """One push of gradient-like tensors of ``shapes`` at ``levels`` (one
    per tensor), each with an eighth of its values at exact
    half-steps (round-half-to-even decides them) and an eighth far beyond
    +-levels*scale (the clamp); and each tensor's fp32 scale."""
    import torch

    xs, scales = [], []
    for shape, lv in zip(shapes.values(), levels):
        x = torch.randn(shape, generator=gen, device="cuda") * 1e-2
        flat = x.view(-1)
        scale = float(np.float32(float(flat.abs().max()) / lv))
        k = max(1, flat.numel() // 8)
        codes = torch.randint(-lv - 2, lv + 2, (k,), generator=gen,
                              device="cuda")
        flat[:k] = (codes.float() + 0.5) * scale
        flat[-k:] = torch.sign(flat[-k:]) * 3 * lv * scale
        xs.append(x)
        scales.append(scale)
    return xs, scales


def k1_host_breakdown(xs, scales, levels, rounds: int = 7,
                      reps: int = 50) -> dict:
    """Host microseconds per push of each step of ``wire_quantize_multi``'s
    CUDA route, and of the whole call, by ``time.perf_counter``: every
    round times ``reps`` calls of each step in turn; the median round of
    each. ``views_by_split`` is the views' first way (a split of the buffer
    with a piece per padding gap, then a ``view`` an entry), timed beside
    the ``as_strided`` way the wrapper takes."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    ns = [x.numel() for x in xs]
    offsets, total, groups = Q.wire_multi_layout(ns)
    offsets_list = offsets.tolist()
    flat = torch.empty(total, dtype=torch.int8, device=xs[0].device)
    table = Q._wire_table(xs, ns, offsets, scales, levels)

    def views_by_split():
        sizes, keep = [], []
        gaps = (np.diff(offsets, append=total) - ns).tolist()
        for n, gap in zip(ns, gaps):
            keep.append(len(sizes))
            sizes.append(n)
            if gap:
                sizes.append(gap)
        parts = torch.split(flat, sizes)
        return [parts[i].view(x.shape) for i, x in zip(keep, xs)]

    steps = {
        "checks": lambda: Q._check_wire_inputs(xs),
        "sizes": lambda: [x.numel() for x in xs],
        "layout": lambda: Q.wire_multi_layout(ns),
        "alloc": lambda: torch.empty(total, dtype=torch.int8,
                                     device=xs[0].device),
        "table": lambda: Q._wire_table(xs, ns, offsets, scales, levels),
        "launch": lambda: Q._wire_launch(table, groups, ns, flat),
        "offsets_list": lambda: offsets.tolist(),
        "views": lambda: Q._views(flat, xs, offsets_list),
        "views_by_split": views_by_split,
        "whole": lambda: Q.wire_quantize_multi(xs, scales, levels),
    }
    runs = {name: [] for name in steps}
    for _ in range(rounds):
        for name, fn in steps.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            runs[name].append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return {name: sorted(r)[len(r) // 2] for name, r in runs.items()}


def phase_kernel(state: dict) -> None:
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    shapes = resnet18_shapes()
    assert len(shapes) == 62, len(shapes)
    n_total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = {"wire_quantize_multi": 0}
    mismatched = []

    def check(case, got, want):
        torch.cuda.synchronize()
        if got.numel():
            max_err["wire_quantize_multi"] = max(
                max_err["wire_quantize_multi"],
                int((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            mismatched.append(case)

    # The kernel against its plain version on every ResNet-18 shape: tensor
    # by tensor through the one-tensor surface (a push of one tensor), and
    # over the whole push (its flat buffer, padding included).
    for levels in (127, 7):
        xs, scales = k1_push(gen, shapes, [levels] * len(shapes))
        for name, x, scale in zip(shapes, xs, scales):
            check(("wire_quantize_flat", name, levels),
                  Q.wire_quantize_flat(x, scale, levels),
                  Q.wire_quantize_plain(x, scale, levels))
        check(("wire_quantize_multi", levels),
              Q.wire_quantize_multi(xs, scales, [levels] * len(xs))[0],
              Q.wire_quantize_multi_plain(xs, scales, [levels] * len(xs))[0])
    # One push that mixes levels; one whose largest entry is a view x[1:]
    # off 16-byte alignment (the scalar path); a table of 124 entries (two
    # launches of at most 64).
    mixed = [127 if i % 2 else 7 for i in range(len(shapes))]
    xs, scales = k1_push(gen, shapes, mixed)
    check(("wire_quantize_multi", "mixed_levels"),
          Q.wire_quantize_multi(xs, scales, mixed)[0],
          Q.wire_quantize_multi_plain(xs, scales, mixed)[0])
    big = max(range(len(xs)), key=lambda i: xs[i].numel())
    shifted = torch.cat([xs[big].new_zeros(1), xs[big].reshape(-1)])
    xs_m = list(xs)
    xs_m[big] = shifted[1:]
    check(("wire_quantize_multi", "misaligned_view"),
          Q.wire_quantize_multi(xs_m, scales, mixed)[0],
          Q.wire_quantize_multi_plain(xs_m, scales, mixed)[0])
    before = Q.wire_quantize_multi.launches
    check(("wire_quantize_multi", "124_entries"),
          Q.wire_quantize_multi(xs + xs, scales + scales, mixed + mixed)[0],
          Q.wire_quantize_multi_plain(xs + xs, scales + scales,
                                      mixed + mixed)[0])
    if Q.wire_quantize_multi.launches - before != 2:
        mismatched.append(("wire_quantize_multi", "124_entries_launches",
                           Q.wire_quantize_multi.launches - before))
    del xs_m, shifted

    # One whole int8 push of gradient-like tensors: host-issued by CUDA
    # events (twice, around the plain version's runs), and the kernel's
    # device time from torch.profiler.
    xs = [torch.randn(s, generator=gen, device="cuda") * 1e-2
          for s in shapes.values()]
    scales = [float(np.float32(float(x.abs().max()) / 127)) for x in xs]
    int8 = [127] * len(xs)
    pushes = {
        "wire_quantize_multi": lambda: Q.wire_quantize_multi(xs, scales,
                                                             int8)}
    turns = {"wire_quantize_multi": [cuda_time_ms(
        pushes["wire_quantize_multi"], 20)]}
    plain = [cuda_time_ms(lambda: Q.wire_quantize_multi_plain(
        xs, scales, int8), 20) for _ in range(2)]
    turns["wire_quantize_multi"].append(cuda_time_ms(
        pushes["wire_quantize_multi"], 20))
    device = {name: device_ms_per_call(fn, 20, f"::{name}_kernel")
              for name, fn in pushes.items()}
    host_us = k1_host_breakdown(xs, scales, int8)
    # Least time for the same work: each input read once and each output
    # written once (4 + 1 bytes per element), or the fp32 operations
    # (divide, round, two clamps per element) at the fp32 peak.
    bytes_ms = 5 * n_total / H100_BYTES_PER_S * 1e3
    ops_ms = 4 * n_total / H100_FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    state["k1"] = {name: {
        "ms": min(turns[name]), "device_ms": device[name][0],
        "plain_ms": min(plain), "bound_ms": bound_ms,
        "max_abs_err": max_err[name],
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        for name in pushes}
    emit({"phase": "kernel_vs_plain", "kernel": "wire_quantize_multi",
          "shapes": len(shapes), "levels": [127, 7, "mixed"],
          "cases": ["resnet18_127", "resnet18_7", "per_tensor_127",
                    "per_tensor_7", "mixed_levels", "misaligned_view",
                    "124_entries"],
          "elements_per_push": n_total, "max_abs_err": max_err,
          "mismatched": mismatched,
          "push_ms_turns": turns, "plain_push_ms_runs": plain,
          "device_ms_per_push": {n: d[0] for n, d in device.items()},
          "device_launches_per_push": {n: d[1] for n, d in device.items()},
          "share_of_bound_device": {n: bound_ms / d[0]
                                    for n, d in device.items() if d[0]},
          "share_of_bound_host_issued": {n: bound_ms / min(t)
                                         for n, t in turns.items()},
          "bound_ms": bound_ms, "bytes_bound_ms": bytes_ms,
          "ops_bound_ms": ops_ms, "card": state["card"]})
    steps = ("checks", "sizes", "layout", "alloc", "table", "launch",
             "offsets_list", "views")
    emit({"phase": "k1_host_breakdown", "kernel": "wire_quantize_multi",
          "host_us_per_push": host_us,
          "sum_of_steps_us": sum(host_us[k] for k in steps),
          "card": state["card"]})
    if mismatched:
        raise AssertionError(f"K1 differs from its plain version on "
                             f"{mismatched}")


def ring_chunk_rows(n_slots: int = 4) -> tuple[int, int]:
    """(slots, values per slot) of the ResNet-18 ring chunk."""
    return n_slots, -(-11_220_132 // n_slots)


def sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(smi.stdout.split()[0]) * 1e6


def sass_pipe_counts(symbol: str) -> dict:
    """SASS instructions one thread of the block-quantize kernel whose
    mangled name holds ``symbol`` issues for one quantization block, by
    pipe (SASS_PIPES), from ``cuobjdump -sass`` of the built library: the
    body of the kernel's loop over blocks, from the target of the last
    backward branch before the last EXIT to that branch. The loop is
    straight-line code over a thread's 16 values (four Philox groups);
    the rarely taken paths (a slice past n, the exact division) are calls
    to functions outside it, and the warp-divergence fallbacks sit after
    the EXIT. The code before the loop (once a CTA) is not counted."""
    import re

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        _build

    tool = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    text = subprocess.run(
        [tool, "-sass", str(_build.library_path("block_quantize"))],
        capture_output=True, text=True, timeout=120, check=True).stdout
    funcs = [f for f in re.split(r"^\s*Function : ", text, flags=re.M)[1:]
             if symbol in f.split("\n", 1)[0]]
    if len(funcs) != 1:
        raise AssertionError(f"{len(funcs)} SASS functions match {symbol}")
    ins = [(int(m[1], 16), m[2], re.findall(r"0x([0-9a-f]+)", m[3]))
           for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+"
                                r"\s+)?([A-Z][A-Z0-9]*)\S*\s*([^;]*);",
                                funcs[0])]
    last_exit = max(i for i, x in enumerate(ins) if x[1] == "EXIT")
    back = max(i for i in range(last_exit) if ins[i][1] == "BRA"
               and ins[i][2] and int(ins[i][2][-1], 16) < ins[i][0])
    head = int(ins[back][2][-1], 16)
    body = [op for addr, op, _ in ins[:back + 1] if addr >= head]
    counts = {pipe: sum(op in ops for op in body)
              for pipe, (_, ops) in SASS_PIPES.items()}
    counts["issued"] = len(body)
    return counts


def block_bound(n_rows: int, n: int, kernel: str,
                sass: dict | None = None) -> tuple[float, str, dict]:
    """Least time for a block kernel's work on ``n_rows`` rows of ``n``
    values: each input read once and each output written once at the
    memory rate, against the operations at their pipes' rates; the
    largest, whether bytes or operations bound it, and each part in ms.

    K2/K3: ``sass`` is :func:`sass_pipe_counts` of the kernel, instructions
    a thread (16 values, padding included), priced per pipe at SASS_PIPES'
    lanes x the SMs x the highest SM clock. K4: a convert and a multiply a
    value at the fp32 peak."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    rows_padded, _, n_blocks = Q.block_layout(n)
    payload = n_rows * (rows_padded * Q.LANES + 4 * n_blocks)
    values = n_rows * n
    parts = {}
    if kernel == "block_dequantize":
        parts["bytes"] = (payload + 4 * values) / H100_BYTES_PER_S * 1e3
        parts["fp32"] = 2 * values / H100_FP32_OPS_PER_S * 1e3
    else:
        parts["bytes"] = (4 * values + payload) / H100_BYTES_PER_S * 1e3
        threads = n_rows * rows_padded * Q.LANES // 16
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        clock = sm_clock_hz()
        for pipe, (lanes, _) in SASS_PIPES.items():
            parts[pipe] = sass[pipe] * threads / (lanes * sms * clock) * 1e3
    bound = max(parts.values())
    return bound, ("bytes" if parts["bytes"] >= bound else "operations"), \
        parts


# K2's and K3's device times on the ring chunk in their first design (one
# thread block a quantization block, two passes over its values), on
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).
BLOCK_QUANTIZE_FIRST_DESIGN_DEVICE_MS = {"block_quantize": 0.044241,
                                         "block_quantize_stochastic": 0.045867}


def phase_kernel_int8(state: dict) -> None:
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    gen = torch.Generator(device="cuda").manual_seed(3)
    n_slots, chunk = ring_chunk_rows()
    ring = torch.randn((n_slots, chunk), generator=gen, device="cuda") * 1e-2
    zero_block = torch.randn((1, 2 * 32768), generator=gen,
                             device="cuda") * 1e-2
    zero_block[:, 32768:] = 0.0
    outlier = torch.randn((1, 2 * 32768), generator=gen, device="cuda") * 1e-2
    outlier[0, 0] = 1000.0
    cases = {
        "ring_chunk_4x2805033": ring,
        # rows 1 and 2 start off 16-byte alignment
        "rows3_n513": torch.randn((3, 513), generator=gen, device="cuda"),
        "n65536": torch.randn((1, 2 * 32768), generator=gen, device="cuda"),
        "zero_block": zero_block,
        "empty": torch.zeros((1, 0), device="cuda"),
        "outlier_block0": outlier,
        # the last block's cluster holds 1 value and 7 CTAs past n
        "n32769": torch.randn((2, 32_769), generator=gen, device="cuda"),
        # a view with the odd row stride 20,003 starting one value in: its
        # rows start 4, 0, 12 and 8 bytes past a 16-byte boundary
        "strided_4x20001": torch.randn(
            (4, 20_003), generator=gen, device="cuda")[:, 1:20_002],
    }
    # Blocks that take the kernels' exact division: a block scale below
    # 2^-40, one above 2^40, and values below scale * 2^-60.
    exact = torch.randn((2, 3 * 32_768 + 1), generator=gen, device="cuda")
    exact[:, :32_768] *= 1e-20
    exact[:, 32_768:65_536] *= 1e15
    exact[:, 65_536::97] = 1e-30 * torch.sign(exact[:, 65_536::97])
    cases["exact_division"] = exact
    # One block of block_elems = 4096 C values, C = 1..8: every cluster size.
    for n in (513, 5_000, 10_000, 15_000, 20_000, 24_000, 28_000, 32_768):
        cases[f"cluster{Q.block_layout(n)[1] * Q.LANES // 4096}_n{n}"] = \
            torch.randn((1, n), generator=gen, device="cuda")
    seeds = [[0x5EED0000 + 64 * k + r for r in range(n_slots)]
             for k in range(3)]
    err = {"block_quantize": 0, "block_quantize_stochastic": 0,
           "block_dequantize": 0.0}
    mismatched = []
    for name, x in cases.items():
        rows = x.shape[0]
        runs = [("block_quantize", Q.block_quantize(x),
                 Q.quantize_int8_plain(x))]
        for sd in seeds:
            runs.append(("block_quantize_stochastic",
                         Q.block_quantize_stochastic(x, sd[:rows]),
                         Q.quantize_int8_plain(x, sd[:rows],
                                               stochastic=True)))
        torch.cuda.synchronize()
        for kernel, got, want in runs:
            if got[0].numel():
                err[kernel] = max(err[kernel], int(
                    (got[0].int() - want[0].int()).abs().max()))
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                mismatched.append((kernel, name))
            back_plain = Q.dequantize_int8_plain(*got, x.shape[1])
            back = Q.block_dequantize(*got, x.shape[1])
            torch.cuda.synchronize()
            if back.numel():
                err["block_dequantize"] = max(err["block_dequantize"], float(
                    (back - back_plain).abs().max()))
            if not torch.equal(back, back_plain):
                mismatched.append(("block_dequantize", name))
    row_offsets = {name: sorted({x[r].data_ptr() % 16
                                 for r in range(x.shape[0])})
                   for name, x in cases.items() if x.numel()}

    # K3 on the chunk: unbiased, and every code floor or floor + 1.
    v, sc = Q.block_quantize_stochastic(ring, seeds[0])
    rows_padded, br, _ = Q.block_layout(chunk)
    scale = sc.repeat_interleave(br * Q.LANES, dim=1)[:, :chunk]
    scaled = ring / scale
    q = v.reshape(n_slots, -1)[:, :chunk].float()
    fl = torch.floor(scaled)
    floor_ok = bool(((q == fl.clamp(-127, 127))
                     | (q == (fl + 1).clamp(-127, 127))).all())
    mean_err = float((q - scaled).mean())   # in units of the block scale
    # Per value the error lies in (-1, 1) with sd <= 1/2: the mean of 11.2M
    # values has sd <= 1.5e-4; 2e-3 is over 13 sd.
    unbiased = abs(mean_err) < 2e-3

    payload = Q.block_quantize(ring)
    fns = {
        "block_quantize": (lambda: Q.block_quantize(ring),
                           lambda: Q.quantize_int8_plain(ring)),
        "block_quantize_stochastic": (
            lambda: Q.block_quantize_stochastic(ring, seeds[0]),
            lambda: Q.quantize_int8_plain(ring, seeds[0], stochastic=True)),
        "block_dequantize": (
            lambda: Q.block_dequantize(*payload, chunk),
            lambda: Q.dequantize_int8_plain(*payload, chunk)),
    }
    sass = {"block_quantize": sass_pipe_counts("block_quantize_kernelILb0E"),
            "block_quantize_stochastic": sass_pipe_counts(
                "block_quantize_kernelILb1E")}
    state["block_sass"] = sass
    # Each kernel twice by CUDA events (host-issued, 50 calls), then its
    # device time per call from torch.profiler's kernel durations.
    ms = {kernel: [cuda_time_ms(fk, 50) for _ in range(2)]
          for kernel, (fk, _) in fns.items()}
    state["block"] = {}
    for kernel, (fk, fp) in fns.items():
        plain = [cuda_time_ms(fp, 10), cuda_time_ms(fp, 10)]
        device_ms = device_ms_per_call(
            fk, 50, "::block_dequantize_kernel"
            if kernel == "block_dequantize" else "::block_quantize_kernel")[0]
        bound_ms, bound_by, parts = block_bound(n_slots, chunk, kernel,
                                                sass.get(kernel))
        state["block"][kernel] = {
            "ms": min(ms[kernel]), "device_ms": device_ms,
            "plain_ms": min(plain), "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err[kernel]}
        emit({"phase": "kernel_int8_vs_plain", "kernel": kernel,
              "shape": [n_slots, chunk], "ms_runs": ms[kernel],
              "device_ms": device_ms,
              "first_design_device_ms":
                  BLOCK_QUANTIZE_FIRST_DESIGN_DEVICE_MS.get(kernel),
              "plain_ms_runs": plain, "bound_ms": bound_ms,
              "bound_by": bound_by, "bound_parts_ms": parts,
              "sass_per_thread_16_values": sass.get(kernel),
              "share_of_bound_device": bound_ms / device_ms
              if device_ms else None,
              "max_abs_err": err[kernel], "card": state["card"]})
    emit({"phase": "kernel_int8_vs_plain", "cases": list(cases),
          "row_offsets_mod_16": row_offsets,
          "k3_seeds": len(seeds), "mismatched": mismatched,
          "k3_mean_error_in_scales": mean_err, "k3_unbiased": unbiased,
          "k3_codes_floor_or_floor_plus_1": floor_ok,
          "sm_clock_max_hz": sm_clock_hz(), "card": state["card"]})
    if mismatched:
        raise AssertionError(f"K2-K4 differ from their plain versions on "
                             f"{mismatched}")
    if not (unbiased and floor_ok):
        raise AssertionError(f"K3 rounding: mean error {mean_err} scales, "
                             f"floor/floor+1 {floor_ok}")


def _payload_equal(a: dict, b: dict) -> str | None:
    if list(a) != list(b):
        return f"key order differs: {list(a)[:4]} vs {list(b)[:4]}"
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype != y.dtype or x.shape != y.shape \
                or x.tobytes() != y.tobytes():
            return f"entry {k!r} differs ({x.dtype}{x.shape} vs " \
                   f"{y.dtype}{y.shape})"
        if getattr(a[k], "logical_shape", None) \
                != getattr(b[k], "logical_shape", None):
            return f"entry {k!r}: int4 logical shape differs"
    return None


def phase_codec(state: dict) -> None:
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .compression import ErrorFeedback, compress_push
    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .device_codec import DeviceCodec

    shapes = resnet18_shapes()
    rng = np.random.default_rng(7)
    cases = [("int8", False), ("int8", True), ("int4", False),
             ("int4", True)]
    checked = 0
    for kind, shared in cases:
        plan = {name: kind for name in shapes}
        codec = DeviceCodec(error_feedback=True, device="cuda")
        ef = ErrorFeedback()
        for push in range(3):
            grads = {n: (rng.standard_normal(s) * 1e-2).astype(np.float32)
                     for n, s in shapes.items()}
            scales = {n: float(np.abs(g).max()) * 0.7
                      for n, g in grads.items()} if shared else None
            want = compress_push(grads, plan, scales=scales, ef=ef)
            dev = {n: torch.from_numpy(g).cuda() for n, g in grads.items()}
            got = codec.encode_now(dev, plan, scales=scales)
            diff = _payload_equal(got, want)
            if diff:
                raise AssertionError(f"codec {kind} shared={shared} push "
                                     f"{push}: {diff}")
            checked += 1
    # Top-k: magnitudes unique by construction (boundary ties are
    # unspecified in the reference), one push without EF.
    plan = {n: ("topk" if math.prod(s) >= 4096 else "int8")
            for n, s in shapes.items()}
    grads = {}
    for n, s in shapes.items():
        size = math.prod(s)
        mags = (rng.permutation(size) + 1).astype(np.float32) * 2.0 ** -22
        signs = np.where(rng.random(size) < 0.5, -1.0, 1.0)
        grads[n] = (mags * signs).astype(np.float32).reshape(s)
    want = compress_push(grads, plan)
    got = DeviceCodec(error_feedback=False, device="cuda").encode_now(
        {n: torch.from_numpy(g).cuda() for n, g in grads.items()}, plan)
    diff = _payload_equal(got, want)
    if diff:
        raise AssertionError(f"codec topk: {diff}")
    checked += 1
    emit({"phase": "codec_bytes", "pushes_checked": checked,
          "cases": [f"{k}{'+shared' if s else ''} x3 EF" for k, s in cases]
          + ["topk+int8 x1"], "equal": True})


N_WORKERS, BATCH = 2, 128


def main_path(steps_per_worker: int, n_test: int, seed: int):
    """The main path's pieces: synthetic CIFAR-100 for ``steps_per_worker``
    batches per worker, full ResNet-18 (100 classes, bf16 compute) on the
    card, and an async int8 store holding its params. Returns
    ``(dataset, model, store, initial params)``."""
    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import synthetic_cifar100
    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        import get_model
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        ParameterStore, StoreConfig)
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .pytree import params_to_jax

    ds = synthetic_cifar100(n_train=N_WORKERS * BATCH * steps_per_worker,
                            n_test=n_test)
    model = get_model("resnet18", num_classes=100, dtype="bfloat16",
                      device="cuda", seed=seed)
    init, _ = params_to_jax(model)
    store = ParameterStore(init, StoreConfig(
        mode="async", total_workers=N_WORKERS, push_codec="int8",
        staleness_bound=5))
    return ds, model, store, init


def grad_step_times(ds, params: dict) -> list:
    """Grad-step times at the main path's shapes: one worker's step over a
    batch of 128, bf16, from ``params`` (NumPy), by CUDA events, 20 runs
    after 5 warm-up runs."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        import get_model
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .steps import make_grad_step
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .pytree import params_to_jax

    gs_model = get_model("resnet18", num_classes=100, dtype="bfloat16",
                         device="cuda", seed=1)
    grad_step = make_grad_step(gs_model, augment=True)
    params = {k: torch.from_numpy(np.asarray(v)).cuda()
              for k, v in params.items()}
    _, init_stats = params_to_jax(gs_model)
    stats = {k: torch.from_numpy(v).cuda() for k, v in init_stats.items()}
    xb, yb = ds.x_train[:BATCH], ds.y_train[:BATCH]
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = []
    for i in range(25):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        grad_step(params, stats, xb, yb, gen)
        b.record()
        torch.cuda.synchronize()
        if i >= 5:
            times.append(a.elapsed_time(b))
    return times


def phase_main_path(state: dict) -> None:
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        WorkerConfig, run_workers)
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        import get_registry

    n_workers, batch = N_WORKERS, BATCH
    ds, model, store, init = main_path(steps_per_worker=8, n_test=1000,
                                       seed=0)
    cfg = WorkerConfig(batch_size=batch, num_epochs=1, device="cuda")
    Q.wire_quantize_multi.launches = 0
    t0 = time.perf_counter()
    results = run_workers(store, model, ds, n_workers, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"wire_quantize_multi": Q.wire_quantize_multi.launches}
    state["k1_launches"] = launches

    pushes = sum(r.pushes_accepted + r.pushes_rejected for r in results)
    errors = [repr(r.error) for r in results if r.error is not None]
    losses = [v for r in results for v in r.train_loss_per_epoch]
    final, step = store.snapshot()
    moved = sum(not np.array_equal(final[k], init[k]) for k in init)
    # Worker-seconds by goodput category (the workers' wall ledger).
    goodput = {k.split("=")[1].rstrip("}"): round(v, 4) for k, v in
               get_registry().snapshot()["counters"].items()
               if k.startswith("dps_goodput_seconds_total{")}
    images = sum(r.local_steps_completed for r in results) * batch
    train_s = max(sum(r.epoch_times) for r in results)

    times = grad_step_times(ds, final)
    state["grad_step_ms"] = float(np.median(times))
    state["main_path_img_per_s"] = images / train_s
    state["main_path_store"] = store.metrics()

    emit({"phase": "main_path", "model": "resnet18", "dtype": "bfloat16",
          "workers": n_workers, "batch_size": batch,
          "push_codec": "int8", "prefetch_batches": cfg.prefetch_batches,
          "global_step": step, "pushes": pushes,
          "pushes_rejected": sum(r.pushes_rejected for r in results),
          "k1_launches": launches, "train_loss_per_epoch": losses,
          "test_accuracies": [r.test_accuracies for r in results],
          "tensors_moved": moved, "images": images,
          "img_per_s": images / train_s, "train_seconds": train_s,
          "run_seconds": wall,
          "grad_step_ms_median": state["grad_step_ms"],
          "grad_step_ms_runs": times, "store": store.metrics(),
          "goodput_worker_seconds": goodput,
          "card": state["card"]})
    if errors:
        raise AssertionError(f"worker errors: {errors}")
    if step <= 0 or pushes <= 0:
        raise AssertionError(f"no training happened (step {step}, "
                             f"pushes {pushes})")
    # One launch of the multi-tensor K1 per 64 of a push's 62 tensors.
    want = {"wire_quantize_multi": -(-62 // Q.WIRE_MAX_ENTRIES) * pushes}
    if launches != want:
        raise AssertionError(f"K1 launched {launches} times for {pushes} "
                             f"pushes; expected {want}")
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if moved == 0:
        raise AssertionError("the store's params did not move")


def device_events(prof) -> list:
    """The profile's device-side events (kernels, copies), averaged by name.
    A host operator's own row also carries the device time of the kernels
    it launched, so summing over every row would count that time twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def phase_profile(state: dict) -> None:
    """Where the time goes on the main path: the same 2-worker int8 run,
    shorter and without eval, under torch.profiler — device time by kernel
    and the device's busy share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        WorkerConfig, run_workers)

    ds, model, store, _ = main_path(steps_per_worker=4, n_test=10, seed=2)
    cfg = WorkerConfig(batch_size=BATCH, num_epochs=1, device="cuda",
                       eval_each_epoch=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_workers(store, model, ds, N_WORKERS, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    k1 = [e for e in events if "::wire_quantize_multi_kernel" in e.key]
    k1_launches = sum(e.count for e in k1)
    emit({"phase": "profile", "steps": store.global_step,
          "wall_s": wall, "device_busy_s": device_us / 1e6,
          "device_idle_share": (1 - device_us / 1e6 / wall)
          if device_us else None,
          "wire_quantize_multi_launches": k1_launches,
          "wire_quantize_multi_device_ms_per_push": sum(
              e.self_device_time_total for e in k1) / 1e3 / k1_launches
          if k1_launches else None,
          "top_device_ms": [[e.key[:160], round(e.self_device_time_total
                                               / 1e3, 3), e.count]
                            for e in top],
          "card": state["card"]})


SYNC_SLOTS, SYNC_STEPS = 4, 16


def sync_trainer(steps: int, n_test: int, compression: str = "int8",
                 seed: int = 0):
    """The sync path's trainer: full ResNet-18 (bf16) on the card, 4 slots
    of batch 128, ``steps`` steps of synthetic CIFAR-100 in one epoch."""
    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import synthetic_cifar100
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .distributed import DistributedConfig, SyncTrainer

    ds = synthetic_cifar100(n_train=SYNC_SLOTS * BATCH * steps,
                            n_test=n_test)
    return SyncTrainer(ds, DistributedConfig(
        mode="sync", num_workers=SYNC_SLOTS, batch_size=BATCH, num_epochs=1,
        compression=compression, dtype="bfloat16", device="cuda",
        seed=seed))


def _reset_block_counts():
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    Q.block_quantize.launches = 0
    Q.block_quantize_stochastic.launches = 0
    Q.block_dequantize.launches = 0


def _block_counts() -> dict:
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    return {"block_quantize": Q.block_quantize.launches,
            "block_quantize_stochastic": Q.block_quantize_stochastic.launches,
            "block_dequantize": Q.block_dequantize.launches}


def phase_sync_path(state: dict) -> None:
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.data.cifar \
        import standardize, to_float
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import make_sync_dp_step, shard_batch
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        .sync_dp import (_int8_ring_allreduce_mean, make_slot_grad_fn,
                         ravel_slots)

    trainer = sync_trainer(SYNC_STEPS, n_test=1000)
    init = {k: v.clone() for k, v in trainer.state.params.items()}
    torch.cuda.synchronize()
    _reset_block_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _block_counts()
    state["sync_counts"] = counts
    steps = trainer.global_steps
    size = sum(v.numel() for v in init.values())
    moved = sum(not torch.equal(init[k], v)
                for k, v in trainer.state.params.items())
    finite = all(math.isfinite(v) for v in trainer.train_loss_per_epoch) \
        and all(bool(torch.isfinite(v).all())
                for v in trainer.state.params.values())
    images = steps * SYNC_SLOTS * BATCH
    train_s = sum(trainer.train_seconds)
    rows_padded, _, n_blocks = Q.block_layout(-(-size // SYNC_SLOTS))
    wire_model = 2 * (SYNC_SLOTS - 1) / SYNC_SLOTS * size \
        + 2 * (SYNC_SLOTS - 1) * 4 * n_blocks

    # Step time at the path's shapes, by CUDA events, on one batch.
    xb = trainer.dataset.x_train[:SYNC_SLOTS * BATCH]
    yb = trainer.dataset.y_train[:SYNC_SLOTS * BATCH]
    bi, bl = shard_batch(trainer.mesh, (xb, yb))
    st = trainer.state
    times = []
    for i in range(13):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        st, _ = trainer._step(st, bi, bl, 1)
        b.record()
        torch.cuda.synchronize()
        if i >= 3:
            times.append(a.elapsed_time(b))

    # The ring on one step's real per-slot gradient rows, on the card and
    # on a CPU copy (the plain versions), with the same seed.
    base = trainer.state
    grads, *_ = make_slot_grad_fn(trainer.model)(
        base.params, base.batch_stats, standardize(to_float(bi)), bl.long())
    flat, _ = ravel_slots(grads)
    ring = _int8_ring_allreduce_mean(flat, 0x5EED)
    ring_plain = _int8_ring_allreduce_mean(flat.cpu(), 0x5EED)
    ring_equal = torch.equal(ring.cpu(), ring_plain)
    ring_vs_mean = float((ring[0] - flat.mean(0)).abs().max())
    ring_shape = list(flat.shape)
    del grads, flat, ring, ring_plain

    # One step each from the trained state, uncompressed and int8, the
    # same batch and seed.
    out = {}
    for comp in ("none", "int8"):
        step = make_sync_dp_step(trainer.mesh, trainer.model,
                                 compression=comp, augment=False)
        out[comp], _ = step(base, bi, bl, 7)
    torch.cuda.synchronize()
    worst = [k for k, v in out["int8"].params.items()
             if not torch.allclose(v, out["none"].params[k], rtol=0.05,
                                   atol=1e-3)]
    emit({"phase": "sync_path", "model": "resnet18", "dtype": "bfloat16",
          "slots": SYNC_SLOTS, "batch_per_slot": BATCH,
          "compression": "int8", "steps": steps, "images": images,
          "launches": counts,
          "launches_per_step": {k: v / max(steps, 1)
                                for k, v in counts.items()},
          "train_loss_per_epoch": trainer.train_loss_per_epoch,
          "test_accuracies": trainer.test_accuracies,
          "tensors_moved": moved, "params": size,
          "ring_replicas_identical": trainer.ring_replicas_identical,
          "img_per_s": images / train_s, "train_seconds": train_s,
          "run_seconds": wall,
          "step_ms_median": float(np.median(times)), "step_ms_runs": times,
          "wire_bytes_per_slot_per_step": trainer.wire_bytes_per_slot_step,
          "wire_bytes_model": wire_model,
          "ring_on_card_equals_plain": ring_equal,
          "ring_rows": ring_shape,
          "ring_max_abs_err_vs_exact_mean": ring_vs_mean,
          "int8_vs_none_params_outside_tolerance": worst,
          "card": state["card"]})
    want = {"block_quantize": 0,
            "block_quantize_stochastic": SYNC_SLOTS * steps,
            "block_dequantize": (2 * SYNC_SLOTS - 1) * steps}
    if steps != SYNC_STEPS or counts != want:
        raise AssertionError(f"{steps} steps launched {counts}; expected "
                             f"{want}")
    if not finite or moved == 0:
        raise AssertionError(f"losses finite {finite}, tensors moved {moved}")
    if trainer.ring_replicas_identical is not True:
        raise AssertionError("the ring's per-slot results differ")
    if not ring_equal:
        raise AssertionError("the ring on the card differs from the ring "
                             "on the CPU (plain versions)")
    if worst:
        raise AssertionError(f"the int8 step is outside rtol 0.05 / atol "
                             f"1e-3 of the uncompressed step: {worst}")


def phase_sync_profile(state: dict) -> None:
    """Where the time goes on the sync path: 6 int8 steps under
    torch.profiler (eval on 8 images)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trainer = sync_trainer(6, n_test=8, seed=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    emit({"phase": "sync_profile", "steps": trainer.global_steps,
          "wall_s": wall, "device_busy_s": device_us / 1e6,
          "device_idle_share": (1 - device_us / 1e6 / wall)
          if device_us else None,
          "top_device_ms": [[e.key[:160], round(e.self_device_time_total
                                               / 1e3, 3), e.count]
                            for e in top],
          "card": state["card"]})


# -- the single-device baseline ---------------------------------------------

BASELINE_EPOCHS = 2          # (c): eager and graphed, bf16, full set
BASELINE_PROFILE_STEPS = 20


def _baseline_parts(dtype: str, device: str, milestones, steps_per_epoch,
                    augment: bool, seed: int = 0, name: str = "resnet18",
                    num_classes: int = 100, image_size: int = 32):
    """A full-width registry model (ResNet-18, 100 classes, unless asked)
    with its in-place state and steps."""
    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        import get_model
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .optimizers import baseline_optimizer
    from distributed_parameter_server_for_ml_training_tpu_torch.train.steps \
        import make_eval_step, make_train_step
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .train_state import module_train_state

    model = get_model(name, num_classes=num_classes, dtype=dtype,
                      image_size=image_size, device=device, seed=seed)
    state = module_train_state(model, baseline_optimizer(
        milestones=milestones, steps_per_epoch=steps_per_epoch))
    ev = make_eval_step(model)
    return (model, state, make_train_step(model, augment=augment),
            lambda x, y: ev({}, {}, x, y)[0])


def _state_diff(a, b) -> dict:
    """Per part of two train states (b the reference): the largest
    absolute difference, the largest relative norm of a tensor's
    difference, and the tensors outside atol 1e-5 / rtol 1e-3."""
    import torch

    out = {}
    for part in ("params", "batch_stats", "momentum"):
        x, y = ((s.opt_state.trace if part == "momentum" else
                 getattr(s, part)) for s in (a, b))
        pairs = [(k, x[k].cpu().double(), y[k].cpu().double()) for k in y]
        out[part] = {
            "max_abs_err": max(float((u - v).abs().max())
                               for _, u, v in pairs),
            "max_rel_norm": max(float((u - v).norm() / v.norm())
                                for _, u, v in pairs if v.norm() > 0),
            "outside": [k for k, u, v in pairs
                        if not torch.allclose(u, v, atol=1e-5, rtol=1e-3)]}
    return out


def _profile_steps(fn, steps: int) -> dict:
    """``fn()`` ``steps`` times under torch.profiler: wall, device busy
    and idle share, device ms by CUDA events, top device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        a.record()
        for _ in range(steps):
            fn()
        b.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    return {"steps": steps, "wall_s": wall,
            "ms_per_step_by_events": a.elapsed_time(b) / steps,
            "device_busy_s": device_us / 1e6,
            "device_idle_share": (1 - device_us / 1e6 / wall)
            if device_us else None,
            "top_device_ms": [[e.key[:120], round(e.self_device_time_total
                                                 / 1e3, 3), e.count]
                              for e in top]}


def phase_baseline(state: dict) -> None:
    """The single-device baseline (``BaselineTrainer``) on
    ``compositional_cifar100(50_000, 10_000)``: (a) one eager step on
    the card against the same step on the CPU, in float64 and in fp32;
    (b) the captured epoch loop against the eager one over the same
    permutations, fp32, augment on, 3 epochs of 4 steps across
    milestones (1, 2); (c) the reference recipe in bf16, 2 epochs eager
    and 2 graphed, each profiled over 20 steps."""
    import itertools

    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import Dataset, compositional_cifar100, make_batches
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .baseline import BaselineConfig, BaselineTrainer
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .device_loop import DeviceEpochLoop, prefetch_to_device

    bs = BATCH
    t0 = time.perf_counter()
    ds = compositional_cifar100(50_000, 10_000, seed=0)
    data_s = time.perf_counter() - t0
    steps_per_epoch = len(ds.x_train) // bs
    out = {"phase": "baseline", "model": "resnet18", "batch_size": bs,
           "dataset": "compositional_cifar100(50000, 10000, seed=0)",
           "data_seconds": data_s, "steps_per_epoch": steps_per_epoch,
           "card": state["card"]}
    failures = []

    # (a) One eager step, augment off, card against CPU from the same
    # weights on the first batch. In float64 the two compute the same
    # function to rounding: params, batch statistics and momentum within
    # atol 1e-5 / rtol 1e-3. In fp32 the loss and the batch statistics
    # hold that tolerance, and the params' and momentum's differences are
    # reported beside each fp32 run's distance from the float64 one: at
    # full width an fp32 rounding difference flips the sign of a few
    # pre-ReLU activations within rounding of zero, which moves the
    # gradients of every earlier layer by tenths of a percent on either
    # device.
    xb, yb = ds.x_train[:bs], ds.y_train[:bs]
    runs = {}
    for dtype in ("float32", torch.float64):
        for device in ("cuda", "cpu"):
            model, st, step, _ = _baseline_parts(
                dtype, device, (10, 15), steps_per_epoch, False)
            if runs:
                model.load_state_dict(weights)
            else:
                weights = {k: v.cpu() for k, v in model.state_dict().items()}
            _, m = step(st, xb, yb)
            runs[(str(dtype), device)] = (st, float(m["loss"]))
            del model
    f32, f64 = "float32", str(torch.float64)
    a64 = _state_diff(runs[(f64, "cuda")][0], runs[(f64, "cpu")][0])
    a32 = _state_diff(runs[(f32, "cuda")][0], runs[(f32, "cpu")][0])
    losses = {f"{d}/{dev}": loss for (d, dev), (_, loss) in runs.items()}
    out["a_card_vs_cpu"] = {
        "tolerance": "atol 1e-5, rtol 1e-3",
        "float64": a64, "float32": a32, "losses": losses,
        "float32_vs_float64_rel_norm": {
            dev: {part: v["max_rel_norm"] for part, v in _state_diff(
                runs[(f32, dev)][0], runs[(f64, "cpu")][0]).items()}
            for dev in ("cuda", "cpu")}}
    bad = [f"float64 {p}" for p, v in a64.items() if v["outside"]]
    if a32["batch_stats"]["outside"]:
        bad.append("float32 batch_stats")
    l32 = [losses[f"{f32}/cuda"], losses[f"{f32}/cpu"]]
    if abs(l32[0] - l32[1]) > 1e-5 + 1e-3 * abs(l32[1]):
        bad.append(f"float32 loss {l32}")
    if bad:
        failures.append(f"(a) card against CPU outside atol 1e-5 / rtol "
                        f"1e-3: {bad}")
    del runs

    # (b) The captured loop against the eager loop, fp32, augment on,
    # with cuDNN's deterministic algorithms: the default ones sum some
    # gradients in an order that changes from launch to launch, and at
    # full width that alone moves two eager runs apart by more than the
    # tolerance within two steps (ReLU sign flips, as in (a)).
    small = Dataset(ds.x_train[:4 * bs], ds.y_train[:4 * bs],
                    ds.x_test[:1000], ds.y_test[:1000])
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    for graph in (True, False):
        model, st, step, ev = _baseline_parts("float32", "cuda", (1, 2), 4,
                                              True)
        gen = torch.Generator(device="cuda").manual_seed(1)
        runs[graph] = [DeviceEpochLoop(small, step, ev, batch_size=bs,
                                       generator=gen, graph=graph), st, gen,
                       [], []]
    draws_equal = gen_equal = True
    for _ in range(3):
        for graph, run in runs.items():
            run[1], m = run[0].run_epoch(run[1])
            run[3].append(m["learning_rate"])
            run[4].append(m["loss"])
        draws_equal &= torch.equal(runs[True][0].draws, runs[False][0].draws)
        gen_equal &= torch.equal(runs[True][2].get_state(),
                                 runs[False][2].get_state())
    torch.backends.cudnn.deterministic = deterministic
    gs, es = runs[True][1], runs[False][1]
    bit_equal = all(torch.equal(a, b)
                    for a, b in zip(gs.tensors(), es.tensors()))
    close = all(torch.allclose(a.float(), b.float(), atol=1e-6, rtol=1e-5)
                for a, b in zip(gs.tensors(), es.tensors()))
    b_errs = {part: v["max_abs_err"]
              for part, v in _state_diff(gs, es).items()}
    lr_bits = [[hex(int(v)) for v in
                np.array(e, np.float32).view(np.uint32)]
               for e in runs[True][3]]
    want_bits = [["0x3dcccccd"] * 4, ["0x3c23d70b"] * 4, ["0x3a83126f"] * 4]
    out["b_graph_vs_eager"] = {
        "epochs": 3, "steps_per_epoch": 4, "cudnn_deterministic": True,
        "bit_equal": bit_equal,
        "within_tolerance": close, "tolerance": "atol 1e-6, rtol 1e-5",
        "max_abs_err": b_errs, "draws_equal": draws_equal,
        "generator_states_equal": gen_equal,
        "graph_lr_bits": lr_bits,
        "eager_lr_equal": runs[True][3] == runs[False][3],
        "graph_losses": runs[True][4], "eager_losses": runs[False][4],
        "step_counts": [gs.step, es.step, int(gs.opt_state.count)]}
    if not (close and draws_equal and gen_equal and lr_bits == want_bits
            and runs[True][3] == runs[False][3]):
        failures.append(f"(b) graph against eager: {out['b_graph_vs_eager']}")
    del runs, gs, es

    # (c) The reference recipe at full size, bf16, eager then graphed.
    paths = {}
    for name, device_loop in (("eager", False), ("graph", True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer = BaselineTrainer(ds, BaselineConfig(
            num_epochs=BASELINE_EPOCHS, device_loop=device_loop,
            device="cuda"))
        met = trainer.train()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        images = steps_per_epoch * bs
        if device_loop:
            loop = trainer._device_loop

            def step_fn(loop=loop):
                loop._cuda_graph.replay()
            loop._slot.zero_()
        else:
            batches = prefetch_to_device(make_batches(
                ds.x_train, ds.y_train, bs, seed=12345), depth=2)
            batches = itertools.cycle(list(itertools.islice(
                batches, BASELINE_PROFILE_STEPS + 3)))
            for _ in range(3):     # the profile starts with warm steps
                trainer._train_step(trainer.state, *next(batches),
                                    trainer._gen)

            def step_fn(trainer=trainer, batches=batches):
                trainer._train_step(trainer.state, *next(batches),
                                    trainer._gen)
        prof = _profile_steps(step_fn, BASELINE_PROFILE_STEPS)
        paths[name] = {
            "epoch_seconds": met.epoch_times,
            "train_seconds": trainer.train_seconds,
            "img_per_s_epoch2": images / trainer.train_seconds[-1],
            "train_loss": met.train_losses,
            "train_accuracy_pct": met.train_accuracies,
            "test_accuracy_pct": met.test_accuracies,
            "peak_memory_gib": peak, "profile": prof}
        learned = met.test_accuracies[-1] > 2.0 \
            and met.train_losses[-1] < met.train_losses[0]
        paths[name]["learned"] = learned
        if not learned:
            failures.append(f"(c) {name} did not learn: loss "
                            f"{met.train_losses}, test "
                            f"{met.test_accuracies}")
        del trainer
    out["c_full_size"] = {"dtype": "bfloat16", "augment": True,
                          "epochs": BASELINE_EPOCHS, **paths}
    emit(out)
    if failures:
        raise AssertionError("; ".join(failures))


# -- flash attention (K5-K7) and the SP path ----------------------------------

HOP = (192, 2048, 64)           # [N*B*H, T/N, D] of the SP path's ring hops


def _flash_case(bh: int, t: int, d: int, dtype, out_dtype, *, kv_len=None,
                causal=False, q_offset=0, k_offset=0, seed=0):
    """K5, K6 and K7 and their plain versions on one input, and on bf16
    inputs the wgmma forward (``flash_fwd_wgmma``, outputs ``O_wgmma``,
    ``LSE_wgmma``) and the fused backward (``flash_bwd``, outputs
    ``dQ_fused``, ``dK_fused``, ``dV_fused``): returns ``{output:
    (kernel's, plain version's)}`` over the unpadded rows, and the
    forwards' ``{wrapper: (O, LSE)}``."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((bh, t, d), generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    kv_len = kv_len or t
    for x in (q, k, v, do):       # padded rows are zeros, as the caller pads
        x[:, kv_len:] = 0
    kw = dict(out_dtype=out_dtype, causal=causal, q_offset=q_offset,
              k_offset=k_offset)
    o, lse = fa.flash_fwd(q, k, v, kv_len, **kw)
    fwd = {"flash_fwd": (o, lse)}
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, kv_len, **kw)
    delta = (do.float() * o_p.float()).sum(-1, keepdim=True)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_p, delta, kv_len, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_p, delta, kv_len,
                              q_len=kv_len, **kw)
    dq_p, dk_p, dv_p = fa.flash_bwd_plain(q, k, v, do, lse_p, delta, kv_len,
                                          **kw)
    rows = slice(0, kv_len)
    pairs = {"O": (o[:, rows], o_p[:, rows]),
             "LSE": (lse[:, rows], lse_p[:, rows]),
             "dQ": (dq[:, rows], dq_p[:, rows]),
             "dK": (dk, dk_p), "dV": (dv, dv_p)}
    if dtype == torch.bfloat16:
        ow, lsew = fwd["flash_fwd_wgmma"] = fa.flash_fwd_wgmma(q, k, v,
                                                               kv_len, **kw)
        fq, fk, fv = fa.flash_bwd(q, k, v, do, lse_p, delta, kv_len,
                                  q_len=kv_len, **kw)
        pairs.update({"O_wgmma": (ow[:, rows], o_p[:, rows]),
                      "LSE_wgmma": (lsew[:, rows], lse_p[:, rows]),
                      "dQ_fused": (fq[:, rows], dq_p[:, rows]),
                      "dK_fused": (fk, dk_p), "dV_fused": (fv, dv_p)})
    torch.cuda.synchronize()
    return {name: (a.float(), b.float()) for name, (a, b) in pairs.items()}, \
        fwd


#: Operations of each flash kernel's work, in units of BH T^2 D.
FLASH_MATS = {"flash_fwd_wgmma": 4, "flash_fwd": 4, "flash_bwd": 10,
              "flash_bwd_dq": 6, "flash_bwd_dkv": 8}


def _flash_bounds(bh: int, t: int, d: int) -> dict:
    """Least time of each kernel's work at ``[bh, t, d]`` bf16 in, fp32
    out, non-causal: max(FLOPs at the bf16 tensor-core peak, bytes (each
    input read once, each output written once) at the HBM rate). The
    fused backward's work is S, dP, dV, dK and dQ, 10 BH T^2 D."""
    mat = bh * t * t * d
    io_in, row = 2 * bh * t * d, 4 * bh * t
    fwd = (4 * mat, 3 * io_in + 4 * bh * t * d + row)
    work = {"flash_fwd_wgmma": fwd, "flash_fwd": fwd,
            "flash_bwd": (10 * mat,
                          4 * io_in + 2 * row + 12 * bh * t * d),
            "flash_bwd_dq": (6 * mat, 4 * io_in + 2 * row + 4 * bh * t * d),
            "flash_bwd_dkv": (8 * mat,
                              4 * io_in + 2 * row + 8 * bh * t * d)}
    out = {}
    for name, (flops, nbytes) in work.items():
        ops_ms = flops / H100_BF16_OPS_PER_S * 1e3
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        out[name] = (max(ops_ms, bytes_ms),
                     "operations" if ops_ms >= bytes_ms else "bytes")
    return out


def phase_kernel_flash(state: dict) -> None:
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        flash_attention as fa

    bf16, f32 = torch.bfloat16, torch.float32
    bh, t, d = HOP
    # name: (args, kwargs, tolerance). bf16 in, fp32 out: 5e-3, about 3x
    # the largest error seen; 2e-2 only where the output itself is bf16.
    cases = {
        "hop_bf16_fp32out": ((bh, t, d, bf16, f32), {}, 5e-3),
        "hop_fp32": ((bh, t, d, f32, f32), {}, 2e-3),
        "t197_padded256_bf16": ((64, 256, 64, bf16, bf16),
                                dict(kv_len=197), 2e-2),
        "t197_padded256_fp32": ((64, 256, 64, f32, f32),
                                dict(kv_len=197), 2e-3),
        "causal_128_0_bf16": ((64, 256, 64, bf16, f32),
                              dict(causal=True, q_offset=128), 5e-3),
        "causal_128_0_fp32": ((64, 256, 64, f32, f32),
                              dict(causal=True, q_offset=128), 2e-3),
        "two_slots_causal_fp32": ((64, 256, 64, f32, f32),
                                  dict(causal=True, q_offset=[0, 256],
                                       k_offset=[0, 0]), 2e-3),
        "d128_bf16": ((48, 512, 128, bf16, f32), {}, 5e-3),
        "d128_fp32": ((48, 512, 128, f32, f32), dict(causal=True), 2e-3),
        # bf16 out: slot 0's first rows see 1-64 keys, where rounding dS
        # to bf16 (the TPU kernel's rounding, which the first version's
        # K6/K7 share) alone can exceed the 5e-3 limit of an fp32 output.
        "two_slots_causal_bf16": ((64, 256, 64, bf16, bf16),
                                  dict(causal=True, q_offset=[0, 256],
                                       k_offset=[0, 0]), 2e-2),
    }
    errors, typical, bad = {}, {}, []
    hop_err = {}
    for name, (args, kw, tol) in cases.items():
        pairs, _ = _flash_case(*args, **kw)
        errors[name], typical[name] = {}, {}
        for out, (a, b) in pairs.items():
            errors[name][out] = float((a - b).abs().max())
            typical[name][out] = float(b.abs().mean())
            if not torch.allclose(a, b, atol=tol, rtol=tol):
                bad.append((name, out))
        if name == "hop_bf16_fp32out":
            hop_err = errors[name]
        del pairs
        torch.cuda.empty_cache()
    # A block wholly in the future of every query: no key tile runs, every
    # output is exactly 0 (LSE -1e30), in fp32 (K5-K7) and in bf16 (K5, the
    # wgmma forward and the fused backward).
    future = {}
    for dtype in (f32, bf16):
        pairs, fwd = _flash_case(64, 256, 64, dtype, f32, causal=True,
                                 k_offset=2048)
        grads = {n: float(a.abs().max()) for n, (a, _) in pairs.items()
                 if n.startswith("d")}
        future[str(dtype)] = {"grad_max_abs": grads}
        for wrapper, (o, lse) in fwd.items():
            future[str(dtype)][wrapper] = {"O_max_abs": float(o.abs().max()),
                                           "LSE_max": float(lse.max())}
            if float(o.abs().max()) != 0.0 or float(lse.max()) > -1e29:
                bad.append(("future_block", str(dtype), wrapper))
        if any(x != 0.0 for x in grads.values()):
            bad.append(("future_block", str(dtype), "gradients"))

    # Times at the hop shape, bf16 in and fp32 out, as the ring runs them.
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((bh, t, d), generator=gen,
                               device="cuda").to(bf16) for _ in range(4))
    # Two launches on one input: the wgmma forward's O and LSE and the
    # fused backward's dK and dV are summed in a fixed order (bit-equal);
    # dQ's fp32 partial sums arrive in an order that varies.
    o, lse = fa.flash_fwd_wgmma(q, k, v, t, out_dtype=f32)
    o2, lse2 = fa.flash_fwd_wgmma(q, k, v, t, out_dtype=f32)
    delta = (do.float() * o).sum(-1, keepdim=True)
    a = fa.flash_bwd(q, k, v, do, lse, delta, t, out_dtype=f32)
    b = fa.flash_bwd(q, k, v, do, lse, delta, t, out_dtype=f32)
    torch.cuda.synchronize()
    repeat = {"O_wgmma_bit_equal": bool(torch.equal(o, o2)),
              "LSE_wgmma_bit_equal": bool(torch.equal(lse, lse2)),
              "dK_bit_equal": bool(torch.equal(a[1], b[1])),
              "dV_bit_equal": bool(torch.equal(a[2], b[2])),
              "dQ_max_abs_diff": float((a[0] - b[0]).abs().max())}
    if not all(x for n, x in repeat.items() if n.endswith("bit_equal")):
        bad.append(("repeat", repeat))
    del a, b, o2, lse2
    q4, k4, v4, do4 = (x.view(bh // 12, 12, t, d) for x in (q, k, v, do))
    lib = torch.ops.aten._scaled_dot_product_flash_attention(q4, k4, v4)
    kernels = {
        "flash_fwd_wgmma": lambda: fa.flash_fwd_wgmma(q, k, v, t,
                                                      out_dtype=f32),
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, t, out_dtype=f32),
        "flash_bwd": lambda: fa.flash_bwd(q, k, v, do, lse, delta, t,
                                          out_dtype=f32),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, t,
                                                out_dtype=f32),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                  t, out_dtype=f32)}
    # The backward kernels' plain version is one function, the dense
    # backward (dQ, dK and dV together), as is the library's backward call.
    plain = {"fwd": lambda: fa.flash_fwd_plain(q, k, v, t, out_dtype=f32),
             "bwd": lambda: fa.flash_bwd_plain(q, k, v, do, lse, delta, t,
                                               out_dtype=f32)}
    library = {
        "fwd": lambda: torch.ops.aten._scaled_dot_product_flash_attention(
            q4, k4, v4),
        "bwd": lambda: torch.ops.aten
        ._scaled_dot_product_flash_attention_backward(
            do4, q4, k4, v4, lib[0], lib[1], lib[2], lib[3], lib[4], lib[5],
            0.0, False, lib[6], lib[7])}
    bounds = _flash_bounds(bh, t, d)
    err = {"flash_fwd_wgmma": max(hop_err["O_wgmma"], hop_err["LSE_wgmma"]),
           "flash_fwd": max(hop_err["O"], hop_err["LSE"]),
           "flash_bwd": max(hop_err["dQ_fused"], hop_err["dK_fused"],
                            hop_err["dV_fused"]),
           "flash_bwd_dq": hop_err["dQ"],
           "flash_bwd_dkv": max(hop_err["dK"], hop_err["dV"])}
    # Each redesign against its first version and the library, in turns
    # (new, old, library, library, old, new) in this one call.
    redesigns = {"fwd": ("flash_fwd_wgmma", "first_version_k5",
                         kernels["flash_fwd"]),
                 "bwd": ("flash_bwd", "first_version_k6_k7",
                         lambda: (kernels["flash_bwd_dq"](),
                                  kernels["flash_bwd_dkv"]()))}
    turns, lib_ms, ms = {}, {}, {}
    for key, (new, old, old_fn) in redesigns.items():
        fns = {new: kernels[new], old: old_fn, "library": library[key]}
        turns[key] = {name: [] for name in fns}
        for name in (new, old, "library", "library", old, new):
            turns[key][name].append(cuda_time_ms(fns[name], 20))
        lib_ms[key] = turns[key]["library"]
        ms[new] = turns[key][new]
        if key == "fwd":
            ms["flash_fwd"] = turns[key][old]
        mats = FLASH_MATS[new] * bh * t * t * d
        emit({"phase": "kernel_flash_vs_plain", "redesign": new,
              "shape": list(HOP), "dtype": "bfloat16 in, float32 out",
              "turns_ms": turns[key], "bound_ms": bounds[new][0],
              f"tflops_{FLASH_MATS[new]}_mats": {
                  n: mats / min(x) / 1e9 for n, x in turns[key].items()},
              "share_of_bound": bounds[new][0] / min(turns[key][new]),
              "faster_than_first_version_in_every_turn": max(
                  turns[key][new]) < min(turns[key][old]),
              "repeat": repeat, "card": state["card"]})
    plain_ms = {key: [cuda_time_ms(fn, 3)] for key, fn in plain.items()}
    state["flash"] = {}
    for name, fk in kernels.items():
        key = "fwd" if name.startswith("flash_fwd") else "bwd"
        if name not in ms:
            ms[name] = [cuda_time_ms(fk, 20), cuda_time_ms(fk, 20)]
        plain_ms[key].append(cuda_time_ms(plain[key], 3))
        bound_ms, bound_by = bounds[name]
        state["flash"][name] = {
            "ms": min(ms[name]), "plain_ms": min(plain_ms[key]),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": min(lib_ms[key]), "max_abs_err": err[name]}
        emit({"phase": "kernel_flash_vs_plain", "kernel": name,
              "shape": list(HOP), "dtype": "bfloat16 in, float32 out",
              "ms_runs": ms[name], "plain_ms_runs": plain_ms[key],
              "library_ms_runs": lib_ms[key],
              "library_call": ("aten._scaled_dot_product_flash_attention"
                               if key == "fwd" else
                               "aten._scaled_dot_product_flash_attention_"
                               "backward (dQ, dK and dV together)"),
              "bound_ms": bound_ms, "bound_by": bound_by,
              "tflops": FLASH_MATS[name] * bh * t * t * d / min(ms[name])
              / 1e9,
              "card": state["card"]})
    emit({"phase": "kernel_flash_vs_plain", "cases": errors,
          "mean_abs_plain": typical,
          "tolerance": {name: tol for name, (_, _, tol) in cases.items()},
          "future_block": future, "outside_tolerance": bad,
          "card": state["card"]})
    if bad:
        raise AssertionError(f"the flash kernels differ from their plain "
                             f"versions: {bad}")
    if max(ms["flash_fwd_wgmma"]) >= min(ms["flash_fwd"]):
        raise AssertionError(f"the wgmma forward is not faster than the "
                             f"first version in every turn: "
                             f"{turns['fwd']}")


SP_STEPS, SP_BATCH, SP_SLOTS, SP_IMAGE = 2, 8, 2, 1024
RING_ATOL, RING_RTOL = 5e-3, 2.0 ** -7


def sp_trainer(steps: int, n_test: int, seed: int = 0):
    """The SP path's trainer: ViT-B/16 (bf16, 1,000 classes) on synthetic
    ImageNet at 1024 x 1024 over 2 sequence slots, batch 8."""
    from distributed_parameter_server_for_ml_training_tpu_torch.data import \
        synthetic_imagenet
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .model_parallel import ModelParallelConfig, SPTrainer

    ds = synthetic_imagenet(n_train=SP_BATCH * steps, n_test=n_test,
                            image_size=SP_IMAGE, seed=seed)
    return SPTrainer(ds, ModelParallelConfig(
        model="vit_b16", num_workers=SP_SLOTS, batch_size=SP_BATCH,
        num_epochs=1, num_classes=ds.num_classes, dtype="bfloat16",
        device="cuda", seed=seed))


def _flash_counts() -> dict:
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        flash_attention as fa

    return {"flash_fwd_wgmma": fa.flash_fwd_wgmma.launches,
            "flash_fwd": fa.flash_fwd.launches,
            "flash_bwd": fa.flash_bwd.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def _reset_flash_counts() -> None:
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        flash_attention as fa

    fa.flash_fwd_wgmma.launches = 0
    fa.flash_fwd.launches = 0
    fa.flash_bwd.launches = 0
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0


def phase_sp_path(state: dict) -> None:
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.data.cifar \
        import standardize, to_float
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        .ring_attention import make_ring_flash_attention

    trainer = sp_trainer(SP_STEPS, n_test=SP_BATCH)
    if not trainer.flash or trainer.tokens != 4096:
        raise AssertionError(f"SP path not on the flash ring (flash "
                             f"{trainer.flash}, {trainer.tokens} tokens)")
    model = trainer.model
    init = {k: v.clone() for k, v in trainer.state.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts()
    t0 = time.perf_counter()
    metrics = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _flash_counts()
    state["sp_counts"] = counts
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = trainer.global_steps
    eval_batches = -(-len(trainer.dataset.x_test) // 1000)
    moved = sum(not torch.equal(init[k], v)
                for k, v in trainer.state.params.items())
    finite = all(math.isfinite(v) for v in trainer.train_loss_per_epoch) \
        and all(bool(torch.isfinite(v).all())
                for v in trainer.state.params.values())

    # Step time at the path's shapes, by CUDA events.
    xb, yb = trainer.dataset.x_train[:SP_BATCH], \
        trainer.dataset.y_train[:SP_BATCH]
    gen = torch.Generator(device="cuda").manual_seed(3)
    times = []
    for i in range(4):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        trainer._step(trainer.state, xb, yb, gen)
        b.record()
        torch.cuda.synchronize()
        if i:
            times.append(a.elapsed_time(b))

    # One layer's ring on real activations: kernels against plain hops.
    # The input of block 0's attention, from one forward of the model.
    captured = {}
    hook = model.block_0.attn.register_forward_pre_hook(
        lambda mod, args: captured.setdefault("x", args[0]))
    with torch.no_grad():
        model(standardize(to_float(torch.as_tensor(xb, device="cuda"))))
        hook.remove()
        qkv = model.block_0.attn.qkv(captured.pop("x")).view(
            SP_BATCH, trainer.tokens, 3, 12, 64)
    ring_err = {}
    outs = {}
    cot = torch.randn((SP_BATCH, 4096, 12, 64), device="cuda",
                      generator=gen).to(torch.bfloat16)
    for kind in ("kernel", "plain"):
        ring = make_ring_flash_attention(trainer.mesh,
                                         use_kernel=kind == "kernel")
        q, k, v = (qkv[:, :, i].detach().clone().requires_grad_()
                   for i in range(3))
        out = ring(q, k, v)
        (out.float() * cot.float()).sum().backward()
        outs[kind] = [out.detach().float(), q.grad.float(), k.grad.float(),
                      v.grad.float()]
        del q, k, v, out
        torch.cuda.empty_cache()
    # The ring returns bf16: a one-step rounding difference is 2^-7 of
    # the value, so rtol is one bf16 step and atol covers values near 0.
    ring_ok, ring_typical = True, {}
    for name, a, b in zip(("out", "dq", "dk", "dv"), outs["kernel"],
                          outs["plain"]):
        ring_err[name] = float((a - b).abs().max())
        ring_typical[name] = float(b.abs().mean())
        ring_ok &= bool(torch.allclose(a, b, atol=RING_ATOL,
                                       rtol=RING_RTOL))
    del outs
    torch.cuda.empty_cache()

    images = steps * SP_BATCH
    train_s = sum(trainer.train_seconds)
    state["sp_step_ms"] = float(np.median(times))
    emit({"phase": "sp_path", "model": "vit_b16", "dtype": "bfloat16",
          "image_size": SP_IMAGE, "tokens": trainer.tokens,
          "seq_slots": SP_SLOTS, "tokens_per_slot": trainer.tokens // SP_SLOTS,
          "batch_size": SP_BATCH, "steps": steps,
          "eval_batches": eval_batches, "launches": counts,
          "train_loss_per_epoch": trainer.train_loss_per_epoch,
          "test_accuracies": trainer.test_accuracies,
          "tensors_moved": moved, "metrics": metrics,
          "img_per_s": images / train_s, "train_seconds": train_s,
          "run_seconds": wall, "step_ms_median": state["sp_step_ms"],
          "step_ms_runs": times, "peak_memory_gib": peak_gb,
          "ring_layer0_kernel_vs_plain_max_abs_err": ring_err,
          "ring_layer0_plain_mean_abs": ring_typical,
          "card": state["card"]})
    # One wgmma forward and one fused backward a hop; the first versions
    # of K5, K6 and K7 (fp32 inputs) are on no step of this bf16 path.
    want = {"flash_fwd_wgmma": 24 * (steps + eval_batches), "flash_fwd": 0,
            "flash_bwd": 24 * steps, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if steps != SP_STEPS or counts != want:
        raise AssertionError(f"{steps} steps launched {counts}; expected "
                             f"{want}")
    if not finite or moved == 0:
        raise AssertionError(f"losses finite {finite}, tensors moved {moved}")
    if not ring_ok:
        raise AssertionError(f"the ring with the kernels is outside atol "
                             f"{RING_ATOL} / rtol {RING_RTOL} of the ring "
                             f"with plain hops: {ring_err}")


def phase_sp_profile(state: dict) -> None:
    """Where the time goes on the SP path: one step under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trainer = sp_trainer(1, n_test=1, seed=2)
    xb, yb = trainer.dataset.x_train, trainer.dataset.y_train
    gen = torch.Generator(device="cuda").manual_seed(0)
    trainer._step(trainer.state, xb, yb, gen)           # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer._step(trainer.state, xb, yb, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof)
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    flash_us = sum(e.self_device_time_total for e in events
                   if "flash_" in e.key and "kernel" in e.key)
    fused = [e for e in events if "flash_bwd_kernel" in e.key]
    forward = [e for e in events if "flash_fwd_wgmma_kernel" in e.key]
    emit({"phase": "sp_profile", "steps": 1, "wall_s": wall,
          "device_busy_s": device_us / 1e6,
          "device_idle_share": (1 - device_us / 1e6 / wall)
          if device_us else None,
          "flash_kernels_device_s": flash_us / 1e6,
          "flash_bwd_device_ms": sum(e.self_device_time_total
                                     for e in fused) / 1e3,
          "flash_bwd_launches": sum(e.count for e in fused),
          "flash_fwd_wgmma_device_ms": sum(e.self_device_time_total
                                           for e in forward) / 1e3,
          "flash_fwd_wgmma_launches": sum(e.count for e in forward),
          "top_device_ms": [[e.key[:160], round(e.self_device_time_total
                                               / 1e3, 3), e.count]
                            for e in top],
          "card": state["card"]})


def phase_cli(state: dict) -> None:
    from distributed_parameter_server_for_ml_training_tpu_torch import cli

    runs = {"async": ["train", "--mode", "async", "--workers", "2",
                      "--epochs", "1", "--synthetic", "--num-train", "1024",
                      "--num-test", "500", "--emit-metrics"],
            "sync_int8": ["train", "--mode", "sync", "--workers", "4",
                          "--compression", "int8", "--epochs", "1",
                          "--synthetic", "--num-train", "2048",
                          "--num-test", "500", "--emit-metrics"],
            "baseline": ["train", "--mode", "baseline", "--epochs", "1",
                         "--synthetic", "--num-train", "2048",
                         "--num-test", "500", "--emit-metrics"],
            "sp_vit_b16_1024": ["train", "--mode", "sp", "--model", "vit_b16",
                                "--dataset", "imagenet-synth",
                                "--image-size", "1024", "--workers", "2",
                                "--batch-size", "8", "--num-train", "8",
                                "--num-test", "8", "--epochs", "1",
                                "--emit-metrics"]}
    for name, argv in runs.items():
        t0 = time.perf_counter()
        rc = cli.main(argv)
        emit({"phase": "cli", "run": name, "rc": rc,
              "seconds": round(time.perf_counter() - t0, 3)})
        if rc != 0:
            raise AssertionError(f"cli {' '.join(argv)} returned {rc}")


GRPC_WORKER_TIMEOUT_S = 420    # (b): each worker process, start to exit
GRPC_SERVER_TIMEOUT_S = 60     # (b): the server, after its workers exit


def _rpc_timer(remote, times: dict) -> None:
    """Time every call of ``remote``'s method stubs into ``times[rpc]``
    (milliseconds), beside the client's own histograms."""
    for name, call in list(remote._call.items()):
        def timed(request, timeout=None, call=call, name=name):
            t0 = time.perf_counter()
            try:
                return call(request, timeout=timeout)
            finally:
                times.setdefault(name, []).append(
                    (time.perf_counter() - t0) * 1e3)
        remote._call[name] = timed


def _grpc_run(steps_per_worker: int, n_test: int, seed: int,
              eval_each_epoch: bool, record: bool, store_kw=None,
              worker_kw=None, probe=None, service=None, worker_kw_of=None,
              parts=None, batch: int = BATCH):
    """Phase 5's configuration through the port's gRPC service on
    127.0.0.1: the server in this process, 2 ``PSWorker`` threads on the
    card, each through its own ``RemoteStore``. ``store_kw`` and
    ``worker_kw`` add StoreConfig and WorkerConfig options (phase 15),
    ``worker_kw_of(i)`` options of worker i alone (phase 18), and
    ``service(store)`` builds the service (phase 18: with a monitor).
    With ``record``, the service keeps every push request and fetch
    reply, and the device codec the first gradients of each worker.
    ``probe(workers, done)`` runs on a thread of its own while the
    workers train. ``parts`` replaces phase 5's ``(dataset, model, store,
    initial params)`` and ``batch`` its batch (phase 19). Returns a dict
    of the run's pieces."""
    import threading

    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.comms import (
        ParameterService, RemoteStore, serve)
    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .device_codec import DeviceCodec
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        ParameterStore, PSWorker, StoreConfig, WorkerConfig)

    ds, model, store, init = parts or main_path(steps_per_worker, n_test,
                                                seed)
    if store_kw:
        store = ParameterStore(init, StoreConfig(**{
            "mode": "async", "total_workers": N_WORKERS,
            "push_codec": "int8", "staleness_bound": 5, **store_kw}))
    svc = service(store) if service else ParameterService(store)
    pushes, fetches, first_grads = [], [], {}
    encode = DeviceCodec.encode
    if record:
        push_body, fetch_body = svc.push_gradrients, svc.fetch_parameters

        def push_rec(request, ctx):
            reply = push_body(request, ctx)
            pushes.append((bytes(request), reply))
            return reply

        def fetch_rec(request, ctx):
            reply = fetch_body(request, ctx)
            fetches.append((len(request), reply))
            return reply
        svc.push_gradrients, svc.fetch_parameters = push_rec, fetch_rec

        def encode_spy(self, flat, plan=None, scales=None):
            wid = threading.current_thread().result.worker_id
            if wid not in first_grads:
                first_grads[wid] = (
                    {k: v.detach().float().cpu().numpy()
                     for k, v in flat.items()},
                    dict(plan or {}), dict(scales or {}))
            return encode(self, flat, plan=plan, scales=scales)
        DeviceCodec.encode = encode_spy
    server, port = serve(store, port=0, service=svc, host="127.0.0.1")
    rpc_ms: dict = {}
    remotes = [RemoteStore(f"127.0.0.1:{port}") for _ in range(N_WORKERS)]
    for r in remotes:
        _rpc_timer(r, rpc_ms)
    workers = [PSWorker(r, model, ds, WorkerConfig(
        batch_size=batch, num_epochs=1, device="cuda",
        eval_each_epoch=eval_each_epoch, **(worker_kw or {}),
        **(worker_kw_of(i) if worker_kw_of else {})),
        worker_name=f"grpc-{i}") for i, r in enumerate(remotes)]
    done = threading.Event()
    prober = threading.Thread(target=probe, args=(workers, done),
                              daemon=True) if probe else None
    try:
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        if prober is not None:
            prober.start()
        for w in workers:
            w.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        done.set()
        if prober is not None:
            prober.join(10)
        DeviceCodec.encode = encode
        for r in remotes:
            r.close()
        server.stop(grace=None).wait(10)
    return {"store": store, "init": init, "results": [w.result
                                                      for w in workers],
            "remotes": remotes, "wall": wall, "pushes": pushes,
            "fetches": fetches, "first_grads": first_grads,
            "rpc_ms": rpc_ms, "address": f"127.0.0.1:{port}",
            "service": svc, "workers": workers}


def _grpc_in_process(state: dict) -> None:
    import collections

    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .service import unpack_msg
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .wire import encode_tensor_dict, frame_checksum_ok
    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .compression import ErrorFeedback, compress_push
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        import get_registry

    corrupt = get_registry().counter("dps_wire_corrupt_total")
    corrupt0 = corrupt.value
    Q.wire_quantize_multi.launches = 0
    run = _grpc_run(steps_per_worker=8, n_test=1000, seed=0,
                    eval_each_epoch=True, record=True)
    launches = {"wire_quantize_multi": Q.wire_quantize_multi.launches}
    state["grpc_k1_launches"] = launches
    store, results = run["store"], run["results"]
    errors = [repr(r.error) for r in results if r.error is not None]
    n_push = sum(r.pushes_accepted + r.pushes_rejected for r in results)
    final, step = store.snapshot()
    moved = sum(not np.array_equal(final[k], run["init"][k])
                for k in run["init"])
    replies = [unpack_msg(reply)[0] for _, reply in run["pushes"]]
    duplicates = sum(bool(m.get("duplicate")) for m in replies)
    refused = sum(bool(m.get("corrupt")) for m in replies)
    frames = [unpack_msg(req) for req, _ in run["pushes"]]
    trailer_ok = sum(frame_checksum_ok(f) is True for _, f in frames)
    # Each worker's first push against the NumPy codec on the same
    # gradients: a fresh error feedback, the same plan and scales.
    frame_checks = {}
    for wid, (grads, plan, scales) in sorted(run["first_grads"].items()):
        want = encode_tensor_dict(
            compress_push(grads, plan, scales=scales or None,
                          ef=ErrorFeedback()), checksum=True)
        got = [bytes(f) for m, f in frames if m["worker_id"] == wid
               and m["push_token"].endswith(":1")]
        frame_checks[wid] = {"bytes": len(want),
                             "equal": got == [want]}
    fetch_meta = [unpack_msg(r)[0] for _, r in run["fetches"]]
    full = [len(r) for (_, r), m in zip(run["fetches"], fetch_meta)
            if not m.get("not_modified")]
    nm = [len(r) for (_, r), m in zip(run["fetches"], fetch_meta)
          if m.get("not_modified")]
    hist = get_registry().snapshot()["histograms"]
    rpc_hist = {k.split("rpc=")[1].rstrip("}"): {
        "count": h["count"],
        "mean_ms": h["sum"] / h["count"] * 1e3 if h["count"] else None}
        for k, h in hist.items() if k.startswith("dps_rpc_client_seconds")
        and h["count"]}
    images = sum(r.local_steps_completed for r in results) * BATCH
    train_s = max(sum(r.epoch_times) for r in results)
    state["grpc_a"] = {
        "img_per_s": images / train_s,
        "rpc_ms_median": {k: float(np.median(v))
                          for k, v in sorted(run["rpc_ms"].items())},
        "push_request_bytes": sorted(set(len(q) for q, _ in run["pushes"])),
        "fetch_reply_bytes_full": sorted(set(full))}
    emit({"phase": "grpc_path", "form": "in_process", "model": "resnet18",
          "workers": N_WORKERS, "batch_size": BATCH, "push_codec": "int8",
          "global_step": step, "pushes": n_push,
          "pushes_rejected": sum(r.pushes_rejected for r in results),
          "k1_launches": launches, "duplicates": duplicates,
          "refused_corrupt": refused,
          "corrupt_counter": corrupt.value - corrupt0,
          "push_frames_with_valid_crc": trailer_ok,
          "first_push_frame_vs_compress_push": frame_checks,
          "tensors_moved": moved,
          "train_loss_per_epoch": [v for r in results
                                   for v in r.train_loss_per_epoch],
          "test_accuracies": [r.test_accuracies for r in results],
          "images": images, "img_per_s": images / train_s,
          "train_seconds": train_s, "run_seconds": run["wall"],
          "phase5_img_per_s": state.get("main_path_img_per_s"),
          "rpc_ms_median": {k: float(np.median(v))
                            for k, v in sorted(run["rpc_ms"].items())},
          "rpc_calls": {k: len(v) for k, v in sorted(run["rpc_ms"].items())},
          "rpc_client_histograms": rpc_hist,
          "push_request_bytes": sorted(set(len(q) for q, _ in run["pushes"])),
          "push_reply_bytes": sorted(set(len(r) for _, r in run["pushes"])),
          "push_frame_bytes": sorted(set(len(f) for _, f in frames)),
          "fetch_request_bytes": sorted(set(n for n, _ in run["fetches"])),
          "fetch_reply_bytes_full": sorted(set(full)),
          "fetch_reply_bytes_not_modified": sorted(set(nm)),
          "fetches_full": len(full), "fetches_not_modified": len(nm),
          "wire_stats": [r.wire for r in results],
          "store": store.metrics(),
          "staleness_counts": dict(sorted(collections.Counter(
              store.stats.staleness_values).items())),
          "card": state["card"]})
    if errors:
        raise AssertionError(f"worker errors: {errors}")
    if step <= 0 or n_push != N_WORKERS * 8:
        raise AssertionError(f"step {step}, {n_push} pushes; expected "
                             f"a step above 0 and {N_WORKERS * 8} pushes")
    want = {"wire_quantize_multi": -(-62 // Q.WIRE_MAX_ENTRIES) * n_push}
    if launches != want:
        raise AssertionError(f"K1 launched {launches} times for {n_push} "
                             f"pushes; expected {want}")
    if duplicates or refused or corrupt.value != corrupt0:
        raise AssertionError(f"{duplicates} duplicate and {refused} "
                             f"corrupt push replies")
    if trailer_ok != n_push or len(frames) != n_push:
        raise AssertionError(f"{trailer_ok} of {len(frames)} push frames "
                             f"carry a valid CRC trailer; {n_push} pushes")
    if len(frame_checks) != N_WORKERS or not all(
            c["equal"] for c in frame_checks.values()):
        raise AssertionError(f"push frames differ from compress_push's: "
                             f"{frame_checks}")
    if moved == 0:
        raise AssertionError("the store's params did not move")


def _grpc_profile(state: dict) -> None:
    """The same path, shorter and without eval, under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = _grpc_run(steps_per_worker=4, n_test=10, seed=2,
                        eval_each_epoch=False, record=False)
    events = device_events(prof)
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    errors = [repr(r.error) for r in run["results"] if r.error is not None]
    state["grpc_idle_share"] = (1 - device_us / 1e6 / run["wall"]) \
        if device_us else None
    emit({"phase": "grpc_path", "form": "profile",
          "steps": run["store"].global_step, "wall_s": run["wall"],
          "device_busy_s": device_us / 1e6,
          "device_idle_share": state["grpc_idle_share"],
          "top_device_ms": [[e.key[:120], round(e.self_device_time_total
                                               / 1e3, 3), e.count]
                            for e in top],
          "card": state["card"]})
    if errors:
        raise AssertionError(f"worker errors: {errors}")


def _metrics_rows(text: str) -> list:
    return [json.loads(line.split("METRICS_JSON:", 1)[1])
            for line in text.splitlines() if "METRICS_JSON:" in line]


def _grpc_processes(state: dict) -> None:
    """The reference's topology: ``cli serve`` and 2 ``cli worker``
    processes on the card, over gRPC on 127.0.0.1."""
    import os
    import re
    import socket
    import tempfile

    cli = [sys.executable, "-m",
           "distributed_parameter_server_for_ml_training_tpu_torch.cli"]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(repo)}
    procs, late = [], None
    # Output goes to files, so that no process blocks on a full pipe; the
    # server's stderr is read up to its 'up' line.
    logs = [tempfile.TemporaryFile("w+") for _ in range(5)]
    t0 = time.perf_counter()
    try:
        server = subprocess.Popen(
            cli + ["serve", "--mode", "async", "--workers", "2",
                   "--push-codec", "int8", "--port", str(port),
                   "--emit-metrics"],
            cwd=repo, env=env, stdout=logs[0], stderr=subprocess.PIPE,
            text=True)
        procs.append(server)
        up = None
        while up is None:
            line = server.stderr.readline()
            if not line:
                break
            up = re.search(r"parameter server up on :(\d+)", line)
        workers = [subprocess.Popen(
            cli + ["worker", "--server", f"127.0.0.1:{port}",
                   "--worker-name", f"proc-{i}", "--synthetic",
                   "--num-train", "2048", "--epochs", "1",
                   "--emit-metrics"],
            cwd=repo, env=env, stdout=logs[1 + 2 * i],
            stderr=logs[2 + 2 * i], text=True)
            for i in range(2)] if up else []
        procs += workers
        deadline = time.perf_counter() + GRPC_WORKER_TIMEOUT_S
        for w in workers:
            try:
                w.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                late = f"a cli worker still alive after " \
                       f"{GRPC_WORKER_TIMEOUT_S} s"
                break
        if late is None:
            try:
                s_err = server.communicate(
                    timeout=GRPC_SERVER_TIMEOUT_S)[1]
            except subprocess.TimeoutExpired:
                late = f"cli serve still alive {GRPC_SERVER_TIMEOUT_S} s " \
                       f"after its workers"
        wall = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
    if late is not None or not up:
        raise AssertionError(
            f"{late or 'cli serve never came up'}; killed. Output tails: "
            f"{[t[-1500:] for t in texts]}")
    s_out, outs = texts[0], [(texts[1], texts[2]), (texts[3], texts[4])]
    rows = [_metrics_rows(out) for out, _ in outs]
    srv = _metrics_rows(s_out)
    rcs = {"server": server.returncode,
           "workers": [w.returncode for w in workers]}
    img_s = [r[-1]["local_steps_completed"] * BATCH
             / r[-1]["total_training_time_seconds"]
             for r in rows if r and r[-1]["total_training_time_seconds"]]
    sm = srv[-1] if srv else {}
    emit({"phase": "grpc_path", "form": "processes", "port": port,
          "rcs": rcs, "wall_seconds": wall,
          "workers_img_per_s": img_s, "img_per_s_summed": sum(img_s),
          "worker_metrics": [r[-1] if r else None for r in rows],
          "server_metrics": sm,
          "server_apply_seconds": sm.get("average_update_time_seconds", 0)
          * sm.get("total_parameter_updates", 0),
          "card": state["card"]})
    if rcs != {"server": 0, "workers": [0, 0]}:
        tails = [err[-2000:] for _, err in outs] + [s_err[-2000:]]
        raise AssertionError(f"process exit codes {rcs}: {tails}")
    if not sm or sm.get("global_steps_completed", 0) <= 0:
        raise AssertionError(f"server metrics report no step: {sm}")
    if len(img_s) != 2:
        raise AssertionError(f"worker metrics missing: {rows}")


def phase_grpc_path(state: dict) -> None:
    """Phase 14: the gRPC path, in one process and across processes."""
    _grpc_in_process(state)
    _grpc_profile(state)
    _grpc_processes(state)


# Phase 15: the store options and the worker's modes over gRPC.
MODES_STORE = dict(fetch_codec="bf16", worker_timeout=30)
MODES_WORKER = dict(k_step_mode="local_sgd", sync_steps=4, overlap=True,
                    heartbeat_interval=1.0)
MODES_STEPS = 16          # batches of 128 a worker: 4,096 images, 4 pushes


def _saved_values(names):
    """Have the registry hand out, for the named histograms, proxies that
    keep every observed value (the workers create theirs at start);
    returns (values by histogram name, restore)."""
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        import get_registry
    reg = get_registry()
    orig = reg.histogram
    kept = {name: [] for name in names}

    class Keeping:
        def __init__(self, inner, box):
            self._inner, self._box = inner, box

        def observe(self, v, *args, **kwargs):
            self._box.append(float(v))
            return self._inner.observe(v, *args, **kwargs)

        def __getattr__(self, name):
            return getattr(self._inner, name)

    def histogram(name, *args, **kwargs):
        h = orig(name, *args, **kwargs)
        return Keeping(h, kept[name]) if name in kept else h

    reg.histogram = histogram

    def restore():
        del reg.histogram
    return kept, restore


def _modes_levers(state: dict) -> None:
    """(a) The reference topology with the JAX package's levers on, beside
    phase 14 (a) from the same run; then the same run with overlap off,
    and a profiled shorter one."""
    import ml_dtypes
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_parameter_server_for_ml_training_tpu_torch.comms import (
        ParameterService, RemoteStore, serve)
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .service import unpack_msg
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .wire import frame_checksum_ok
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    depth = {"max": 0, "samples": 0, "busy": 0}

    def sample_depth(workers, done):
        while not done.is_set():
            for w in workers:
                pipe = w._pipe
                if pipe is not None:
                    d = int(pipe._tm_depth.value)   # the depth gauge
                    depth["max"] = max(depth["max"], d)
                    depth["samples"] += 1
                    depth["busy"] += d
            time.sleep(0.0005)

    saved, restore = _saved_values(("dps_worker_overlap_saved_seconds",
                                    "dps_worker_d2h_overlap_saved_seconds"))
    Q.wire_quantize_multi.launches = 0
    try:
        run = _grpc_run(steps_per_worker=MODES_STEPS, n_test=1000, seed=0,
                        eval_each_epoch=True, record=True,
                        store_kw=MODES_STORE, worker_kw=MODES_WORKER,
                        probe=sample_depth)
    finally:
        restore()
    launches = Q.wire_quantize_multi.launches
    state["modes_k1_launches"] = {"wire_quantize_multi": launches}
    store, results = run["store"], run["results"]
    errors = [repr(r.error) for r in results if r.error is not None]
    n_push = sum(r.pushes_accepted + r.pushes_rejected for r in results)
    final, step = store.snapshot()
    moved = sum(not np.array_equal(final[k], run["init"][k])
                for k in run["init"])
    replies = [unpack_msg(reply)[0] for _, reply in run["pushes"]]
    duplicates = sum(bool(m.get("duplicate")) for m in replies)
    frames = [unpack_msg(req)[1] for req, _ in run["pushes"]]
    crc_ok = sum(frame_checksum_ok(f) is True for f in frames)
    fetch_meta = [unpack_msg(r)[0] for _, r in run["fetches"]]
    full = [len(r) for (_, r), m in zip(run["fetches"], fetch_meta)
            if not m.get("not_modified")]
    nm = sum(bool(m.get("not_modified")) for m in fetch_meta)
    # One fetch decoded by a fresh client, against the store's params
    # cast to bf16 and back, bit for bit (the run is over: no push races
    # it).
    server, port = serve(store, port=0, service=ParameterService(store),
                         host="127.0.0.1")
    try:
        probe_client = RemoteStore(f"127.0.0.1:{port}")
        probe_client.register_worker("probe")
        fetched, fstep = probe_client.fetch()
        probe_client.close()
    finally:
        server.stop(grace=None).wait(10)
    want, wstep = store.snapshot()
    fetch_bits = fstep == wstep and list(fetched) == sorted(want) and all(
        fetched[k].tobytes() == want[k].astype(ml_dtypes.bfloat16)
        .astype(np.float32).tobytes() for k in want)
    images = sum(r.local_steps_completed for r in results) * BATCH
    train_s = max(sum(r.epoch_times) for r in results)
    img_s = images / train_s
    ov = saved["dps_worker_overlap_saved_seconds"]
    d2h = saved["dps_worker_d2h_overlap_saved_seconds"]
    heartbeats = [r.heartbeats for r in results]

    # The same configuration, unrecorded and eval off, with overlap off
    # and on in turns (off, on, on, off): what the pipeline hides.
    turns = {False: [], True: []}
    s_err = []
    for overlap in (False, True, True, False):
        t_run = _grpc_run(steps_per_worker=MODES_STEPS, n_test=10, seed=0,
                          eval_each_epoch=False, record=False,
                          store_kw=MODES_STORE,
                          worker_kw={**MODES_WORKER, "overlap": overlap})
        t_res = t_run["results"]
        s_err += [repr(r.error) for r in t_res if r.error is not None]
        turns[overlap].append(
            sum(r.local_steps_completed for r in t_res) * BATCH
            / max(sum(r.epoch_times) for r in t_res))

    # A shorter run, eval off, under torch.profiler: the idle share.
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_run = _grpc_run(steps_per_worker=8, n_test=10, seed=2,
                             eval_each_epoch=False, record=False,
                             store_kw=MODES_STORE, worker_kw=MODES_WORKER)
    events = device_events(prof)
    device_us = sum(e.self_device_time_total for e in events)
    idle = (1 - device_us / 1e6 / prof_run["wall"]) if device_us else None
    p_err = [repr(r.error) for r in prof_run["results"]
             if r.error is not None]
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    p14 = state.get("grpc_a", {})
    emit({"phase": "grpc_modes", "form": "levers", "model": "resnet18",
          "workers": N_WORKERS, "batch_size": BATCH,
          "store": {"mode": "async", "push_codec": "int8",
                    "staleness_bound": 5, **MODES_STORE},
          "worker": MODES_WORKER, "images_per_worker": MODES_STEPS * BATCH,
          "global_step": step, "pushes": n_push,
          "pushes_rejected": sum(r.pushes_rejected for r in results),
          "k1_launches": launches, "duplicates": duplicates,
          "push_frames_with_valid_crc": crc_ok,
          "fetch_decoded_equals_bf16_of_store": fetch_bits,
          "pipeline_depth_max": depth["max"],
          "pipeline_depth_samples": depth["samples"],
          "pipeline_busy_share": depth["busy"] / max(depth["samples"], 1),
          "heartbeats": heartbeats,
          "heartbeat_errors": [r.heartbeat_errors for r in results],
          "tensors_moved": moved,
          "train_loss_per_epoch": [v for r in results
                                   for v in r.train_loss_per_epoch],
          "test_accuracies": [r.test_accuracies for r in results],
          "img_per_s": img_s, "train_seconds": train_s,
          "img_per_s_turns_overlap_on": turns[True],
          "img_per_s_turns_overlap_off": turns[False],
          "phase14_img_per_s": p14.get("img_per_s"),
          "rpc_ms_median": {k: float(np.median(v))
                            for k, v in sorted(run["rpc_ms"].items())},
          "rpc_calls": {k: len(v) for k, v in sorted(run["rpc_ms"].items())},
          "phase14_rpc_ms_median": p14.get("rpc_ms_median"),
          "push_request_bytes": sorted(set(len(q) for q, _ in run["pushes"])),
          "phase14_push_request_bytes": p14.get("push_request_bytes"),
          "fetch_reply_bytes_full": sorted(set(full)),
          "phase14_fetch_reply_bytes_full": p14.get(
              "fetch_reply_bytes_full"),
          "fetches_full": len(full), "fetches_not_modified": nm,
          "overlap_saved_s": {"sum": float(sum(ov)), "count": len(ov),
                              "median": float(np.median(ov)) if ov
                              else None},
          "d2h_saved_s": {"sum": float(sum(d2h)), "count": len(d2h)},
          "device_idle_share": idle,
          "phase14_device_idle_share": state.get("grpc_idle_share"),
          "profiled_steps": prof_run["store"].global_step,
          "profiled_wall_s": prof_run["wall"],
          "top_device_ms": [[e.key[:100], round(
              e.self_device_time_total / 1e3, 3), e.count] for e in top],
          "store_metrics": store.metrics(),
          "card": state["card"]})
    if errors or s_err or p_err:
        raise AssertionError(f"worker errors: {errors} {s_err} {p_err}")
    pushes_want = N_WORKERS * MODES_STEPS // MODES_WORKER["sync_steps"]
    if n_push != pushes_want or launches != n_push:
        raise AssertionError(f"{n_push} pushes and {launches} K1 launches;"
                             f" expected {pushes_want} of each")
    if duplicates or crc_ok != n_push or len(frames) != n_push:
        raise AssertionError(f"{duplicates} duplicates, {crc_ok} of "
                             f"{len(frames)} frames with a valid CRC")
    p14_full = (p14.get("fetch_reply_bytes_full") or [44_885_549])[0]
    if not full or not all(0.45 < n / p14_full < 0.55 for n in full):
        raise AssertionError(f"full bf16 fetch replies {sorted(set(full))}"
                             f" are not about half of {p14_full}")
    if not fetch_bits:
        raise AssertionError("a decoded bf16 fetch differs from the "
                             "store's params cast to bf16")
    if depth["max"] > 1 or depth["busy"] == 0:
        raise AssertionError(f"pipeline depth {depth}")
    if min(heartbeats) <= 0 or moved == 0:
        raise AssertionError(f"heartbeats {heartbeats}, {moved} tensors "
                             f"moved")


def _one_worker(store, model, ds, **worker_kw):
    """One PSWorker on the card against an in-process store whose pushes
    it records; returns (pushes, result)."""
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        PSWorker, WorkerConfig)

    class Recording:
        def __init__(self, inner):
            self._inner, self.pushes = inner, []

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def push(self, wid, grads, step):
            self.pushes.append({k: np.array(v) for k, v in grads.items()})
            return self._inner.push(wid, grads, step)

    rec = Recording(store)
    w = PSWorker(rec, model, ds, WorkerConfig(
        batch_size=BATCH, num_epochs=1, device="cuda",
        eval_each_epoch=False, **worker_kw))
    w.run()
    if w.result.error is not None:
        raise w.result.error
    return rec.pushes, w.result


def _modes_bits(state: dict) -> None:
    """(b) Bit checks on the card, one worker, deterministic cuDNN:
    local_sgd with K=1 pushes the faithful step's int8 frame, and
    overlap=True leaves the store bit-equal to overlap=False."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .wire import encode_tensor_dict
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        ParameterStore, StoreConfig)

    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        # 512 images: 4 batches for the one worker, 2 pushes at K=2.
        ds, model, _, init = main_path(2, 10, 3)

        def store():
            return ParameterStore(init, StoreConfig(
                mode="async", total_workers=1, push_codec="int8",
                staleness_bound=5))
        one = dataclasses.replace(ds, x_train=ds.x_train[:BATCH],
                                  y_train=ds.y_train[:BATCH])
        faithful, _ = _one_worker(store(), model, one)
        local, _ = _one_worker(store(), model, one, k_step_mode="local_sgd",
                               sync_steps=1)
        frames = [encode_tensor_dict(p[0], checksum=True)
                  for p in (faithful, local)]
        k1_equal = frames[0] == frames[1]
        runs = {}
        for overlap in (False, True):
            st = store()
            pushes, res = _one_worker(st, model, ds, k_step_mode="local_sgd",
                                      sync_steps=2, overlap=overlap)
            runs[overlap] = (st.snapshot(), pushes, res)
        (sp, sstep), _, _ = runs[False]
        (pp, pstep), _, _ = runs[True]
        overlap_equal = sstep == pstep and all(
            sp[k].tobytes() == pp[k].tobytes() for k in sp)
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = prev
    emit({"phase": "grpc_modes", "form": "bits", "cudnn_deterministic": True,
          "local_sgd_k1_frame_bytes": len(frames[1]),
          "local_sgd_k1_frame_equals_faithful": k1_equal,
          "overlap_store_equals_serial": overlap_equal,
          "overlap_steps": [sstep, pstep], "card": state["card"]})
    if not k1_equal:
        raise AssertionError("local_sgd K=1's int8 frame differs from "
                             "faithful's")
    if not overlap_equal or sstep != 2:
        raise AssertionError(f"overlap=True's store differs from "
                             f"overlap=False's (steps {sstep}, {pstep})")


def _modes_resume(state: dict) -> None:
    """(c) A resume drill: the server is stopped just before the worker's
    3rd push leaves and a new one starts on the same port from
    ``load_snapshot`` of the old store's snapshot."""
    import threading

    from distributed_parameter_server_for_ml_training_tpu_torch.comms import (
        ParameterService, RemoteStore, serve)
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        ParameterStore, PSWorker, StoreConfig, WorkerConfig)

    # MODES_STEPS batches for the one worker: its 4 pushes.
    ds, model, _, init = main_path(MODES_STEPS // N_WORKERS, 10, 4)

    def store():
        return ParameterStore(init, StoreConfig(
            mode="async", total_workers=1, push_codec="int8",
            staleness_bound=5, **MODES_STORE))
    store1 = store()
    server1, port = serve(store1, port=0, host="127.0.0.1",
                          service=ParameterService(store1))
    client = RemoteStore(f"127.0.0.1:{port}", rpc_timeout=10.0,
                         rpc_retries=1, rpc_backoff=0.05)
    worker = PSWorker(client, model, ds, WorkerConfig(
        batch_size=BATCH, num_epochs=1, device="cuda", eval_each_epoch=False,
        reconnect_timeout=60.0, reconnect_backoff=0.05, **MODES_WORKER))
    killed, restarted = threading.Event(), threading.Event()
    holder = {}

    def restart_after_kill():
        killed.wait(120)
        time.sleep(0.3)
        params, step = holder["snapshot"]
        store2 = store()
        store2.load_snapshot(params, step)
        server2, bound = serve(store2, port=port, host="127.0.0.1",
                               service=ParameterService(store2))
        holder.update(server2=server2, store2=store2, bound=bound)
        restarted.set()

    inner_push = client._call["PushGradrients"]

    def push_with_kill(request, timeout=None):
        push_with_kill.calls += 1
        if push_with_kill.calls == 3 and not killed.is_set():
            holder["snapshot"] = store1.snapshot()
            server1.stop(grace=None).wait(10)
            killed.set()
        return inner_push(request, timeout=timeout)

    push_with_kill.calls = 0
    client._call["PushGradrients"] = push_with_kill
    t = threading.Thread(target=restart_after_kill, daemon=True)
    t0 = time.perf_counter()
    t.start()
    worker.start()
    worker.join(300)
    t.join(120)
    wall = time.perf_counter() - t0
    try:
        r = worker.result
        store2 = holder.get("store2")
        total = MODES_STEPS // MODES_WORKER["sync_steps"]
        snap_step = holder["snapshot"][1] if "snapshot" in holder else None
        emit({"phase": "grpc_modes", "form": "resume",
              "error": repr(r.error) if r.error else None,
              "reconnects": r.reconnects, "pushes": total,
              "pushes_accepted": r.pushes_accepted,
              "snapshot_step": snap_step,
              "restored_port_bound": holder.get("bound") == port,
              "new_store_step": store2.global_step if store2 else None,
              "new_store_pushes_applied":
                  store2.stats.gradients_processed if store2 else None,
              "wall_s": wall, "card": state["card"]})
        if r.error is not None or worker.is_alive():
            raise AssertionError(f"worker failed: {r.error!r}")
        if not (killed.is_set() and restarted.is_set()
                and holder["bound"] == port):
            raise AssertionError("the server was not restarted on its port")
        # Each push applied exactly once: 2 before the stop (in the
        # snapshot), the rest — the stranded one re-sent under its own
        # token included — on the new server.
        if (r.reconnects, r.pushes_accepted, snap_step,
                store2.global_step, store2.stats.gradients_processed) != (
                1, total, 2, total, total - 2):
            raise AssertionError("a push was lost or applied twice")
    finally:
        if "server2" in holder:
            holder["server2"].stop(grace=None).wait(10)
        client.close()


def phase_grpc_modes(state: dict) -> None:
    """Phase 15: the store options and the worker's modes over gRPC."""
    _modes_levers(state)
    _modes_bits(state)
    _modes_resume(state)


# -- phase 16: the device-resident store -------------------------------------

# Bytes one async apply over ResNet-18 must move: read p, read g, write p,
# 11,220,132 fp32 values each.
APPLY_BYTES = 3 * 4 * 11_220_132
# A step's host-to-device bytes beside its batch: the labels and scalars.
SMALL_COPY_BYTES = 16_384


def _device_store_setup(steps_per_worker: int, n_test: int, seed: int,
                        backend: str = "device"):
    """Phase 5's configuration over ``make_store(backend, ...)``: the
    device store on the card, or (``python``) phase 5's int8 host store.
    Returns (dataset, model, store, initial params); the model's upload
    and the store's are done here, outside any measured run."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        StoreConfig, make_store)

    ds, model, store, init = main_path(steps_per_worker, n_test, seed)
    if backend == "device":
        store = make_store("device", init, StoreConfig(
            mode="async", total_workers=N_WORKERS, staleness_bound=5),
            device="cuda")
    torch.cuda.synchronize()
    return ds, model, store, init


def _device_store_run(model, store, ds, eval_each_epoch: bool):
    """The 2 workers' run over ``store``: (results, wall seconds)."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        WorkerConfig, run_workers)

    cfg = WorkerConfig(batch_size=BATCH, num_epochs=1, device="cuda",
                       eval_each_epoch=eval_each_epoch)
    t0 = time.perf_counter()
    results = run_workers(store, model, ds, N_WORKERS, cfg)
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def _img_per_s(results) -> float:
    """Images over the slowest worker's training seconds (eval out)."""
    images = sum(r.local_steps_completed for r in results) * BATCH
    return images / max(sum(r.epoch_times) for r in results)


def _device_store_async(state: dict) -> None:
    """(a) Phase 5's run with the device store: K1 must not launch. Then
    phase 5's python-store run again and the device store's again, in
    turns, with every cache warm (eval off)."""
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    ds, model, store, init = _device_store_setup(8, 1000, 0)
    Q.wire_quantize_multi.launches = 0
    results, wall = _device_store_run(model, store, ds, True)
    k1 = Q.wire_quantize_multi.launches
    pushes = sum(r.pushes_accepted + r.pushes_rejected for r in results)
    errors = [repr(r.error) for r in results if r.error is not None]
    losses = [v for r in results for v in r.train_loss_per_epoch]
    final, step = store.snapshot()
    moved = sum(not np.array_equal(final[k], init[k]) for k in init)
    train_s = max(sum(r.epoch_times) for r in results)
    times = grad_step_times(ds, final)
    metrics = store.metrics()
    python = state.get("main_path_store", {})
    turns = {}
    for backend in ("python", "device"):
        tds, tmodel, tstore, _ = _device_store_setup(8, 10, 0, backend)
        turns[backend] = _img_per_s(_device_store_run(
            tmodel, tstore, tds, False)[0])
    emit({"phase": "device_store", "form": "async", "model": "resnet18",
          "dtype": "bfloat16", "workers": N_WORKERS, "batch_size": BATCH,
          "global_step": step, "pushes": pushes, "k1_launches": k1,
          "img_per_s": _img_per_s(results),
          "img_per_s_python_store": state.get("main_path_img_per_s"),
          "img_per_s_turns_eval_off": turns,
          "train_seconds": train_s, "run_seconds": wall,
          "grad_step_ms_median": float(np.median(times)),
          "grad_step_ms_median_python_store": state.get("grad_step_ms"),
          "apply_s_mean": metrics["average_update_time_seconds"],
          "apply_samples": len(store.stats.update_times),
          "update_time_wait_every": metrics.get("update_time_wait_every"),
          "apply_s_mean_python_store":
              python.get("average_update_time_seconds"),
          "train_loss_per_epoch": losses,
          "test_accuracies": [r.test_accuracies for r in results],
          "tensors_moved": moved, "store": metrics, "card": state["card"]})
    if errors:
        raise AssertionError(f"worker errors: {errors}")
    if step <= 0 or step != pushes:
        raise AssertionError(f"step {step} for {pushes} pushes")
    if k1 != 0:
        raise AssertionError(f"K1 launched {k1} times on the device-store "
                             f"path, which has no codec")
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if moved == 0:
        raise AssertionError("the store's params did not move")


def _memcpy_bytes(prof) -> dict:
    """Bytes and count of the profile's memory copies by kind (HtoD,
    DtoH, DtoD, ...), from the trace's memcpy events."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    out: dict = {}
    for ev in trace.get("traceEvents", []):
        name = str(ev.get("name", ""))
        if not name.startswith("Memcpy") or ev.get("ph") != "X":
            continue
        kind = name.split()[1]
        n = (ev.get("args") or {}).get("bytes")
        if n is None:
            raise AssertionError(f"memcpy event without a byte count: "
                                 f"{ev}")
        row = out.setdefault(kind, {"bytes": 0, "count": 0})
        row["bytes"] += int(n)
        row["count"] += 1
    return out


def _device_store_profile(state: dict) -> None:
    """(b) A shorter run under torch.profiler: idle share, the apply's
    device time against its byte bound, and the host<->device bytes a
    step: the batches only, no parameter or gradient."""
    from torch.profiler import ProfilerActivity, profile

    ds, model, store, _ = _device_store_setup(4, 10, 2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        results, wall = _device_store_run(model, store, ds, False)
    events = device_events(prof)
    device_us = sum(e.self_device_time_total for e in events)
    applies = store.global_step
    apply_ev = [e for e in events if "multi_tensor_apply_kernel" in e.key]
    apply_us = sum(e.self_device_time_total for e in apply_ev) / applies
    bound_us = APPLY_BYTES / H100_BYTES_PER_S * 1e6
    copies = _memcpy_bytes(prof)
    steps = sum(r.local_steps_completed for r in results)
    batch_bytes = BATCH * 32 * 32 * 3
    htod = copies.get("HtoD", {}).get("bytes", 0) / steps
    dtoh = copies.get("DtoH", {}).get("bytes", 0) / steps
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    emit({"phase": "device_store", "form": "profile", "steps": steps,
          "applies": applies, "wall_s": wall,
          "device_busy_s": device_us / 1e6,
          "device_idle_share": 1 - device_us / 1e6 / wall,
          "apply_device_us": apply_us,
          "apply_kernel_launches": sum(e.count for e in apply_ev),
          "apply_bound_us": bound_us, "apply_bound_by": "bytes",
          "apply_share_of_bound": bound_us / apply_us if apply_us else None,
          "memcpy": copies, "htod_bytes_per_step": htod,
          "dtoh_bytes_per_step": dtoh, "batch_bytes": batch_bytes,
          "top_device_ms": [[e.key[:120], round(e.self_device_time_total
                                               / 1e3, 3), e.count]
                            for e in top],
          "card": state["card"]})
    if not apply_ev:
        raise AssertionError("no apply kernel in the profile")
    if not batch_bytes <= htod <= batch_bytes + SMALL_COPY_BYTES:
        raise AssertionError(f"{htod} host-to-device bytes a step; the "
                             f"batch is {batch_bytes}")
    if dtoh > SMALL_COPY_BYTES:
        raise AssertionError(f"{dtoh} device-to-host bytes a step")


def _device_store_parity(state: dict) -> None:
    """(c) Real gradients of one step drive two async pushes (the second
    one step stale) and one full sync round of 2 workers, through the
    device store on the card and on the CPU: bit-equal (tolerance 0)."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        DeviceParameterStore, StoreConfig)
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .steps import make_grad_step
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .pytree import params_to_jax

    ds, model, _, init = main_path(1, 10, 5)
    grad_step = make_grad_step(model, augment=False)
    params = {k: torch.from_numpy(v).cuda() for k, v in init.items()}
    _, stats = params_to_jax(model)
    stats = {k: torch.from_numpy(v).cuda() for k, v in stats.items()}
    grads = [grad_step(params, stats, ds.x_train[i:i + BATCH],
                       ds.y_train[i:i + BATCH])[0]
             for i in (0, BATCH)]

    def script(device, gs):
        a = DeviceParameterStore(init, StoreConfig(
            mode="async", total_workers=2, staleness_bound=5),
            device=device)
        a.register_worker()
        a.register_worker()
        out = [a.push(0, gs[0], 0), a.push(1, gs[1], 0)]
        mid, step = a.snapshot()
        r = DeviceParameterStore(mid, StoreConfig(mode="sync",
                                                  total_workers=2),
                                 device=device)
        r.register_worker()
        r.register_worker()
        out += [r.push(0, gs[0], step), r.push(1, gs[1], step)]
        final, fstep = r.snapshot()
        return out + [step, fstep], mid, final

    card = script("cuda", grads)
    cpu = script("cpu", [{k: v.cpu() for k, v in g.items()}
                         for g in grads])
    diffs = {name: max(float(np.max(np.abs(a[k] - b[k]))) for k in a)
             for name, a, b in (("async", card[1], cpu[1]),
                                ("sync_round", card[2], cpu[2]))}
    equal = all(a[k].tobytes() == b[k].tobytes()
                for a, b in ((card[1], cpu[1]), (card[2], cpu[2]))
                for k in a)
    emit({"phase": "device_store", "form": "parity",
          "returns": card[0], "returns_cpu": cpu[0], "bit_equal": equal,
          "max_abs_diff": diffs, "tolerance": 0.0, "card": state["card"]})
    if card[0] != cpu[0] or card[0] != [True, True, True, True, 2, 1]:
        raise AssertionError(f"returns {card[0]} != {cpu[0]}")
    if not equal:
        raise AssertionError(f"card and CPU differ: {diffs}")


def phase_device_store(state: dict) -> None:
    """Phase 16: the device-resident store at full width."""
    _device_store_async(state)
    _device_store_profile(state)
    _device_store_parity(state)


# -- phase 17: checkpoints on the card ---------------------------------------

def _lost_reply(state: dict) -> None:
    """(a) A push the server applied whose reply was lost: a snapshot is
    flushed, the server stopped, and a new one on the same port restored
    with its push-token journal answers the worker's retry as a
    duplicate, at the restored step, its params the snapshot's."""
    import shutil
    import tempfile
    import threading

    from distributed_parameter_server_for_ml_training_tpu_torch.checkpoint \
        import (PeriodicStoreCheckpointer, load_store_record,
                restore_server_state)
    from distributed_parameter_server_for_ml_training_tpu_torch.comms import (
        ParameterService, RemoteStore, serve)
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .service import unpack_msg
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        PSWorker, StoreConfig, WorkerConfig, make_store)

    # 4 batches for the one worker: 4 pushes.
    ds, model, _, init = main_path(4 // N_WORKERS, 10, 6)

    def store():
        return make_store("device", init, StoreConfig(
            mode="async", total_workers=1, staleness_bound=5),
            device="cuda")
    ckpt_dir = tempfile.mkdtemp(prefix="dps-ckpt-")
    store1 = store()
    svc1 = ParameterService(store1)
    ckpt = PeriodicStoreCheckpointer(store1, ckpt_dir, interval=3600.0,
                                     journal_fn=svc1.journal_snapshot)
    ckpt.start()
    server1, port = serve(store1, port=0, host="127.0.0.1", service=svc1)
    client = RemoteStore(f"127.0.0.1:{port}", rpc_timeout=10.0,
                         rpc_retries=1, rpc_backoff=0.05)
    worker = PSWorker(client, model, ds, WorkerConfig(
        batch_size=BATCH, num_epochs=1, device="cuda", eval_each_epoch=False,
        reconnect_timeout=60.0, reconnect_backoff=0.05))
    killed, restarted = threading.Event(), threading.Event()
    holder: dict = {}

    def restart_after_kill():
        killed.wait(120)
        time.sleep(0.3)
        store2 = store()
        svc2 = ParameterService(store2)
        t_restore = time.perf_counter()
        holder["restored"] = restore_server_state(store2, svc2, ckpt_dir)
        holder["restore_s"] = time.perf_counter() - t_restore
        npz, meta = load_store_record(ckpt_dir)
        holder["npz_bytes"] = meta["npz_size"]
        push_body = svc2.push_gradrients

        def first_push_seen(request, ctx):
            # The new server's first push is the worker's retry: its
            # reply, and the store's step and params as it answers.
            reply = push_body(request, ctx)
            if "retry" not in holder:
                params, step = store2.snapshot()
                holder["retry"] = (unpack_msg(reply)[0], step, all(
                    params[k].tobytes() == npz[k].tobytes() for k in npz))
            return reply
        svc2.push_gradrients = first_push_seen
        server2, bound = serve(store2, port=port, host="127.0.0.1",
                               service=svc2)
        holder.update(server2=server2, store2=store2, bound=bound)
        restarted.set()

    inner_push = client._call["PushGradrients"]

    def push_losing_reply(request, timeout=None):
        push_losing_reply.calls += 1
        if push_losing_reply.calls == 2 and not killed.is_set():
            inner_push(request, timeout=timeout)      # applied ...
            t_flush = time.perf_counter()
            ckpt.stop(final_snapshot=True)            # ... and journaled
            holder["snapshot_s"] = time.perf_counter() - t_flush
            server1.stop(grace=None).wait(10)
            killed.set()                              # the reply is lost
        return inner_push(request, timeout=timeout)

    push_losing_reply.calls = 0
    client._call["PushGradrients"] = push_losing_reply
    t = threading.Thread(target=restart_after_kill, daemon=True)
    t0 = time.perf_counter()
    t.start()
    worker.start()
    worker.join(300)
    t.join(120)
    wall = time.perf_counter() - t0
    try:
        r = worker.result
        store2 = holder.get("store2")
        meta, retry_step, retry_equal = holder.get("retry",
                                                   ({}, None, None))
        emit({"phase": "checkpoints", "form": "lost_reply",
              "error": repr(r.error) if r.error else None,
              "reconnects": r.reconnects,
              "pushes_accepted": r.pushes_accepted,
              "restored": holder.get("restored"),
              "retry_reply": {k: meta.get(k) for k in
                              ("received", "accepted", "duplicate",
                               "global_step")},
              "step_at_retry": retry_step,
              "params_equal_snapshot_npz": retry_equal,
              "new_store_step": store2.global_step if store2 else None,
              "new_store_pushes_applied":
                  store2.stats.gradients_processed if store2 else None,
              "snapshot_s": holder.get("snapshot_s"),
              "snapshot_npz_bytes": holder.get("npz_bytes"),
              "restore_s": holder.get("restore_s"),
              "wall_s": wall, "card": state["card"]})
        if r.error is not None or worker.is_alive():
            raise AssertionError(f"worker failed: {r.error!r}")
        if r.reconnects != 1 or holder.get("bound") != port:
            raise AssertionError("the server was not restarted on its port")
        restored_step, journaled = holder["restored"]
        if (restored_step, meta.get("duplicate"), meta.get("global_step"),
                retry_step, retry_equal) != (2, True, 2, 2, True) \
                or journaled < 1:
            raise AssertionError("the retried push was not answered as a "
                                 "duplicate of the restored state")
        # 4 pushes: 2 in the snapshot, the retried 2nd a duplicate, the
        # 3rd and 4th applied on the new server.
        if (r.pushes_accepted, store2.global_step,
                store2.stats.gradients_processed) != (4, 4, 2):
            raise AssertionError("a push was lost or applied twice")
    finally:
        if "server2" in holder:
            holder["server2"].stop(grace=None).wait(10)
        client.close()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def _graphed_resume(state: dict) -> None:
    """(b) ``BaselineTrainer(device_loop=True)`` with deterministic cuDNN,
    2 epochs of 2,048 images, a checkpoint each epoch: a fresh trainer
    restored from epoch 1 (copied into the tensors its graph replays
    over) trains epoch 2 bit-equal to the uninterrupted run."""
    import shutil
    import tempfile

    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.checkpoint \
        import CheckpointManager
    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import synthetic_cifar100
    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        import get_model
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .baseline import BaselineConfig, BaselineTrainer

    ds = synthetic_cifar100(n_train=2048, n_test=1000)

    def trainer(epochs):
        model = get_model("resnet18", num_classes=100, dtype="bfloat16",
                          device="cuda", seed=7)
        return BaselineTrainer(ds, BaselineConfig(
            batch_size=BATCH, num_epochs=epochs, device_loop=True,
            device="cuda", seed=7), model=model)

    def tensors(st):
        out = [*st.params.values(), *st.batch_stats.values(),
               *st.opt_state.trace.values(), st.opt_state.count]
        return [t.detach().cpu() for t in out]

    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    root = tempfile.mkdtemp(prefix="dps-ckpt-")
    t0 = time.perf_counter()
    try:
        full = trainer(2)
        whole = full.train(checkpoint_dir=f"{root}/a")
        trainer(1).train(checkpoint_dir=f"{root}/b")
        resumed = trainer(2)
        again = resumed.train(checkpoint_dir=f"{root}/b", resume=True)
        graphed = resumed._device_loop._cuda_graph is not None
        a, b = tensors(full.state), tensors(resumed.state)
        equal = len(a) == len(b) and all(torch.equal(x, y)
                                         for x, y in zip(a, b))
        diff = max(float((x.double() - y.double()).abs().max())
                   for x, y in zip(a, b))
        # One train-state checkpoint's cost: save, then restore in place.
        mgr = CheckpointManager(f"{root}/c")
        t1 = time.perf_counter()
        mgr.save(resumed.state)
        save_s = time.perf_counter() - t1
        ckpt_bytes = sum(f.stat().st_size for f in Path(root, "c").iterdir())
        t1 = time.perf_counter()
        mgr.restore(resumed.state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = prev
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "checkpoints", "form": "graphed_resume",
          "cudnn_deterministic": True, "steps": full.state.step,
          "resumed_step": resumed.state.step, "graph_replayed": graphed,
          "state_bit_equal": equal, "max_abs_diff": diff,
          "losses": whole.train_losses, "resumed_losses": again.train_losses,
          "checkpoint_save_s": save_s, "checkpoint_bytes": ckpt_bytes,
          "checkpoint_restore_s": restore_s,
          "wall_s": time.perf_counter() - t0, "card": state["card"]})
    if not graphed or not equal or full.state.step != resumed.state.step:
        raise AssertionError(f"the resumed graphed run differs (max "
                             f"{diff})")
    if again.train_losses != whole.train_losses[1:]:
        raise AssertionError(f"epoch 2 loss {again.train_losses} != "
                             f"{whole.train_losses[1:]}")


def phase_checkpoints(state: dict) -> None:
    """Phase 17: checkpoints on the card."""
    _lost_reply(state)
    _graphed_resume(state)


def _health_stack(store, parts: dict, quarantine_s: float = 30.0,
                  evaluate_on_push: bool = False):
    """The port's service over ``store`` wired as ``cli serve --remediate``
    wires it: a ``ClusterMonitor`` with the JAX defaults (5 s tick) and the
    SLO evaluator, a ``RemediationEngine`` that is not a dry run, and
    ``reject_nonfinite`` on. ``parts`` receives the monitor, the engine,
    the service, every alert edge event, the monitor's view as the first
    worker says goodbye (both workers still members), and, with
    ``evaluate_on_push``, each push reply and its time; the monitor then
    also evaluates right after each push (the tick, at the push)."""
    from distributed_parameter_server_for_ml_training_tpu_torch.comms import \
        ParameterService
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .service import unpack_msg
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        import (ClusterMonitor, RemediationEngine, RemediationPolicy,
                SloEvaluator)

    monitor = ClusterMonitor(store)
    monitor.slo = SloEvaluator()
    # The registry's RPC histograms are process-global and hold earlier
    # phases' calls: the evaluator's baseline is their state now, stamped
    # before both burn windows, as a fresh serve process starts from 0.
    monitor.slo.evaluate(time.time() - monitor.slo.windows[-1].window_s - 1)
    svc = ParameterService(store, monitor=monitor, reject_nonfinite=True)
    engine = RemediationEngine(store, service=svc, policy=RemediationPolicy(
        quarantine_s=quarantine_s))
    monitor.remediation = engine
    monitor.add_listener(engine.handle_events)
    events, views, replies = [], [], []
    monitor.add_listener(events.extend)
    goodbye = svc.job_finished

    def job_finished(request, ctx):
        if not views:
            views.append(monitor.cluster_view())
        return goodbye(request, ctx)
    svc.job_finished = job_finished
    if evaluate_on_push:
        push_body = svc.push_gradrients

        def push(request, ctx):
            wid = int(unpack_msg(request)[0]["worker_id"])
            # The drill lifts a quarantine whose windows the worker has
            # served, so its later pushes apply again.
            if svc.is_quarantined(wid) and any(
                    w.result.worker_id == wid
                    and w.result.pushes_quarantined >= 3
                    for w in parts.get("workers", ())):
                svc.unquarantine(wid)
                parts["drill_unquarantined"] = wid
            reply = push_body(request, ctx)
            replies.append((wid, unpack_msg(reply)[0], time.perf_counter()))
            monitor.evaluate()
            return reply
        svc.push_gradrients = push
    parts.update(monitor=monitor, engine=engine, service=svc,
                 events=events, views=views, replies=replies)
    monitor.start()
    return svc


def _health_main(state: dict) -> None:
    """(a) Health on the main path: phase 14 (a)'s run with the monitor,
    the SLO evaluator and the remediation engine; K1 once a push; every
    report's grad norm against the pushed window's norm on the card in
    float64; no alert, directive or quarantine. Then img/s with the
    monitor off and on in turns, and the device->host copies the note
    adds a boundary, from two profiled runs' memcpy events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import \
        worker as W

    notes = []
    note = W.PSWorker._note_health

    def note_spy(self, loss, grads, epoch, grad_scale=1.0):
        # Synchronized first, so the time is the note's own, not the
        # step's compute it would otherwise wait for.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        note(self, loss, grads, epoch, grad_scale)
        host_us = (time.perf_counter() - t0) * 1e6
        ref = float(torch.linalg.vector_norm(torch.cat(
            [g.detach().double().flatten() for g in grads.values()]))) \
            * grad_scale
        with self._health_lock:
            notes.append((self.result.worker_id, dict(self._health), ref,
                          host_us))

    parts: dict = {}
    W.PSWorker._note_health = note_spy
    Q.wire_quantize_multi.launches = 0
    try:
        run = _grpc_run(steps_per_worker=8, n_test=1000, seed=0,
                        eval_each_epoch=True, record=True,
                        service=lambda st: _health_stack(st, parts))
    finally:
        W.PSWorker._note_health = note
        if "monitor" in parts:
            parts["monitor"].stop(final=False)
    k1 = Q.wire_quantize_multi.launches
    state["health_k1_launches"] = {"wire_quantize_multi": k1}
    results, svc, engine = run["results"], parts["service"], parts["engine"]
    errors = [repr(r.error) for r in results if r.error is not None]
    n_push = sum(r.pushes_accepted + r.pushes_rejected for r in results)
    view = parts["views"][0] if parts["views"] else {"workers": []}
    rows = {r["worker"]: r for r in view["workers"]}
    ids = sorted(r.worker_id for r in results)
    fired = [(e["rule"], e["worker"]) for e in parts["events"]
             if e["state"] == "fired"]
    # The SLO rules watch the server's RPC latency, not training: a
    # fetch-latency burn is held to the objective's own window numbers
    # (reported); every other rule must stay silent.
    slo = view.get("slo") or {}
    slo_fired = sorted({r for r, _ in fired if r.startswith("slo_burn")})
    slo_backed = sorted({b["rule"] for b in slo.get("breaches", ())
                         if b["objective"] == "fetch_latency"
                         and b["bad"] > 0
                         and b["burn"] >= b["burn_threshold"]})
    health_fired = [(r, w) for r, w in fired if not r.startswith("slo_")]
    rel = [abs(rep["grad_norm"] - ref) / ref for _, rep, ref, _ in notes
           if isinstance(rep.get("grad_norm"), float) and ref > 0]
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .service import unpack_msg
    quarantined = sum(bool(unpack_msg(r)[0].get("quarantined"))
                      for _, r in run["pushes"])

    # img/s with the monitor off and on, in turns; eval off.
    turns: dict = {"off": [], "on": []}
    for label in ("off", "on", "on", "off"):
        p: dict = {}
        try:
            r = _grpc_run(steps_per_worker=8, n_test=10, seed=0,
                          eval_each_epoch=False, record=False,
                          service=(lambda st, p=p: _health_stack(st, p))
                          if label == "on" else None)
        finally:
            if "monitor" in p:
                p["monitor"].stop(final=False)
        turns[label].append(_img_per_s(r["results"]))
    # Device->host copies a boundary: the same short run with the
    # monitor off and on under torch.profiler.
    copies, boundaries = {}, {}
    for label in ("off", "on"):
        p = {}
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                r = _grpc_run(steps_per_worker=4, n_test=10, seed=2,
                              eval_each_epoch=False, record=False,
                              service=(lambda st, p=p: _health_stack(st, p))
                              if label == "on" else None)
        finally:
            if "monitor" in p:
                p["monitor"].stop(final=False)
        copies[label] = _memcpy_bytes(prof)
        boundaries[label] = sum(x.pushes_accepted + x.pushes_rejected
                                + x.pushes_quarantined
                                for x in r["results"])
    dtoh = {k: v.get("DtoH", {}).get("count", 0) for k, v in copies.items()}
    per_boundary = (dtoh["on"] - dtoh["off"]) / boundaries["on"]
    host_us = [n[3] for n in notes]
    state["health"] = {
        "img_per_s_off": turns["off"], "img_per_s_on": turns["on"],
        "note_host_us_median": float(np.median(host_us)) if host_us
        else None, "dtoh_copies_per_boundary": per_boundary}
    emit({"phase": "health", "form": "main_path", "model": "resnet18",
          "workers": N_WORKERS, "batch_size": BATCH, "push_codec": "int8",
          "pushes": n_push, "k1_launches": k1,
          "register_health_report": [r.supports_health_report
                                     for r in run["remotes"]],
          "reports": {str(k): {f: v.get(f) for f in (
              "step", "epoch", "loss", "grad_norm", "push_codec",
              "examples_per_s", "goodput_fraction")}
              for k, v in sorted(rows.items())},
          "notes": len(notes),
          "grad_norm_rel_err_max": max(rel) if rel else None,
          "note_host_us_median": state["health"]["note_host_us_median"],
          "note_host_us_max": max(host_us) if host_us else None,
          "alerts_fired": fired, "health_rules_fired": health_fired,
          "slo_rules_fired": slo_fired,
          "directives_posted": svc._directive_seq,
          "remediation_events": list(engine.events),
          "quarantined_replies": quarantined,
          "slo": slo,
          "img_per_s_turns_eval_off": turns,
          "phase14_img_per_s": state.get("grpc_a", {}).get("img_per_s"),
          "dtoh_copies": dtoh, "boundaries": boundaries,
          "dtoh_copies_per_boundary": per_boundary,
          "memcpy": copies, "card": state["card"]})
    if errors:
        raise AssertionError(f"worker errors: {errors}")
    if not all(r.supports_health_report for r in run["remotes"]):
        raise AssertionError("the register reply did not advertise "
                             "health_report")
    if n_push != N_WORKERS * 8 or k1 != n_push:
        raise AssertionError(f"K1 launched {k1} times for {n_push} pushes; "
                             f"expected {N_WORKERS * 8} of each")
    for wid in ids:
        row = rows.get(wid, {})
        if not all(isinstance(row.get(f), (int, float))
                   for f in ("step", "loss", "grad_norm")) \
                or row.get("push_codec") != "int8+ef":
            raise AssertionError(f"worker {wid}'s row in the cluster view: "
                                 f"{row}")
    if len(notes) != n_push or len(rel) != len(notes) or max(rel) > 1e-4:
        raise AssertionError(f"{len(notes)} notes for {n_push} pushes; "
                             f"grad norm relative error {max(rel or [0])}")
    if health_fired or svc._directive_seq or quarantined or engine.events:
        raise AssertionError(f"a healthy run fired {fired}, posted "
                             f"{svc._directive_seq} directives, refused "
                             f"{quarantined} pushes")
    if not set(slo_fired) <= set(slo_backed):
        raise AssertionError(f"SLO rules fired {slo_fired}; the "
                             f"evaluator's fetch-latency breaches: "
                             f"{slo.get('breaches')}")
    if per_boundary > 1:
        raise AssertionError(f"the health note adds {per_boundary} "
                             f"device->host copies a boundary")


def _health_drill(state: dict) -> None:
    """(b) The self-heal drill: fp16 pushes, worker 1 poisons its 3rd step
    with NaN. Its push is refused before the apply, both non-finite rules
    fire against it alone, the engine quarantines it and posts the
    quarantine and refetch directives, the worker skips 3 windows, and
    once the quarantine is lifted (by the engine when the worker's next
    report resolves the alerts, else by the drill after the windows) its
    pushes apply again."""
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import \
        worker as W

    parts: dict = {}
    applied = []
    apply = W.PSWorker._apply_directive

    def apply_spy(self, d):
        applied.append((time.perf_counter(), self.result.worker_id,
                        d.get("action"), dict(d)))
        return apply(self, d)

    def probe(workers, done):
        parts["workers"] = workers

    W.PSWorker._apply_directive = apply_spy
    try:
        run = _grpc_run(
            steps_per_worker=8, n_test=10, seed=1, eval_each_epoch=False,
            record=False, store_kw={"push_codec": "fp16"}, probe=probe,
            worker_kw_of=lambda i: {"nan_inject_step": 2} if i == 1 else {},
            service=lambda st: _health_stack(st, parts,
                                             evaluate_on_push=True))
    finally:
        W.PSWorker._apply_directive = apply
        if "monitor" in parts:
            parts["monitor"].stop(final=False)
    healthy, poisoned = run["workers"]
    hid, pid = healthy.result.worker_id, poisoned.result.worker_id
    store = run["store"]
    errors = [repr(w.result.error) for w in run["workers"]
              if w.result.error is not None]
    q_replies = [(wid, m, t) for wid, m, t in parts["replies"]
                 if m.get("quarantined")]
    fired = [(e["rule"], e["worker"]) for e in parts["events"]
             if e["state"] == "fired"]
    nonfinite = sorted({w for rule, w in fired
                        if rule in ("nonfinite_loss", "nonfinite_grad")})
    actions = [(e["action"], e["worker"], e["outcome"])
               for e in parts["engine"].events]
    final, step = store.snapshot()
    finite = all(np.isfinite(v).all() for v in final.values())
    accepted = healthy.result.pushes_accepted \
        + poisoned.result.pushes_accepted
    t_nan = q_replies[0][2] if q_replies else None
    t_apply = min((t for t, wid, a, _ in applied
                   if wid == pid and a == "quarantine"), default=None)
    seconds = t_apply - t_nan if t_nan and t_apply else None
    state["health_drill_s"] = seconds
    emit({"phase": "health", "form": "self_heal", "push_codec": "fp16",
          "poisoned_worker": pid, "healthy_worker": hid,
          "quarantined_replies": [(w, m) for w, m, _ in q_replies],
          "alerts_fired": fired, "remediation_actions": actions,
          "directives_applied": {
              str(w.result.worker_id): w.result.directives_applied
              for w in run["workers"]},
          "pushes_quarantined": poisoned.result.pushes_quarantined,
          "pushes_accepted": {str(hid): healthy.result.pushes_accepted,
                              str(pid): poisoned.result.pushes_accepted},
          "pushes_rejected": {str(hid): healthy.result.pushes_rejected,
                              str(pid): poisoned.result.pushes_rejected},
          "quarantine_lifted_by": "drill" if parts.get(
              "drill_unquarantined") is not None else "engine" if (
              "quarantine", pid, "lifted") in actions else None,
          "quarantined_at_end": parts["service"].is_quarantined(pid),
          "global_step": step, "params_finite": finite,
          "nan_push_to_directive_applied_s": seconds,
          "card": state["card"]})
    if errors:
        raise AssertionError(f"worker errors: {errors}")
    if len(q_replies) != 1 or q_replies[0][0] != pid \
            or q_replies[0][1].get("accepted") is not False:
        raise AssertionError(f"quarantined replies: {q_replies}")
    if nonfinite != [pid] or {r for r, w in fired if w == pid} \
            < {"nonfinite_loss", "nonfinite_grad"}:
        raise AssertionError(f"alerts fired: {fired}")
    if ("quarantine", pid, "ok") not in actions \
            or ("refetch", pid, "ok") not in actions:
        raise AssertionError(f"remediation actions: {actions}")
    if poisoned.result.directives_applied != {"quarantine": 1,
                                              "refetch_params": 1} \
            or poisoned.result.pushes_quarantined != 3 \
            or any(d.get("steps") != 3 for _, wid, a, d in applied
                   if a == "quarantine"):
        raise AssertionError(f"worker {pid} applied "
                             f"{poisoned.result.directives_applied}, "
                             f"skipped {poisoned.result.pushes_quarantined}")
    if healthy.result.pushes_accepted != 8 \
            or poisoned.result.pushes_accepted != 8 - 1 - 3:
        raise AssertionError("pushes accepted: "
                             f"{healthy.result.pushes_accepted} and "
                             f"{poisoned.result.pushes_accepted}")
    if step != accepted or not finite:
        raise AssertionError(f"step {step} for {accepted} accepted pushes; "
                             f"params finite: {finite}")


def _health_carry(state: dict) -> None:
    """(c) The quarantine directive drops the device codec's carry: one
    int8 worker with error feedback; after its 2nd push the drill posts
    ``quarantine`` with steps=2. The next 2 windows push nothing (K1 runs
    once a push sent), the residuals are empty right after the directive,
    and the first push after it is byte-equal to ``compress_push`` of its
    gradients under a fresh ``ErrorFeedback``."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.comms import (
        ParameterService, RemoteStore, serve)
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .service import unpack_msg
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .wire import encode_tensor_dict
    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .compression import ErrorFeedback, compress_push
    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .device_codec import DeviceCodec
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        ParameterStore, PSWorker, StoreConfig, WorkerConfig)
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import \
        worker as W

    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    # 768 images: 6 batches for the one worker.
    ds, model, _, init = main_path(3, 10, 4)
    store = ParameterStore(init, StoreConfig(
        mode="async", total_workers=1, push_codec="int8", staleness_bound=5))
    svc = ParameterService(store)
    frames, encoded, residuals = [], [], []
    push_body = svc.push_gradrients

    def push(request, ctx):
        meta, payload = unpack_msg(request)
        frames.append(bytes(payload))
        reply = push_body(request, ctx)
        if len(frames) == 2:
            svc.post_directive(int(meta["worker_id"]), "quarantine",
                               steps=2)
        return reply
    svc.push_gradrients = push
    encode = DeviceCodec.encode

    def encode_spy(self, flat, plan=None, scales=None):
        encoded.append(({k: v.detach().float().cpu().numpy()
                         for k, v in flat.items()},
                        dict(plan or {}), dict(scales or {})))
        return encode(self, flat, plan=plan, scales=scales)
    apply = W.PSWorker._apply_directive

    def apply_spy(self, d):
        before = len(self._device_codec._residual)
        apply(self, d)
        residuals.append((d.get("action"), before,
                          len(self._device_codec._residual)))
    DeviceCodec.encode, W.PSWorker._apply_directive = encode_spy, apply_spy
    server, port = serve(store, port=0, service=svc, host="127.0.0.1")
    remote = RemoteStore(f"127.0.0.1:{port}")
    Q.wire_quantize_multi.launches = 0
    try:
        worker = PSWorker(remote, model, ds, WorkerConfig(
            batch_size=BATCH, num_epochs=1, device="cuda",
            eval_each_epoch=False), worker_name="carry")
        worker.run()
        k1 = Q.wire_quantize_multi.launches
    finally:
        DeviceCodec.encode, W.PSWorker._apply_directive = encode, apply
        remote.close()
        server.stop(grace=None).wait(10)
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = prev
    res = worker.result
    checks = {}
    if len(encoded) == len(frames) == 4:
        def frame(grads, plan, scales, ef):
            return encode_tensor_dict(compress_push(
                grads, plan, scales=scales or None, ef=ef), checksum=True)
        checks["after_quarantine_equals_fresh_ef"] = \
            frames[2] == frame(*encoded[2], ErrorFeedback())
        carried = ErrorFeedback()
        for g in encoded[:2]:
            frame(*g, carried)
        checks["carried_ef_frame_differs"] = \
            frames[2] != frame(*encoded[2], carried)
        checks["first_push_equals_fresh_ef"] = \
            frames[0] == frame(*encoded[0], ErrorFeedback())
    emit({"phase": "health", "form": "carry_reset", "push_codec": "int8",
          "cudnn_deterministic": True, "steps": res.local_steps_completed,
          "pushes_sent": len(frames), "k1_launches": k1,
          "pushes_quarantined": res.pushes_quarantined,
          "directives_applied": res.directives_applied,
          "residual_tensors_before_after": residuals, "frame_checks": checks,
          "card": state["card"]})
    if res.error is not None:
        raise res.error
    if len(frames) != 4 or res.pushes_quarantined != 2 or k1 != 4:
        raise AssertionError(f"{len(frames)} pushes sent, "
                             f"{res.pushes_quarantined} skipped, K1 {k1}; "
                             f"expected 4, 2 and 4")
    if len(residuals) != 1 or residuals[0][0] != "quarantine" \
            or residuals[0][1] == 0 or residuals[0][2] != 0:
        raise AssertionError(f"residuals around the directive: {residuals}")
    if not checks or not all(checks.values()):
        raise AssertionError(f"frame checks: {checks}")


def phase_health(state: dict) -> None:
    """Phase 18: the cluster health monitor, the non-finite guard,
    quarantine and the directive loop on the main path."""
    _health_main(state)
    _health_drill(state)
    _health_carry(state)


# -- phase 19: every registry model under the data-parallel modes ------------

MODELS_TRAIN, MODELS_TEST = 1_024, 256   # synthetic ImageNet, 224 px
MODELS_PROFILE_STEPS = 8                 # one epoch of the baseline's 8
R50_VALUES, VIT_VALUES = 25_557_032, 86_567_656


def _device_ms_per_launch(fn, reps: int, kernel: str) -> dict:
    """:func:`device_ms_per_call` as a mean per recorded launch, beside
    the launches the trace recorded a call: a trace may drop some of a
    launch-heavy phase's kernel records, and one that recorded none
    gives no time (None), never 0."""
    ms, launches = device_ms_per_call(fn, reps, kernel)
    return {"device_ms_per_launch": ms / launches if launches else None,
            "profiled_launches_per_call": launches}


def _subset(ds, n_train: int, n_test: int):
    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import Dataset

    return Dataset(ds.x_train[:n_train], ds.y_train[:n_train],
                   ds.x_test[:n_test], ds.y_test[:n_test],
                   num_classes=ds.num_classes, synthetic=True)


def _models_baseline(state: dict, ds, out: dict, failures: list) -> None:
    """(a) ResNet-50 through ``BaselineTrainer``, 2 epochs eager and 2
    graphed (8 steps each), each profiled over an epoch's steps; one step
    card against CPU in float64 at batch 2; ResNet-18 with the ImageNet
    stem for 4 eager steps."""
    import itertools

    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import make_batches
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .baseline import BaselineConfig, BaselineTrainer
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .device_loop import prefetch_to_device

    bs = BATCH
    steps = len(ds.x_train) // bs
    paths = {}
    for name, device_loop in (("eager", False), ("graph", True)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = BaselineTrainer(ds, BaselineConfig(
            model="resnet50", num_classes=1000, num_epochs=2,
            device_loop=device_loop, device="cuda"))
        if not trainer.model.imagenet_stem:
            failures.append("(a) ResNet-50 at 224 px without the ImageNet "
                            "stem")
        met = trainer.train()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if device_loop:
            loop = trainer._device_loop

            def step_fn(loop=loop):
                loop._cuda_graph.replay()
            loop._slot.zero_()
        else:
            batches = itertools.cycle(list(prefetch_to_device(make_batches(
                ds.x_train, ds.y_train, bs, seed=12345), depth=2)))
            for _ in range(2):     # the profile starts with warm steps
                trainer._train_step(trainer.state, *next(batches),
                                    trainer._gen)

            def step_fn(trainer=trainer, batches=batches):
                trainer._train_step(trainer.state, *next(batches),
                                    trainer._gen)
        prof = _profile_steps(step_fn, MODELS_PROFILE_STEPS)
        paths[name] = {
            "epoch_seconds": met.epoch_times,
            "train_seconds": trainer.train_seconds,
            "img_per_s_epoch2": steps * bs / trainer.train_seconds[-1],
            "step_ms": prof["ms_per_step_by_events"],
            "device_idle_share": prof["device_idle_share"],
            "train_loss": met.train_losses,
            "test_accuracy_pct": met.test_accuracies,
            "peak_memory_gib": peak, "profile": prof}
        if not all(math.isfinite(v) for v in met.train_losses):
            failures.append(f"(a) {name}: losses {met.train_losses}")
        del trainer, step_fn
    out["a_baseline_resnet50"] = {"batch_size": bs, "steps_per_epoch": steps,
                                  "dtype": "bfloat16", **paths}

    # One step, augment off, card against CPU from the same weights in
    # float64 (phase 9 (a)'s check at ResNet-50's shapes).
    xb, yb = ds.x_train[:2], ds.y_train[:2]
    runs = {}
    for device in ("cuda", "cpu"):
        model, st, step, _ = _baseline_parts(
            torch.float64, device, (10, 15), steps, False, name="resnet50",
            num_classes=1000, image_size=224)
        if runs:
            model.load_state_dict(weights)
        else:
            weights = {k: v.cpu() for k, v in model.state_dict().items()}
        _, m = step(st, xb, yb)
        runs[device] = (st, float(m["loss"]))
        del model
    diff = _state_diff(runs["cuda"][0], runs["cpu"][0])
    out["a_card_vs_cpu_float64"] = {
        "batch_size": 2, "tolerance": "atol 1e-5, rtol 1e-3", **diff,
        "losses": {d: loss for d, (_, loss) in runs.items()}}
    bad = [p for p, v in diff.items() if v["outside"]]
    if bad:
        failures.append(f"(a) card against CPU in float64 outside atol "
                        f"1e-5 / rtol 1e-3: {bad}")
    del runs, weights

    # ResNet-18 with the ImageNet stem: 4 eager steps.
    model, st, step, _ = _baseline_parts(
        "bfloat16", "cuda", (10, 15), steps, True, name="resnet18",
        num_classes=1000, image_size=224)
    gen = torch.Generator(device="cuda").manual_seed(0)
    losses, times = [], []
    for i in range(4):
        xb = torch.as_tensor(ds.x_train[i * bs:(i + 1) * bs], device="cuda")
        yb = torch.as_tensor(ds.y_train[i * bs:(i + 1) * bs], device="cuda")
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        st, m = step(st, xb, yb, gen)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
        losses.append(float(m["loss"]))
    out["a_resnet18_imagenet_stem"] = {
        "imagenet_stem": model.imagenet_stem,
        "stem_kernel": list(model.stem_conv.kernel_size), "losses": losses,
        "step_ms": times}
    if not (model.imagenet_stem and all(map(math.isfinite, losses))):
        failures.append(f"(a) ResNet-18 ImageNet stem: "
                        f"{out['a_resnet18_imagenet_stem']}")
    del model, st, step


def _ring_rows_vs_plain(state: dict, model, params, stats, bi, bl) -> dict:
    """One step's real per-slot gradient rows at the ring's first hop
    (each slot's own chunk): K3 and K4 against their plain versions on
    the card, bit for bit, and their device times against their bounds at
    this chunk."""
    import torch
    import torch.nn.functional as F

    from distributed_parameter_server_for_ml_training_tpu_torch.data.cifar \
        import standardize, to_float
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        .sync_dp import make_slot_grad_fn, mix_seed, ravel_slots

    grads, *_ = make_slot_grad_fn(model)(params, stats,
                                         standardize(to_float(bi)),
                                         bl.long())
    flat, _ = ravel_slots(grads)
    del grads
    n, size = flat.shape
    chunk = -(-size // n)
    slots = torch.arange(n, device=flat.device)
    x = F.pad(flat, (0, n * chunk - size)).view(n, n, chunk)[slots, slots]
    del flat
    seeds = [mix_seed(0x5EED, s, 0) for s in range(n)]
    v, sc = Q.block_quantize_stochastic(x, seeds)
    pv, psc = Q.quantize_int8_plain(x, seeds, stochastic=True)
    back = Q.block_dequantize(v, sc, chunk)
    pback = Q.dequantize_int8_plain(v, sc, chunk)
    torch.cuda.synchronize()
    k3_equal = torch.equal(v, pv) and torch.equal(sc, psc)
    k4_equal = torch.equal(back, pback)
    del pv, psc, pback
    sass = state.get("block_sass") or {
        "block_quantize_stochastic": sass_pipe_counts(
            "block_quantize_kernelILb1E")}
    fns = {"block_quantize_stochastic": (
        lambda: Q.block_quantize_stochastic(x, seeds),
        lambda: Q.quantize_int8_plain(x, seeds, stochastic=True),
        "::block_quantize_kernel"),
        "block_dequantize": (lambda: Q.block_dequantize(v, sc, chunk),
                             lambda: Q.dequantize_int8_plain(v, sc, chunk),
                             "::block_dequantize_kernel")}
    kernels = {}
    for kernel, (fk, fp, sym) in fns.items():
        bound_ms, bound_by, parts = block_bound(n, chunk, kernel,
                                                sass.get(kernel))
        prof = _device_ms_per_launch(fk, 50, sym)
        kernels[kernel] = {
            "device_ms": prof["device_ms_per_launch"], **prof,
            "ms": cuda_time_ms(fk, 20), "plain_ms": cuda_time_ms(fp, 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_parts": parts}
    return {"rows": [n, chunk], "k3_bit_equal": k3_equal,
            "k4_bit_equal": k4_equal, "kernels": kernels}


def _models_sync(state: dict, ds, name: str, slots: int, batch: int,
                 compression: str, epochs: int) -> dict:
    """``SyncTrainer`` on ``name`` at 224 px, 1,000 classes, bf16: counts
    reset just before ``train()`` and read just after; the step's time by
    CUDA events; with int8 the ring's kernels on real rows against their
    plain versions."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import shard_batch
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        .sync_dp import ring_payload_bytes
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .distributed import DistributedConfig, SyncTrainer

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = SyncTrainer(ds, DistributedConfig(
        mode="sync", model=name, num_workers=slots, batch_size=batch,
        num_epochs=epochs, compression=compression, num_classes=1000,
        dtype="bfloat16", device="cuda"))
    init = {k: v.clone() for k, v in trainer.state.params.items()}
    size = sum(v.numel() for v in init.values())
    torch.cuda.synchronize()
    _reset_block_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _block_counts()
    steps = trainer.global_steps
    moved = sum(not torch.equal(init[k], v)
                for k, v in trainer.state.params.items())
    del init
    finite = all(math.isfinite(v) for v in trainer.train_loss_per_epoch)
    images = steps * slots * batch
    bi, bl = shard_batch(trainer.mesh, (ds.x_train[:slots * batch],
                                        ds.y_train[:slots * batch]))
    st = trainer.state
    times = []
    for i in range(6):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        st, _ = trainer._step(st, bi, bl, 1)
        b.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(a.elapsed_time(b))
    del st
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    chunk = -(-size // slots)
    res = {"model": name, "slots": slots, "batch_per_slot": batch,
           "compression": compression, "params": size, "steps": steps,
           "images": images, "launches": counts,
           "img_per_s": images / sum(trainer.train_seconds),
           "train_seconds": trainer.train_seconds, "run_seconds": wall,
           "step_ms_median": float(np.median(times)), "step_ms_runs": times,
           "train_loss_per_epoch": trainer.train_loss_per_epoch,
           "tensors_moved": moved, "peak_memory_gib": peak,
           "ring_replicas_identical": trainer.ring_replicas_identical,
           "wire_bytes_per_slot_per_step": trainer.wire_bytes_per_slot_step,
           "ring_payload_bytes": ring_payload_bytes(chunk), "chunk": chunk}
    if compression == "int8":
        res["ring_rows_vs_plain"] = _ring_rows_vs_plain(
            state, trainer.model, trainer.state.params,
            trainer.state.batch_stats, bi, bl)
    del trainer, bi, bl
    torch.cuda.empty_cache()
    problems = []
    want = {"block_quantize": 0,
            "block_quantize_stochastic": slots * steps,
            "block_dequantize": (2 * slots - 1) * steps} \
        if compression == "int8" else {k: 0 for k in counts}
    if counts != want:
        problems.append(f"{steps} steps launched {counts}; expected {want}")
    if not finite or moved == 0:
        problems.append(f"losses {res['train_loss_per_epoch']}, tensors "
                        f"moved {moved}")
    if compression == "int8":
        ring = res["ring_rows_vs_plain"]
        if res["wire_bytes_per_slot_per_step"] != \
                2 * (slots - 1) * res["ring_payload_bytes"]:
            problems.append(f"wire bytes {res['wire_bytes_per_slot_per_step']}"
                            f" a slot a step; expected {2 * (slots - 1)} x "
                            f"{res['ring_payload_bytes']}")
        if res["ring_replicas_identical"] is not True:
            problems.append("the ring's per-slot results differ")
        if not (ring["k3_bit_equal"] and ring["k4_bit_equal"]):
            problems.append(f"K3/K4 against their plain versions at "
                            f"{ring['rows']}: K3 {ring['k3_bit_equal']}, "
                            f"K4 {ring['k4_bit_equal']}")
    res["problems"] = problems
    return res


def _models_async(state: dict, ds, name: str, batch: int,
                  pushes_per_worker: int) -> dict:
    """``AsyncTrainer`` on ``name`` (2 workers) over a store with int8
    pushes: K1's count reset just before ``train()`` and read just after;
    the first push K1 quantized, against its plain version byte for
    byte, and its device time against the byte bound."""
    import threading

    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        device_codec as DC, quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        StoreConfig, make_store)
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .distributed import AsyncTrainer, DistributedConfig

    workers = N_WORKERS
    sub = _subset(ds, workers * batch * pushes_per_worker, 64)
    trainer = AsyncTrainer(sub, DistributedConfig(
        mode="async", model=name, num_workers=workers, batch_size=batch,
        num_epochs=1, num_classes=1000, dtype="bfloat16", device="cuda"))
    init, _ = trainer.store.snapshot()
    # The trainer's store with the int8 push codec (phase 5's store).
    trainer.store = make_store("python", init, StoreConfig(
        mode="async", total_workers=workers, push_codec="int8",
        staleness_bound=5))
    rec, lock = {}, threading.Lock()
    kernel = DC.wire_quantize_multi

    def spy(xs, scales, levels):
        out = kernel(xs, scales, levels)
        with lock:
            if "xs" not in rec:
                rec.update(xs=[x.detach().clone() for x in xs],
                           scales=list(scales), levels=list(levels),
                           codes=out[0].clone())
        return out
    DC.wire_quantize_multi = spy
    Q.wire_quantize_multi.launches = 0
    try:
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        DC.wire_quantize_multi = kernel
    launches = Q.wire_quantize_multi.launches
    results = trainer.results
    pushes = sum(r.pushes_accepted + r.pushes_rejected for r in results)
    errors = [repr(r.error) for r in results if r.error is not None]
    final, step = trainer.store.snapshot()
    moved = sum(not np.array_equal(final[k], init[k]) for k in init)
    images = sum(r.local_steps_completed for r in results) * batch
    train_s = max(sum(r.epoch_times) for r in results)
    values = sum(x.numel() for x in rec.get("xs", []))
    res = {"model": name, "workers": workers, "batch_size": batch,
           "push_codec": "int8", "pushes": pushes, "global_step": step,
           "tensors": len(init), "k1_launches": launches,
           "k1_launches_per_push": launches / max(pushes, 1),
           "images": images, "img_per_s": images / train_s,
           "train_seconds": train_s, "run_seconds": wall,
           "tensors_moved": moved, "pushed_values": values,
           "train_loss_per_epoch": [v for r in results
                                    for v in r.train_loss_per_epoch]}
    problems = []
    if errors:
        problems.append(f"worker errors: {errors}")
    want = -(-len(init) // Q.WIRE_MAX_ENTRIES) * pushes
    if pushes != workers * pushes_per_worker or launches != want:
        problems.append(f"K1 launched {launches} times for {pushes} pushes; "
                        f"expected {want} for "
                        f"{workers * pushes_per_worker}")
    if moved == 0:
        problems.append("the store's params did not move")
    if rec:
        xs, scales, levels = rec["xs"], rec["scales"], rec["levels"]
        plain = Q.wire_quantize_multi_plain(xs, scales, levels)[0]
        res["first_push_equal_plain"] = torch.equal(rec["codes"], plain)
        before = Q.wire_quantize_multi.launches
        Q.wire_quantize_multi(xs, scales, levels)
        per_call = Q.wire_quantize_multi.launches - before
        # The trace's mean a launch times the wrapper's own launches a
        # push.
        prof = _device_ms_per_launch(
            lambda: Q.wire_quantize_multi(xs, scales, levels), 20,
            "::wire_quantize_multi_kernel")
        per_launch = prof["device_ms_per_launch"]
        bound = (4 * values + values) / H100_BYTES_PER_S * 1e3
        res["k1_push"] = {
            "entries": len(xs), "values": values,
            "device_ms": None if per_launch is None
            else per_launch * per_call, **prof,
            "launches_per_call": per_call,
            "ms": cuda_time_ms(lambda: Q.wire_quantize_multi(
                xs, scales, levels), 20),
            "plain_ms": cuda_time_ms(lambda: Q.wire_quantize_multi_plain(
                xs, scales, levels), 3),
            "bound_ms": bound, "bound_by": "bytes",
            "max_abs_err": int((rec["codes"].int() - plain.int()).abs().max())}
        if not res["first_push_equal_plain"] or per_call != -(
                -len(xs) // Q.WIRE_MAX_ENTRIES):
            problems.append(f"a push through K1: equal to plain "
                            f"{res['first_push_equal_plain']}, launches "
                            f"{per_call}")
        del plain
    else:
        problems.append("no push went through K1")
    del trainer, rec
    torch.cuda.empty_cache()
    res["problems"] = problems
    return res


def _models_grpc(state: dict, ds) -> dict:
    """(e) ``serve()`` on 127.0.0.1 and 2 ``PSWorker`` threads through
    their own ``RemoteStore``s, ResNet-50 with int8 pushes, 2 pushes a
    worker, eval off."""
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .service import unpack_msg
    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        import get_model
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        ParameterStore, StoreConfig)
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .pytree import params_to_jax

    batch, per_worker = 64, 2
    model = get_model("resnet50", num_classes=1000, dtype="bfloat16",
                      image_size=224, device="cuda", seed=0)
    init, _ = params_to_jax(model)
    store = ParameterStore(init, StoreConfig(
        mode="async", total_workers=N_WORKERS, push_codec="int8",
        staleness_bound=5))
    sub = _subset(ds, N_WORKERS * batch * per_worker, 64)
    Q.wire_quantize_multi.launches = 0
    run = _grpc_run(steps_per_worker=per_worker, n_test=0, seed=0,
                    eval_each_epoch=False, record=True,
                    parts=(sub, model, store, init), batch=batch)
    launches = Q.wire_quantize_multi.launches
    results = run["results"]
    errors = [repr(r.error) for r in results if r.error is not None]
    n_push = sum(r.pushes_accepted + r.pushes_rejected for r in results)
    final, step = store.snapshot()
    moved = sum(not np.array_equal(final[k], init[k]) for k in init)
    replies = [unpack_msg(reply)[0] for _, reply in run["pushes"]]
    duplicates = sum(bool(m.get("duplicate")) for m in replies)
    fetch_meta = [unpack_msg(r)[0] for _, r in run["fetches"]]
    full = [len(r) for (_, r), m in zip(run["fetches"], fetch_meta)
            if not m.get("not_modified")]
    images = sum(r.local_steps_completed for r in results) * batch
    train_s = max(sum(r.epoch_times) for r in results)
    res = {"model": "resnet50", "workers": N_WORKERS, "batch_size": batch,
           "push_codec": "int8", "global_step": step, "pushes": n_push,
           "k1_launches": launches, "duplicates": duplicates,
           "tensors_moved": moved, "images": images,
           "img_per_s": images / train_s, "train_seconds": train_s,
           "run_seconds": run["wall"],
           "rpc_ms_median": {k: float(np.median(v))
                             for k, v in sorted(run["rpc_ms"].items())},
           "rpc_calls": {k: len(v) for k, v in sorted(run["rpc_ms"].items())},
           "push_request_bytes": sorted(set(len(q)
                                            for q, _ in run["pushes"])),
           "fetch_reply_bytes_full": sorted(set(full)),
           "fetches_full": len(full)}
    problems = []
    if errors:
        problems.append(f"worker errors: {errors}")
    want = -(-len(init) // Q.WIRE_MAX_ENTRIES) * n_push
    if n_push != N_WORKERS * per_worker or launches != want:
        problems.append(f"K1 launched {launches} times for {n_push} pushes; "
                        f"expected {want}")
    if duplicates or moved == 0:
        problems.append(f"{duplicates} duplicates, {moved} tensors moved")
    res["problems"] = problems
    del run, model, store
    return res


def phase_models(state: dict) -> None:
    """Phase 19: ResNet-50 with the ImageNet stem and ViT-B/16 at 224 px
    (1,000 classes, bf16) on synthetic ImageNet (1,024 training images):
    (a) the baseline, (b) sync int8 ResNet-50, (c) async int8 pushes of
    ResNet-50, (d) ViT-B/16 sync (bf16 and int8) and async, with the
    flash kernels' counts at 0 (197 tokens take the dense core), (e) the
    gRPC path with ResNet-50. The counts each sub-phase's checks read are
    reset just before its run and read just after."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import synthetic_imagenet

    t0 = time.perf_counter()
    ds = synthetic_imagenet(n_train=MODELS_TRAIN, n_test=MODELS_TEST,
                            num_classes=1000, image_size=224, seed=0)
    out = {"phase": "models", "dataset": f"synthetic_imagenet("
           f"{MODELS_TRAIN}, {MODELS_TEST}, 1000 classes, 224 px)",
           "data_seconds": time.perf_counter() - t0, "card": state["card"]}
    failures: list = []
    timings = {}

    def sub(key, fn):
        t = time.perf_counter()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — reported, fails the phase
            traceback.print_exc()
            failures.append(f"({key}) raised {e!r}")
        timings[key] = time.perf_counter() - t
        torch.cuda.empty_cache()

    sub("a", lambda: _models_baseline(state, ds, out, failures))

    def sync_r50():
        out["b_sync_resnet50"] = res = _models_sync(
            state, ds, "resnet50", 4, 64, "int8", epochs=2)
        failures.extend(f"(b) {p}" for p in res["problems"])
    sub("b", sync_r50)

    def async_r50():
        out["c_async_resnet50"] = res = _models_async(
            state, ds, "resnet50", 64, 4)
        failures.extend(f"(c) {p}" for p in res["problems"])
    sub("c", async_r50)

    def vit():
        _reset_flash_counts()
        small = _subset(ds, 4 * 32 * 4, 64)
        for comp in ("bf16", "int8"):
            res = _models_sync(state, small, "vit_b16", 4, 32, comp,
                               epochs=1)
            out[f"d_sync_vit_b16_{comp}"] = res
            failures.extend(f"(d) sync {comp}: {p}"
                            for p in res["problems"])
        res = _models_async(state, ds, "vit_b16", 32, 2)
        out["d_async_vit_b16"] = res
        failures.extend(f"(d) async: {p}" for p in res["problems"])
        flash = _flash_counts()
        out["d_flash_launches"] = flash
        if any(flash.values()):
            failures.append(f"(d) flash kernels launched at 197 tokens: "
                            f"{flash}")
    sub("d", vit)

    def grpc():
        out["e_grpc_resnet50"] = res = _models_grpc(state, ds)
        failures.extend(f"(e) {p}" for p in res["problems"])
    sub("e", grpc)

    out["sub_phase_seconds"] = timings
    # The launches of the path's runs, for the kernels line.
    state["models_k1_launches"] = sum(
        out.get(k, {}).get("k1_launches", 0) for k in (
            "c_async_resnet50", "d_async_vit_b16", "e_grpc_resnet50"))
    state["models_block_counts"] = {
        name: sum(out.get(k, {}).get("launches", {}).get(name, 0) for k in (
            "b_sync_resnet50", "d_sync_vit_b16_bf16", "d_sync_vit_b16_int8"))
        for name in ("block_quantize", "block_quantize_stochastic",
                     "block_dequantize")}
    emit(out)
    if failures:
        raise AssertionError("; ".join(failures))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 1
    # Stated numerics: no TF32 anywhere (the main path computes in bf16).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import distributed_parameter_server_for_ml_training_tpu_torch  # noqa: F401

    state: dict = {}
    failed = []
    for phase in (phase_build, phase_kernel, phase_kernel_int8, phase_codec,
                  phase_main_path, phase_profile, phase_sync_path,
                  phase_sync_profile, phase_baseline, phase_kernel_flash,
                  phase_sp_path, phase_sp_profile, phase_cli,
                  phase_grpc_path, phase_grpc_modes, phase_device_store,
                  phase_checkpoints, phase_health, phase_models):
        t0 = time.perf_counter()
        try:
            phase(state)
        except Exception:  # noqa: BLE001 — reported, and fails the run
            traceback.print_exc()
            failed.append(phase.__name__)
        print(f"[{phase.__name__}] {time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)
    if failed:
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        flash_attention as FA
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    # K1 with its launches from the async path's run, the gRPC path's
    # (phase 14 (a); (b)'s workers are other processes), the gRPC
    # modes' (phase 15 (a)), the health path's (phase 18 (a)) and the
    # models' (phase 19 (c), (d), (e)); a push's times.
    kernels = []
    for name, k in state["k1"].items():
        kernels.append({
            "name": name, "route": "cuda", "source": Q.KERNEL_SOURCE,
            "replaces": Q.REPLACES[name],
            "launches": state["k1_launches"][name]
            + state["grpc_k1_launches"][name]
            + state["modes_k1_launches"][name]
            + state["health_k1_launches"][name]
            + state["models_k1_launches"],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "device_ms": k["device_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None})
    # K2-K4 launches from the sync path's runs (phase 7 and phase 19 (b),
    # (d)): the ring rounds stochastically, so K2 (nearest rounding) reads
    # 0 there. No single PyTorch call computes a block quantize, so
    # library_ms is null.
    launches = {k: v + state["models_block_counts"][k]
                for k, v in state["sync_counts"].items()}
    for name, k in state["block"].items():
        kernels.append({
            "name": name, "route": "cuda", "source": Q.BLOCK_KERNEL_SOURCE,
            "replaces": Q.BLOCK_REPLACES[name], "launches": launches[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "device_ms": k["device_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None})
    # The wgmma forward (the K5 entry on bf16) and the fused backward (the
    # K6/K7 entry) with their launches from the SP path's run, then the
    # first versions of K5, K6 and K7, which run on fp32 inputs and so on
    # no step of that bf16 path; times at its hop shape. The library's
    # backward computes dQ, dK and dV in one call: its time stands beside
    # every backward entry.
    for name, k in state["flash"].items():
        kernels.append({
            "name": name, "route": "cuda", "source": FA.KERNEL_SOURCE,
            "replaces": FA.REPLACES[name],
            "launches": state["sp_counts"][name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
