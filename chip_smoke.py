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
   random, half-step and clipping inputs, over a push that mixes levels,
   one whose largest entry is a misaligned view x[1:] and one table of 124
   entries (two launches); the per-tensor first version (``wire_quantize``)
   on every shape at both levels. Times one whole push of each, in turns,
   host-issued by CUDA events, and the kernels' device time a push by
   torch.profiler, against the bound; and the multi-tensor wrapper's host
   time a push, step by step;
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
   ahead (the worker's default). K1's launch counts are reset
   just before and read just after: the multi-tensor kernel must have
   launched ceil(62 / 64) = 1 time per push made, the per-tensor first
   version never;
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
   K1's counts reset just before and read just after: the multi-tensor
   kernel once a push, the per-tensor one never; no push answered
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
   fails), and the server reports a step above 0.

Then one JSON line of kernels and, last, the device line. Without a CUDA
device, or outside a checkout of the repo, it exits non-zero and prints
no result.
"""

from __future__ import annotations

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
    max_err = {"wire_quantize_multi": 0, "wire_quantize": 0}
    mismatched = []

    def check(case, got, want):
        torch.cuda.synchronize()
        if got.numel():
            max_err[case[0]] = max(max_err[case[0]], int(
                (got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            mismatched.append(case)

    # Both kernels against their plain versions on every ResNet-18 shape:
    # the per-tensor first version tensor by tensor, the multi-tensor
    # kernel over the whole push (its flat buffer, padding included).
    for levels in (127, 7):
        xs, scales = k1_push(gen, shapes, [levels] * len(shapes))
        for name, x, scale in zip(shapes, xs, scales):
            check(("wire_quantize", name, levels),
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

    # One whole int8 push of gradient-like tensors, the same tensors and
    # scales for every version: host-issued by CUDA events, in turns (new,
    # first version, first version, new), and the kernels' device time
    # from torch.profiler.
    xs = [torch.randn(s, generator=gen, device="cuda") * 1e-2
          for s in shapes.values()]
    scales = [float(np.float32(float(x.abs().max()) / 127)) for x in xs]
    int8 = [127] * len(xs)
    pushes = {
        "wire_quantize_multi": lambda: Q.wire_quantize_multi(xs, scales,
                                                             int8),
        "wire_quantize": lambda: [Q.wire_quantize_flat(x, s, 127)
                                  for x, s in zip(xs, scales)]}
    turns = {name: [] for name in pushes}
    for name in ("wire_quantize_multi", "wire_quantize", "wire_quantize",
                 "wire_quantize_multi"):
        turns[name].append(cuda_time_ms(pushes[name], 20))
    plain = [cuda_time_ms(lambda: Q.wire_quantize_multi_plain(
        xs, scales, int8), 20) for _ in range(2)]
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
          "first_version": "wire_quantize",
          "shapes": len(shapes), "levels": [127, 7, "mixed"],
          "cases": ["resnet18_127", "resnet18_7", "mixed_levels",
                    "misaligned_view", "124_entries"],
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


def phase_main_path(state: dict) -> None:
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        import get_model
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        WorkerConfig, run_workers)
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        import get_registry
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .steps import make_grad_step
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .pytree import params_to_jax

    n_workers, batch = N_WORKERS, BATCH
    ds, model, store, init = main_path(steps_per_worker=8, n_test=1000,
                                       seed=0)
    cfg = WorkerConfig(batch_size=batch, num_epochs=1, device="cuda")
    Q.wire_quantize_multi.launches = 0
    Q.wire_quantize.launches = 0
    t0 = time.perf_counter()
    results = run_workers(store, model, ds, n_workers, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"wire_quantize_multi": Q.wire_quantize_multi.launches,
                "wire_quantize": Q.wire_quantize.launches}
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

    # Grad-step time at the main path's shapes: one worker's step over a
    # batch of 128, bf16, by CUDA events.
    gs_model = get_model("resnet18", num_classes=100, dtype="bfloat16",
                         device="cuda", seed=1)
    grad_step = make_grad_step(gs_model, augment=True)
    params = {k: torch.from_numpy(v).cuda() for k, v in final.items()}
    _, init_stats = params_to_jax(gs_model)
    stats = {k: torch.from_numpy(v).cuda() for k, v in init_stats.items()}
    xb, yb = ds.x_train[:batch], ds.y_train[:batch]
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
    state["grad_step_ms"] = float(np.median(times))
    state["main_path_img_per_s"] = images / train_s

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
    # One launch of the multi-tensor K1 per 64 of a push's 62 tensors; the
    # per-tensor first version on no push.
    want = {"wire_quantize_multi": -(-62 // Q.WIRE_MAX_ENTRIES) * pushes,
            "wire_quantize": 0}
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
                    augment: bool, seed: int = 0):
    """Full ResNet-18 (100 classes) with its in-place state and steps."""
    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        import get_model
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .optimizers import baseline_optimizer
    from distributed_parameter_server_for_ml_training_tpu_torch.train.steps \
        import make_eval_step, make_train_step
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .train_state import module_train_state

    model = get_model("resnet18", num_classes=100, dtype=dtype,
                      device=device, seed=seed)
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
              eval_each_epoch: bool, record: bool):
    """Phase 5's configuration through the port's gRPC service on
    127.0.0.1: the server in this process, 2 ``PSWorker`` threads on the
    card, each through its own ``RemoteStore``. With ``record``, the
    service keeps every push request and fetch reply, and the device
    codec the first gradients of each worker. Returns a dict of the
    run's pieces."""
    import threading

    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.comms import (
        ParameterService, RemoteStore, serve)
    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .device_codec import DeviceCodec
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        PSWorker, WorkerConfig)

    ds, model, store, init = main_path(steps_per_worker, n_test, seed)
    svc = ParameterService(store)
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
    cfg = WorkerConfig(batch_size=BATCH, num_epochs=1, device="cuda",
                       eval_each_epoch=eval_each_epoch)
    workers = [PSWorker(r, model, ds, cfg, worker_name=f"grpc-{i}")
               for i, r in enumerate(remotes)]
    try:
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        DeviceCodec.encode = encode
        for r in remotes:
            r.close()
        server.stop(grace=None).wait(10)
    return {"store": store, "init": init, "results": [w.result
                                                      for w in workers],
            "remotes": remotes, "wall": wall, "pushes": pushes,
            "fetches": fetches, "first_grads": first_grads,
            "rpc_ms": rpc_ms}


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
    Q.wire_quantize.launches = 0
    run = _grpc_run(steps_per_worker=8, n_test=1000, seed=0,
                    eval_each_epoch=True, record=True)
    launches = {"wire_quantize_multi": Q.wire_quantize_multi.launches,
                "wire_quantize": Q.wire_quantize.launches}
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
    want = {"wire_quantize_multi": -(-62 // Q.WIRE_MAX_ENTRIES) * n_push,
            "wire_quantize": 0}
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
    emit({"phase": "grpc_path", "form": "profile",
          "steps": run["store"].global_step, "wall_s": run["wall"],
          "device_busy_s": device_us / 1e6,
          "device_idle_share": (1 - device_us / 1e6 / run["wall"])
          if device_us else None,
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
                  phase_grpc_path):
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

    # The multi-tensor K1 and its per-tensor first version, with their
    # launches from the async path's run and the gRPC path's (phase 14
    # (a); (b)'s workers are other processes); a push's times.
    kernels = []
    for name, k in state["k1"].items():
        kernels.append({
            "name": name, "route": "cuda", "source": Q.KERNEL_SOURCE,
            "replaces": Q.REPLACES[name],
            "launches": state["k1_launches"][name]
            + state["grpc_k1_launches"][name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "device_ms": k["device_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None})
    # K2-K4 launches from the sync path's run: the ring rounds
    # stochastically, so K2 (nearest rounding) reads 0 there. No single
    # PyTorch call computes a block quantize, so library_ms is null.
    launches = state["sync_counts"]
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
