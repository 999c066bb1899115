#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure makes the exit code 1):

1. the card's name and power limit (nvidia-smi), then the build of every
   kernel from the sources in the checkout (one nvcc per source, all
   started together);
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
3. kernels K2, K3 and K4 (block-wise int8) and K4's first version against
   their plain versions, torch.equal at tolerance 0: the ResNet-18 ring
   chunk at N=4 as a batch of 4 rows of 2,805,033 values, 513 values, 3
   rows of 513 (rows that start off 16-byte alignment), exactly 2 x
   32,768, an all-zero block, an empty input and a 1000-valued outlier in
   block 0; K3 at 3 seeds. On the chunk, K3's mean rounding error (in
   scales) must be near 0 and every code floor or floor + 1 of x / scale.
   Times each kernel on the chunk by CUDA events (K4 in turns with its
   first version) and by torch.profiler, and its plain version;
4. the CUDA device codec on a full-width ResNet-18 gradient tree: int8 and
   int4 with error feedback over 3 pushes, with and without shared
   scales, plus a top-k push, byte-for-byte against the NumPy
   ``compress_push``;
5. the async path: full ResNet-18 (100 classes, bf16 compute) trained by
   2 async workers through ``ParameterStore(push_codec="int8")`` for one
   epoch of synthetic CIFAR-100, eval on. K1's launch counts are reset
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
   7 times per step (one launch over all slots per hop), K2 and K4's
   first version never (the ring rounds stochastically; K2 is on no main
   path). Then, from the
   trained state, the ring on one step's real per-slot gradient rows
   ``[4, 11,220,132]`` on the card must equal, bit for bit, the same ring
   on a CPU copy (the plain versions), with the same seed; and one step
   each with ``compression="none"`` and with the int8 ring, whose params
   must be within rtol 0.05 / atol 1e-3 of each other;
8. a few sync steps under torch.profiler: device busy share and top
   device kernels;
9. the flash kernels against their plain versions: the wgmma forward
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
10. the SP path: ``SPTrainer`` with ViT-B/16 (768 wide, 12 layers, 12
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
11. one SP step under torch.profiler: device busy share, the flash
   kernels', the wgmma forward's and the fused backward's device time,
   top device kernels;
12. the CLI verb ``train`` in async mode at its default codec, in sync
   mode with the int8 ring, and in sp mode on ViT-B/16 at 1024 x 1024.

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

import numpy as np

H100_BYTES_PER_S = 3.35e12    # HBM3, NVIDIA's H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12   # fp32 outside the tensor cores, same sheet
# 32-bit integer operations: 64 INT32 lanes per SM against 128 FP32 lanes
# (NVIDIA's Hopper white paper), so half the fp32 rate.
H100_INT32_OPS_PER_S = H100_FP32_OPS_PER_S / 2
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


def block_bound(n_rows: int, n: int, kernel: str) -> tuple[float, str]:
    """Least time for a block kernel's work on ``n_rows`` rows of ``n``
    values: each input read once and each output written once, against
    the operations at the card's peak rates; the larger, and which."""
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    rows_padded, _, n_blocks = Q.block_layout(n)
    payload = n_rows * (rows_padded * Q.LANES + 4 * n_blocks)
    values = n_rows * n
    if kernel.startswith("block_dequantize"):
        nbytes = payload + 4 * values
        fp_ops, int_ops = 2 * values, 0            # convert, multiply
    else:
        nbytes = 4 * values + payload
        # abs, max, divide, round, two clamps, convert
        fp_ops, int_ops = 7 * values, 0
        if kernel == "block_quantize_stochastic":
            # Philox4x32-10 per 4 values: 10 rounds of 2 mul.hi, 2 mul.lo,
            # 4 xor and 2 key adds; then shift, convert, scale, add, floor.
            int_ops = 25 * values + values
            fp_ops += 4 * values
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = (fp_ops / H100_FP32_OPS_PER_S
              + int_ops / H100_INT32_OPS_PER_S) * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


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
        "n513": torch.randn((1, 513), generator=gen, device="cuda"),
        # rows 1 and 2 start off 16-byte alignment in K4's output
        "rows3_n513": torch.randn((3, 513), generator=gen, device="cuda"),
        "n65536": torch.randn((1, 2 * 32768), generator=gen, device="cuda"),
        "zero_block": zero_block,
        "empty": torch.zeros((1, 0), device="cuda"),
        "outlier_block0": outlier,
    }
    seeds = [[0x5EED0000 + 64 * k + r for r in range(n_slots)]
             for k in range(3)]
    err = {"block_quantize": 0, "block_quantize_stochastic": 0,
           "block_dequantize": 0.0, "block_dequantize_v1": 0.0}
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
            for k4 in ("block_dequantize", "block_dequantize_v1"):
                back = getattr(Q, k4)(*got, x.shape[1])
                torch.cuda.synchronize()
                if back.numel():
                    err[k4] = max(err[k4], float(
                        (back - back_plain).abs().max()))
                if not torch.equal(back, back_plain):
                    mismatched.append((k4, name))

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

    fns = {
        "block_quantize": (lambda: Q.block_quantize(ring),
                           lambda: Q.quantize_int8_plain(ring)),
        "block_quantize_stochastic": (
            lambda: Q.block_quantize_stochastic(ring, seeds[0]),
            lambda: Q.quantize_int8_plain(ring, seeds[0], stochastic=True)),
    }
    payload = Q.block_quantize(ring)
    for k4 in ("block_dequantize", "block_dequantize_v1"):
        fns[k4] = (lambda k4=k4: getattr(Q, k4)(*payload, chunk),
                   lambda: Q.dequantize_int8_plain(*payload, chunk))
    # Each kernel twice by CUDA events (host-issued, 50 calls); K4 in turns
    # with its first version (new, first, first, new). Device time per call
    # from torch.profiler's kernel durations.
    ms = {kernel: [] for kernel in fns}
    for kernel in ("block_quantize", "block_quantize",
                   "block_quantize_stochastic", "block_quantize_stochastic",
                   "block_dequantize", "block_dequantize_v1",
                   "block_dequantize_v1", "block_dequantize"):
        ms[kernel].append(cuda_time_ms(fns[kernel][0], 50))
    state["block"] = {}
    for kernel, (fk, fp) in fns.items():
        plain = [cuda_time_ms(fp, 10), cuda_time_ms(fp, 10)]
        device_ms = device_ms_per_call(
            fk, 50, "::block_dequantize_v1_kernel"
            if kernel == "block_dequantize_v1" else
            "::block_dequantize_kernel" if kernel == "block_dequantize"
            else "::block_quantize_kernel")[0]
        bound_ms, bound_by = block_bound(n_slots, chunk, kernel)
        state["block"][kernel] = {
            "ms": min(ms[kernel]), "device_ms": device_ms,
            "plain_ms": min(plain), "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err[kernel]}
        emit({"phase": "kernel_int8_vs_plain", "kernel": kernel,
              "shape": [n_slots, chunk], "ms_runs": ms[kernel],
              "device_ms": device_ms, "plain_ms_runs": plain,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "share_of_bound_device": bound_ms / device_ms
              if device_ms else None,
              "max_abs_err": err[kernel], "card": state["card"]})
    emit({"phase": "kernel_int8_vs_plain", "cases": list(cases),
          "k3_seeds": len(seeds), "mismatched": mismatched,
          "k3_mean_error_in_scales": mean_err, "k3_unbiased": unbiased,
          "k3_codes_floor_or_floor_plus_1": floor_ok,
          "card": state["card"]})
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

    emit({"phase": "main_path", "model": "resnet18", "dtype": "bfloat16",
          "workers": n_workers, "batch_size": batch,
          "push_codec": "int8", "global_step": step, "pushes": pushes,
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
    Q.block_dequantize_v1.launches = 0


def _block_counts() -> dict:
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    return {"block_quantize": Q.block_quantize.launches,
            "block_quantize_stochastic": Q.block_quantize_stochastic.launches,
            "block_dequantize": Q.block_dequantize.launches,
            "block_dequantize_v1": Q.block_dequantize_v1.launches}


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
            "block_dequantize": (2 * SYNC_SLOTS - 1) * steps,
            "block_dequantize_v1": 0}
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
                  phase_sync_profile, phase_kernel_flash, phase_sp_path,
                  phase_sp_profile, phase_cli):
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
    # launches from the async path's run; a push's times.
    kernels = []
    for name, k in state["k1"].items():
        kernels.append({
            "name": name, "route": "cuda", "source": Q.KERNEL_SOURCE,
            "replaces": Q.REPLACES[name],
            "launches": state["k1_launches"][name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "device_ms": k["device_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None})
    # K2-K4 launches from the sync path's run: the ring rounds
    # stochastically, so K2 (nearest rounding) reads 0 there, and K4's
    # first version is on no path. No single PyTorch call computes a block
    # quantize, so library_ms is null.
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
