#!/usr/bin/env python3
"""Where the fused flash backward's time goes, on one NVIDIA GPU.

    python3 scripts/flash_bwd_breakdown.py

Builds the fused backward kernel (``flash_bwd_kernel`` in the port's
``ops/csrc/flash_attention.cu``) as it is and in variants with one part
removed, then times each at the SP path's hop shape [192, 2048, 64] (bf16
in, fp32 out) by CUDA events, in turns (each variant twice, in forward then
reverse order). A variant's results are wrong by construction; only its
time is read. The difference to the full kernel is what that part costs
where nothing else hides it:

- ``no_dq_adds``: dQ's ``red.global.add`` instructions skipped;
- ``no_lo_product``: dV's second product (the lo half of P) left out;
- ``no_dq_stage``: the dS store, its barrier, the dQ product and the adds
  left out.

Prints one JSON line with the times and the card (nvidia-smi). Builds go
to ``build/flash_bwd_breakdown/`` (git-ignored).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

RED = 'asm volatile("red.global.add.v4.f32'
LO = "        wgmma_rs_n64_t(acc_v[c], fl, smem_desc(do_s + b));\n"
DQ_START = "    // dS^T to shared memory, swizzled like the tiles"
LOOP_END = "#pragma unroll\n  for (int c = 0; c < kCB; ++c) {\n    pin(acc_k[c]);"


def variants(src: str) -> dict[str, str]:
    for marker in (RED, LO, DQ_START, LOOP_END):
        if marker not in src:
            raise SystemExit(f"kernel source changed: {marker!r} not found")
    # Everything from the dS store to the end of the query loop goes; the
    # loop closes after a wait for the dV/dK products.
    no_dq = (src[:src.index(DQ_START)] + "    wgmma_wait<0>();\n  }\n"
             + src[src.index(LOOP_END):])
    return {"full": src,
            "no_dq_adds": src.replace(RED, "if (scale < 0.f) " + RED),
            "no_lo_product": src.replace(LO, ""),
            "no_dq_stage": no_dq}


def main() -> int:
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        _build
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_bwd_breakdown: no CUDA device", file=sys.stderr)
        return 1
    srcs = variants((_build.CSRC / "flash_attention.cu").read_text())
    out = REPO / "build" / "flash_bwd_breakdown"
    out.mkdir(parents=True, exist_ok=True)

    def build(name: str) -> str:
        cu, so = out / f"{name}.cu", out / f"{name}.so"
        cu.write_text(srcs[name])
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                               str(so), str(cu)], capture_output=True,
                              text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        return name

    with ThreadPoolExecutor(len(srcs)) as pool:
        list(pool.map(build, srcs))

    bf16, f32 = torch.bfloat16, torch.float32
    bh, t, d = 192, 2048, 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((bh, t, d), generator=gen,
                               device="cuda").to(bf16) for _ in range(4))
    o, lse = fa.flash_fwd_plain(q, k, v, t, out_dtype=f32)
    delta = (do.float() * o).sum(-1, keepdim=True)

    def time_ms(reps: int = 20) -> float:
        def run():
            fa.flash_bwd(q, k, v, do, lse, delta, t, out_dtype=f32)
        for _ in range(2):
            run()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    order = list(srcs) + list(reversed(srcs))
    times: dict[str, list[float]] = {}
    for name in order:
        # Point the wrappers at this variant's library.
        _build._loaded["flash_attention"] = ctypes.CDLL(str(out / f"{name}.so"))
        times.setdefault(name, []).append(time_ms())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"shape": [bh, t, d], "dtype": "bfloat16 in, float32 out",
                      "ms": times, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
