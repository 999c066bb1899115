#!/usr/bin/env python3
"""A ``cli worker``'s start-up on one NVIDIA GPU, stage by stage.

    python3 scripts/worker_startup.py

Each run is a fresh process that takes the steps a ``cli worker
--synthetic --num-train 2048 --num-test 256`` takes before its epoch,
with the seconds of each: ``import torch``, the card's context, the
port's CLI import, the dataset (the kept images only, as the CLI draws
them, and beside it the whole 60,000-image set the CLI drew before and
sliced), the full-width ResNet-18, the step's setup, the profiler's start
(``--profile-dir``; nothing without it), two grad steps of batch 128
and the profiler's stop (the trace written). Runs plain, profiled,
profiled, plain, and prints one JSON line a run and the card
(nvidia-smi) on the last line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

CHILD = r'''
import json, sys, tempfile, time
seconds = {}
t0 = time.perf_counter()


def mark(stage):
    global t0
    now = time.perf_counter()
    seconds[stage] = round(now - t0, 3)
    t0 = now


import torch
mark("import_torch")
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
mark("cuda_context")
from distributed_parameter_server_for_ml_training_tpu_torch import cli
from distributed_parameter_server_for_ml_training_tpu_torch.data import \
    synthetic_cifar100
mark("import_cli")
args = cli.build_parser().parse_args(
    ["worker", "--synthetic", "--num-train", "2048", "--num-test", "256"])
ds = cli._load_dataset(args)
mark("dataset_kept_2048_256")
synthetic_cifar100()
mark("dataset_whole_60000")
from distributed_parameter_server_for_ml_training_tpu_torch.models import \
    get_model
model = get_model("resnet18", num_classes=100, dtype="bfloat16",
                  device="cuda", seed=0)
torch.cuda.synchronize()
mark("get_model")
from distributed_parameter_server_for_ml_training_tpu_torch.train.steps \
    import make_grad_step
from distributed_parameter_server_for_ml_training_tpu_torch.utils.pytree \
    import params_to_jax
init, stats = params_to_jax(model)
params = {k: torch.from_numpy(v).cuda() for k, v in init.items()}
stats = {k: torch.from_numpy(v).cuda() for k, v in stats.items()}
step = make_grad_step(model, augment=True)
mark("step_setup")
session = cli._profiler_session(
    tempfile.mkdtemp() if sys.argv[1] == "profiled" else None, "cuda")
session.__enter__()
mark("profiler_start")
for i in range(2):
    step(params, stats, ds.x_train[:128], ds.y_train[:128])
    torch.cuda.synchronize()
    mark(f"grad_step_{i}")
session.__exit__(None, None, None)
mark("profiler_stop")
print("STAGES " + json.dumps(seconds))
'''


def main() -> int:
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    rc = 0
    for form in ("plain", "profiled", "profiled", "plain"):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", CHILD, form],
                             capture_output=True, text=True, env=env,
                             cwd=REPO)
        line = next((ln for ln in run.stdout.splitlines()
                     if ln.startswith("STAGES ")), None)
        if run.returncode or line is None:
            print(run.stderr[-3000:], file=sys.stderr)
            rc = 1
            continue
        print(json.dumps({"form": form,
                          "process_seconds": time.perf_counter() - t0,
                          "stages": json.loads(line[len("STAGES "):])}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
