#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s seconds go, helper by helper, on one NVIDIA GPU.

    python3 scripts/smoke_helper_times.py 2> helper_times.txt

Runs ``chip_smoke.main()`` with every function of ``chip_smoke`` but the
phases themselves wrapped in a timer (and the dataset generators, the
baseline trainer's ``train`` and ``get_model``): each call of 0.5 s or
more prints ``[t] <name> <seconds>`` on stderr, beside the script's own
``[phase_*]`` lines. The exit code and stdout are ``chip_smoke.py``'s.
Nested helpers print too, so a phase's lines overlap: read a helper's
line against its phase's total.
"""

from __future__ import annotations

import functools
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def timed(name: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds = time.perf_counter() - t0
            if seconds >= 0.5:
                print(f"[t] {name} {seconds:.2f}", file=sys.stderr,
                      flush=True)
    return wrapper


def main() -> int:
    from distributed_parameter_server_for_ml_training_tpu_torch import (
        data, models)
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        import baseline

    for name, fn in list(vars(chip_smoke).items()):
        if callable(fn) and getattr(fn, "__module__", None) == "chip_smoke" \
                and not isinstance(fn, type) \
                and name not in ("main", "emit", "captured") \
                and not name.startswith("phase_"):
            setattr(chip_smoke, name, timed(name, fn))
    for name in ("synthetic_cifar100", "compositional_cifar100",
                 "synthetic_imagenet"):
        setattr(data, name, timed(f"data.{name}", getattr(data, name)))
    baseline.BaselineTrainer.train = timed(
        "BaselineTrainer.train", baseline.BaselineTrainer.train)
    models.get_model = timed("get_model", models.get_model)
    return chip_smoke.main()


if __name__ == "__main__":
    sys.exit(main())
