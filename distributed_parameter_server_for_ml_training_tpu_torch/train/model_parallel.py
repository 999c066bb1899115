"""Model-parallel trainers of the port (counterpart of the JAX package's
``train/model_parallel.py``).

:class:`SPTrainer` is sequence-parallel training of the registry ViT:
every encoder block's attention runs as ring attention over the ``seq``
slots of a mesh on one card (``parallel/ring_attention.py`` wired into
``models/vit.py``'s ``SelfAttention`` through ``attention_fn``), the
flash kernels K5-K7 as each hop's core when the per-slot length allows
them. ``--mode sp --model vit_tiny|vit_b16``; ``pool='gap'`` keeps the
sequence a multiple of the slot count.

:class:`TPTrainer`, :class:`PipelineTrainer` and :class:`MoETrainer`
raise ``NotImplementedError`` naming the slice that brings them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..data.cifar import Dataset, make_batches
from ..models.registry import _DTYPES
from ..models.vit import ViT
from ..ops.flash_attention import flash_preferred
from ..parallel.mesh import SEQ_AXIS, make_mesh
from ..parallel.ring_attention import (make_ring_attention,
                                       make_ring_flash_attention)
from ..utils.metrics import emit_metrics_json
from .optimizers import server_sgd
from .steps import make_eval_step, make_train_step
from .train_state import module_train_state

# ViT shapes by registry name, CIFAR-resolution patch sizes.
VIT_SHAPES = {
    "vit_tiny": dict(patch_size=4, hidden_dim=192, depth=4, num_heads=3),
    "vit_b16": dict(patch_size=16, hidden_dim=768, depth=12, num_heads=12),
}


@dataclass
class ModelParallelConfig:
    model: str = "vit_tiny"
    num_workers: int = 4           # sequence slots (sp mode)
    learning_rate: float = 0.1
    num_epochs: int = 3
    batch_size: int = 128          # GLOBAL batch
    augment: bool = True
    num_classes: int = 100
    dtype: str = "bfloat16"
    seed: int = 0
    device: str = "cuda"


class _EpochTrainer:
    """Shared epoch loop of the model-parallel trainers: batching, eval,
    METRICS_JSON fields. Subclasses set ``mode`` and implement
    ``_train_batch`` / ``evaluate`` / ``_extra_metrics``."""

    mode = "?"

    def __init__(self, dataset: Dataset, config: ModelParallelConfig):
        self.config = config
        self.dataset = dataset
        self.epoch_times: list[float] = []
        # Per epoch: seconds to the end of its last step (eval excluded;
        # the device has finished once the epoch's loss is read), and the
        # mean train loss.
        self.train_seconds: list[float] = []
        self.train_loss_per_epoch: list[float] = []
        self.test_accuracies: list[float] = []
        self.global_steps = 0

    def _train_batch(self, xb, yb, generator):
        raise NotImplementedError

    def evaluate(self) -> float:
        raise NotImplementedError

    def _extra_metrics(self) -> dict:
        return {}

    def _label(self) -> str:
        return self.mode

    def train(self, emit_metrics: bool = False,
              checkpoint_dir: str | None = None,
              resume: bool = False) -> dict:
        cfg = self.config
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        # A checkpoint a epoch (the state and the augment generator); a
        # resume copies the newest back and skips the epochs it covers.
        mgr = None
        start_epoch = 0
        if checkpoint_dir:
            from ..checkpoint import CheckpointManager
            mgr = CheckpointManager(checkpoint_dir)
            if resume and mgr.latest_step() is not None:
                self.state = mgr.restore(self.state)
                gen.set_state(mgr.restore_extra()["generator"])
                steps_per_epoch = max(
                    1, len(self.dataset.x_train) // cfg.batch_size)
                self.global_steps = int(self.state.step)
                start_epoch = self.global_steps // steps_per_epoch
                print(f"resumed from step {self.global_steps} "
                      f"(epoch {start_epoch + 1})")
        t_start = time.time()
        for epoch in range(start_epoch, cfg.num_epochs):
            t0 = time.time()
            losses = []
            for xb, yb in make_batches(self.dataset.x_train,
                                       self.dataset.y_train, cfg.batch_size,
                                       seed=cfg.seed * 997 + epoch):
                self.state, m = self._train_batch(xb, yb, gen)
                losses.append(m["loss"])
                self.global_steps += 1
            mean_loss = float(torch.stack(losses).mean()) if losses \
                else float("nan")
            self.train_seconds.append(time.time() - t0)
            self.train_loss_per_epoch.append(mean_loss)
            acc = self.evaluate()
            self.epoch_times.append(time.time() - t0)
            self.test_accuracies.append(acc)
            print(f"[{self._label()}] epoch {epoch + 1}: loss {mean_loss:.4f} "
                  f"test {acc:.2%} ({self.epoch_times[-1]:.1f}s)")
            if mgr is not None:
                mgr.save(self.state, extra={"generator": gen.get_state()})
        total = time.time() - t_start
        if mgr is not None:
            mgr.close()
        metrics = {
            "mode": self.mode,
            "total_workers": cfg.num_workers,
            "total_training_time_seconds": round(total, 2),
            "global_steps_completed": self.global_steps,
            "total_parameter_updates": self.global_steps,
            "learning_rate": cfg.learning_rate,
            "final_test_accuracy": (self.test_accuracies[-1]
                                    if self.test_accuracies else 0.0),
            "all_test_accuracies": self.test_accuracies,
            **self._extra_metrics(),
        }
        if emit_metrics:
            emit_metrics_json(metrics)
        return metrics


class _NotPorted(_EpochTrainer):
    slice_name = "?"

    def __init__(self, dataset: Dataset,
                 config: ModelParallelConfig | None = None):
        raise NotImplementedError(
            f"--mode {self.mode} is not ported yet; {type(self).__name__} "
            f"comes with {self.slice_name}")


class TPTrainer(_NotPorted):
    mode = "tp"
    slice_name = "the tensor-parallel slice (parallel/tensor.py)"


class PipelineTrainer(_NotPorted):
    mode = "pp"
    slice_name = ("the pipeline slice (ViTPrologue/EncoderStage/ViTEpilogue, "
                  "parallel/pipeline.py)")


class MoETrainer(_NotPorted):
    mode = "moe"
    slice_name = "the MoE slice (SwitchMoEMlp, parallel/moe.py)"


class SPTrainer(_EpochTrainer):
    """Sequence-parallel training of the registry ViT: ring attention over
    ``num_workers`` sequence slots on one card. The ring's hops run the
    flash kernels when the per-slot length is a multiple of 128 and
    :func:`~..ops.flash_attention.flash_preferred` holds for it (on a
    CUDA device, from ``DEFAULT_CROSSOVER_T`` = 2048 tokens per slot),
    else the dense ring, as the reference dispatches. Weights are
    replicated (one copy); only activations split along T."""

    mode = "sp"

    def __init__(self, dataset: Dataset,
                 config: ModelParallelConfig | None = None):
        super().__init__(dataset, config or ModelParallelConfig())
        cfg = self.config
        shape = VIT_SHAPES.get(cfg.model)
        if shape is None:
            raise ValueError(
                f"--mode sp supports ViT models {tuple(VIT_SHAPES)}")
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got "
                             f"{cfg.dtype!r}")
        n_shards = cfg.num_workers
        h, w = dataset.x_train.shape[1:3]
        patch = shape["patch_size"]
        self.tokens = (h // patch) * (w // patch)
        if self.tokens % n_shards:
            raise ValueError(f"{self.tokens} tokens not divisible by "
                             f"{n_shards} sequence shards")
        self.mesh = make_mesh(n_shards, cfg.device, axis_names=(SEQ_AXIS,))
        self.device = self.mesh.device
        per_shard = self.tokens // n_shards
        self.flash = per_shard % 128 == 0 \
            and flash_preferred(per_shard, self.device)
        ring = (make_ring_flash_attention(self.mesh, axis=SEQ_AXIS)
                if self.flash else
                make_ring_attention(self.mesh, axis=SEQ_AXIS, causal=False))
        gen = torch.Generator().manual_seed(cfg.seed)
        self.model = ViT(patch_size=patch, hidden_dim=shape["hidden_dim"],
                         depth=shape["depth"], num_heads=shape["num_heads"],
                         num_classes=cfg.num_classes,
                         dtype=_DTYPES[cfg.dtype], pool="gap",
                         attention_fn=ring, image_size=h,
                         generator=gen).to(self.device)
        self.state = module_train_state(self.model,
                                        server_sgd(cfg.learning_rate))
        self._step = make_train_step(self.model, augment=cfg.augment)
        self._eval_step = make_eval_step(self.model)

    def _label(self) -> str:
        return (f"sp {self.config.model} {self.config.num_workers} "
                f"seq shards (T={self.tokens})")

    def _extra_metrics(self) -> dict:
        return {"seq_shards": self.config.num_workers,
                "tokens": self.tokens}

    def _train_batch(self, xb, yb, generator):
        return self._step(self.state, xb, yb, generator)

    def evaluate(self) -> float:
        """Top-1 over the test set in batches of 1000, from the module's
        own (current) weights."""
        correct, total = None, 0
        for xb, yb in make_batches(self.dataset.x_test, self.dataset.y_test,
                                   1000, shuffle=False,
                                   drop_remainder=False):
            c, t = self._eval_step({}, {}, xb, yb)
            correct = c if correct is None else correct + c
            total += t
        return (int(correct) if correct is not None else 0) / max(total, 1)

