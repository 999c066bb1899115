"""Model-parallel trainers of the port (counterpart of the JAX package's
``train/model_parallel.py``).

:class:`SPTrainer` is sequence-parallel training of the registry ViT:
every encoder block's attention runs as ring attention over the ``seq``
slots of a mesh on one card (``parallel/ring_attention.py`` wired into
``models/vit.py``'s ``SelfAttention`` through ``attention_fn``), the
flash kernels K5-K7 as each hop's core when the per-slot length allows
them. ``--mode sp --model vit_tiny|vit_b16``; ``pool='gap'`` keeps the
sequence a multiple of the slot count. ``SPTrainer(..., group=...)``
spreads the slots over several ranks, one process per card, as the
reference's ``seq`` axis spans several chips (the CLI keeps JAX's refusal
of ``--multihost`` outside ``--mode sync``, so this is reached through
the API or a joined job).

:class:`TPTrainer`, :class:`PipelineTrainer` and :class:`MoETrainer`
raise ``NotImplementedError`` naming the slice that brings them.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import torch

from ..data.cifar import Dataset, make_batches
from ..models.registry import _DTYPES
from ..models.vit import ViT
from ..ops.flash_attention import flash_preferred
from ..parallel.mesh import SEQ_AXIS, make_mesh
from ..parallel.multihost import (RankGroup, make_global_mesh, rank_reduce,
                                  replicate_to_mesh, world_group)
from ..parallel.ring_attention import (make_ring_attention,
                                       make_ring_flash_attention)
from ..utils.collective_bytes import record_collectives
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
    ``_train_batch`` / ``evaluate`` / ``_extra_metrics``. Only the chief
    (rank 0 of a multi-process trainer) prints, saves checkpoints and
    emits METRICS_JSON; every rank restores on ``resume``."""

    mode = "?"
    is_chief = True

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
                if self.is_chief:
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
            if self.is_chief:
                print(f"[{self._label()}] epoch {epoch + 1}: loss "
                      f"{mean_loss:.4f} test {acc:.2%} "
                      f"({self.epoch_times[-1]:.1f}s)")
            if mgr is not None and self.is_chief:
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
        if emit_metrics and self.is_chief:
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
    replicated (one copy); only activations split along T.

    Over several ranks (``group``, or the world group of a joined job)
    ``num_workers`` counts the slots of every rank, rank-major, and each
    rank holds the tokens of its own slots for the same global batch and
    the same augmentation draws. The state starts from rank 0's weights;
    the gradients of the parameters used per token (everything but the
    head, whose gradient every rank already holds whole) are summed over
    the ranks before the apply; every rank evaluates, since the model is
    split along T."""

    mode = "sp"

    def __init__(self, dataset: Dataset,
                 config: ModelParallelConfig | None = None,
                 group: RankGroup | None = None):
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
        if group is None and torch.distributed.is_available() \
                and torch.distributed.is_initialized():
            group = world_group()
        if group is not None:
            if n_shards % group.size:
                raise ValueError(
                    f"--workers {n_shards} (the global slot count) must "
                    f"divide evenly over {group.size} processes")
            self.mesh = make_global_mesh(n_shards, cfg.device,
                                         axis_names=(SEQ_AXIS,), group=group)
            staged = " (collectives staged through the host)" \
                if group.staged(self.mesh.device) else ""
            first = self.mesh.slot_offset
            print(f"multihost: rank {group.rank} of {group.size}, seq "
                  f"slots {first}-{first + self.mesh.local_slots - 1} of "
                  f"{n_shards} on {self.mesh.device}, {group.backend}"
                  f"{staged}", file=sys.stderr, flush=True)
        else:
            self.mesh = make_mesh(n_shards, cfg.device,
                                  axis_names=(SEQ_AXIS,))
        self.is_chief = self.mesh.rank == 0
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
                         generator=gen, seq_group=group).to(self.device)
        self.state = replicate_to_mesh(self.mesh, module_train_state(
            self.model, server_sgd(cfg.learning_rate)))
        self._step = make_train_step(
            self.model, augment=cfg.augment,
            reduce_grads=None if group is None else _rank_sum_token_grads(
                group))
        self._eval_step = make_eval_step(self.model)
        #: What the last step's collectives moved (``utils/
        #: collective_bytes.py`` schema).
        self.collective_bytes_step: dict | None = None

    def _label(self) -> str:
        return (f"sp {self.config.model} {self.config.num_workers} "
                f"seq shards (T={self.tokens})")

    def _extra_metrics(self) -> dict:
        extra = {"seq_shards": self.config.num_workers,
                 "tokens": self.tokens}
        if self.mesh.group is not None:
            extra.update({"ranks": self.mesh.num_ranks,
                          "collective_bytes_per_step":
                              self.collective_bytes_step})
        return extra

    def _train_batch(self, xb, yb, generator):
        with record_collectives() as rec:
            out = self._step(self.state, xb, yb, generator)
        self.collective_bytes_step = rec.summary()
        return out

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


def _rank_sum_token_grads(group: RankGroup):
    """``reduce_grads`` of SP over ranks: the gradients of the parameters
    used per token summed over the ranks in one all-reduce of their flat
    concatenation; the head's gradient, the same on every rank, is left
    as it is (a sum would multiply it by R)."""

    def reduce(names, grads):
        idx = [i for i, name in enumerate(names)
               if not name.startswith("head.")]
        flat = rank_reduce(torch.cat([grads[i].reshape(-1) for i in idx]),
                           "sum", group)
        out, off = list(grads), 0
        for i in idx:
            out[i] = flat[off:off + grads[i].numel()].view_as(grads[i])
            off += grads[i].numel()
        return out

    return reduce
