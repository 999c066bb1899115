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

:class:`TPTrainer` is data x tensor parallel training of the registry
ViT on a ``(data, model)`` mesh of ``num_workers x tp_degree`` slots on
one card: the model's TP form (``models/vit.py`` over
``parallel/tensor.py``) splits ``qkv``/``fc1`` by column and
``out``/``fc2`` by row over the ``model`` slots, each slot a view of the
whole parameters, and the batch's rows split over ``data``. ``--mode tp
--tp-degree N``.

:class:`MoETrainer` is expert-parallel training of the registry ViT:
each block's MLP is a Switch top-1 MoE (``models/vit.py:SwitchMoEMlp``
over ``parallel/moe.py``) with one expert a slot of an ``expert`` mesh on
one card, the batch's tokens split over the same slots. ``--mode moe``;
``dp_degree`` > 1 is dp x ep on a ``(data, expert)`` mesh.

:class:`PipelineTrainer` is GPipe training of the CLS ViT: the prologue
(patch embedding, CLS, positions) and the epilogue (final LayerNorm,
head) run outside the pipeline; the ``depth`` blocks form S
``EncoderStage``s whose parameters are stacked ``[S, ...]``, one stage a
slot of the ``stage`` axis of a ``(data, model, stage)`` mesh on one card
(``parallel/pipeline.py``), and autograd through the schedule trains
them. ``--mode pp``; ``dp_degree`` splits each microbatch over ``data``
and ``pp_tp_degree`` runs the stages' TP form over ``model``.

``MoETrainer(..., group=...)`` and ``PipelineTrainer(..., group=...)``
spread the experts or the stages over several ranks, one process per
card, as the reference's ``expert`` and ``stage`` axes span several
chips (a one-axis mesh over ranks; a ``(data, expert)`` or ``(data,
model, stage)`` mesh over ranks comes with ROADMAP §1 item 10, sixth
part). Every rank draws the whole model from the seed, as one process
does, and keeps its experts' or stages' rows; every rank takes the whole
global batch from the same seeded shuffle and the same augmentation
draws. MoE: a rank trains on its contiguous rows of the batch
(``multihost.host_local_slice``), its expert leaves' gradients arrive
whole through the all_to_all's backward, and the other leaves' are
averaged over the ranks in one all-reduce (each rank's loss is its rows'
mean plus the whole aux loss, so the ranks' gradients sum to R times one
process's, and every leaf's is divided by R). PP: rank 0's prologue
feeds the pipeline, the last rank's CLS token reaches every rank
(``multihost.shared_broadcast``), so every rank computes the same
logits, loss and epilogue gradients; the prologue's gradients, whole on
rank 0 only, are broadcast from it. Rank 0 alone writes checkpoints, in
the one-process layout (the stacked leaves gathered from every rank), and
every rank restores its own rows of them.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import torch
from torch import nn
from torch.func import functional_call

from ..data.cifar import Dataset, make_batches
from ..models.registry import _DTYPES, get_model
from ..models.vit import (EncoderStage, ViT, ViTEpilogue, ViTPrologue,
                          embed_first)
from ..ops.flash_attention import flash_preferred
from ..parallel.mesh import (AXES_OVER_RANKS, DATA_AXIS, EXPERT_AXIS,
                             MODEL_AXIS, SEQ_AXIS, STAGE_AXIS, make_mesh,
                             mesh_from_shape)
from ..parallel.moe import make_moe_ffn
from ..parallel.pipeline import make_pipeline_apply
from ..parallel.multihost import (RankGroup, host_local_slice,
                                  make_global_mesh, rank_gather, rank_reduce,
                                  replicate_to_mesh, shared_broadcast,
                                  world_group)
from ..parallel.ring_attention import (make_ring_attention,
                                       make_ring_flash_attention)
from ..utils.collective_bytes import record_collectives
from ..utils.metrics import emit_metrics_json
from ..utils.pytree import leaf_rank_rows, rank_stacked
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
    num_workers: int = 4           # seq slots (sp) / stages (pp) / experts
    tp_degree: int = 2             # model-axis size (tp mode)
    pp_microbatches: int = 8       # GPipe M (pp mode)
    # Composed axes: 'data' for pp and moe (dp x pp, dp x ep), 'model'
    # for pp (dp x tp x pp).
    dp_degree: int = 1
    pp_tp_degree: int = 1
    # MoE (moe mode): per-expert buffer = capacity_factor x the
    # even-routing load; Switch aux-loss weight (0 disables balancing).
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01
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
    #: The ranks of a trainer spread over several processes, else None.
    group: RankGroup | None = None
    #: What the last step's collectives moved (``utils/
    #: collective_bytes.py`` schema), over ranks.
    collective_bytes_step: dict | None = None

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

    def _rank_metrics(self) -> dict:
        """``ranks`` and the last step's collective bytes, over ranks."""
        if self.group is None:
            return {}
        return {"ranks": self.group.size,
                "collective_bytes_per_step": self.collective_bytes_step}

    def _saved_state(self):
        """The state in the one-process layout (every rank calls it): the
        ranks' rows of the stacked expert and stage leaves gathered."""
        if self.group is None:
            return self.state

        def whole(tree):
            return {k: rank_gather(v, self.group) if rank_stacked(k) else v
                    for k, v in tree.items()}

        opt = self.state.opt_state
        if opt is not None:
            opt = type(opt)(trace=whole(opt.trace), count=opt.count)
        return self.state.replace(params=whole(self.state.params),
                                  opt_state=opt)

    def _restore(self, mgr):
        """The newest checkpoint into the state, each rank its rows."""
        rows = None if self.group is None else (
            lambda name, t: leaf_rank_rows(name, t, self.group.rank,
                                           self.group.size))
        return mgr.restore(self.state, rows=rows)

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
                self.state = self._restore(mgr)
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
            if mgr is not None:
                saved = self._saved_state()
                if self.is_chief:
                    mgr.save(saved, extra={"generator": gen.get_state()})
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


def _vit_shape(cfg: ModelParallelConfig, mode: str) -> dict:
    shape = VIT_SHAPES.get(cfg.model)
    if shape is None:
        raise ValueError(
            f"--mode {mode} supports ViT models {tuple(VIT_SHAPES)}")
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got "
                         f"{cfg.dtype!r}")
    return shape


def _evaluate(eval_step, x_test, y_test, batch_size: int,
              drop_remainder: bool, group: RankGroup | None = None
              ) -> float:
    """Top-1 over the test set from the module's own weights; one host
    sync at the end. With ``group`` each rank evaluates its rows of every
    batch and the counts are summed over the ranks."""
    correct, total = None, 0
    for xb, yb in make_batches(x_test, y_test, batch_size, shuffle=False,
                               drop_remainder=drop_remainder):
        if group is not None:
            xb, yb = host_local_slice(xb, group), host_local_slice(yb, group)
        c, t = eval_step({}, {}, xb, yb)
        correct = c if correct is None else correct + c
        total += t
    if group is not None and correct is not None:
        correct = rank_reduce(correct, "sum", group)
        total *= group.size
    return (int(correct) if correct is not None else 0) / max(total, 1)


def _joined(group: RankGroup | None) -> RankGroup | None:
    """``group``, or the world group of a joined job, or None."""
    if group is None and torch.distributed.is_available() \
            and torch.distributed.is_initialized():
        group = world_group()
    return group


def _rank_mesh(group: RankGroup, n: int, cfg, axis: str, what: str):
    """The one-axis mesh of ``n`` slots over the ranks of ``group``, with
    the ``multihost: rank r of R ...`` line on stderr."""
    if n % group.size:
        raise ValueError(f"--workers {n} (the global slot count) must "
                         f"divide evenly over {group.size} processes")
    mesh = make_global_mesh(n, cfg.device, axis_names=(axis,), group=group)
    staged = " (collectives staged through the host)" \
        if group.staged(mesh.device) else ""
    first = mesh.slot_offset
    print(f"multihost: rank {group.rank} of {group.size}, {what} "
          f"{first}-{first + mesh.local_slots - 1} of {n} on {mesh.device}, "
          f"{group.backend}{staged}", file=sys.stderr, flush=True)
    return mesh


class TPTrainer(_EpochTrainer):
    """Data x tensor parallel training of the registry ViT (``get_model``,
    CLS pool) on a ``(data, model)`` mesh of ``num_workers x tp_degree``
    slots on one card: the model's TP form over the ``model`` slots, the
    plain train step, each batch's rows split over the ``data`` slots (a
    batch the data slots do not divide is refused, as the reference's
    ``device_put`` refuses it). On one card the data slots' rows run
    together: every operation but the TP sums is row-wise, and the data
    slots' gradient sum is the batch's. The parameters are the plain
    ViT's (each model slot a view of them), so the state and checkpoints
    are too. Evaluation in batches of 1,000, the last one short."""

    mode = "tp"

    def __init__(self, dataset: Dataset,
                 config: ModelParallelConfig | None = None):
        super().__init__(dataset, config or ModelParallelConfig())
        cfg = self.config
        if cfg.model not in VIT_SHAPES:
            raise ValueError(
                f"--mode tp supports transformer models {tuple(VIT_SHAPES)}; "
                f"BatchNorm models train with --mode sync")
        dp, tp = cfg.num_workers, cfg.tp_degree
        self.mesh = make_mesh(dp, cfg.device,
                              axis_names=(DATA_AXIS, MODEL_AXIS),
                              num_slots=dp * tp)
        self.device = self.mesh.device
        self.model = get_model(cfg.model, num_classes=cfg.num_classes,
                               dtype=cfg.dtype,
                               image_size=dataset.x_train.shape[1],
                               device=self.device, seed=cfg.seed,
                               tp_degree=tp)
        self.state = module_train_state(self.model,
                                        server_sgd(cfg.learning_rate))
        self._step = make_train_step(self.model, augment=cfg.augment)
        self._eval_step = make_eval_step(self.model)

    def _label(self) -> str:
        return f"tp {self.config.num_workers}x{self.config.tp_degree}"

    def _extra_metrics(self) -> dict:
        return {"tp_degree": self.config.tp_degree}

    def _train_batch(self, xb, yb, generator):
        dp = self.mesh.shape[DATA_AXIS]
        if xb.shape[0] % dp:
            raise ValueError(
                f"a batch of {xb.shape[0]} rows is split over {dp} data "
                f"slots, which implies that its size should be divisible "
                f"by {dp}")
        return self._step(self.state, xb, yb, generator)

    def evaluate(self) -> float:
        return _evaluate(self._eval_step, self.dataset.x_test,
                         self.dataset.y_test, 1000, drop_remainder=False)


class MoETrainer(_EpochTrainer):
    """Expert-parallel training of the registry ViT (``pool='gap'``):
    every encoder block's MLP is a Switch top-1 MoE of ``num_workers``
    experts, one a slot of an ``expert`` mesh on one card; the tokens of
    the batch split over the same slots, each shard routing its own
    (``parallel/moe.py``). The capacity is ``max(8, int(capacity_factor
    * tokens_per_shard / experts))``; the loss adds
    ``moe_aux_weight`` times the layers' mean Switch aux loss, and the
    routing statistics of each step are kept as device tensors and read
    once, into the run's metrics. Evaluation runs at the training batch
    size, for which the capacity was sized. ``dp_degree`` > 1 is dp x ep
    on a ``(data, expert)`` mesh: ``dp * num_workers`` token shards, each
    data group routing its own over the experts (``parallel/moe.py``).

    Over several ranks (``group``, or the world group of a joined job)
    ``num_workers`` experts spread over the ranks, each holding ``E/R``
    of them and the tokens of its rows of the batch (module notes); the
    capacity is the one process's. The loss and accuracy of a step are
    averaged over the ranks, the MoE statistics are global already, and
    evaluation runs over the ranks at the training batch size."""

    mode = "moe"

    def __init__(self, dataset: Dataset,
                 config: ModelParallelConfig | None = None,
                 group: RankGroup | None = None):
        super().__init__(dataset, config or ModelParallelConfig())
        cfg = self.config
        shape = _vit_shape(cfg, "moe")
        n_exp = cfg.num_workers
        dp = max(1, cfg.dp_degree)
        n_shards = n_exp * dp
        if cfg.batch_size % n_shards:
            raise ValueError(f"batch {cfg.batch_size} not divisible by "
                             f"{n_shards} token shards (experts x dp; "
                             f"the batch shards over both axes)")
        if len(dataset.x_test) < cfg.batch_size:
            raise ValueError(
                f"test set ({len(dataset.x_test)}) smaller than the batch "
                f"size ({cfg.batch_size}) — eval runs at the training batch "
                f"size (expert capacity is sized for it) and would be empty")
        self.group = group = _joined(group)
        # The reference keeps a one-axis expert mesh at dp 1.
        if group is not None and dp > 1:
            raise NotImplementedError(
                f"a (data, expert) mesh of dp {dp} x {n_exp} experts over "
                f"ranks comes with {AXES_OVER_RANKS}")
        if group is not None:
            self.mesh = _rank_mesh(group, n_exp, cfg, EXPERT_AXIS, "experts")
        elif dp > 1:
            self.mesh = make_mesh(dp, cfg.device,
                                  axis_names=(DATA_AXIS, EXPERT_AXIS),
                                  num_slots=n_shards)
        else:
            self.mesh = make_mesh(n_exp, cfg.device,
                                  axis_names=(EXPERT_AXIS,))
        self.is_chief = self.mesh.rank == 0
        self.dp_degree = dp
        self.device = self.mesh.device
        h, w = dataset.x_train.shape[1:3]
        patch = shape["patch_size"]
        self.tokens = (h // patch) * (w // patch)
        tokens_per_shard = cfg.batch_size * self.tokens // n_shards
        self.capacity = max(
            8, int(cfg.moe_capacity_factor * tokens_per_shard / n_exp))
        gen = torch.Generator().manual_seed(cfg.seed)
        self.model = ViT(patch_size=patch, hidden_dim=shape["hidden_dim"],
                         depth=shape["depth"], num_heads=shape["num_heads"],
                         num_classes=cfg.num_classes,
                         dtype=_DTYPES[cfg.dtype], pool="gap",
                         image_size=h, generator=gen,
                         moe_fn=make_moe_ffn(
                             self.mesh, self.capacity,
                             data_axis=DATA_AXIS if dp > 1 else None),
                         moe_experts=n_exp).to(self.device)
        self.state = module_train_state(self.model,
                                        server_sgd(cfg.learning_rate))
        self._step = make_train_step(
            self.model, augment=cfg.augment,
            moe_aux_weight=cfg.moe_aux_weight,
            reduce_grads=None if group is None else _rank_mean_grads(group),
            batch_rows=None if group is None else (
                lambda t: host_local_slice(t, group)))
        self._eval_step = make_eval_step(self.model)
        self._moe_step_metrics: list[dict] = []

    def _label(self) -> str:
        return f"moe {self.config.model} {self.config.num_workers} experts"

    def _extra_metrics(self) -> dict:
        cfg = self.config
        out = {"n_experts": cfg.num_workers,
               "expert_capacity": self.capacity,
               "moe_dp_degree": self.dp_degree,
               "moe_aux_weight": cfg.moe_aux_weight,
               "moe_capacity_factor": cfg.moe_capacity_factor,
               **self._rank_metrics()}
        hist = [{k: float(v) for k, v in m.items()}
                for m in self._moe_step_metrics if m]
        if hist:
            last = hist[-1]
            out.update({
                "moe_aux_loss": round(last["moe_aux_loss"], 4),
                "moe_load_imbalance": round(last["moe_load_imbalance"], 3),
                "moe_drop_frac": round(last["moe_drop_frac"], 4),
                "moe_load_imbalance_mean": round(sum(
                    m["moe_load_imbalance"] for m in hist) / len(hist), 3),
                "moe_drop_frac_mean": round(sum(
                    m["moe_drop_frac"] for m in hist) / len(hist), 4),
            })
        return out

    def _train_batch(self, xb, yb, generator):
        with record_collectives() as rec:
            state, m = self._step(self.state, xb, yb, generator)
            if self.group is not None:
                mean = rank_reduce(torch.stack([m["loss"], m["accuracy"]]),
                                   "mean", self.group)
                m["loss"], m["accuracy"] = mean[0], mean[1]
        if self.group is not None:
            self.collective_bytes_step = rec.summary()
        self._moe_step_metrics.append(
            {k: m[k] for k in ("moe_aux_loss", "moe_load_imbalance",
                               "moe_drop_frac") if k in m})
        return state, m

    def evaluate(self) -> float:
        return _evaluate(self._eval_step, self.dataset.x_test,
                         self.dataset.y_test, self.config.batch_size,
                         drop_remainder=True, group=self.group)


class PipelinedViT(nn.Module):
    """The CLS ViT as a pipeline: ``prologue`` -> S stages -> ``epilogue``.

    ``stages`` is one :class:`EncoderStage` whose parameters are the S
    stages' stacked ``[S, ...]``; each stage call runs it with one
    stage's views (``torch.func.functional_call``) through
    ``make_pipeline_apply``. Parameter names are the flax tree's
    (``prologue/...``, ``stages/block_i/...``, ``epilogue/...``), so
    ``utils/pytree`` maps the JAX trainer's parameters both ways.
    ``data_axis`` splits each microbatch over the mesh's data slots.

    Over the ranks of ``mesh.group``, ``stages`` are this rank's, and the
    last rank's CLS token reaches every rank before the epilogue (module
    notes)."""

    def __init__(self, prologue: ViTPrologue, stages: list[EncoderStage],
                 epilogue: ViTEpilogue, mesh, num_microbatches: int,
                 data_axis: str | None = None):
        super().__init__()
        self.group = mesh.group
        self.prologue = prologue
        self.stages = stages[0]
        for name, _ in list(self.stages.named_parameters()):
            *path, leaf = name.split(".")
            owner = self.stages.get_submodule(".".join(path))
            stacked = torch.stack([s.get_parameter(name).detach()
                                   for s in stages])
            setattr(owner, leaf, nn.Parameter(stacked))
        self.epilogue = epilogue
        template = self.stages
        self._pipe = make_pipeline_apply(
            mesh, lambda p, x: functional_call(template, p, (x,)),
            num_microbatches, data_axis=data_axis)

    def named_parameters(self, prefix: str = "", recurse: bool = True,
                         remove_duplicate: bool = True):
        return embed_first(super().named_parameters(prefix, recurse,
                                                    remove_duplicate))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stacked = dict(self.stages.named_parameters())
        y = self._pipe(stacked, self.prologue(x))
        if self.group is not None:
            y = shared_broadcast(y[:, :1], self.group.size - 1, self.group)
        return self.epilogue(y)


class PipelineTrainer(_EpochTrainer):
    """GPipe training of the ViT (CLS pool): ``num_workers`` stages of
    ``depth / num_workers`` encoder blocks on the ``stage`` axis of a
    ``(data, model, stage)`` mesh on one card (all three axes at any
    size, as the reference's), ``pp_microbatches`` microbatches, each
    stage call recomputed in the backward; plain SGD
    (:class:`PipelinedViT`). ``dp_degree`` splits each microbatch over the
    ``data`` slots, ``pp_tp_degree`` runs the stages' TP form over the
    ``model`` slots.

    Over several ranks (``group``, or the world group of a joined job)
    the ``num_workers`` stages spread over the ranks, ``S/R`` consecutive
    stages each, at dp and tp 1 (module notes). Every rank ends a step
    with the same prologue and epilogue, loss and metrics, and every rank
    runs evaluation, whose pipeline spans the ranks."""

    mode = "pp"

    def __init__(self, dataset: Dataset,
                 config: ModelParallelConfig | None = None,
                 group: RankGroup | None = None):
        super().__init__(dataset, config or ModelParallelConfig())
        cfg = self.config
        shape = _vit_shape(cfg, "pp")
        n_stages = cfg.num_workers
        if shape["depth"] % n_stages:
            raise ValueError(f"depth {shape['depth']} not divisible by "
                             f"{n_stages} stages")
        if cfg.pp_microbatches > len(dataset.x_test):
            raise ValueError(
                f"test set ({len(dataset.x_test)}) smaller than "
                f"pp_microbatches ({cfg.pp_microbatches}) — eval would be "
                f"empty")
        dp, tp = cfg.dp_degree, cfg.pp_tp_degree
        mb = cfg.batch_size // cfg.pp_microbatches
        if cfg.batch_size % cfg.pp_microbatches or (dp > 1 and mb % dp):
            raise ValueError(
                f"batch {cfg.batch_size} must split into "
                f"{cfg.pp_microbatches} microbatches of a size divisible "
                f"by dp_degree {dp}")
        self.group = group = _joined(group)
        if group is not None and (dp > 1 or tp > 1):
            raise NotImplementedError(
                f"a (data, model, stage) mesh of dp {dp} x tp {tp} x "
                f"{n_stages} stages over ranks comes with {AXES_OVER_RANKS}")
        if group is not None:
            self.mesh = _rank_mesh(group, n_stages, cfg, STAGE_AXIS,
                                   "stages")
        else:
            self.mesh = mesh_from_shape(
                {DATA_AXIS: dp, MODEL_AXIS: tp, STAGE_AXIS: n_stages},
                cfg.device)
        self.is_chief = self.mesh.rank == 0
        self.device = self.mesh.device
        h = dataset.x_train.shape[1]
        dtype = _DTYPES[cfg.dtype]
        gen = torch.Generator().manual_seed(cfg.seed)
        prologue = ViTPrologue(patch_size=shape["patch_size"],
                               hidden_dim=shape["hidden_dim"], dtype=dtype,
                               image_size=h, generator=gen)
        # Every stage is drawn, as one process draws them; a rank keeps
        # its own.
        stages = [EncoderStage(shape["depth"] // n_stages,
                               shape["hidden_dim"], shape["num_heads"],
                               dtype=dtype, generator=gen, tp_degree=tp)
                  for _ in range(n_stages)]
        per = n_stages // self.mesh.num_ranks
        stages = stages[self.mesh.rank * per:(self.mesh.rank + 1) * per]
        epilogue = ViTEpilogue(hidden_dim=shape["hidden_dim"],
                               num_classes=cfg.num_classes, dtype=dtype,
                               generator=gen)
        self.model = PipelinedViT(
            prologue, stages, epilogue, self.mesh, cfg.pp_microbatches,
            data_axis=None if group is not None else DATA_AXIS
        ).to(self.device)
        self.state = module_train_state(self.model,
                                        server_sgd(cfg.learning_rate))
        self._step = make_train_step(
            self.model, augment=cfg.augment,
            reduce_grads=None if group is None else _rank0_prologue(group))
        self._eval_step = make_eval_step(self.model)

    def _label(self) -> str:
        cfg = self.config
        composed = (f" x dp{cfg.dp_degree}" if cfg.dp_degree > 1 else "") \
            + (f" x tp{cfg.pp_tp_degree}" if cfg.pp_tp_degree > 1 else "")
        return (f"pp {cfg.num_workers} stages "
                f"x{cfg.pp_microbatches} microbatches{composed}")

    def _extra_metrics(self) -> dict:
        return {"pp_microbatches": self.config.pp_microbatches,
                "dp_degree": self.config.dp_degree,
                "pp_tp_degree": self.config.pp_tp_degree,
                **self._rank_metrics()}

    def _train_batch(self, xb, yb, generator):
        with record_collectives() as rec:
            out = self._step(self.state, xb, yb, generator)
        if self.group is not None:
            self.collective_bytes_step = rec.summary()
        return out

    def evaluate(self) -> float:
        """The reference's eval batch: a multiple of the microbatch count
        times ``dp_degree`` (each microbatch splits over the data slots),
        at most 1,000 and at most the test set."""
        m = self.config.pp_microbatches * max(1, self.config.dp_degree)
        n_test = len(self.dataset.x_test)
        bs = max(min((1000 // m) * m, (n_test // m) * m), m)
        return _evaluate(self._eval_step, self.dataset.x_test,
                         self.dataset.y_test, bs, drop_remainder=True)


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
        self.group = group = _joined(group)
        if group is not None:
            self.mesh = _rank_mesh(group, n_shards, cfg, SEQ_AXIS,
                                   "seq slots")
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

    def _label(self) -> str:
        return (f"sp {self.config.model} {self.config.num_workers} "
                f"seq shards (T={self.tokens})")

    def _extra_metrics(self) -> dict:
        return {"seq_shards": self.config.num_workers,
                "tokens": self.tokens, **self._rank_metrics()}

    def _train_batch(self, xb, yb, generator):
        with record_collectives() as rec:
            out = self._step(self.state, xb, yb, generator)
        self.collective_bytes_step = rec.summary()
        return out

    def evaluate(self) -> float:
        """Top-1 over the test set in batches of 1000, from the module's
        own (current) weights."""
        return _evaluate(self._eval_step, self.dataset.x_test,
                         self.dataset.y_test, 1000, drop_remainder=False)


def _through_one(grads: list, idx: list, collective) -> list:
    """``grads`` with those at ``idx`` passed through one collective of
    their flat concatenation."""
    flat = collective(torch.cat([grads[i].reshape(-1) for i in idx]))
    out, off = list(grads), 0
    for i in idx:
        out[i] = flat[off:off + grads[i].numel()].view_as(grads[i])
        off += grads[i].numel()
    return out


def _rank_sum_token_grads(group: RankGroup):
    """``reduce_grads`` of SP over ranks: the gradients of the parameters
    used per token summed over the ranks in one all-reduce of their flat
    concatenation; the head's gradient, the same on every rank, is left
    as it is (a sum would multiply it by R)."""

    def reduce(names, grads):
        idx = [i for i, name in enumerate(names)
               if not name.startswith("head.")]
        return _through_one(grads, idx,
                            lambda flat: rank_reduce(flat, "sum", group))

    return reduce


def _rank_mean_grads(group: RankGroup):
    """``reduce_grads`` of MoE over ranks: every rank's loss is its rows'
    mean plus the whole aux loss, so the ranks' gradients sum to R times
    one process's. The expert leaves' come whole through the
    all_to_all's backward and are divided by R; the others are summed
    over the ranks in one all-reduce of their flat concatenation and
    divided by R."""

    def reduce(names, grads):
        idx = [i for i, name in enumerate(names) if not rank_stacked(name)]
        out = _through_one(grads, idx, lambda flat: rank_reduce(
            flat, "sum", group) / group.size)
        experts = set(range(len(grads))) - set(idx)
        return [g / group.size if i in experts else g
                for i, g in enumerate(out)]

    return reduce


def _rank0_prologue(group: RankGroup):
    """``reduce_grads`` of a pipeline over ranks: the prologue's gradients,
    whole on rank 0 (the others' prologue output feeds no stage), are
    broadcast from it in one flat tensor; the stages' are the rank's own
    and the epilogue's the same on every rank."""

    def reduce(names, grads):
        idx = [i for i, name in enumerate(names)
               if name.startswith("prologue.")]
        with torch.no_grad():
            return _through_one(grads, idx, lambda flat: shared_broadcast(
                flat, 0, group))

    return reduce
