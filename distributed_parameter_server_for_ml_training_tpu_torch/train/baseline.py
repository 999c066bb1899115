"""Single-machine baseline trainer of the port (counterpart of the JAX
package's ``train/baseline.py``; reference: baseline/baseline_training.py).

The same recipe — ResNet-18/CIFAR-100, batch 128, SGD(momentum 0.9, wd
5e-4), MultiStepLR([10,15], gamma 0.1), per-epoch train/test metrics and
plots (baseline_training.py:201-260) — on one card, for any registry
model (``BaselineConfig.model``; ResNet-50 on ImageNet-shaped data takes
the ImageNet stem). Each epoch runs either as a per-batch host loop
(the reference's DataLoader shape, host batches uploaded ahead of the
step by ``prefetch_to_device``) or, with
``device_loop=True``, over the device-resident dataset with each step one
CUDA-graph replay (``train/device_loop.py``). With a checkpoint directory
the train state and the generator are saved each epoch, and a resume
copies them back into the same tensors (the graph's), so the resumed run
is the uninterrupted one.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..data.cifar import Dataset, make_batches
from ..utils.device import resolve_device
from ..utils.metrics import emit_metrics_json
from .device_loop import DeviceEpochLoop, prefetch_to_device
from .optimizers import baseline_optimizer, server_sgd
from .steps import make_eval_step, make_train_step
from .train_state import module_train_state


@dataclass
class BaselineConfig:
    batch_size: int = 128          # baseline_training.py:203
    num_epochs: int = 3            # baseline_training.py:204
    learning_rate: float = 0.1     # baseline_training.py:205
    momentum: float = 0.9          # baseline_training.py:223
    weight_decay: float = 5e-4
    milestones: tuple = (10, 15)   # baseline_training.py:224
    gamma: float = 0.1
    augment: bool = True
    num_classes: int = 100
    dtype: str = "bfloat16"        # 'float32' for parity
    plain_sgd: bool = False        # True = the distributed server optimizer
    model: str = "resnet18"        # models/registry.py name
    seed: int = 0
    # True = each epoch over the device-resident dataset, each step one
    # CUDA-graph replay (train/device_loop.py). False = per-batch host
    # loop (the reference's DataLoader shape, baseline_training.py:149-179).
    device_loop: bool = False
    device: str = "cuda"

    def __post_init__(self):
        resolve_device(self.device)


@dataclass
class TrainingMetrics:
    """Per-epoch records (baseline_training.py:97-147 TrainingMetrics)."""

    epochs: list = field(default_factory=list)
    train_losses: list = field(default_factory=list)
    train_accuracies: list = field(default_factory=list)
    test_accuracies: list = field(default_factory=list)
    epoch_times: list = field(default_factory=list)

    def add_epoch(self, epoch, loss, train_acc, test_acc, seconds):
        self.epochs.append(epoch)
        self.train_losses.append(float(loss))
        self.train_accuracies.append(float(train_acc))
        self.test_accuracies.append(float(test_acc))
        self.epoch_times.append(float(seconds))

    def plot_results(self, path: str) -> None:
        """4-panel summary plot (baseline_training.py:110-147). matplotlib
        is imported here, so a host without it trains all the same."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 2, figsize=(12, 8))
        axes[0, 0].plot(self.epochs, self.train_losses, "o-")
        axes[0, 0].set_title("Training loss")
        axes[0, 1].plot(self.epochs, self.train_accuracies, "o-",
                        label="train")
        axes[0, 1].plot(self.epochs, self.test_accuracies, "s-", label="test")
        axes[0, 1].set_title("Accuracy (%)")
        axes[0, 1].legend()
        axes[1, 0].bar(self.epochs, self.epoch_times)
        axes[1, 0].set_title("Epoch time (s)")
        axes[1, 1].axis("off")
        summary = (f"final test acc: "
                   f"{self.test_accuracies[-1]:.2f}%\n"
                   f"total time: {sum(self.epoch_times):.1f}s"
                   if self.epochs else "no epochs")
        axes[1, 1].text(0.1, 0.5, summary, fontsize=12)
        for ax in axes.flat:
            ax.set_xlabel("epoch")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)


class BaselineTrainer:
    """The reference's baseline_training.py main loop as a class. ``model``
    (on any device; moved to the config's) replaces the registry's."""

    def __init__(self, dataset: Dataset, config: BaselineConfig | None = None,
                 model: torch.nn.Module | None = None):
        from ..models import get_model

        self.config = cfg = config or BaselineConfig()
        self.dataset = dataset
        self.device = resolve_device(cfg.device)
        steps_per_epoch = max(1, len(dataset.x_train) // cfg.batch_size)
        self.model = model.to(self.device) if model is not None else \
            get_model(cfg.model, num_classes=cfg.num_classes,
                      dtype=cfg.dtype, image_size=dataset.x_train.shape[1],
                      device=self.device, seed=cfg.seed)
        tx = (server_sgd(cfg.learning_rate) if cfg.plain_sgd
              else baseline_optimizer(
                  cfg.learning_rate, cfg.momentum, cfg.weight_decay,
                  cfg.milestones, cfg.gamma, steps_per_epoch))
        self.state = module_train_state(self.model, tx)
        self._train_step = make_train_step(self.model, augment=cfg.augment)
        self._eval_step = make_eval_step(self.model)
        # The augmentation's draws (and the device loop's permutations).
        self._gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)
        self._device_loop = None
        if cfg.device_loop:
            self._device_loop = DeviceEpochLoop(
                dataset, self._train_step,
                lambda x, y: self._eval_step({}, {}, x, y)[0],
                batch_size=cfg.batch_size, generator=self._gen)
        self.metrics = TrainingMetrics()
        # Per epoch: seconds to the end of its last step (eval excluded).
        self.train_seconds: list[float] = []

    def train_epoch(self, epoch: int) -> tuple[float, float]:
        """One epoch (baseline_training.py:149-179). Returns (loss, acc%).
        Reads the step metrics back once, at the end."""
        cfg = self.config
        t0 = time.perf_counter()
        losses, accs = [], []
        batches = make_batches(self.dataset.x_train, self.dataset.y_train,
                               cfg.batch_size, seed=cfg.seed * 997 + epoch)
        for xb, yb in prefetch_to_device(batches, depth=2,
                                         device=self.device):
            self.state, m = self._train_step(self.state, xb, yb, self._gen)
            losses.append(m["loss"])
            accs.append(m["accuracy"])
        losses = torch.stack(losses).double().cpu().numpy()
        accs = torch.stack(accs).double().cpu().numpy()
        self.train_seconds.append(time.perf_counter() - t0)
        return float(np.mean(losses)), 100.0 * float(np.mean(accs))

    def test_epoch(self) -> float:
        """Full test-set top-1 in % (baseline_training.py:181-199), in
        batches of 1,000 with the remainder kept."""
        correct, total = None, 0
        for xb, yb in make_batches(self.dataset.x_test, self.dataset.y_test,
                                   1000, shuffle=False,
                                   drop_remainder=False):
            c, t = self._eval_step({}, {}, xb, yb)
            correct = c if correct is None else correct + c
            total += t
        return 100.0 * (int(correct) if correct is not None else 0) \
            / max(total, 1)

    def train(self, plot_path: str | None = None,
              emit_metrics: bool = False,
              checkpoint_dir: str | None = None,
              resume: bool = False) -> TrainingMetrics:
        cfg = self.config
        mgr = None
        start_epoch = 1
        if checkpoint_dir:
            from ..checkpoint import CheckpointManager
            mgr = CheckpointManager(checkpoint_dir)
            if resume and mgr.latest_step() is not None:
                # Copied into the state's tensors and the generator in
                # place: a captured epoch loop replays over them.
                self.state = mgr.restore(self.state)
                self._gen.set_state(mgr.restore_extra()["generator"])
                step = self.state.step
                steps_per_epoch = max(
                    1, len(self.dataset.x_train) // cfg.batch_size)
                start_epoch = step // steps_per_epoch + 1
                print(f"resumed from step {step} (epoch {start_epoch})")
        for epoch in range(start_epoch, cfg.num_epochs + 1):
            t0 = time.perf_counter()
            if self._device_loop is not None:
                self.state, em = self._device_loop.run_epoch(self.state)
                self.train_seconds.append(em["train_seconds"])
                loss = em["train_loss"]
                train_acc = 100.0 * em["train_accuracy"]
                test_acc = 100.0 * em["test_accuracy"]
            else:
                loss, train_acc = self.train_epoch(epoch)
                test_acc = self.test_epoch()
            dt = time.perf_counter() - t0
            self.metrics.add_epoch(epoch, loss, train_acc, test_acc, dt)
            print(f"epoch {epoch}/{cfg.num_epochs}: loss {loss:.4f} "
                  f"train {train_acc:.2f}% test {test_acc:.2f}% "
                  f"({dt:.1f}s)")
            if mgr is not None:
                mgr.save(self.state,
                         extra={"generator": self._gen.get_state()})
        if mgr is not None:
            mgr.close()
        if plot_path:
            self.metrics.plot_results(plot_path)
        if emit_metrics:
            emit_metrics_json({
                "role": "baseline",
                "num_epochs": cfg.num_epochs,
                "batch_size": cfg.batch_size,
                "learning_rate": cfg.learning_rate,
                "total_training_time_seconds": round(
                    sum(self.metrics.epoch_times), 2),
                "epoch_times_seconds": [round(t, 2)
                                        for t in self.metrics.epoch_times],
                "final_test_accuracy": self.metrics.test_accuracies[-1],
                "all_test_accuracies": self.metrics.test_accuracies,
                "final_train_loss": self.metrics.train_losses[-1],
            })
        return self.metrics
