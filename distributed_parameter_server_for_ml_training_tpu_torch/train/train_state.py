"""Train state of the port (counterpart of the JAX package's
``train/train_state.py``).

The JAX state is a flax ``TrainState``: nested params and batch_stats, a
step count, the optax transform and its state. The port's is a plain
dataclass of flat ``{flax_name: tensor}`` dicts in flax layouts and flax
creation order (the store's and the wire's format, ``utils/pytree.py``),
on the trainer's device, plus the step count, the optimizer and its
state (:class:`~.optimizers.SGDState`: momentum and the update count that
drives the schedule; ``None`` for plain SGD).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch

from ..utils.pytree import (flax_names, params_from_jax, params_to_jax,
                            to_flax_layout)
from .optimizers import ServerSGD


@dataclass
class TrainState:
    params: dict[str, torch.Tensor]
    batch_stats: dict[str, torch.Tensor]
    tx: Any
    step: int = 0
    opt_state: Any = None

    def apply_gradients(self, grads: Mapping[str, torch.Tensor]
                        ) -> "TrainState":
        """One optimizer update; returns a new state (step + 1)."""
        return dataclasses.replace(self, step=self.step + 1,
                                   params=self.tx.apply(self.params, grads))

    def apply_gradients_(self, grads: Mapping[str, torch.Tensor]
                         ) -> torch.Tensor | None:
        """One optimizer update of params and optimizer state in place
        (step + 1). Returns the learning rate applied as a 0-dim tensor
        where the optimizer schedules it, else None."""
        lr = self.tx.apply_(self.params, grads, self.opt_state)
        self.step += 1
        return lr

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor the state updates in place: params, batch
        statistics, momentum and the update count."""
        out = [*self.params.values(), *self.batch_stats.values()]
        if self.opt_state is not None:
            out += [*self.opt_state.trace.values(), self.opt_state.count]
        return out

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def create_train_state(model: torch.nn.Module, tx: ServerSGD) -> TrainState:
    """State from a module's current weights, on the module's device."""
    device = next(model.parameters()).device
    params, stats = params_to_jax(model)

    def dev(d):
        return {k: torch.from_numpy(v).to(device) for k, v in d.items()}
    params = dev(params)
    return TrainState(params=params, batch_stats=dev(stats), tx=tx,
                      opt_state=tx.init(params))


def module_train_state(model: torch.nn.Module, tx) -> TrainState:
    """State whose tensors ARE the module's: its params as flax-named views
    in flax layouts, and its BatchNorm running statistics (which the
    module's training forward updates in place). An in-place update
    (:meth:`TrainState.apply_gradients_`) moves the module's weights,
    the optimizer state is allocated once here, and nothing is copied
    or reallocated per step, as a CUDA graph of the step needs."""
    pnames, snames = flax_names(model)
    own = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    params = {f: to_flax_layout(own[t].detach(), f)
              for t, f in pnames.items()}
    return TrainState(params=params,
                      batch_stats={f: buffers[t] for t, f in snames.items()},
                      tx=tx, opt_state=tx.init(params))


def train_state_from_jax(model: torch.nn.Module,
                         params: Mapping[str, np.ndarray],
                         batch_stats: Mapping[str, np.ndarray],
                         tx: ServerSGD) -> TrainState:
    """State from a JAX ``TrainState``'s flat params and batch_stats (numpy,
    flax names and layouts): loaded into ``model`` through
    ``params_from_jax`` (which refuses a name it cannot map), then read
    back in the model's order. ``model`` keeps the weights."""
    model.load_state_dict(params_from_jax(params, batch_stats))
    return create_train_state(model, tx)
