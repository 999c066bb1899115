"""Train state of the port (counterpart of the JAX package's
``train/train_state.py``).

The JAX state is a flax ``TrainState``: nested params and batch_stats, a
step count and the optax transform. The port's is a plain dataclass of
flat ``{flax_name: tensor}`` dicts in flax layouts and flax creation
order (the store's and the wire's format, ``utils/pytree.py``), on the
trainer's device, plus the step count and the optimizer.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from ..utils.pytree import (flax_names, params_from_jax, params_to_jax,
                            to_flax_layout)
from .optimizers import ServerSGD


@dataclass
class TrainState:
    params: dict[str, torch.Tensor]
    batch_stats: dict[str, torch.Tensor]
    tx: ServerSGD
    step: int = 0

    def apply_gradients(self, grads: Mapping[str, torch.Tensor]
                        ) -> "TrainState":
        """One optimizer update; returns a new state (step + 1)."""
        return dataclasses.replace(self, step=self.step + 1,
                                   params=self.tx.apply(self.params, grads))

    def apply_gradients_(self, grads: Mapping[str, torch.Tensor]
                         ) -> "TrainState":
        """One optimizer update in place (step + 1); returns this state."""
        self.tx.apply_(self.params, grads)
        self.step += 1
        return self

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def create_train_state(model: torch.nn.Module, tx: ServerSGD) -> TrainState:
    """State from a module's current weights, on the module's device."""
    device = next(model.parameters()).device
    params, stats = params_to_jax(model)

    def dev(d):
        return {k: torch.from_numpy(v).to(device) for k, v in d.items()}
    return TrainState(params=dev(params), batch_stats=dev(stats), tx=tx)


def module_train_state(model: torch.nn.Module, tx: ServerSGD) -> TrainState:
    """State whose params ARE the module's parameters, as flax-named views
    in flax layouts: an in-place update (:meth:`TrainState.
    apply_gradients_`) moves the module's weights, and nothing is
    copied. For models without batch statistics (the ViTs)."""
    pnames, snames = flax_names(model)
    if snames:
        raise ValueError("module_train_state is for models without "
                         "batch statistics")
    own = dict(model.named_parameters())
    return TrainState(params={f: to_flax_layout(own[t].detach())
                              for t, f in pnames.items()},
                      batch_stats={}, tx=tx)


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
