"""Optimizers of the port (counterpart of the JAX package's
``train/optimizers.py``).

The reference's parameter server applies plain ``p -= lr * g``
(server.py:133, lr 0.1); :func:`server_sgd` is that update, the
distributed-mode optimizer. ``baseline_optimizer`` (SGD with momentum and
weight decay under MultiStepLR) comes with the single-device baseline
slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch


@dataclass(frozen=True)
class ServerSGD:
    """Plain SGD over flat ``{name: tensor}`` dicts."""

    learning_rate: float = 0.1

    def apply(self, params: Mapping[str, torch.Tensor],
              grads: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """New params ``p - g * lr`` (optax: ``p + g * -lr``, the same
        floats). A multiply then a subtract, never one fused
        multiply-add, so each param rounds as the reference's does."""
        lr = self.learning_rate
        return {k: p - grads[k] * lr for k, p in params.items()}

    @torch.no_grad()
    def apply_(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor]) -> None:
        """The same update in place, ``p -= g * lr`` (the same two
        roundings): no param-sized allocation beyond ``g * lr``."""
        lr = self.learning_rate
        for k, p in params.items():
            p.sub_(grads[k] * lr)


def server_sgd(learning_rate: float = 0.1) -> ServerSGD:
    """Plain SGD: exactly the server update ``p -= lr * g`` (server.py:133)."""
    return ServerSGD(learning_rate)
