"""Optimizers of the port (counterpart of the JAX package's
``train/optimizers.py``).

The reference has two optimizer configurations: the parameter server
applies plain ``p -= lr * g`` (server.py:133, lr 0.1), :func:`server_sgd`,
the distributed-mode optimizer; the single-machine baseline uses SGD with
momentum 0.9 and weight decay 5e-4 under MultiStepLR([10, 15], gamma 0.1)
(baseline_training.py:223-224), :func:`baseline_optimizer`.

Both update in place and round as optax does: one rounding per optax op
and never a fused multiply-add, so the updates are bit-equal to the JAX
package's run op by op.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import torch


@dataclass(frozen=True)
class ServerSGD:
    """Plain SGD over flat ``{name: tensor}`` dicts."""

    learning_rate: float = 0.1

    def init(self, params: Mapping[str, torch.Tensor]) -> None:
        """Plain SGD keeps no state."""
        return None

    def apply(self, params: Mapping[str, torch.Tensor],
              grads: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """New params ``p - g * lr`` (optax: ``p + g * -lr``, the same
        floats). A multiply then a subtract, never one fused
        multiply-add, so each param rounds as the reference's does."""
        lr = self.learning_rate
        return {k: p - grads[k] * lr for k, p in params.items()}

    @torch.no_grad()
    def apply_(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor], state: None = None
               ) -> None:
        """The same update in place, ``p -= g * lr`` (the same two
        roundings): no param-sized allocation beyond ``g * lr``."""
        lr = self.learning_rate
        for k, p in params.items():
            p.sub_(grads[k] * lr)


def server_sgd(learning_rate: float = 0.1) -> ServerSGD:
    """Plain SGD: exactly the server update ``p -= lr * g`` (server.py:133)."""
    return ServerSGD(learning_rate)


@dataclass
class SGDState:
    """:class:`BaselineSGD`'s state: the momentum buffers (optax's trace,
    keyed and laid out like the params) and the number of updates applied,
    a 0-dim int64 tensor on the params' device that the schedule reads."""

    trace: dict[str, torch.Tensor]
    count: torch.Tensor


@dataclass(frozen=True)
class BaselineSGD:
    """SGD with momentum and weight decay under a piecewise-constant
    schedule, the update of optax's ``chain(add_decayed_weights(wd),
    sgd(piecewise_constant_schedule(lr, boundaries), momentum))``.

    ``boundaries`` are ``(step, scale)`` pairs sorted by step. The
    learning rate is a device tensor computed from the state's count, so a
    CUDA graph that replays the update reads the current value."""

    learning_rate: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    boundaries: tuple = ()

    def init(self, params: Mapping[str, torch.Tensor]) -> SGDState:
        """Zero momentum (optax's trace init) and a zero count, on the
        params' device; each buffer has its param's strides."""
        device = next(iter(params.values())).device
        return SGDState(
            trace={k: torch.zeros_like(p) for k, p in params.items()},
            count=torch.zeros((), dtype=torch.int64, device=device))

    def lr(self, count: torch.Tensor) -> torch.Tensor:
        """The fp32 learning rate for the update after ``count`` updates,
        on ``count``'s device, computed as optax's schedule computes it:
        the initial value times float32(scale) at each boundary with
        ``count >= step``, one rounding a boundary (so 0.1 becomes
        0.010000001 after a 0.1 boundary, not 0.01)."""
        v = torch.full((), self.learning_rate, dtype=torch.float32,
                       device=count.device)
        for step, scale in self.boundaries:
            v = torch.where(count >= step, v * scale, v)
        return v

    @torch.no_grad()
    def apply_(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor], state: SGDState
               ) -> torch.Tensor:
        """One update of ``params`` and ``state`` in place; returns the
        learning rate applied (0-dim fp32 tensor). optax's ops, each
        rounded once: ``g' = g + wd * p``, ``trace = g' + momentum *
        trace``, ``p = p - lr * trace``. Weight decay covers every
        param, as optax's does with no mask."""
        names = list(params)
        p = [params[k] for k in names]
        t = [state.trace[k] for k in names]
        lr = self.lr(state.count)
        g = torch._foreach_mul(p, self.weight_decay)
        torch._foreach_add_(g, [grads[k] for k in names])
        torch._foreach_mul_(t, self.momentum)
        torch._foreach_add_(t, g)
        torch._foreach_sub_(p, torch._foreach_mul(t, lr))
        state.count.add_(1)
        return lr


def baseline_optimizer(learning_rate: float = 0.1, momentum: float = 0.9,
                       weight_decay: float = 5e-4,
                       milestones: Sequence[int] = (10, 15),
                       gamma: float = 0.1, steps_per_epoch: int = 1
                       ) -> BaselineSGD:
    """SGD(momentum, wd) + MultiStepLR, matching baseline_training.py:
    223-224. ``milestones`` are epochs; the schedule runs on steps (one
    boundary per distinct step, as optax's dict of boundaries has)."""
    boundaries = {int(m) * int(steps_per_epoch): gamma for m in milestones}
    return BaselineSGD(learning_rate, momentum, weight_decay,
                       tuple(sorted(boundaries.items())))
