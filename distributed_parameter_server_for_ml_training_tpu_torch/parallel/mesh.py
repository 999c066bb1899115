"""The worker mesh of the port (counterpart of the JAX package's
``parallel/mesh.py``).

In the reference a worker is a slot along the ``data`` axis of a
``jax.sharding.Mesh``, one device per slot, and ``make_mesh(n)`` needs n
devices. In the port a :class:`Mesh` is N worker slots on ONE device: the
sync step runs every slot in one program on that card
(``parallel/sync_dp.py``), so 4 slots run on one H100. Worker ids are the
slot indices, contiguous and never duplicated, as in the reference.
A mesh over several cards (one process per card, NCCL) comes with the
multi-card slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..utils.device import resolve_device

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    num_workers: int
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.num_workers}


def make_mesh(num_workers: int,
              device: str | torch.device | Sequence = "cuda") -> Mesh:
    """N worker slots on ``device``. A sequence of devices names the cards
    of the mesh: more than one distinct card raises
    ``NotImplementedError``."""
    if not isinstance(device, (str, torch.device)):
        cards = list(dict.fromkeys(str(torch.device(d)) for d in device))
        if len(cards) != 1:
            raise NotImplementedError(
                f"a mesh over several cards ({cards}) comes with the "
                "multi-card slice (one process per card, NCCL)")
        device = cards[0]
    if num_workers < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    return Mesh(num_workers, resolve_device(device))


def worker_axis_size(mesh: Mesh, axis: str = DATA_AXIS) -> int:
    return mesh.shape[axis]
