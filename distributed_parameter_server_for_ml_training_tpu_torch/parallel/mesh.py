"""The worker mesh of the port (counterpart of the JAX package's
``parallel/mesh.py``).

In the reference a worker is a slot along the ``data`` axis of a
``jax.sharding.Mesh``, one device per slot, and ``make_mesh(n)`` needs n
devices. In the port a :class:`Mesh` is N worker slots on ONE device: the
sync step runs every slot in one program on that card
(``parallel/sync_dp.py``), so 4 slots run on one H100. Worker ids are the
slot indices, contiguous and never duplicated, as in the reference.

A mesh over several cards runs one process per card
(``parallel/multihost.py``, ``train --multihost``): the mesh then names
the group of ranks, ``num_workers`` counts the slots of every rank
(``R*S``, rank-major), and this process's card holds ``local_slots`` of
them from ``slot_offset`` on. One process never drives two cards.

A mesh has one named axis: ``data`` (the worker slots of sync data
parallelism) by default, or ``seq`` (the sequence slots of ring
attention, ``parallel/ring_attention.py``), as the reference's
``make_mesh(n, axis_names=("seq",))``. Meshes of two or more axes (data x
model, data x expert) come with the TP and MoE slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

from ..utils.device import resolve_device

DATA_AXIS = "data"
SEQ_AXIS = "seq"


@dataclass(frozen=True)
class Mesh:
    num_workers: int
    device: torch.device
    axis_name: str = DATA_AXIS
    #: The ranks of a multi-process mesh (``multihost.RankGroup``), or
    #: None for the slots of one process.
    group: Any = field(default=None, compare=False)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_name: self.num_workers}

    @property
    def rank(self) -> int:
        return self.group.rank if self.group is not None else 0

    @property
    def num_ranks(self) -> int:
        return self.group.size if self.group is not None else 1

    @property
    def local_slots(self) -> int:
        """The slots on this process's card."""
        return self.num_workers // self.num_ranks

    @property
    def slot_offset(self) -> int:
        """The global index of this card's first slot."""
        return self.rank * self.local_slots


def make_mesh(num_workers: int,
              device: str | torch.device | Sequence = "cuda",
              axis_names: Sequence[str] = (DATA_AXIS,)) -> Mesh:
    """N slots on ``device`` along the one axis in ``axis_names``. A
    sequence of devices names the cards of the mesh: more than one
    distinct card raises ``NotImplementedError``, as do two or more
    axes."""
    if len(axis_names) != 1:
        raise NotImplementedError(
            f"a mesh of axes {tuple(axis_names)} comes with the tensor- and "
            "expert-parallel slices; the port's meshes have one axis")
    if not isinstance(device, (str, torch.device)):
        cards = list(dict.fromkeys(str(torch.device(d)) for d in device))
        if len(cards) != 1:
            raise NotImplementedError(
                f"one process drives one card, not {cards}: run one "
                "process per card (train --multihost; "
                "parallel.multihost.make_global_mesh)")
        device = cards[0]
    if num_workers < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    return Mesh(num_workers, resolve_device(device), axis_names[0])


def worker_axis_size(mesh: Mesh, axis: str = DATA_AXIS) -> int:
    return mesh.shape[axis]
