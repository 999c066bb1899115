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

A one-axis mesh names ``data`` (the worker slots of sync data
parallelism) by default, ``seq`` (the sequence slots of ring attention,
``parallel/ring_attention.py``), ``expert`` (one Switch-MoE expert a
slot, ``parallel/moe.py``) or ``stage`` (one pipeline stage a slot,
``parallel/pipeline.py``), as the reference's ``make_mesh(n,
axis_names=("seq",))``. A mesh of two or three axes is an ordered set of
``(axis, size)`` pairs, every slot on the one card: ``data`` x ``model``
(tensor parallelism, ``parallel/tensor.py``), ``data`` x ``expert``
(dp x ep) and ``data`` x ``model`` x ``stage`` (dp x tp x pp).
``mesh.shape`` is the dict in axis order, as the reference's. A mesh of
two or more axes over ranks comes with ROADMAP §1 item 10, sixth part.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import torch

from ..utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
STAGE_AXIS = "stage"

#: Where a mesh of two or more axes over ranks comes from.
AXES_OVER_RANKS = ("ROADMAP §1 item 10, sixth part (TP over ranks: "
                   "meshes of two or more axes over ranks)")


@dataclass(frozen=True)
class Mesh:
    """Slots on one card (or, one axis only, spread over the ranks of
    ``group``). ``num_workers`` and ``axis_name`` are the leading axis;
    ``axes`` every axis in order as ``(name, size)`` pairs (filled in
    from the leading axis for a one-axis mesh)."""

    num_workers: int
    device: torch.device
    axis_name: str = DATA_AXIS
    #: The ranks of a multi-process mesh (``multihost.RankGroup``), or
    #: None for the slots of one process.
    group: Any = field(default=None, compare=False)
    axes: tuple = ()

    def __post_init__(self):
        if not self.axes:
            object.__setattr__(self, "axes",
                               ((self.axis_name, self.num_workers),))
        if len(self.axes) > 1 and self.group is not None:
            raise NotImplementedError(
                f"a mesh of axes {self.axis_names} over ranks comes with "
                f"{AXES_OVER_RANKS}")

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axes)

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


def _one_card(device) -> torch.device:
    if not isinstance(device, (str, torch.device)):
        cards = list(dict.fromkeys(str(torch.device(d)) for d in device))
        if len(cards) != 1:
            raise NotImplementedError(
                f"one process drives one card, not {cards}: run one "
                "process per card (train --multihost; "
                "parallel.multihost.make_global_mesh)")
        device = cards[0]
    return resolve_device(device)


def make_mesh(num_workers: int,
              device: str | torch.device | Sequence = "cuda",
              axis_names: Sequence[str] = (DATA_AXIS,),
              num_slots: int | None = None) -> Mesh:
    """A mesh on ``device`` whose leading axis is the ``num_workers``
    worker slots, as the reference's ``make_mesh``. With one axis name the
    shape is ``(num_workers,)``; with two (``("data", "model")``) the
    trailing axis takes the remaining slots, ``(num_workers, num_slots //
    num_workers)``: the reference divides its device count, the port the
    ``num_slots`` it is given (required with two axes). A sequence of
    devices names the cards of the mesh: more than one distinct card
    raises ``NotImplementedError``. Three axes: :func:`mesh_from_shape`."""
    device = _one_card(device)
    if num_workers < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    if len(axis_names) == 1:
        return Mesh(num_workers, device, axis_names[0])
    if len(axis_names) != 2:
        raise ValueError(f"make_mesh builds one or two axes, not "
                         f"{tuple(axis_names)}; use mesh_from_shape")
    if num_slots is None:
        raise ValueError("a two-axis mesh on one card needs num_slots, the "
                         "slot count its trailing axis divides")
    if num_slots % num_workers:
        raise ValueError(f"{num_slots} slots not divisible by {num_workers}")
    return mesh_from_shape({axis_names[0]: num_workers,
                            axis_names[1]: num_slots // num_workers}, device)


def mesh_from_shape(shape: Mapping[str, int],
                    device: str | torch.device | Sequence = "cuda") -> Mesh:
    """A mesh of the named axes in ``shape``'s order, every slot on
    ``device``: the reference's ``Mesh(devices.reshape(...), names)``, as
    its ``PipelineTrainer`` builds ``(data, model, stage)``."""
    axes = tuple((str(name), int(n)) for name, n in shape.items())
    if not axes or any(n < 1 for _, n in axes):
        raise ValueError(f"every axis needs >= 1 slot, got {dict(axes)}")
    return Mesh(axes[0][1], _one_card(device), axes[0][0], axes=axes)


def worker_axis_size(mesh: Mesh, axis: str = DATA_AXIS) -> int:
    return mesh.shape[axis]
