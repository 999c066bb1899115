"""The aggregation math, as pure unit-testable functions.

Every function here reproduces a specific piece of the reference server's
numerics bit-for-bit (SURVEY.md §4 names these the natural test seams):

- :func:`staleness_weight`  == server.py:171-186 ``apply_gradients_async``
- :func:`mean_gradients`    == server.py:145-169 ``aggregate_gradients_sync``
- :func:`sgd_apply`         == server.py:126-143 ``apply_gradients``
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

#: server.py:418 ``--staleness-bound`` default.
DEFAULT_STALENESS_BOUND = 5

#: server.py:178 decay constant and floor.
STALENESS_DECAY = 0.1
STALENESS_FLOOR = 0.1


def staleness_weight(staleness: int, decay: float = STALENESS_DECAY,
                     floor: float = STALENESS_FLOOR) -> float:
    """Down-weighting for stale gradients: ``max(0.1, 1/(1+0.1*s))``
    (server.py:178)."""
    return max(floor, 1.0 / (1.0 + decay * float(staleness)))


def mean_gradients(
    grads_per_worker: Iterable[Mapping[str, np.ndarray]],
) -> dict[str, np.ndarray]:
    """Element-wise mean over workers, per parameter (server.py:145-169).

    Parameter names come from the FIRST worker's push, and each parameter is
    averaged over only the workers that supplied it (``valid_workers`` in
    ``aggregate_gradients_sync``) — a partial push therefore skews the mean
    for the parameters it carries rather than aborting the round. Names that
    appear only in later workers' pushes are dropped, exactly as the
    reference's ``param_names = list(worker_gradients[0].keys())`` does.
    Float32 accumulation. Returns ``{}`` for an empty round (server.py:147).
    """
    grads_list = list(grads_per_worker)
    if not grads_list:
        return {}
    out: dict[str, np.ndarray] = {}
    for name in grads_list[0]:
        total = None
        valid = 0
        for g in grads_list:
            if name in g:
                arr = np.asarray(g[name], np.float32)
                # no copy needed: accumulation and the final divide both
                # allocate fresh arrays, so `total` never aliases the output
                total = arr if total is None else total + arr
                valid += 1
        if valid > 0:
            out[name] = total / np.float32(valid)
    return out


def sgd_apply(params: dict[str, np.ndarray],
              grads: Mapping[str, np.ndarray],
              lr: float, weight: float = 1.0) -> None:
    """In-place plain SGD ``p -= lr * weight * g`` (server.py:133; the
    async path additionally scales by the staleness weight, server.py:183).

    Unknown gradient names are ignored, matching the reference's
    ``if name in self.parameters`` guard (server.py:131).
    """
    scale = np.float32(lr * weight)
    for name, g in grads.items():
        if name in params:
            params[name] -= scale * np.asarray(g, np.float32)
