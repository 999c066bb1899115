"""Flat ``{name: array}`` dicts and the flax <-> torch parameter mapping.

The reference's canonical parameter format is a flat ``{param_name:
np.ndarray}`` dict (server.py:96, worker.py:274-279); in the JAX package
the names are '/'-joined flax paths (``stem_conv/kernel``,
``BasicBlock_0/Conv_0/kernel``, ``head/bias``) in flax layouts. The port's
store, codec and wire keep exactly those names and layouts, so payloads
are byte-identical to the reference's and a store of either package
serves a worker of either package. The torch modules keep torch's own
layouts; this module converts at the boundary:

- conv ``kernel`` HWIO  <->  ``weight`` OIHW,
- Dense ``kernel`` [in, out]  <->  ``weight`` [out, in],
- BatchNorm and LayerNorm ``scale``/``bias`` (params) and
  ``mean``/``var`` (batch_stats)  <->  ``weight``/``bias``/
  ``running_mean``/``running_var``;
- ViT's ``cls_token`` and ``pos_embed`` (3-D) keep name and layout.

- the Switch-MoE leaves (``router`` [D, E], ``w1`` [E, D, H], ``b1``
  [E, H], ``w2`` [E, H, D], ``b2`` [E, D]) keep name and layout: the
  port holds them in flax's layout;
- a pipeline's stacked stage leaves ``[S, ...]`` convert stage by stage
  under their leading S: a stacked Dense kernel ``[S, in, out]`` <->
  ``[S, out, in]``, a stacked LayerNorm scale ``[S, D]`` as it is.

Over ranks (``MoETrainer(group=)``, ``PipelineTrainer(group=)``) a rank
holds its rows of the leaves stacked over experts (``.../moe/w1``,
``b1``, ``w2``, ``b2``) and over stages (``stages/...``), the rest
whole: :func:`rank_rows` cuts a one-process tree into a rank's, and
:func:`join_rank_rows` puts the ranks' trees back together, the
one-process layout that checkpoints keep.

The port's modules are named after the flax ones (``stem_conv``,
``stem_conv_s2d``, ``BasicBlock_0.Conv_0``, ``Bottleneck_0.Conv_3``,
``block_0.attn.qkv``, ``prologue.patch_embed``, ``stages.block_0.moe``,
...), so a name maps by swapping '/' for '.' and renaming the leaf. The
leaf names the layout, before the rank: a torch ``weight`` is a
``kernel`` when a Dense or conv module owns it, else a ``scale``; only a
``kernel`` changes layout (4-D: a conv kernel, the 3x3, 1x1, the 7x7
ImageNet stem and its 4x4 space-to-depth form alike; 2-D, or 3-D
stacked: a Dense kernel). Called without a name, the layout functions
fall back to the rank alone (4-D conv, 2-D Dense, the rest as it is),
which is right for every model without MoE or stacked leaves.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

PyTree = Any

# flax leaf -> torch leaf, per flax collection.
_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "cls_token": "cls_token", "pos_embed": "pos_embed",
               "router": "router", "w1": "w1", "b1": "b1", "w2": "w2",
               "b2": "b2"}
_STATS_LEAF = {"mean": "running_mean", "var": "running_var"}


def flatten_params(tree: PyTree, *, as_numpy: bool = True
                   ) -> dict[str, Any]:
    """Nested dict -> flat {'a/b/c': leaf} dict, in the nested order.

    ``as_numpy=False`` keeps the leaves as they are (device tensors stay
    on the device)."""
    flat: dict[str, Any] = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, name)
            else:
                flat[name] = np.asarray(v) if as_numpy else v

    walk(tree, "")
    return flat


def unflatten_params(flat: Mapping[str, Any]) -> dict:
    """Inverse of :func:`flatten_params`."""
    out: dict = {}
    for name, v in flat.items():
        node = out
        *path, leaf = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def tree_bytes(flat: Mapping[str, np.ndarray]) -> int:
    """Total payload size in bytes (the reference logs compressed sizes at
    worker.py:292)."""
    return sum(np.asarray(v).nbytes for v in flat.values())


# -- flax <-> torch layouts ----------------------------------------------------

def _leaf(name: str) -> str:
    return name.replace(".", "/").rsplit("/", 1)[-1]


def to_flax_layout(t: torch.Tensor, name: str | None = None
                   ) -> torch.Tensor:
    """Torch layout -> flax layout (a view; ``.contiguous()`` to pack).
    ``name``, the flax name (or its leaf), decides the layout; without it
    the rank does (module notes)."""
    if name is not None and _leaf(name) != "kernel":
        return t
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0)      # OIHW -> HWIO
    if t.dim() == 2 or (name is not None and t.dim() == 3):
        return t.transpose(-1, -2)        # [(S,) out, in] -> [(S,) in, out]
    return t


def to_torch_layout(t: torch.Tensor, name: str | None = None
                    ) -> torch.Tensor:
    """Flax layout -> torch layout (a view); ``name`` as in
    :func:`to_flax_layout`."""
    if name is not None and _leaf(name) != "kernel":
        return t
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1)      # HWIO -> OIHW
    if t.dim() == 2 or (name is not None and t.dim() == 3):
        return t.transpose(-1, -2)
    return t


def torch_name(flax_name: str, collection: str = "params") -> str:
    """``BasicBlock_0/BatchNorm_0/scale`` -> ``BasicBlock_0.BatchNorm_0.weight``
    (``collection='batch_stats'`` maps ``mean``/``var`` to the running
    buffers)."""
    *path, leaf = flax_name.split("/")
    table = _PARAM_LEAF if collection == "params" else _STATS_LEAF
    if leaf not in table:
        raise KeyError(f"no torch counterpart for {collection} leaf "
                       f"{flax_name!r}")
    return ".".join(path + [table[leaf]])


def flax_names(module: torch.nn.Module) -> tuple[dict, dict]:
    """``({torch_name: flax_name} for params, ... for batch_stats)`` in the
    module's registration order — flax's creation order, since the port's
    modules are built in the same order as the flax ones."""
    params, stats = {}, {}
    for tname, p in module.named_parameters():
        *path, leaf = tname.split(".")
        if leaf == "weight":
            owner = module.get_submodule(".".join(path))
            leaf = "kernel" if isinstance(
                owner, (torch.nn.Linear, torch.nn.modules.conv._ConvNd)) \
                else "scale"
        params[tname] = "/".join(path + [leaf])
    inverse = {v: k for k, v in _STATS_LEAF.items()}
    for tname, _ in module.named_buffers():
        *path, leaf = tname.split(".")
        stats[tname] = "/".join(path + [inverse[leaf]])
    return params, stats


def params_to_jax(module: torch.nn.Module
                  ) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Module -> (flat flax params, flat flax batch_stats), fp32 numpy in
    flax layouts and flax order."""
    pnames, snames = flax_names(module)
    state = module.state_dict()

    def host(t, f):
        return np.ascontiguousarray(
            to_flax_layout(t.detach(), f).to("cpu", torch.float32).numpy())

    return ({f: host(state[t], f) for t, f in pnames.items()},
            {f: host(state[t], f) for t, f in snames.items()})


def params_from_jax(params: Mapping[str, np.ndarray],
                    batch_stats: Mapping[str, np.ndarray] | None = None
                    ) -> dict[str, torch.Tensor]:
    """Flat flax params (+ batch_stats) -> a torch ``state_dict`` for the
    port's module of the same architecture (``module.load_state_dict``)."""
    out: dict[str, torch.Tensor] = {}
    for collection, flat in (("params", params),
                             ("batch_stats", batch_stats or {})):
        for name, v in flat.items():
            t = torch.as_tensor(np.asarray(v, np.float32))
            out[torch_name(name, collection)] = \
                to_torch_layout(t, name).contiguous()
    return out


# -- the rows of a rank --------------------------------------------------------

def rank_stacked(name: str) -> bool:
    """Whether a leaf (flax or torch name) is stacked over the experts
    (``.../moe/{w1,b1,w2,b2}``; the router is not) or the pipeline stages
    (``stages/...``), whose rows split over the ranks."""
    path = name.replace(".", "/").split("/")
    return path[0] == "stages" or (len(path) > 1 and path[-2] == "moe"
                                   and path[-1] in ("w1", "b1", "w2", "b2"))


def leaf_rank_rows(name: str, leaf, rank: int, size: int):
    """Rank ``rank``'s rows of one leaf of ``size`` ranks: its contiguous
    ``1/size`` of a stacked leaf's leading axis, any other leaf whole."""
    if not rank_stacked(name):
        return leaf
    n = leaf.shape[0]
    if n % size:
        raise ValueError(f"{name}: {n} rows do not divide evenly over "
                         f"{size} ranks")
    return leaf[rank * (n // size):(rank + 1) * (n // size)]


def rank_rows(flat: Mapping[str, Any], rank: int, size: int) -> dict:
    """A one-process flat tree (NumPy or torch leaves) cut to rank
    ``rank``'s rows of its stacked leaves (:func:`leaf_rank_rows`)."""
    return {k: leaf_rank_rows(k, v, rank, size) for k, v in flat.items()}


def join_rank_rows(per_rank: list) -> dict:
    """Inverse of :func:`rank_rows`: the ranks' trees, in rank order, back
    to one, stacked leaves concatenated and the rest rank 0's."""
    def join(leaves):
        if isinstance(leaves[0], torch.Tensor):
            return torch.cat(leaves)
        return np.concatenate(leaves)

    return {k: join([t[k] for t in per_rank]) if rank_stacked(k) else v
            for k, v in per_rank[0].items()}
