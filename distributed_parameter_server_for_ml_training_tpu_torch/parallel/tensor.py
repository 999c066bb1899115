"""Tensor parallelism of the ViT: Megatron's split over the ``model``
slots of a mesh on one card (counterpart of the JAX package's
``parallel/tensor.py``).

The reference annotates placements: a rule table maps each flax
parameter path to a ``PartitionSpec`` (``_TP_RULES``, first match wins),
``shard_train_state`` puts every leaf on the mesh under its spec, and
XLA inserts the collectives. The split is Megatron's:

- column-parallel: the attention ``qkv`` kernel and the MLP ``fc1``
  kernel split on their OUTPUT dim over ``model``, their biases with
  them;
- row-parallel: the attention ``out`` kernel and the MLP ``fc2`` kernel
  split on their INPUT dim; their biases stay whole;
- everything else (embeddings, LayerNorms, the head) replicated.

The port keeps the rule table (specs are tuples in flax's ``[in, out]``
layout: ``(None, "model")`` a column split, ``("model", None)`` a row
split, ``("model",)`` a split bias, ``()`` replicated) and replaces the
placement by per-slot VIEWS of whole parameters. Slot j of a column
split is rows ``[j O/tp, (j+1) O/tp)`` of the torch weight ``[O, I]``
(``weight.view(tp, O/tp, I)``); slot j of a row split is its columns
``[j I/tp, (j+1) I/tp)`` (``weight.view(O, tp, I/tp).transpose(0,
1)``). The parameter tree, its names and order, the optimizer state and
the checkpoints therefore stay the plain ViT's, as the reference's tree
does; there is nothing to re-place after a restore.

The products are plain functions on tensors, run by ``models/vit.py``'s
TP forms (a ViT or ``EncoderStage`` built with ``tp_degree`` > 1):

    x [N, I] --column_parallel--> [tp, N, O/tp]   (one batched product)
    [tp, N, I/tp] --row_parallel--> [tp, N, O] partials --sum--> [N, O]

The concatenation of the slots' ``qkv`` columns before the attention
core (:func:`gather_columns`) and the sums over the slots after ``out``
and ``fc2`` (in :func:`row_parallel`) are the only places the slots
meet: a mesh spread over ranks puts ``all_gather`` and ``all_reduce``
there (ROADMAP §1 item 10, sixth part). The fused ``qkv`` columns are
ordered ``(3, H, D/H)``, so a contiguous column block never holds the
q, k and v of whole heads: the core runs over every head after the
gather, and ``out``'s input columns may split inside a head.

Precision. Each slot's product runs in the model's dtype (bf16 on the
tensor cores); the row-parallel partials come out in at least fp32, are
summed over the slots in fp32 and cast once, with the whole bias added
once after the sum. The reference's compiled step does the same: its
partial-sum all-reduces are f32 in the bf16 model as in fp32. The
products, the concatenation and the sums are ``bmm``/``baddbmm``,
copies and one ``sum``; the reference leaves them to XLA, outside any
Pallas kernel.
"""

from __future__ import annotations

import re
from typing import Mapping

import torch

from .mesh import MODEL_AXIS

Spec = tuple

# (path regex, spec) — first match wins. Specs are for 2-D kernels
# [in, out] / 1-D biases of the ViT naming scheme (models/vit.py).
_TP_RULES: list[tuple[str, Spec]] = [
    (r".*attn/qkv/kernel$", (None, MODEL_AXIS)),    # column
    (r".*attn/qkv/bias$", (MODEL_AXIS,)),
    (r".*attn/out/kernel$", (MODEL_AXIS, None)),    # row
    (r".*mlp/fc1/kernel$", (None, MODEL_AXIS)),     # column
    (r".*mlp/fc1/bias$", (MODEL_AXIS,)),
    (r".*mlp/fc2/kernel$", (MODEL_AXIS, None)),     # row
]


def tp_spec_for_path(path: str) -> Spec:
    """The spec of a flax parameter path; ``()`` is replicated."""
    for pattern, spec in _TP_RULES:
        if re.match(pattern, path):
            return spec
    return ()


def _split_dim(spec: Spec, ndim: int) -> int | None:
    """The dim of an ``ndim``-D flax-layout leaf that ``spec`` splits; the
    spec names the trailing dims, so stacked leaves ``[S, ...]`` split
    under their leading axes."""
    if MODEL_AXIS not in spec:
        return None
    return ndim - len(spec) + spec.index(MODEL_AXIS)


def check_tp_split(shapes: Mapping[str, tuple], tp: int) -> None:
    """Raise the reference's ``device_put`` error where ``tp`` does not
    divide a split dim. ``shapes`` maps flax paths to flax-layout shapes;
    the paths are checked in sorted order, the reference's tree order."""
    for path in sorted(shapes):
        shape = tuple(shapes[path])
        spec = tp_spec_for_path(path)
        dim = _split_dim(spec, len(shape))
        if dim is not None and shape[dim] % tp:
            raise ValueError(
                f"{path} is split {spec} over {tp} model slots, which "
                f"implies that the global size of its dimension {dim} "
                f"should be divisible by {tp}, but it is equal to "
                f"{shape[dim]} (full shape: {shape})")


def slot_views(flax_leaf: torch.Tensor, path: str, tp: int
               ) -> torch.Tensor:
    """``[tp, *shard]``: slot j's view of a flax-layout leaf, the shape of
    the reference's ``addressable_shards`` on a model slot; a replicated
    leaf is the whole of it in every slot (an expanded view)."""
    dim = _split_dim(tp_spec_for_path(path), flax_leaf.dim())
    if dim is None:
        return flax_leaf.expand(tp, *flax_leaf.shape)
    return flax_leaf.unflatten(dim, (tp, -1)).movedim(dim, 0)


def column_views(weight: torch.Tensor, tp: int) -> torch.Tensor:
    """Torch weight ``[O, I]`` -> slot j's output rows ``[tp, O/tp, I]``."""
    o, i = weight.shape
    return weight.view(tp, o // tp, i)


def row_views(weight: torch.Tensor, tp: int) -> torch.Tensor:
    """Torch weight ``[O, I]`` -> slot j's input columns ``[tp, O,
    I/tp]`` (a strided view)."""
    o, i = weight.shape
    return weight.view(o, tp, i // tp).transpose(0, 1)


def bias_views(bias: torch.Tensor, tp: int) -> torch.Tensor:
    """A column-split bias ``[O]`` -> ``[tp, O/tp]``."""
    return bias.view(tp, -1)


def column_parallel(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, tp: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """``x`` ``[N, I]``, shared by the slots -> ``[tp, N, O/tp]``: slot j's
    ``x @ W_j^T + b_j``, one batched product in ``dtype``."""
    x = x.to(dtype)
    return torch.baddbmm(bias_views(bias.to(dtype), tp).unsqueeze(1),
                         x.expand(tp, *x.shape),
                         column_views(weight.to(dtype), tp).transpose(1, 2))


class _WidePartials(torch.autograd.Function):
    """``bmm`` of low-precision ``a`` ``[tp, N, K]`` and ``b`` ``[tp, K,
    O]`` with its result in fp32. The forward accumulates and returns
    fp32: ``out_dtype`` on the card (a bf16 product on the tensor cores);
    elsewhere the inputs are widened first, which gives the same exact
    products. ``bmm``'s ``out_dtype`` form has no derivative, so the
    backward is written here: the gradient goes back to the inputs' dtype
    (exact on the TP path, where it is the widened gradient of the layer's
    bf16 output) and the two products run in that dtype, as the plain
    layer's backward does."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad = grad.to(a.dtype)
        ga = torch.bmm(grad, b.transpose(1, 2)) \
            if ctx.needs_input_grad[0] else None
        gb = torch.bmm(a.transpose(1, 2), grad) \
            if ctx.needs_input_grad[1] else None
        return ga, gb


def _partials(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``bmm`` with its result in at least fp32 (:class:`_WidePartials`
    for bf16 and fp16 inputs)."""
    if torch.promote_types(a.dtype, torch.float32) != a.dtype:
        return _WidePartials.apply(a, b)
    return torch.bmm(a, b)


def row_parallel(x_slots: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x_slots`` ``[tp, N, I/tp]`` (slot j's input columns) -> ``[N,
    O]``: the slots' partial products ``[tp, N, O]`` in at least fp32,
    one sum over the slots, the whole bias added once, one cast to
    ``dtype``."""
    tp = x_slots.shape[0]
    partial = _partials(x_slots.to(dtype),
                        row_views(weight.to(dtype), tp).transpose(1, 2))
    total = partial.sum(dim=0) + bias.to(dtype).to(partial.dtype)
    return total.to(dtype)


def gather_columns(y: torch.Tensor) -> torch.Tensor:
    """``[tp, N, O/tp]`` -> ``[N, O]``: the slots' columns side by side
    (the all-gather's counterpart)."""
    tp, n, o = y.shape
    return y.permute(1, 0, 2).reshape(n, tp * o)


def split_columns(x: torch.Tensor, tp: int) -> torch.Tensor:
    """``[N, I]`` -> ``[tp, N, I/tp]``: slot j's input columns (a view
    where ``x``'s strides allow)."""
    n, i = x.shape
    return x.reshape(n, tp, i // tp).transpose(0, 1)
