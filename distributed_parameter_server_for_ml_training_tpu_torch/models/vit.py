"""Vision Transformer in PyTorch, numerically matched to the flax model
(counterpart of the JAX package's ``models/vit.py``).

The flax conventions carried over, each of which differs from torch's
defaults:

- inputs are NHWC images; the patch embedding is a conv with stride ==
  kernel == patch size, VALID padding, and its output is flattened to
  tokens in row-major (h, w) order, as flax's NHWC reshape;
- ``dtype=torch.bfloat16`` means bf16 compute with fp32 parameters: Dense
  layers and the patch conv cast inputs, kernels and biases to ``dtype``;
  :class:`LayerNorm` computes its statistics (E[x^2] - E[x]^2, clipped at
  0) and normalization in fp32 and casts the result; the logits come out
  fp32;
- LayerNorm epsilon 1e-6; gelu is the tanh approximation (flax's
  ``nn.gelu`` default);
- a float64 ``dtype``, for reference runs, computes all of it in float64,
  LayerNorm and the attention softmax included;
- submodules are named after the flax ones (``patch_embed``,
  ``cls_token``, ``pos_embed``, ``block_i.ln1``, ``block_i.attn.qkv``,
  ``block_i.attn.out``, ``block_i.ln2``, ``block_i.mlp.fc1``,
  ``block_i.mlp.fc2``, ``ln_final``, ``head``) and registered in flax's
  creation order, so ``utils/pytree.py`` maps names and layouts
  mechanically and the flat parameter order equals the JAX package's.

Weights are drawn from an explicit ``torch.Generator`` with flax's
initializers: lecun-normal kernels, zero biases, unit LayerNorm scales, a
zero CLS token and a normal(0.02) position embedding.

``attention_fn`` replaces the dense core with one of the same
``[B, T, H, D] x3 -> [B, T, H, D]`` contract: ring attention
(``parallel/ring_attention.py``) for sequence parallelism, or
``ops/flash_attention.flash_attention``.

Per-slot gradients (the sync data-parallel step, ``parallel/sync_dp.py``):
:meth:`ViT.forward_slots` runs N replicas at once, as ``ResNet`` does,
from images ``[N, B, H, W, C]`` and one parameter leaf ``[N, ...]`` per
slot, so autograd returns one gradient per slot. Dense layers are one
``baddbmm`` over the slots, LayerNorm applies each slot's own affine, the
patch embedding is a conv grouped over the slots, and the attention core
(``attention_fn`` or the dense core, as in ``forward``) sees the slots
folded into the batch. No statistic crosses slots (LayerNorm needs no
sync).

Sequence parallelism over several ranks (``train/model_parallel.py``,
``seq_group``): each rank holds the tokens ``[r T/R, (r+1) T/R)`` of the
same global batch. :meth:`ViT.forward` embeds only the rank's patches
(whole patch rows where ``T/R`` is a multiple of the grid width, else the
whole image, keeping the rank's range), adds the matching rows of the
position embedding, and pools the ``gap`` mean over every rank's tokens
(``multihost.shared_rank_mean`` of the local means), so every rank
computes the same logits and loss.

The patch embedding's bias is added after the conv, as flax adds it, so
its gradient is a reduction of its own (torch's CPU conv backward sums
the bias gradient in one long fp32 chain, which drifts from float64 at a
few hundred tokens).

Expert parallelism (``moe_fn``, ``train/model_parallel.py:MoETrainer``):
each block's MLP becomes a :class:`SwitchMoEMlp` over
``parallel/moe.make_moe_ffn``, whose parameters are fp32 in flax's
layout and whose products run in fp32 (float64 for a float64 model)
whatever the model's dtype. Pipeline parallelism
(``PipelineTrainer``): :class:`ViTPrologue`, :class:`EncoderStage` and
:class:`ViTEpilogue` split the CLS model with the flax names, so a
pipelined model's parameters map stage by stage.

Tensor parallelism (``tp_degree`` > 1, ``train/model_parallel.py:
TPTrainer`` and ``PipelineTrainer(pp_tp_degree=)``): a :class:`ViT` or
:class:`EncoderStage` built with it runs every block's TP form over
``parallel/tensor.py``. ``qkv`` and ``fc1`` are column-parallel (one
batched product over the ``model`` slots), ``out`` and ``fc2``
row-parallel (the slots' partials summed in fp32, the bias added once);
the slots' ``qkv`` columns are concatenated back to ``[B, T, 3D]``
before the core, which runs over every head as in the plain block, and
slot j takes the core's columns ``[j D/tp, (j+1) D/tp)`` into ``out``.
The parameters are the plain model's, each slot a view of them; a tp
that does not divide ``3D``, ``D`` or the MLP width raises the
reference's ``ValueError`` (a head count tp does not divide is run, as
the reference runs it).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dense_core
from ..parallel import tensor as tpar
from ..parallel.multihost import RankGroup, shared_rank_mean
from ..utils.pytree import flax_names, to_flax_layout


def _sub(name: str, leaf: str) -> str:
    return f"{name}.{leaf}" if name else leaf


class Dense(nn.Linear):
    """flax ``nn.Dense``: fp32 weights, inputs/kernel/bias cast to
    ``dtype``."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))

    def forward_slots(self, x: torch.Tensor, params: dict,
                      name: str) -> torch.Tensor:
        """``[N, ..., I]`` with per-slot weight ``[N, O, I]`` and bias
        ``[N, O]`` -> ``[N, ..., O]``: one batched product over the
        slots."""
        d = self.compute_dtype
        w, b = params[_sub(name, "weight")], params[_sub(name, "bias")]
        n = w.shape[0]
        y = torch.baddbmm(b.to(d).unsqueeze(1),
                          x.to(d).reshape(n, -1, x.shape[-1]),
                          w.to(d).transpose(1, 2))
        return y.view(*x.shape[:-1], w.shape[1])

    def forward_column(self, x: torch.Tensor, tp: int) -> torch.Tensor:
        """TP form, column-parallel: ``[N, I]`` -> ``[tp, N, O/tp]``."""
        return tpar.column_parallel(x, self.weight, self.bias, tp,
                                    self.compute_dtype)

    def forward_row(self, x_slots: torch.Tensor) -> torch.Tensor:
        """TP form, row-parallel: ``[tp, N, I/tp]`` -> ``[N, O]``."""
        return tpar.row_parallel(x_slots, self.weight, self.bias,
                                 self.compute_dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: fp32 statistics
    (E[x^2] - E[x]^2 clipped at 0; float64 for a float64 ``dtype``), eps
    1e-6, result cast to ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-6):
        super().__init__()
        self.compute_dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._norm(x, self.weight, self.bias)

    def forward_slots(self, x: torch.Tensor, params: dict,
                      name: str) -> torch.Tensor:
        """``[N, ..., D]`` with per-slot scale and bias ``[N, D]``."""
        w, b = params[_sub(name, "weight")], params[_sub(name, "bias")]
        shape = (w.shape[0],) + (1,) * (x.dim() - 2) + (w.shape[1],)
        return self._norm(x, w.view(shape), b.view(shape))

    def _norm(self, x, weight, bias):
        xf = x.to(torch.promote_types(self.compute_dtype, torch.float32))
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True)
               - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * weight
        return ((xf - mean) * mul + bias).to(self.compute_dtype)


class MlpBlock(nn.Module):
    def __init__(self, in_dim: int, mlp_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32, tp_degree: int = 1):
        super().__init__()
        self.tp_degree = tp_degree
        self.fc1 = Dense(in_dim, mlp_dim, dtype)
        self.fc2 = Dense(mlp_dim, out_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_degree > 1:
            return self.forward_tp(x)
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))

    def forward_tp(self, x: torch.Tensor) -> torch.Tensor:
        """``fc1`` column-parallel, the GELU on each slot's hidden units,
        ``fc2`` row-parallel (its sum over the slots)."""
        h = self.fc1.forward_column(x.reshape(-1, x.shape[-1]),
                                    self.tp_degree)
        y = self.fc2.forward_row(F.gelu(h, approximate="tanh"))
        return y.view(*x.shape[:-1], y.shape[-1])

    def forward_slots(self, x: torch.Tensor, params: dict,
                      name: str) -> torch.Tensor:
        y = self.fc1.forward_slots(x, params, _sub(name, "fc1"))
        return self.fc2.forward_slots(F.gelu(y, approximate="tanh"),
                                      params, _sub(name, "fc2"))


class SwitchMoEMlp(nn.Module):
    """Switch-style top-1 MoE in place of an encoder block's dense MLP.

    The routing, dispatch and expert products are ``moe_fn``
    (``parallel/moe.make_moe_ffn``); this module owns the parameters, in
    flax's order, names and layouts: ``router`` ``[D, E]``, ``w1`` ``[E,
    D, H]``, ``b1`` ``[E, H]``, ``w2`` ``[E, H, D]``, ``b2`` ``[E, D]``,
    all fp32. The input is cast to fp32 (float64 for a float64 model)
    before the MoE and the output back to the input's dtype.

    A training forward keeps its routing statistics (``stats``: the aux
    loss, load, importance and drop fraction, as device tensors, read
    with no host sync by ``train/steps.collect_moe_stats``); an eval
    forward records nothing, as flax's ``sow`` outside a mutable
    collection.

    Where ``moe_fn`` runs over ranks (``make_moe_ffn`` on a mesh with a
    group, whose function carries it as ``moe_fn.group``), the module
    holds rank r's ``E/R`` experts, rows ``[r E/R, (r+1) E/R)`` of
    ``w1/b1/w2/b2``, under the same names; the router stays whole."""

    def __init__(self, moe_fn: Callable, dim: int, n_experts: int,
                 hidden_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.moe_fn = moe_fn
        self.compute_dtype = dtype
        group = getattr(moe_fn, "group", None)
        self.rank, self.ranks = (0, 1) if group is None \
            else (group.rank, group.size)
        if n_experts % self.ranks:
            raise ValueError(f"{n_experts} experts do not divide evenly "
                             f"over {self.ranks} ranks")
        e, el, d, dh = n_experts, n_experts // self.ranks, dim, hidden_dim
        self.router = nn.Parameter(torch.empty(d, e))
        self.w1 = nn.Parameter(torch.empty(el, d, dh))
        self.b1 = nn.Parameter(torch.zeros(el, dh))
        self.w2 = nn.Parameter(torch.empty(el, dh, d))
        self.b2 = nn.Parameter(torch.zeros(el, d))
        self.stats: dict | None = None

    def reset_parameters(self, generator: torch.Generator | None = None
                         ) -> None:
        """flax's ``normal(d**-0.5)`` router and ``w1``,
        ``normal(dh**-0.5)`` ``w2``, zero biases; over ranks every expert
        is drawn, as one process draws them, and the rank keeps its rows."""
        d, dh = self.w1.shape[1:]
        e = self.router.shape[1]
        lo = self.rank * (e // self.ranks)
        with torch.no_grad():
            for p, std in ((self.router, d ** -0.5), (self.w1, d ** -0.5),
                           (self.w2, dh ** -0.5)):
                if p is self.router or self.ranks == 1:
                    p.normal_(0.0, std, generator=generator)
                else:
                    whole = torch.empty((e, *p.shape[1:]), dtype=p.dtype,
                                        device=p.device)
                    p.copy_(whole.normal_(0.0, std, generator=generator)
                            [lo:lo + p.shape[0]])
            self.b1.zero_()
            self.b2.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        params = {"router": self.router, "w1": self.w1, "b1": self.b1,
                  "w2": self.w2, "b2": self.b2}
        # Batch-major flatten: shard k of the expert slots holds whole
        # images' tokens, as the reference's P("expert") split.
        y, stats = self.moe_fn(params, x.reshape(b * t, d).to(
            torch.promote_types(self.compute_dtype, torch.float32)))
        if self.training:
            self.stats = stats
        return y.view(b, t, d).to(x.dtype)


class SelfAttention(nn.Module):
    """Multi-head self-attention with a fused qkv projection; the core is
    ``attention_fn`` when given, else :func:`~..ops.attention.dense_core`.
    """

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32,
                 attention_fn: Callable | None = None, tp_degree: int = 1):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"hidden dim {dim} not divisible by {num_heads} "
                             f"heads")
        self.num_heads = num_heads
        self.attention_fn = attention_fn
        self.tp_degree = tp_degree
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.out = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_degree > 1:
            return self.forward_tp(x)
        b, t, d = x.shape
        return self.out(self._core(self.qkv(x), b, t, d))

    def forward_tp(self, x: torch.Tensor) -> torch.Tensor:
        """``qkv`` column-parallel, the slots' columns concatenated back
        to ``[B, T, 3D]`` (the all-gather), the core over every head,
        slot j's columns ``[j D/tp, (j+1) D/tp)`` of its output into the
        row-parallel ``out``."""
        b, t, d = x.shape
        tp = self.tp_degree
        qkv = tpar.gather_columns(self.qkv.forward_column(
            x.reshape(b * t, d), tp))
        y = self._core(qkv.view(b, t, 3 * d), b, t, d)
        return self.out.forward_row(
            tpar.split_columns(y.reshape(b * t, d), tp)).view(b, t, d)

    def forward_slots(self, x: torch.Tensor, params: dict,
                      name: str) -> torch.Tensor:
        """``[N, B, T, D]``: the slots fold into the core's batch."""
        n, b, t, d = x.shape
        y = self._core(self.qkv.forward_slots(x, params, _sub(name, "qkv")),
                       n * b, t, d)
        return self.out.forward_slots(y.view(n, b, t, d), params,
                                      _sub(name, "out"))

    def _core(self, qkv: torch.Tensor, b: int, t: int, d: int
              ) -> torch.Tensor:
        qkv = qkv.view(b, t, 3, self.num_heads, d // self.num_heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        core = self.attention_fn or dense_core
        return core(q, k, v).reshape(b, t, d)


class EncoderBlock(nn.Module):
    """Pre-LN encoder block; with ``moe_fn`` its MLP is a
    :class:`SwitchMoEMlp` (named ``moe``, as flax's) of ``moe_experts``
    experts of ``moe_hidden`` (default ``mlp_ratio * dim``) hidden
    units. With ``tp_degree`` > 1 its attention and dense MLP run their
    TP forms (module notes); the LayerNorms and residuals run once on the
    whole activations, which every model slot holds alike."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32,
                 attention_fn: Callable | None = None,
                 moe_fn: Callable | None = None, moe_experts: int = 0,
                 moe_hidden: int | None = None, tp_degree: int = 1):
        super().__init__()
        self.ln1 = LayerNorm(dim, dtype)
        self.attn = SelfAttention(dim, num_heads, dtype, attention_fn,
                                  tp_degree)
        self.ln2 = LayerNorm(dim, dtype)
        if moe_fn is not None:
            self.moe = SwitchMoEMlp(moe_fn, dim, moe_experts,
                                    moe_hidden or mlp_ratio * dim, dtype)
        else:
            self.mlp = MlpBlock(dim, mlp_ratio * dim, dim, dtype, tp_degree)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        ffn = self.moe if hasattr(self, "moe") else self.mlp
        return x + ffn(self.ln2(x))

    def forward_slots(self, x: torch.Tensor, params: dict,
                      name: str) -> torch.Tensor:
        def sub(mod):
            return _sub(name, mod)

        x = x + self.attn.forward_slots(
            self.ln1.forward_slots(x, params, sub("ln1")), params,
            sub("attn"))
        return x + self.mlp.forward_slots(
            self.ln2.forward_slots(x, params, sub("ln2")), params,
            sub("mlp"))


class ViT(nn.Module):
    """ViT with learned position embeddings over ``image_size`` inputs.

    ``pool='cls'`` prepends a CLS token and classifies from it;
    ``pool='gap'`` mean-pools the patch tokens (no CLS token, so the
    sequence divides evenly over ring-attention slots). flax sizes the
    position embedding from the first input; the port takes
    ``image_size`` up front. ``seq_group`` names the ranks that split the
    tokens (module notes; ``gap`` only). ``moe_fn``/``moe_experts``/
    ``moe_hidden`` reach every :class:`EncoderBlock`, as does
    ``tp_degree`` (the TP form, module notes)."""

    def __init__(self, patch_size: int = 16, hidden_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: int = 4,
                 num_classes: int = 100, dtype: torch.dtype = torch.float32,
                 pool: str = "cls", attention_fn: Callable | None = None,
                 image_size: int = 32,
                 generator: torch.Generator | None = None,
                 seq_group: RankGroup | None = None,
                 moe_fn: Callable | None = None, moe_experts: int = 0,
                 moe_hidden: int | None = None, tp_degree: int = 1):
        super().__init__()
        if pool not in ("cls", "gap"):
            raise ValueError(f"pool must be 'cls' or 'gap', got {pool!r}")
        if image_size % patch_size:
            raise ValueError(f"image {image_size} not divisible by patch "
                             f"{patch_size}")
        grid = image_size // patch_size
        if seq_group is not None and (pool != "gap"
                                      or grid * grid % seq_group.size):
            raise ValueError(f"tokens split over {seq_group.size} ranks "
                             f"need pool='gap' and {grid * grid} tokens "
                             f"divisible by the rank count")
        self.patch_size, self.hidden_dim = patch_size, hidden_dim
        self.pool, self.compute_dtype = pool, dtype
        self.seq_group = seq_group
        self.patch_embed = nn.Conv2d(3, hidden_dim, patch_size,
                                     stride=patch_size)
        n_tokens = (image_size // patch_size) ** 2 + (pool == "cls")
        if pool == "cls":
            self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens, hidden_dim))
        for i in range(depth):
            self.add_module(f"block_{i}", EncoderBlock(
                hidden_dim, num_heads, mlp_ratio, dtype, attention_fn,
                moe_fn, moe_experts, moe_hidden, tp_degree))
        self.depth = depth
        self.ln_final = LayerNorm(hidden_dim, dtype)
        self.head = Dense(hidden_dim, num_classes, dtype)
        check_tp_degree(self, tp_degree)
        init_weights(self, generator)

    def named_parameters(self, prefix: str = "", recurse: bool = True,
                         remove_duplicate: bool = True):
        return embed_first(super().named_parameters(prefix, recurse,
                                                    remove_duplicate))

    @property
    def blocks(self) -> list[EncoderBlock]:
        return [getattr(self, f"block_{i}") for i in range(self.depth)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images ``[B, H, W, C]`` -> fp32 logits (float64 for a
        float64 ``dtype``)."""
        b = x.shape[0]
        d = self.compute_dtype
        pos = self.pos_embed
        if self.seq_group is not None:
            lo, hi, x = self._rank_rows(x)
            pos = pos[:, lo:hi]
        x = F.conv2d(x.to(d).permute(0, 3, 1, 2),
                     self.patch_embed.weight.to(d), None,
                     stride=self.patch_size)
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.hidden_dim)
        if self.seq_group is not None and x.shape[1] != hi - lo:
            x = x[:, lo:hi]                  # the whole image: the range
        x = x + self.patch_embed.bias.to(d)
        if self.pool == "cls":
            cls = self.cls_token.expand(b, 1, self.hidden_dim).to(d)
            x = torch.cat([cls, x], dim=1)
        x = x + pos.to(d)
        for block in self.blocks:
            x = block(x)
        x = self.ln_final(x)
        x = x[:, 0] if self.pool == "cls" else x.mean(dim=1)
        if self.seq_group is not None:
            # The pool's own autograd function: every rank's loss uses the
            # same mean, so each rank's part gets g / R back.
            x = shared_rank_mean(x.float(), self.seq_group).to(x.dtype)
        return self.head(x).to(torch.promote_types(d, torch.float32))

    def _rank_rows(self, x: torch.Tensor):
        """This rank's tokens ``[lo, hi)`` and the images' pixel rows that
        hold them: whole patch rows where the range is, else every row."""
        per = self.pos_embed.shape[1] // self.seq_group.size
        lo = self.seq_group.rank * per
        grid, p = x.shape[2] // self.patch_size, self.patch_size
        if per % grid:
            return lo, lo + per, x
        return lo, lo + per, x[:, lo // grid * p:(lo + per) // grid * p]

    def forward_slots(self, x: torch.Tensor, params: dict) -> torch.Tensor:
        """All N slots at once: NHWC images ``[N, B, H, W, C]`` and one leaf
        ``[N, *shape]`` per torch parameter name -> logits ``[N, B,
        classes]`` (module notes)."""
        n, b, h, w, c = x.shape
        d, dim = self.compute_dtype, self.hidden_dim
        kernel = params["patch_embed.weight"]
        x = F.conv2d(x.to(d).permute(1, 0, 4, 2, 3).reshape(b, n * c, h, w),
                     kernel.to(d).reshape(n * dim, *kernel.shape[2:]), None,
                     stride=self.patch_size, groups=n)
        x = x.view(b, n, dim, -1).permute(1, 0, 3, 2) \
            + params["patch_embed.bias"].to(d)[:, None, None]
        if self.pool == "cls":
            cls = params["cls_token"].to(d).expand(n, b, 1, dim)
            x = torch.cat([cls, x], dim=2)
        x = x + params["pos_embed"].to(d)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}").forward_slots(x, params,
                                                          f"block_{i}")
        x = self.ln_final.forward_slots(x, params, "ln_final")
        x = x[:, :, 0] if self.pool == "cls" else x.mean(dim=2)
        return self.head.forward_slots(x, params, "head").to(
            torch.promote_types(d, torch.float32))


def embed_first(items) -> iter:
    """Parameters in flax's creation order: torch yields a module's own
    parameters (``cls_token``, ``pos_embed``) before its children's, flax
    creates ``patch_embed`` first."""
    items = list(items)

    def embed(kv):
        return "patch_embed." in "." + kv[0]

    return iter([kv for kv in items if embed(kv)]
                + [kv for kv in items if not embed(kv)])


class ViTPrologue(nn.Module):
    """Patch embedding, CLS token and position embedding: the
    shape-changing entry of the CLS :class:`ViT`, run outside the pipeline
    (stages keep their shape), with the same flax names and the same
    arithmetic as :meth:`ViT.forward`."""

    def __init__(self, patch_size: int = 4, hidden_dim: int = 192,
                 dtype: torch.dtype = torch.float32, image_size: int = 32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image {image_size} not divisible by patch "
                             f"{patch_size}")
        self.patch_size, self.hidden_dim = patch_size, hidden_dim
        self.compute_dtype = dtype
        self.patch_embed = nn.Conv2d(3, hidden_dim, patch_size,
                                     stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.pos_embed = nn.Parameter(torch.zeros(
            1, (image_size // patch_size) ** 2 + 1, hidden_dim))
        init_weights(self, generator)

    def named_parameters(self, prefix: str = "", recurse: bool = True,
                         remove_duplicate: bool = True):
        return embed_first(super().named_parameters(prefix, recurse,
                                                    remove_duplicate))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d = x.shape[0], self.compute_dtype
        x = F.conv2d(x.to(d).permute(0, 3, 1, 2),
                     self.patch_embed.weight.to(d), None,
                     stride=self.patch_size)
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.hidden_dim) \
            + self.patch_embed.bias.to(d)
        cls = self.cls_token.expand(b, 1, self.hidden_dim).to(d)
        return torch.cat([cls, x], dim=1) + self.pos_embed.to(d)


class EncoderStage(nn.Module):
    """``num_blocks`` encoder blocks: one pipeline stage, ``[B, T, D] ->
    [B, T, D]``, so S of them stack into the ``[S, ...]`` leaves of
    ``parallel/pipeline.py``. With ``tp_degree`` > 1 the blocks run their
    TP form (module notes), the reference's ``pp_tp_degree``."""

    def __init__(self, num_blocks: int, dim: int, num_heads: int,
                 mlp_ratio: int = 4, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 tp_degree: int = 1):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block_{i}", EncoderBlock(
                dim, num_heads, mlp_ratio, dtype, tp_degree=tp_degree))
        check_tp_degree(self, tp_degree)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x)
        return x


class ViTEpilogue(nn.Module):
    """Final LayerNorm and the head on the CLS token: the shape-changing
    exit; fp32 logits (float64 for a float64 ``dtype``)."""

    def __init__(self, hidden_dim: int = 192, num_classes: int = 100,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = dtype
        self.ln_final = LayerNorm(hidden_dim, dtype)
        self.head = Dense(hidden_dim, num_classes, dtype)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # LayerNorm is per token: normalizing the CLS token alone gives
        # its row of the whole sequence's, so a pipeline over ranks hands
        # the epilogue that token only (a contiguous copy either way, so
        # both reduce the same memory layout).
        x = self.head(self.ln_final(x[:, 0].contiguous()))
        return x.to(torch.promote_types(self.compute_dtype, torch.float32))


def check_tp_degree(module: nn.Module, tp_degree: int) -> None:
    """Raise the reference's ``ValueError`` where ``tp_degree`` does not
    divide a dim that the TP rule table splits (``3D``, ``D``, the MLP
    width); a degree below 1 is refused outright."""
    if tp_degree < 1:
        raise ValueError(f"tp_degree must be >= 1, got {tp_degree}")
    if tp_degree > 1:
        names, _ = flax_names(module)
        tpar.check_tp_split(
            {f: tuple(to_flax_layout(module.get_parameter(t), f).shape)
             for t, f in names.items()}, tp_degree)


def init_weights(module: nn.Module,
                 generator: torch.Generator | None = None) -> None:
    """flax's initializers: lecun-normal (truncated at 2 std, fan-in) Dense
    and conv kernels, zero biases; LayerNorm ones/zeros; a zero CLS token;
    a normal(0.02) position embedding."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Dense, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                # 0.8796... = std of a unit normal truncated at +-2.
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                m.bias.zero_()
            elif isinstance(m, SwitchMoEMlp):
                m.reset_parameters(generator)
        if isinstance(module, (ViT, ViTPrologue)):
            module.pos_embed.normal_(0.0, 0.02, generator=generator)


def ViT_B16(num_classes: int = 100, dtype: torch.dtype = torch.float32,
            **kw) -> ViT:
    """ViT-B/16: 12 layers, 768 hidden, 12 heads."""
    return ViT(patch_size=16, hidden_dim=768, depth=12, num_heads=12,
               num_classes=num_classes, dtype=dtype, **kw)


def ViT_Tiny(num_classes: int = 100, dtype: torch.dtype = torch.float32,
             patch_size: int = 4, **kw) -> ViT:
    """Small ViT for tests and CIFAR-resolution runs (32/4 -> 64 tokens)."""
    return ViT(patch_size=patch_size, hidden_dim=192, depth=4, num_heads=3,
               num_classes=num_classes, dtype=dtype, **kw)
