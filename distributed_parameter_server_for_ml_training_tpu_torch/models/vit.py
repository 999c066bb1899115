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
few hundred tokens). ``SwitchMoEMlp``,
``ViTPrologue``, ``EncoderStage`` and ``ViTEpilogue`` come with the MoE
and pipeline slices.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dense_core
from ..parallel.multihost import RankGroup, shared_rank_mean


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
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(in_dim, mlp_dim, dtype)
        self.fc2 = Dense(mlp_dim, out_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))

    def forward_slots(self, x: torch.Tensor, params: dict,
                      name: str) -> torch.Tensor:
        y = self.fc1.forward_slots(x, params, _sub(name, "fc1"))
        return self.fc2.forward_slots(F.gelu(y, approximate="tanh"),
                                      params, _sub(name, "fc2"))


class SelfAttention(nn.Module):
    """Multi-head self-attention with a fused qkv projection; the core is
    ``attention_fn`` when given, else :func:`~..ops.attention.dense_core`.
    """

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32,
                 attention_fn: Callable | None = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"hidden dim {dim} not divisible by {num_heads} "
                             f"heads")
        self.num_heads = num_heads
        self.attention_fn = attention_fn
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.out = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        return self.out(self._core(self.qkv(x), b, t, d))

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
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32,
                 attention_fn: Callable | None = None):
        super().__init__()
        self.ln1 = LayerNorm(dim, dtype)
        self.attn = SelfAttention(dim, num_heads, dtype, attention_fn)
        self.ln2 = LayerNorm(dim, dtype)
        self.mlp = MlpBlock(dim, mlp_ratio * dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))

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
    tokens (module notes; ``gap`` only)."""

    def __init__(self, patch_size: int = 16, hidden_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: int = 4,
                 num_classes: int = 100, dtype: torch.dtype = torch.float32,
                 pool: str = "cls", attention_fn: Callable | None = None,
                 image_size: int = 32,
                 generator: torch.Generator | None = None,
                 seq_group: RankGroup | None = None):
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
                hidden_dim, num_heads, mlp_ratio, dtype, attention_fn))
        self.depth = depth
        self.ln_final = LayerNorm(hidden_dim, dtype)
        self.head = Dense(hidden_dim, num_classes, dtype)
        init_weights(self, generator)

    def named_parameters(self, prefix: str = "", recurse: bool = True,
                         remove_duplicate: bool = True):
        """In flax's creation order: torch yields a module's own
        parameters (``cls_token``, ``pos_embed``) before its children's,
        flax creates ``patch_embed`` first."""
        items = list(super().named_parameters(prefix, recurse,
                                              remove_duplicate))
        embed = (prefix + "." if prefix else "") + "patch_embed."
        first = [kv for kv in items if kv[0].startswith(embed)]
        return iter(first + [kv for kv in items
                             if not kv[0].startswith(embed)])

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
        if isinstance(module, ViT):
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
