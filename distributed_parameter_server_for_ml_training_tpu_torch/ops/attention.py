"""The port's one dense attention core (counterpart of the JAX package's
``ops/attention.py``).

:func:`dense_core` is the softmax attention every dense path shares:
the logits' product in the INPUT dtype, scale and softmax in fp32 (in
float64 for float64 inputs, the reference runs), probabilities cast back
to the input dtype before the product with V. ``models/vit.py``'s
``SelfAttention`` runs it when no ``attention_fn`` is given, and
``ops/flash_attention.flash_attention`` below its crossover.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def dense_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = False) -> torch.Tensor:
    """[B, T, H, D] x3 -> [B, T, H, D] softmax attention in the input
    dtype (fp32 softmax)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    # The product in the input dtype, scaled in fp32: the reference's
    # numpy-scalar scale is not weakly typed, so its multiply promotes.
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(
        torch.promote_types(q.dtype, torch.float32)) * scale
    if causal:
        t = q.shape[1]
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)
