"""The ResNet family in PyTorch, numerically matched to the flax models.

Counterpart of the JAX package's ``models/resnet.py``. ResNet-18 is the
reference's model: 3x3 stem, stride 1, no maxpool, four stages of
BasicBlocks [2,2,2,2], BatchNorm everywhere, global average pool, Linear
head — exactly 11,220,132 parameters at ``num_classes=100`` (the
reference's ``model_specs.parameters``). ResNet-50 stacks Bottlenecks
[3,4,6,3] (1x1 -> 3x3/stride -> 1x1 at 4x width): 25,557,032 parameters
at 1,000 classes, 23,712,932 at 100. Either takes the ImageNet stem
(``imagenet_stem``: 7x7/2 conv, padding 3, then a 3x3/2 max-pool,
padding 1), which the registry picks from 96 px up, or its
space-to-depth form (``s2d_stem``): a 2x2 space-to-depth of the image
and a 4x4/1 conv whose kernel :func:`s2d_stem_kernel` maps from the 7x7
one, the same function. ``max_stages`` truncates the network after that
many stages and returns the feature map (no pool, no head).

The flax conventions carried over, each of which differs from torch's
defaults:

- inputs are NHWC images, as in the JAX package; the model moves them to
  NCHW for cuDNN itself;
- ``dtype=torch.bfloat16`` means bf16 compute with fp32 parameters (flax
  ``dtype``/``param_dtype``): convs and the head cast their inputs and
  weights to bf16, BatchNorm computes its statistics and normalization in
  fp32 and casts the result, and the logits come out fp32 (a float64
  ``dtype``, for reference runs, computes all of it in float64);
- :class:`BatchNorm` follows flax: ``momentum=0.9`` weights the OLD running
  value (torch's ``momentum=0.1``), eps 1e-5, the batch variance is
  E[x^2] - E[x]^2 clipped at 0, and the running variance is updated with
  that BIASED batch variance (``torch.nn.BatchNorm2d`` uses the unbiased
  one);
- the 1x1 convs (shortcuts, the Bottleneck's outer convs) use flax's
  default 'SAME' padding; for a 1x1 kernel at stride 1 or 2 that pads
  nothing, i.e. torch ``padding=0``;
- flax's ``max_pool`` pads with -inf, and so does ``F.max_pool2d``; the
  s2d stem's 4x4 conv pads ((2, 1), (2, 1)), which torch's symmetric
  ``padding=`` cannot say, so the input is padded with ``F.pad`` first;
- submodules are named after the flax ones (``stem_conv``,
  ``stem_conv_s2d``, ``BasicBlock_0.Conv_0``, ``Bottleneck_0.Conv_3``,
  ``head``) and registered in flax's creation order, so
  ``utils/pytree.py`` maps names and layouts mechanically and the flat
  parameter order equals the JAX package's.

Cross-replica BatchNorm. The flax model takes ``axis_name``: under
``shard_map`` each BatchNorm then ``pmean``s its batch mean and mean of
squares over the mesh slots (the sync data-parallel trainer). The port's
model takes the same ``axis_name`` and runs every slot of the mesh in one
program: :meth:`ResNet.forward_slots` takes images ``[N, B, H, W, C]``
and one parameter leaf ``[N, ...]`` per slot, so autograd returns one
gradient per slot. Activations are ``[B, N*C, H, W]`` (slot-major
channels): convolutions are grouped over the slots, BatchNorm averages
each slot's statistics over all slots (the ``pmean``) and applies each
slot's own affine, and the head runs per slot. The running statistics
are updated once, with the averaged batch statistics, as every replica
of the JAX model updates them identically. ``forward(x)`` is the same
program over one slot: each parameter as a ``[1, ...]`` leaf, for which a
grouped conv is the plain conv and the mean over slots is the identity.

Weights are drawn from an explicit ``torch.Generator`` with flax's
initializers (lecun-normal kernels, zero biases, unit BN scales).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _key(name: str, leaf: str) -> str:
    return f"{name}.{leaf}" if name else leaf


class _OneSlot:
    """``forward(x)`` is ``forward_slots`` over one slot, with the module's
    own parameters as ``[1, ...]`` leaves: slot-major activations
    ``[B, 1*C, ...]`` are the plain ones."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_slots(
            x, {k: p[None] for k, p in self.named_parameters()})


class Conv(_OneSlot, nn.Conv2d):
    """Bias-free conv computing in ``dtype`` with fp32 weights."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, features, kernel, stride=stride,
                         padding=padding, bias=False)
        self.compute_dtype = dtype

    def forward_slots(self, x: torch.Tensor, params: dict,
                      name: str = "") -> torch.Tensor:
        """``[B, N*I, H, W]`` with ``params[name + '.weight']`` of shape
        ``[N, O, I, kh, kw]`` -> ``[B, N*O, H', W']``: one conv grouped
        over the N slots."""
        w = params[_key(name, "weight")]
        n = w.shape[0]
        w = w.to(self.compute_dtype).reshape(n * w.shape[1], *w.shape[2:])
        return F.conv2d(x.to(self.compute_dtype), w, None, self.stride,
                        self.padding, groups=n)


class Dense(_OneSlot, nn.Linear):
    """Linear layer computing in ``dtype`` with fp32 weights."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, features)
        self.compute_dtype = dtype

    def forward_slots(self, x: torch.Tensor, params: dict,
                      name: str = "") -> torch.Tensor:
        """``[B, N*I]`` with per-slot weight ``[N, O, I]`` and bias
        ``[N, O]`` -> ``[B, N*O]``, one batched product over the slots."""
        d = self.compute_dtype
        w, b = params[_key(name, "weight")], params[_key(name, "bias")]
        n, batch = w.shape[0], x.shape[0]
        x = x.to(d).view(batch, n, -1).transpose(0, 1)
        y = torch.baddbmm(b.to(d).unsqueeze(1), x, w.to(d).transpose(1, 2))
        return y.transpose(0, 1).reshape(batch, -1)


class BatchNorm(_OneSlot, nn.Module):
    """flax ``nn.BatchNorm`` over NCHW channels (see the module notes).

    In training mode it normalizes with the batch statistics and updates
    ``running_mean``/``running_var`` in place as flax updates
    ``batch_stats``; in eval mode it normalizes with the running values.
    """

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 axis_name: str | None = None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.compute_dtype = dtype
        self.axis_name = axis_name
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward_slots(self, x: torch.Tensor, params: dict,
                      name: str = "") -> torch.Tensor:
        """``[B, N*C, H, W]`` with per-slot scale and bias ``[N, C]``.

        Training: each slot's mean and mean of squares are averaged over
        the slots (flax's ``pmean`` over ``axis_name``), the variance is
        taken from the averages, and the running statistics are updated
        once with them. Eval: the running statistics."""
        w, b = params[_key(name, "weight")], params[_key(name, "bias")]
        n, c = w.shape
        xf = x.to(torch.promote_types(self.compute_dtype, torch.float32)
                  ).reshape(x.shape[0], n, c, *x.shape[2:])
        if self.training:
            if n > 1 and self.axis_name is None:
                raise ValueError("a slotted forward in training needs "
                                 "cross-replica BatchNorm: build the model "
                                 "with axis_name")
            mean = xf.mean(dim=(0, 3, 4)).mean(dim=0)
            mean2 = (xf * xf).mean(dim=(0, 3, 4)).mean(dim=0)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * w                     # [N, C]
        y = (xf - mean[:, None, None]) * mul[:, :, None, None] \
            + b[:, :, None, None]
        return y.to(self.compute_dtype).view(x.shape)


class BasicBlock(_OneSlot, nn.Module):
    """Two 3x3 convs + identity shortcut (1x1 conv when shape changes)."""

    expansion = 1

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32,
                 axis_name: str | None = None):
        super().__init__()
        # Registration order = flax creation order (names and flat order).
        self.Conv_0 = Conv(in_features, features, 3, strides, 1, dtype)
        self.BatchNorm_0 = BatchNorm(features, dtype=dtype,
                                     axis_name=axis_name)
        self.Conv_1 = Conv(features, features, 3, 1, 1, dtype)
        self.BatchNorm_1 = BatchNorm(features, dtype=dtype,
                                     axis_name=axis_name)
        self.shortcut = in_features != features or strides != 1
        if self.shortcut:
            self.Conv_2 = Conv(in_features, features, 1, strides, 0, dtype)
            self.BatchNorm_2 = BatchNorm(features, dtype=dtype,
                                         axis_name=axis_name)

    def forward_slots(self, x: torch.Tensor, params: dict,
                      name: str = "") -> torch.Tensor:
        """Over slot-major activations ``[B, N*C, H, W]`` (module notes)."""
        def sub(mod):
            return _key(name, mod)

        y = self.Conv_0.forward_slots(x, params, sub("Conv_0"))
        y = F.relu(self.BatchNorm_0.forward_slots(y, params,
                                                  sub("BatchNorm_0")))
        y = self.Conv_1.forward_slots(y, params, sub("Conv_1"))
        y = self.BatchNorm_1.forward_slots(y, params, sub("BatchNorm_1"))
        residual = x
        if self.shortcut:
            residual = self.BatchNorm_2.forward_slots(
                self.Conv_2.forward_slots(x, params, sub("Conv_2")),
                params, sub("BatchNorm_2"))
        return F.relu(y + residual)


class Bottleneck(_OneSlot, nn.Module):
    """1x1 -> 3x3/stride -> 1x1 bottleneck block (ResNet-50): ``features``
    is the bottleneck width, the output is 4x that; the shortcut is a 1x1
    conv + BN when the shape changes."""

    expansion = 4

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32,
                 axis_name: str | None = None):
        super().__init__()
        out = features * self.expansion

        def norm(f):
            return BatchNorm(f, dtype=dtype, axis_name=axis_name)

        # Registration order = flax creation order (names and flat order).
        self.Conv_0 = Conv(in_features, features, 1, 1, 0, dtype)
        self.BatchNorm_0 = norm(features)
        self.Conv_1 = Conv(features, features, 3, strides, 1, dtype)
        self.BatchNorm_1 = norm(features)
        self.Conv_2 = Conv(features, out, 1, 1, 0, dtype)
        self.BatchNorm_2 = norm(out)
        self.shortcut = in_features != out or strides != 1
        if self.shortcut:
            self.Conv_3 = Conv(in_features, out, 1, strides, 0, dtype)
            self.BatchNorm_3 = norm(out)

    def forward_slots(self, x: torch.Tensor, params: dict,
                      name: str = "") -> torch.Tensor:
        """Over slot-major activations ``[B, N*C, H, W]`` (module notes)."""
        def conv_bn(y, i):
            y = getattr(self, f"Conv_{i}").forward_slots(
                y, params, _key(name, f"Conv_{i}"))
            return getattr(self, f"BatchNorm_{i}").forward_slots(
                y, params, _key(name, f"BatchNorm_{i}"))

        y = F.relu(conv_bn(x, 0))
        y = F.relu(conv_bn(y, 1))
        y = conv_bn(y, 2)
        residual = conv_bn(x, 3) if self.shortcut else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet with the CIFAR stem (3x3, stride 1, no maxpool — the
    reference's architecture, server.py:43-76) or, with ``imagenet_stem``,
    the ImageNet stem (7x7/2 conv + 3x3/2 max-pool; ``s2d_stem`` its
    space-to-depth form). Takes NHWC images."""

    def __init__(self, stage_sizes: Sequence[int],
                 block_cls: type = BasicBlock, num_classes: int = 100,
                 num_filters: int = 64, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None,
                 axis_name: str | None = None, imagenet_stem: bool = False,
                 s2d_stem: bool = False, max_stages: int | None = None):
        super().__init__()
        self.dtype = dtype
        self.axis_name = axis_name
        self.imagenet_stem = imagenet_stem
        self.s2d = imagenet_stem and s2d_stem
        self.max_stages = max_stages
        if self.s2d:
            self.stem_conv_s2d = Conv(12, num_filters, 4, 1, 0, dtype)
        elif imagenet_stem:
            self.stem_conv = Conv(3, num_filters, 7, 2, 3, dtype)
        else:
            self.stem_conv = Conv(3, num_filters, 3, 1, 1, dtype)
        self.stem_bn = BatchNorm(num_filters, dtype=dtype,
                                 axis_name=axis_name)
        stages = stage_sizes if max_stages is None \
            else stage_sizes[:max_stages]
        in_features = num_filters
        self.block_names: list[str] = []
        for stage, n_blocks in enumerate(stages):
            for block in range(n_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                features = num_filters * 2 ** stage
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                self.add_module(name, block_cls(
                    in_features, features, strides, dtype, axis_name))
                self.block_names.append(name)
                in_features = features * block_cls.expansion
        if max_stages is None:
            self.head = Dense(in_features, num_classes, dtype)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images ``[B, H, W, C]`` -> fp32 logits: one slot (with
        ``max_stages``, the NHWC feature map in the compute dtype)."""
        params = {k: p[None] for k, p in self.named_parameters()}
        return self.forward_slots(x[None], params)[0]

    def forward_slots(self, x: torch.Tensor, params: dict) -> torch.Tensor:
        """All N slots at once: NHWC images ``[N, B, H, W, C]`` and one leaf
        ``[N, *shape]`` per torch parameter name -> fp32 logits ``[N, B,
        classes]`` (module notes); with ``max_stages``, the feature maps
        ``[N, B, H', W', C']``."""
        n, b, h, w, c = x.shape
        x = x.to(self.dtype)
        if self.s2d:
            if h % 2 or w % 2:
                raise ValueError(f"the s2d stem needs even sides, got "
                                 f"{h}x{w}")
            # 2x2 space-to-depth, channel block (row phase * 2 + column
            # phase) * C + channel, as the flax model's reshape.
            x = x.reshape(n, b, h // 2, 2, w // 2, 2, c).permute(
                0, 1, 2, 4, 3, 5, 6)
            h, w, c = h // 2, w // 2, 4 * c
        x = x.permute(1, 0, *range(4, x.dim()), 2, 3).reshape(b, n * c, h, w)
        if self.s2d:
            x = self.stem_conv_s2d.forward_slots(F.pad(x, (2, 1, 2, 1)),
                                                 params, "stem_conv_s2d")
        else:
            x = self.stem_conv.forward_slots(x, params, "stem_conv")
        x = F.relu(self.stem_bn.forward_slots(x, params, "stem_bn"))
        if self.imagenet_stem:
            x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name).forward_slots(x, params, name)
        if self.max_stages is not None:
            _, nc, h, w = x.shape
            return x.view(b, n, nc // n, h, w).permute(1, 0, 3, 4, 2)
        x = self.head.forward_slots(x.mean(dim=(2, 3)), params, "head")
        return x.view(b, n, -1).transpose(0, 1).to(
            torch.promote_types(self.dtype, torch.float32))


def init_weights(module: nn.Module,
                 generator: torch.Generator | None = None) -> None:
    """flax's initializers: lecun-normal (truncated at 2 std, fan-in)
    conv and Dense kernels, zero Dense biases; BN keeps ones/zeros."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Conv, Dense)):
                fan_in = m.weight[0].numel()
                # 0.8796... = std of a unit normal truncated at +-2.
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if isinstance(m, Dense):
                    m.bias.zero_()


def s2d_stem_kernel(w):
    """Map 7x7/2 stem weights [7,7,C,F] (flax HWIO) to the
    exact-equivalent 4x4/1 space-to-depth kernel [4,4,4C,F] — the JAX
    package's function, copied.

    Derivation: o[i,j] = sum_{di,dj in [-3,3]} w[di+3,dj+3] x[2i+di,2j+dj].
    In 2x2-s2d coordinates x[2i+di] lives at s2d row r with phase pr where
    2i+di = 2(i+r-2)+pr, i.e. di = 2r+pr-4 for r in 0..3, pr in {0,1} —
    so the receptive field is 4 s2d rows (i-2..i+1), stride 1, padding
    (2,1); entries with di outside [-3,3] (r=0, pr=0) are zero. Channel
    block order matches the model's reshape: (pr*2+pc)*C + ci.
    """
    w = np.asarray(w)
    kh, kw, c, f = w.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"expected a 7x7 kernel, got {kh}x{kw}")
    out = np.zeros((4, 4, 4 * c, f), w.dtype)
    for r in range(4):
        for pr in range(2):
            di = 2 * r + pr - 1          # = (2r + pr - 4) + 3
            if not 0 <= di < 7:
                continue
            for q in range(4):
                for pc in range(2):
                    dj = 2 * q + pc - 1
                    if not 0 <= dj < 7:
                        continue
                    blk = (pr * 2 + pc) * c
                    out[r, q, blk:blk + c, :] = w[di, dj]
    return out


def ResNet18(num_classes: int = 100, dtype: torch.dtype = torch.float32,
             generator: torch.Generator | None = None,
             axis_name: str | None = None, imagenet_stem: bool = False,
             s2d_stem: bool = False) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock,
                  num_classes=num_classes, dtype=dtype, generator=generator,
                  axis_name=axis_name, imagenet_stem=imagenet_stem,
                  s2d_stem=s2d_stem)


def ResNet50(num_classes: int = 1000, dtype: torch.dtype = torch.float32,
             generator: torch.Generator | None = None,
             axis_name: str | None = None, imagenet_stem: bool = False,
             s2d_stem: bool = False) -> ResNet:
    """ResNet-50. The CIFAR stem is the default, as in the JAX package;
    the registry takes the ImageNet stem from 96 px up."""
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck,
                  num_classes=num_classes, dtype=dtype, generator=generator,
                  axis_name=axis_name, imagenet_stem=imagenet_stem,
                  s2d_stem=s2d_stem)


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
