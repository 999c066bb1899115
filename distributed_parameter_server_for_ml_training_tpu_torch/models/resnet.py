"""CIFAR-style ResNet in PyTorch, numerically matched to the flax model.

Counterpart of the JAX package's ``models/resnet.py``: 3x3 stem, stride 1,
no maxpool, four stages of BasicBlocks [2,2,2,2], BatchNorm everywhere,
global average pool, Linear head — exactly 11,220,132 parameters at
``num_classes=100`` (the reference's ``model_specs.parameters``).

The flax conventions carried over, each of which differs from torch's
defaults:

- inputs are NHWC images, as in the JAX package; the model moves them to
  NCHW for cuDNN itself;
- ``dtype=torch.bfloat16`` means bf16 compute with fp32 parameters (flax
  ``dtype``/``param_dtype``): convs and the head cast their inputs and
  weights to bf16, BatchNorm computes its statistics and normalization in
  fp32 and casts the result, and the logits come out fp32;
- :class:`BatchNorm` follows flax: ``momentum=0.9`` weights the OLD running
  value (torch's ``momentum=0.1``), eps 1e-5, the batch variance is
  E[x^2] - E[x]^2 clipped at 0, and the running variance is updated with
  that BIASED batch variance (``torch.nn.BatchNorm2d`` uses the unbiased
  one);
- the 1x1 shortcut conv uses flax's default 'SAME' padding; for a 1x1
  kernel at stride 1 or 2 that pads nothing, i.e. torch ``padding=0``;
- submodules are named after the flax ones (``stem_conv``,
  ``BasicBlock_0.Conv_0``, ``head``) and registered in flax's creation
  order, so ``utils/pytree.py`` maps names and layouts mechanically and
  the flat parameter order equals the JAX package's.

Weights are drawn from an explicit ``torch.Generator`` with flax's
initializers (lecun-normal kernels, zero biases, unit BN scales).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Conv(nn.Conv2d):
    """Bias-free conv computing in ``dtype`` with fp32 weights."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, features, kernel, stride=stride,
                         padding=padding, bias=False)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.compute_dtype),
                        self.weight.to(self.compute_dtype), None,
                        self.stride, self.padding)


class Dense(nn.Linear):
    """Linear layer computing in ``dtype`` with fp32 weights."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over NCHW channels (see the module notes).

    In training mode it normalizes with the batch statistics and updates
    ``running_mean``/``running_var`` in place as flax updates
    ``batch_stats``; in eval mode it normalizes with the running values.
    """

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.compute_dtype)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity shortcut (1x1 conv when shape changes)."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        # Registration order = flax creation order (names and flat order).
        self.Conv_0 = Conv(in_features, features, 3, strides, 1, dtype)
        self.BatchNorm_0 = BatchNorm(features, dtype=dtype)
        self.Conv_1 = Conv(features, features, 3, 1, 1, dtype)
        self.BatchNorm_1 = BatchNorm(features, dtype=dtype)
        self.shortcut = in_features != features or strides != 1
        if self.shortcut:
            self.Conv_2 = Conv(in_features, features, 1, strides, 0, dtype)
            self.BatchNorm_2 = BatchNorm(features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.BatchNorm_2(self.Conv_2(x)) if self.shortcut else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet with the CIFAR stem (3x3, stride 1, no maxpool — the
    reference's architecture, server.py:43-76). Takes NHWC images."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 100,
                 num_filters: int = 64, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.stem_conv = Conv(3, num_filters, 3, 1, 1, dtype)
        self.stem_bn = BatchNorm(num_filters, dtype=dtype)
        in_features = num_filters
        index = 0
        for stage, n_blocks in enumerate(stage_sizes):
            for block in range(n_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                features = num_filters * 2 ** stage
                self.add_module(f"BasicBlock_{index}", BasicBlock(
                    in_features, features, strides, dtype))
                in_features = features
                index += 1
        self.n_blocks = index
        self.head = Dense(in_features, num_classes, dtype)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        for i in range(self.n_blocks):
            x = getattr(self, f"BasicBlock_{i}")(x)
        x = x.mean(dim=(2, 3))
        return self.head(x).to(torch.float32)


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


def ResNet18(num_classes: int = 100, dtype: torch.dtype = torch.float32,
             generator: torch.Generator | None = None) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), num_classes=num_classes,
                  dtype=dtype, generator=generator)


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
