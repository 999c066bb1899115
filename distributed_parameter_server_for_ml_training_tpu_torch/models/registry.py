"""Model registry by name (counterpart of the JAX package's registry): the
BASELINE.json configurations.

- ``resnet18``: ResNet-18 / CIFAR-100, the reference's only model;
- ``resnet50``: ResNet-50 (the ImageNet-1k sync configuration);
- ``vit_b16``: ViT-B/16;
- ``vit_tiny``: a small ViT for CIFAR-resolution runs and tests.

Both ResNets take the ImageNet stem (7x7/2 conv + 3x3/2 max-pool) from 96
px up, as in the JAX registry: the CIFAR stem would carry full-resolution
feature maps into stage 0.
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device
from .resnet import ResNet18, ResNet50
from .vit import ViT_B16, ViT_Tiny

_RESNETS = {"resnet18": ResNet18, "resnet50": ResNet50}
_VITS = {"vit_b16": ViT_B16, "vit_tiny": ViT_Tiny}

MODEL_NAMES = ("resnet18", "resnet50", "vit_b16", "vit_tiny")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def get_model(name: str, num_classes: int = 100,
              dtype: str | torch.dtype = torch.bfloat16,
              image_size: int = 32, device: str | torch.device = "cuda",
              seed: int = 0, axis_name: str | None = None,
              tp_degree: int = 1) -> torch.nn.Module:
    """Build a model by registry name on ``device``, its weights drawn from
    a ``torch.Generator`` seeded with ``seed``. ``axis_name`` selects
    cross-replica BatchNorm over the mesh slots, as in the JAX model (ViTs
    ignore it: LayerNorm needs no sync). ``image_size`` picks a ResNet's
    stem and sizes a ViT's position embedding. ``tp_degree`` > 1 builds a
    ViT's TP form over that many ``model`` slots (the same weights;
    ``parallel/tensor.py``); the ResNets have none."""
    if name not in MODEL_NAMES:
        raise ValueError(f"unknown model {name!r}; have {MODEL_NAMES}")
    dev = resolve_device(device)
    if isinstance(dtype, str):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, "
                             f"got {dtype!r}")
        dtype = _DTYPES[dtype]
    gen = torch.Generator().manual_seed(seed)
    if name in _VITS:
        return _VITS[name](num_classes=num_classes, dtype=dtype,
                           image_size=image_size, generator=gen,
                           tp_degree=tp_degree).to(dev)
    if tp_degree != 1:
        raise ValueError(f"tensor parallelism splits transformer models "
                         f"{tuple(_VITS)}, not {name!r}")
    return _RESNETS[name](num_classes=num_classes, dtype=dtype,
                          generator=gen, axis_name=axis_name,
                          imagenet_stem=image_size >= 96).to(dev)
