"""Model registry by name (counterpart of the JAX package's registry).

Ported: ResNet-18 / CIFAR-100, the reference's only model, and the ViTs
(``vit_b16``, ``vit_tiny``) of the sequence-parallel slice. ResNet-50
raises ``NotImplementedError`` naming the slice of the port that will
bring it.
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device
from .resnet import ResNet18
from .vit import ViT_B16, ViT_Tiny

_LATER = {
    "resnet50": "the models slice (ResNet-50 with the ImageNet stem)",
}

_VITS = {"vit_b16": ViT_B16, "vit_tiny": ViT_Tiny}

MODEL_NAMES = ("resnet18", "vit_b16", "vit_tiny")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def get_model(name: str, num_classes: int = 100,
              dtype: str | torch.dtype = torch.bfloat16,
              image_size: int = 32, device: str | torch.device = "cuda",
              seed: int = 0, axis_name: str | None = None
              ) -> torch.nn.Module:
    """Build a model by registry name on ``device``, its weights drawn from
    a ``torch.Generator`` seeded with ``seed``. ``axis_name`` selects
    cross-replica BatchNorm over the mesh slots, as in the JAX model (ViTs
    ignore it: LayerNorm needs no sync). A ViT's position embedding is
    sized for ``image_size``."""
    if name in _LATER:
        raise NotImplementedError(
            f"model {name!r} is not ported yet; it comes with {_LATER[name]}")
    if name not in MODEL_NAMES:
        raise ValueError(f"unknown model {name!r}; have {MODEL_NAMES}")
    if name == "resnet18" and image_size >= 96:
        raise NotImplementedError(
            "the ImageNet stem (image_size >= 96) comes with the models "
            "slice")
    dev = resolve_device(device)
    if isinstance(dtype, str):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, "
                             f"got {dtype!r}")
        dtype = _DTYPES[dtype]
    gen = torch.Generator().manual_seed(seed)
    if name in _VITS:
        return _VITS[name](num_classes=num_classes, dtype=dtype,
                           image_size=image_size, generator=gen).to(dev)
    return ResNet18(num_classes=num_classes, dtype=dtype, generator=gen,
                    axis_name=axis_name).to(dev)
