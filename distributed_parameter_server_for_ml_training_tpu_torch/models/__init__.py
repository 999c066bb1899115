from .registry import MODEL_NAMES, get_model
from .resnet import (BasicBlock, BatchNorm, Bottleneck, ResNet, ResNet18,
                     ResNet50, count_params, s2d_stem_kernel)
from .vit import ViT, ViT_B16, ViT_Tiny

__all__ = ["BasicBlock", "BatchNorm", "Bottleneck", "MODEL_NAMES", "ResNet",
           "ResNet18", "ResNet50", "ViT", "ViT_B16", "ViT_Tiny",
           "count_params", "get_model", "s2d_stem_kernel"]
