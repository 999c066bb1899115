from .registry import MODEL_NAMES, get_model
from .resnet import BasicBlock, BatchNorm, ResNet, ResNet18, count_params
from .vit import ViT, ViT_B16, ViT_Tiny

__all__ = ["BasicBlock", "BatchNorm", "MODEL_NAMES", "ResNet", "ResNet18",
           "ViT", "ViT_B16", "ViT_Tiny", "count_params", "get_model"]
