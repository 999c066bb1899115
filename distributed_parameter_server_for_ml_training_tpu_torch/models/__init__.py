from .registry import MODEL_NAMES, get_model
from .resnet import BasicBlock, BatchNorm, ResNet, ResNet18, count_params

__all__ = ["BasicBlock", "BatchNorm", "MODEL_NAMES", "ResNet", "ResNet18",
           "count_params", "get_model"]
