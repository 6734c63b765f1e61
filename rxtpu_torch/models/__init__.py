from rxtpu_torch.models.heads import MLPHead
from rxtpu_torch.models.resnet import (
    BatchNorm, BottleneckBlock, ResNet, ResNetBlock, make_backbone,
)
from rxtpu_torch.models.twosites import TwoSitesNN

__all__ = [
    "BatchNorm", "BottleneckBlock", "MLPHead", "ResNet", "ResNetBlock", "TwoSitesNN",
    "make_backbone",
]
