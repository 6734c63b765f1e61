from rxtpu_torch.models.heads import MLPHead
from rxtpu_torch.models.norm import BatchNorm, Dropout
from rxtpu_torch.models.resnet import (
    BottleneckBlock, ResNet, ResNetBlock, compute_dtype, init_weights, make_backbone,
)
from rxtpu_torch.models.twosites import DummyClassifier, TwoSitesNN

__all__ = [
    "BatchNorm", "BottleneckBlock", "Dropout", "DummyClassifier", "MLPHead", "ResNet",
    "ResNetBlock", "TwoSitesNN", "compute_dtype", "init_weights", "make_backbone",
]
