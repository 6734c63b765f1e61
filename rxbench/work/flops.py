"""Multiply-adds of the benchmark's models, counted from shapes.

Every conv and linear of the reference model is counted by a forward hook
while the model runs on the meta device (shapes only, no arithmetic):
a conv's output elements times its input channels per group times its
kernel area, a linear's rows times its weight's elements. Normalization,
activations, pooling and the ArcFace cosines are not counted.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from rxbench.reference.model import ResNet50, DenseNet121, TwoSites, Ctx

_BACKBONES = {"resnet50": ResNet50, "densenet121": DenseNet121}


def _count(module: nn.Module, run) -> int:
    total = [0]

    def hook(mod, inputs, out):
        if isinstance(mod, nn.Conv2d):
            k = mod.kernel_size[0] * mod.kernel_size[1] * mod.in_channels // mod.groups
            total[0] += out.numel() * k
        elif isinstance(mod, nn.Linear):
            total[0] += out.numel() // mod.out_features * mod.weight.numel()

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in handles:
            h.remove()
    return total[0]


@functools.lru_cache(maxsize=None)
def backbone_macs(arch: str, in_channels: int, size: int) -> int:
    """Multiply-adds of one view of ``in_channels`` x ``size``^2 through the backbone."""
    with torch.device("meta"):
        model = _BACKBONES[arch](Ctx(), in_channels)
    return _count(model, lambda: model(torch.empty(1, in_channels, size, size, device="meta")))


def head_macs(cfg: dict) -> int:
    """Multiply-adds of the head for one well."""
    with torch.device("meta"):
        model = TwoSites(cfg)
    cin = 3 * model.backbone.num_features
    if cfg["head"] == "arcface":
        return cin * cfg["size_features"] + cfg["size_features"] * cfg["nb_classes"]
    return _count(model.head, lambda: model.head(torch.empty(2, cin, device="meta"))) // 2


def view_flops(cfg: dict, size: int, g: int, train: bool) -> float:
    """Model FLOPs of one view (2 per multiply-add; the head's share of a
    well split over its ``g`` views; a train view's forward and backward 3
    times the forward)."""
    macs = backbone_macs(cfg["backbone"], cfg["in_channels"], size) + head_macs(cfg) / g
    return 2.0 * macs * (3.0 if train else 1.0)
