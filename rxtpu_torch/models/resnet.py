"""ResNet backbones with the 6-channel microscopy stem (counterpart of
``rxtpu/models/resnet.py``).

NCHW, PyTorch's habit, where rxtpu is NHWC. Module names follow rxtpu's
parameter tree (``conv_init``/``bn_init``, ``stage{i}_block{j}`` with
``Conv_k``/``BatchNorm_k``, ``conv_proj``/``norm_proj``) so that
``rxtpu_torch.models.convert.from_flax`` maps weights one to one.

Eval only in this slice: the BatchNorm here applies its running statistics
as rxtpu's eval BN does (``rxtpu/models/norm.py:123-127``) and refuses train
mode. ``folded=True`` is the inference variant that consumes BN-folded
weights (``rxtpu_torch.infer.fold``): convs carry a bias, norms are gone.
The 3x3 convs pad (1,1) explicitly, the stem is a 7x7/2 conv padded 3, then
a 3x3/2 max pool padded 1, and features are the global mean.
"""

from __future__ import annotations

from typing import Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from rxtpu_torch.config import NB_CHANNELS


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm with rxtpu's rounding form ``x*mul + add``.

    ``mul = weight * rsqrt(var + eps)`` and ``add = bias - mean * mul`` are
    computed in f32 and applied in the input's dtype. Works on [N, C] and
    [N, C, H, W]. State-dict names are torch's (``weight``, ``bias``,
    ``running_mean``, ``running_var``).
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm is not ported yet; call .eval()")
        mul = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        add = self.bias.float() - self.running_mean.float() * mul
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return x * mul.to(x.dtype).view(shape) + add.to(x.dtype).view(shape)


def _norm_factory(folded: bool):
    return (lambda c: nn.Identity()) if folded else BatchNorm


class ResNetBlock(nn.Module):
    """Basic 3x3 + 3x3 residual block (resnet18/34)."""

    expansion = 1

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 folded: bool = False):
        super().__init__()
        norm = _norm_factory(folded)
        self.Conv_0 = nn.Conv2d(in_channels, filters, 3, stride, 1, bias=folded)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = nn.Conv2d(filters, filters, 3, 1, 1, bias=folded)
        self.BatchNorm_1 = norm(filters)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or in_channels != filters:
            self.conv_proj = nn.Conv2d(in_channels, filters, 1, stride, bias=folded)
            self.norm_proj = norm(filters)
        self.out_channels = filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck block (resnet50/101/152), stride on the 3x3."""

    expansion = 4

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 folded: bool = False):
        super().__init__()
        norm = _norm_factory(folded)
        out = filters * 4
        self.Conv_0 = nn.Conv2d(in_channels, filters, 1, bias=folded)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = nn.Conv2d(filters, filters, 3, stride, 1, bias=folded)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = nn.Conv2d(filters, out, 1, bias=folded)
        self.BatchNorm_2 = norm(out)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or in_channels != out:
            self.conv_proj = nn.Conv2d(in_channels, out, 1, stride, bias=folded)
            self.norm_proj = norm(out)
        self.out_channels = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """Feature extractor: stem + 4 stages + global mean pool -> [N, F].

    The input is cast to the parameters' dtype, so ``.to(torch.bfloat16)``
    gives rxtpu's bf16 compute.
    """

    def __init__(self, stage_sizes: Sequence[int], block_cls: Type[nn.Module],
                 num_filters: int = 64, in_channels: int = NB_CHANNELS,
                 folded: bool = False):
        super().__init__()
        self.conv_init = nn.Conv2d(in_channels, num_filters, 7, 2, 3, bias=folded)
        self.bn_init = _norm_factory(folded)(num_filters)
        self.block_names = []
        channels = num_filters
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                block = block_cls(channels, num_filters * 2**i, stride, folded)
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, block)
                self.block_names.append(name)
                channels = block.out_channels
        self.num_features = channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.conv_init.weight.dtype)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


_ARCHS = {
    "resnet18": ([2, 2, 2, 2], ResNetBlock),
    "resnet34": ([3, 4, 6, 3], ResNetBlock),
    "resnet50": ([3, 4, 6, 3], BottleneckBlock),
    "resnet101": ([3, 4, 23, 3], BottleneckBlock),
    "resnet152": ([3, 8, 36, 3], BottleneckBlock),
}

def make_backbone(arch: str, folded: bool = False) -> ResNet:
    if arch not in _ARCHS:
        raise ValueError(
            f"backbone {arch!r} is not ported (ported: {sorted(_ARCHS)})")
    stage_sizes, block_cls = _ARCHS[arch]
    return ResNet(stage_sizes, block_cls, folded=folded)
