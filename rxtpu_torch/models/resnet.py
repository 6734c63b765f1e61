"""ResNet backbones with the 6-channel microscopy stem (counterpart of
``rxtpu/models/resnet.py``).

NCHW, PyTorch's habit, where rxtpu is NHWC. Module names follow rxtpu's
parameter tree (``conv_init``/``bn_init``, ``stage{i}_block{j}`` with
``Conv_k``/``BatchNorm_k``, ``conv_proj``/``norm_proj``) so that
``rxtpu_torch.models.convert.from_flax`` maps weights one to one.

The BatchNorm is rxtpu's (``rxtpu_torch/models/norm.py``), in train and
eval mode. ``folded=True`` is the inference variant that consumes BN-folded
weights (``rxtpu_torch.infer.fold``): convs carry a bias, norms are gone.
The 3x3 convs pad (1,1) explicitly, the stem is a 7x7/2 conv padded 3, then
a 3x3/2 max pool padded 1, and features are the global mean.

Compute dtype: the input is cast to ``compute_dtype`` (the autocast dtype
inside ``torch.autocast``, else the parameters' dtype). bf16 training runs
f32 parameters under ``torch.autocast``: convs and linears take bf16
copies of their weights and inputs and return bf16, and the gradients land
on the f32 parameters. That is flax's ``dtype=bf16, param_dtype=f32``,
with two differences: autocast casts only the ops on its list (convs,
matmuls), so elementwise ops simply run in the dtype of what they receive
(bf16 activations here, as in flax), and a linear's bias is added inside
the bf16 matmul instead of after it. ``init_weights`` draws rxtpu's
initial distributions (not its bits): He normal over fan-out for convs,
flax's LeCun truncated normal and zero biases for linears, BN scale one
and bias zero, and a zero scale on each block's last BN.
"""

from __future__ import annotations

import math
from typing import Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from rxtpu_torch.config import NB_CHANNELS
from rxtpu_torch.models.norm import BatchNorm


def compute_dtype(param: torch.Tensor) -> torch.dtype:
    """The dtype a module computes in: autocast's when it is on, else its
    parameters'."""
    device = param.device.type
    if torch.is_autocast_enabled(device):
        return torch.get_autocast_dtype(device)
    return param.dtype


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

    The input is cast to ``compute_dtype``: bf16 under ``torch.autocast``
    (f32 parameters) or after ``.to(torch.bfloat16)`` (the folded twin).
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
        x = x.to(compute_dtype(self.conv_init.weight))
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


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """rxtpu's initial distributions, in place, from ``generator`` (CPU).

    Convs: normal with std sqrt(2 / fan_out) (``rxtpu/models/resnet.py:179``);
    linears: flax's default, LeCun truncated normal (std sqrt(1 / fan_in)
    / 0.8796, cut at two std) and zero biases (``rxtpu/models/heads.py:35``);
    BN: scale one, bias zero, running mean zero and variance one, except the
    last BN of each residual branch, whose scale starts at zero
    (``rxtpu/models/resnet.py:74,122``).
    """
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            fan_out = mod.out_channels * mod.kernel_size[0] * mod.kernel_size[1]
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator)
                             * math.sqrt(2.0 / fan_out))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            std = math.sqrt(1.0 / mod.in_features) / 0.87962566103423978
            w = torch.empty(mod.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            mod.weight.copy_(w)
            mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    for mod in model.modules():
        if isinstance(mod, BottleneckBlock) and isinstance(mod.BatchNorm_2, BatchNorm):
            mod.BatchNorm_2.weight.zero_()
        elif isinstance(mod, ResNetBlock) and isinstance(mod.BatchNorm_1, BatchNorm):
            mod.BatchNorm_1.weight.zero_()
    return model
