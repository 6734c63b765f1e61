"""DenseNet-121 with the 6-channel stem (counterpart of
``rxtpu/models/densenet.py``, BASELINE config 2).

DenseNet-BC: a 7x7/2 stem conv, ``bn_init``, ReLU and a 3x3/2 max pool
padded 1; four dense blocks whose layers (BN, ReLU, 1x1 conv to 4*growth
channels, BN, ReLU, 3x3 conv to growth channels) each concatenate their
output to the state on the channel axis; a transition between blocks (BN,
ReLU, 1x1 conv halving the channels, 2x2/2 average pool); then
``bn_final``, ReLU and the spatial mean in the compute dtype. As rxtpu, the
state is concatenated whole per layer, with no recompute.

NCHW, with rxtpu's module names (``conv_init``, ``bn_init``,
``block{i}_layer{j}.{BatchNorm_0,Conv_0,BatchNorm_1,Conv_1}``,
``transition{i}.{BatchNorm_0,Conv_0}``, ``bn_final``), so that
``rxtpu_torch.models.convert.from_flax`` maps weights one to one. The
``Observe`` points after the stem's ReLU and after each transition are the
identity; calibration (``ConvObserver``) records the stored segments' ranges
there (the stem's before the pool: stride 2 under a 3-wide window puts every
value in some window, so its range is the pooled one's).

``quantized=True`` is the W8A8 int8 inference variant (rxtpu's
``DenseNet._quantized``, ``QuantDenseLayer`` and ``QuantTransitionLayer``):
the state is an NHWC ``(int8, per-channel scale vector)`` pair, concatenated
on the last axis. The stem conv (``bn_init`` folded into it, ReLU, a
per-channel requantize) reads the NCHW views through K8's stem entry, the
max pool runs on int8; each pre-activation BN is a ``QuantPreNorm`` that
requantizes at its conv's ``in_scale_vec``; each layer's second BN lives in
its ``Conv_0``'s dequant; a transition's conv emits the compute dtype, is
average-pooled in it and requantized; ``bn_final`` gives f32 before the mean.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rxtpu_torch.config import NB_CHANNELS
from rxtpu_torch.models.norm import BatchNorm
from rxtpu_torch.models.quant import (
    Observe, QuantConv, QuantPreNorm, Quantized, QuantStemConv, quant_max_pool, quantize_to,
)
from rxtpu_torch.models.resnet import compute_dtype


def avg_pool_nhwc(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 average pool of an NHWC tensor, in its dtype."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class DenseLayer(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int, quantized: bool = False):
        super().__init__()
        inner = 4 * growth_rate
        if quantized:
            self.BatchNorm_0 = QuantPreNorm(in_channels)
            self.Conv_0 = QuantConv(in_channels, inner, 1, per_channel=True)
            self.Conv_1 = QuantConv(inner, growth_rate, 3, 1, 1, per_channel=True)
        else:
            self.BatchNorm_0 = BatchNorm(in_channels)
            self.Conv_0 = nn.Conv2d(in_channels, inner, 1, bias=False)
            self.BatchNorm_1 = BatchNorm(inner)
            self.Conv_1 = nn.Conv2d(inner, growth_rate, 3, 1, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Conv_0(F.relu(self.BatchNorm_0(x)))
        y = self.Conv_1(F.relu(self.BatchNorm_1(y)))
        return torch.cat([x, y], dim=1)

    def forward_quantized(self, x: Quantized) -> Quantized:
        """``(int8, svec)`` -> the same pair with the new segment appended
        (``rxtpu/models/densenet.py:60-86``): ``Conv_0`` requantizes at
        ``Conv_1``'s input scales (its ``out_scale``), ``Conv_1`` at its own."""
        q, svec = x
        z = self.BatchNorm_0(x, out_scale=self.Conv_0.in_scale_vec)
        z = self.Conv_0(z, out_scale=self.Conv_0.out_scale, relu_out=True)
        yq, s_out = self.Conv_1(z, out_scale=self.Conv_1.out_scale)
        return torch.cat([q, yq], dim=-1), torch.cat([svec, s_out])


class TransitionLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, quantized: bool = False):
        super().__init__()
        if quantized:
            self.BatchNorm_0 = QuantPreNorm(in_channels)
            self.Conv_0 = QuantConv(in_channels, out_channels, 1, per_channel=True)
        else:
            self.BatchNorm_0 = BatchNorm(in_channels)
            self.Conv_0 = nn.Conv2d(in_channels, out_channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.Conv_0(F.relu(self.BatchNorm_0(x))), 2, 2)

    def forward_quantized(self, x: Quantized, dtype: torch.dtype) -> Quantized:
        """The conv's output in ``dtype``, pooled in it (means of ints are
        not ints), requantized to the new one-segment state's scales
        (``rxtpu/models/densenet.py:89-108``)."""
        z = self.BatchNorm_0(x, out_scale=self.Conv_0.in_scale_vec)
        t = avg_pool_nhwc(self.Conv_0(z, out_dtype=dtype))
        return quantize_to(t, self.Conv_0.out_scale)


class DenseNet(nn.Module):
    """Feature extractor: [N, C, H, W] views -> [N, num_features].

    The input is cast to ``compute_dtype`` (bf16 under ``torch.autocast``).
    Quantized, the compute dtype is ``forward``'s ``dtype``, and an int8 input
    is taken as already quantized at ``conv_init.in_scale``.
    """

    def __init__(self, block_sizes: Sequence[int] = (6, 12, 24, 16), growth_rate: int = 32,
                 num_init_features: int = 64, in_channels: int = NB_CHANNELS,
                 quantized: bool = False):
        super().__init__()
        self.quantized = quantized
        if quantized:
            self.conv_init = QuantStemConv(in_channels, num_init_features, out_channel_scale=True)
        else:
            self.conv_init = nn.Conv2d(in_channels, num_init_features, 7, 2, 3, bias=False)
            self.bn_init = BatchNorm(num_init_features)
        self.stem_obs = Observe("stem_absmax")
        self.stages = []  # (layer names, transition name or None)
        features = num_init_features
        for i, n_layers in enumerate(block_sizes):
            names = []
            for j in range(n_layers):
                name = f"block{i + 1}_layer{j + 1}"
                self.add_module(name, DenseLayer(features, growth_rate, quantized))
                names.append(name)
                features += growth_rate
            transition = None
            if i != len(block_sizes) - 1:
                transition = f"transition{i + 1}"
                self.add_module(transition, TransitionLayer(features, features // 2, quantized))
                self.add_module(f"{transition}_obs", Observe(f"{transition}_absmax"))
                features //= 2
            self.stages.append((names, transition))
        self.bn_final = QuantPreNorm(features) if quantized else BatchNorm(features)
        self.num_features = features

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if self.quantized:
            return self._forward_quantized(x, dtype)
        dtype = compute_dtype(self.conv_init.weight)
        x = x.to(dtype)
        x = self.stem_obs(F.relu(self.bn_init(self.conv_init(x))))
        x = F.max_pool2d(x, 3, 2, 1)
        for names, transition in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            if transition is not None:
                x = getattr(self, f"{transition}_obs")(getattr(self, transition)(x))
        x = F.relu(self.bn_final(x))
        return x.mean(dim=(2, 3)).to(dtype)

    def _forward_quantized(self, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
        """NCHW views (bf16, or int8 at ``conv_init.in_scale``) -> features in
        ``dtype`` (``rxtpu/models/densenet.py:184-218``)."""
        if dtype is None:
            raise ValueError("the quantized backbone needs the compute dtype")
        if x.dtype != torch.int8:
            x = x.to(dtype)
        state: Tuple[torch.Tensor, torch.Tensor] = quant_max_pool(
            self.conv_init(x, out_scale=self.conv_init.out_scale, relu_out=True))
        for names, transition in self.stages:
            for name in names:
                state = getattr(self, name).forward_quantized(state)
            if transition is not None:
                state = getattr(self, transition).forward_quantized(state, dtype)
        return self.bn_final(state).mean(dim=(1, 2)).to(dtype)


def densenet121(quantized: bool = False) -> DenseNet:
    """Growth 32, blocks 6/12/24/16, 64 initial features: 1024 features."""
    return DenseNet((6, 12, 24, 16), quantized=quantized)
