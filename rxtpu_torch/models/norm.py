"""BatchNorm with rxtpu's statistics and rounding (counterpart of
``rxtpu/models/norm.py``), and dropout drawn from a module's own generator.

``BatchNorm`` works on [N, C] and [N, C, H, W]; state-dict names are
torch's (``weight``, ``bias``, ``running_mean``, ``running_var``).

- train: the batch statistics in one f32 pass, ``var = max(E[x^2] -
  E[x]^2, 0)`` over every axis but C; the running statistics move as
  ``m*old + (1-m)*batch`` with m = 0.9 (flax's convention), the variance
  stored UNBIASED (n/(n-1), as torch stores it); the output is
  ``(x - mean)*mul + bias`` in the input's dtype, subtracting first, with
  ``mul = weight*rsqrt(var + eps)`` in f32. Gradients flow through the batch
  statistics. ``F.batch_norm`` is not used: it reduces differently.
- eval: ``x*mul + add`` with ``mul``, ``add`` from the running statistics
  in f32, applied in the input's dtype (the form the BN fold consumes).

An f64 input keeps its statistics in f64, so a whole step can run in f64
as a reference for the f32 ones.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        dtype = x.dtype
        sdt = torch.promote_types(dtype, torch.float32)  # f32, or f64 for f64 input
        if not self.training:
            mul = self.weight.to(sdt) * torch.rsqrt(self.running_var.to(sdt) + self.eps)
            add = self.bias.to(sdt) - self.running_mean.to(sdt) * mul
            return x * mul.to(dtype).view(shape) + add.to(dtype).view(shape)
        dims = [0] + list(range(2, x.ndim))
        xf = x.to(sdt)
        mean = xf.mean(dims)
        var = torch.clamp(xf.square().mean(dims) - mean.square(), min=0.0)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            unbiased = var * (n / max(n - 1, 1))
            self.running_var.copy_(m * self.running_var + (1.0 - m) * unbiased)
        mul = self.weight.to(sdt) * torch.rsqrt(var + self.eps)
        return ((x - mean.to(dtype).view(shape)) * mul.to(dtype).view(shape)
                + self.bias.to(dtype).view(shape))


class Dropout(nn.Module):
    """flax's dropout: keep with probability 1 - rate, scale kept values by
    1/(1 - rate). The mask comes from ``self.generator`` (set by the train
    step per step; None = torch's default generator) on the input's device."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))
