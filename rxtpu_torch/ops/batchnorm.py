"""Train-mode BatchNorm with one statistics pass and a one-pass backward
(counterpart of ``rxtpu/ops/batchnorm.py``), on the port's NCHW layout
(channel axis 1, as ``rxtpu_torch.models.norm``).

``batch_stats_one_pass`` takes ``(mean, var)`` from the sums of ``x`` and
``x*x`` in f32 (biased variance). ``bn_train_apply`` normalizes with them and
returns ``(y, mean, var)``; its backward is rxtpu's textbook BN gradient from
the two sums ``Σdy`` and ``Σdy·x̂``:

    dx = gamma * r * (dy - (Σdy + x̂ * Σ(dy·x̂)) / n),   r = rsqrt(var + eps)

formed as rxtpu forms it (``rg*dy + c2*x + c0`` with per-channel ``c2``,
``c0``). ``mean`` and ``var`` are outputs for the running statistics only:
they take no gradient.

``FusedBatchNorm`` keeps rxtpu's semantics, which are flax's and differ
from ``models/norm.py``: momentum 0.99 (``ra = m*ra + (1-m)*batch``), the
biased batch variance in the running variance, and ``use_running_average``
set on the module or per call (not both). As in rxtpu, no model uses it:
it was a measured dead end on the TPU and stays for experiments.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn


def _dims(x: torch.Tensor) -> List[int]:
    return [d for d in range(x.ndim) if d != 1]


def _channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``[C]`` vector shaped to broadcast over ``x``'s axis 1."""
    return v.reshape((1, -1) + (1,) * (x.ndim - 2))


def batch_stats_one_pass(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) f32 ``[C]`` over every axis but 1, from the sums of ``x``
    and ``x*x``: the biased variance ``E[x²] - E[x]²``."""
    xf = x.to(torch.float32)
    dims = _dims(x)
    n = x.numel() // x.shape[1]
    mean = xf.sum(dims) / n
    var = (xf * xf).sum(dims) / n - mean * mean
    return mean, var


class _BNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        mean, var = batch_stats_one_pass(x)
        r = torch.rsqrt(var + eps)
        # scale-shift form: y = x*a + b with per-channel a, b
        a = r * gamma
        b = beta - mean * a
        y = (x.to(torch.float32) * _channel(a, x) + _channel(b, x)).to(x.dtype)
        ctx.save_for_backward(x, gamma, mean, r)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, r = ctx.saved_tensors
        dims = _dims(x)
        inv_n = 1.0 / (x.numel() // x.shape[1])
        dyf, xf = dy.to(torch.float32), x.to(torch.float32)
        mu_r = mean * r
        s1 = dyf.sum(dims)
        s2 = (dyf * (xf * _channel(r, x) - _channel(mu_r, x))).sum(dims)
        rg = gamma * r
        c2 = -(rg * r) * (s2 * inv_n)
        c0 = -(rg * (s1 * inv_n)) - c2 * mean
        dx = (_channel(rg, x) * dyf + _channel(c2, x) * xf + _channel(c0, x)).to(x.dtype)
        return dx, s2, s1, None


def bn_train_apply(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BN of ``x`` [N, C, ...] with f32 ``gamma``/``beta`` [C] ->
    ``(y, mean, var)``; ``y`` in ``x``'s dtype, the statistics f32 and
    without gradient."""
    return _BNTrain.apply(x, gamma, beta, eps)


class FusedBatchNorm(nn.Module):
    """rxtpu's ``FusedBatchNorm`` on NCHW: parameters ``weight`` / ``bias``
    (rxtpu's ``scale`` / ``bias``) and buffers ``running_mean`` /
    ``running_var`` (its ``mean`` / ``var``), f32. In training
    (``use_running_average`` false) it normalizes with ``bn_train_apply`` and
    moves the running statistics by ``momentum`` (0.99) toward the batch's
    mean and biased variance; otherwise it normalizes with them."""

    def __init__(self, num_features: int, use_running_average: Optional[bool] = None,
                 momentum: float = 0.99, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.use_running_average = use_running_average
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        if (self.use_running_average is None) == (use_running_average is None):
            raise ValueError("use_running_average must be set on the module or in the call, "
                             "exactly once")
        use_ra = self.use_running_average if use_running_average is None \
            else use_running_average
        out_dtype = self.dtype or x.dtype
        if use_ra:
            r = torch.rsqrt(self.running_var + self.eps)
            y = ((x.to(torch.float32) - _channel(self.running_mean, x))
                 * _channel(r * self.weight, x) + _channel(self.bias, x))
            return y.to(out_dtype)
        y, mean, var = bn_train_apply(x, self.weight, self.bias, self.eps)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        return y.to(out_dtype)
