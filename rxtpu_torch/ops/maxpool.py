"""Max pool 3x3, stride 2, pad 1 whose gradient goes to every tied maximum
(counterpart of ``rxtpu/ops/maxpool.py``), on NCHW.

The forward is ``F.max_pool2d(x, 3, 2, 1)``. The backward is rxtpu's 9-tap
rule: ``dy[i, j]`` goes to every input position of window ``(i, j)`` whose
value equals the window's maximum,

    dx[p, q] = sum over windows (i, j) holding (p, q) of dy[i, j] * (x[p, q] == y[i, j]),

as nine shifted compare-and-select taps against ``y`` and ``dy`` dilated
onto the input grid, summed in rxtpu's tap order. Where a window holds
tied maxima, each gets the whole ``dy``; torch's own backward gives it to
one. As in rxtpu, no model uses it: it was a measured dead end on the TPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _MaxPool3x3s2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = F.max_pool2d(x, 3, 2, 1)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        n, c, h, w = x.shape
        ho, wo = y.shape[2], y.shape[3]
        # y[i, j] at canvas position (1 + 2i, 1 + 2j); the tap (u, v) reads the
        # canvas from (2 - u, 2 - v), which aligns y[i, j] with x[2i-1+u, 2j-1+v]
        yd = y.new_zeros((n, c, 2 * ho + 2, 2 * wo + 2))
        yd[:, :, 1:1 + 2 * ho:2, 1:1 + 2 * wo:2] = y
        dd = dy.new_zeros((n, c, 2 * ho + 2, 2 * wo + 2))
        dd[:, :, 1:1 + 2 * ho:2, 1:1 + 2 * wo:2] = dy
        dx = torch.zeros_like(x, dtype=dy.dtype)
        for u in (0, 1, 2):
            for v in (0, 1, 2):
                ys = yd[:, :, 2 - u:2 - u + h, 2 - v:2 - v + w]
                ds = dd[:, :, 2 - u:2 - u + h, 2 - v:2 - v + w]
                dx = dx + torch.where(x == ys, ds, torch.zeros_like(ds))
        return dx


def max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """NCHW [N, C, H, W] -> [N, C, ceil(H/2), ceil(W/2)]; the gradient goes to
    every tied maximum of a window."""
    return _MaxPool3x3s2.apply(x)
