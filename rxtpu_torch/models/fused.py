"""The fused train-mode bottleneck on a standard block's parameters
(counterpart of ``rxtpu/models/fused.py``).

rxtpu needs a flax module of its own to recreate the block's parameter
tree; here one function reads an existing ``BottleneckBlock``: its conv
weights go to the kernels' layouts as views (so their gradients land on the
conv weights), ``BottleneckFused`` (K6 forward, K7 backward) runs the block,
and its BatchNorms' running statistics move as the unfused block's would.
The state dict is the same whether a block runs fused or not, so
checkpoints, ``from_flax``, the pretrained port, freezing and folding are
unchanged. Blocks whose BatchNorms sync over a process group (``group``, the
data ranks) take the batch statistics over every rank's rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from rxtpu_torch.ops.fused_block import bottleneck_fused, conv1x1_to_mat, conv3x3_to_taps


def fused_bottleneck(block, x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """One stride-1 ``BottleneckBlock`` in train mode on ``x [N, H*W, C]``
    (channels last, cast to bf16) -> ``[N, H*W, 4F]`` bf16.

    The running statistics move as ``m*old + (1 - m)*batch`` (m = the
    BatchNorm's momentum, 0.9), the variance stored unbiased with Bessel's
    ``n/(n-1)`` over ``n = N*H*W`` (``rxtpu/models/fused.py:139-151``),
    every rank's ``N`` with the BatchNorms' ``group``.
    """
    bns = [block.BatchNorm_0, block.BatchNorm_1, block.BatchNorm_2]
    params = {"w1": conv1x1_to_mat(block.Conv_0.weight),
              "w2": conv3x3_to_taps(block.Conv_1.weight),
              "w3": conv1x1_to_mat(block.Conv_2.weight)}
    for i, bn in enumerate(bns, 1):
        params[f"g{i}"], params[f"b{i}"] = bn.weight, bn.bias
    if block.conv_proj is not None:
        params["wp"] = conv1x1_to_mat(block.conv_proj.weight)
        params["gp"], params["bp"] = block.norm_proj.weight, block.norm_proj.bias
        bns.append(block.norm_proj)
    group = bns[0].group
    y, stats = bottleneck_fused(x, params, height, width, bns[0].eps, group)
    n = x.shape[0] * height * width * (1 if group is None else dist.get_world_size(group))
    with torch.no_grad():
        for bn, (mean, var) in zip(bns, stats.values()):
            m = bn.momentum
            bn.running_mean.copy_(m * bn.running_mean + (1.0 - m) * mean)
            bn.running_var.copy_(m * bn.running_var + (1.0 - m) * (var * (n / max(n - 1, 1))))
    return y
