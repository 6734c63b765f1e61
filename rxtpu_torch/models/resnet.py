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
``stem_input=True`` takes the stem's output (the fused stem kernel K5,
``rxtpu_torch.ops.fused_stem``) and skips the stem's ops; ``conv_init`` and
``bn_init`` stay in the state dict, so checkpoints and folding map as before.
``quantized=True`` is the W8A8 int8 inference variant
(``rxtpu/models/resnet.py:164-281`` with ``quantized``): every conv is a
``QuantConv`` (``rxtpu_torch.models.quant``) on the int8 weights of
``rxtpu_torch.infer.quant.prepare_quantized``, the stem a ``QuantStemConv``
that reads the NCHW views, activations stay int8 and NHWC from the stem's
output on, each conv's epilogue requantizes to the next conv's
``in_scale``, and the last block emits the ``dtype`` the caller passes (the
head's) before the global mean.
``fuse_blocks=True`` runs, in train mode, each run of consecutive stride-1
bottleneck blocks through the fused kernels K6/K7
(``rxtpu_torch.models.fused``) on a channels-last bf16 ``[N, H*W, C]``
slab, converted once at the start of the run and back at its end
(``rxtpu/models/resnet.py:250-291``); strided and basic blocks, and eval
mode, keep the standard composition.

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
and bias zero, and a zero scale on each residual block's last BN.
``make_backbone("densenet121")`` is ``rxtpu_torch.models.densenet``'s.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from rxtpu_torch.config import NB_CHANNELS
from rxtpu_torch.models.fused import fused_bottleneck
from rxtpu_torch.models.norm import BatchNorm
from rxtpu_torch.models.quant import QuantConv, QuantStemConv, quant_max_pool


def compute_dtype(param: torch.Tensor) -> torch.dtype:
    """The dtype a module computes in: autocast's when it is on, else its
    parameters'."""
    device = param.device.type
    if torch.is_autocast_enabled(device):
        return torch.get_autocast_dtype(device)
    return param.dtype


def _norm_factory(folded: bool):
    return (lambda c: nn.Identity()) if folded else BatchNorm


def _conv_factory(folded: bool, quantized: bool):
    """(in, out, kernel, stride, padding) -> the block's conv: a ``QuantConv``
    when quantized, else an ``nn.Conv2d`` with a bias when folded."""
    if quantized:
        return QuantConv
    return lambda cin, cout, k, stride=1, pad=0: nn.Conv2d(cin, cout, k, stride, pad,
                                                           bias=folded)


class ResNetBlock(nn.Module):
    """Basic 3x3 + 3x3 residual block (resnet18/34)."""

    expansion = 1

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 folded: bool = False, quantized: bool = False):
        super().__init__()
        norm = _norm_factory(folded or quantized)
        conv = _conv_factory(folded, quantized)
        self.Conv_0 = conv(in_channels, filters, 3, stride, 1)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3, 1, 1)
        self.BatchNorm_1 = norm(filters)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or in_channels != filters:
            self.conv_proj = conv(in_channels, filters, 1, stride)
            self.norm_proj = norm(filters)
        self.out_channels = filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)

    def forward_quantized(self, x, out_scale, dtype):
        """``(int8, scale)`` in, ``(int8, out_scale)`` out, or ``dtype`` when
        ``out_scale`` is None (``rxtpu/models/resnet.py:44-61``)."""
        y = self.Conv_0(x, out_scale=self.Conv_1.in_scale, relu_out=True)
        residual = x
        if self.conv_proj is not None:
            residual = self.conv_proj(x, out_scale=self.conv_proj.out_scale)
        return self.Conv_1(y, out_scale=out_scale, relu_out=True, residual=residual,
                           out_dtype=dtype)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck block (resnet50/101/152), stride on the 3x3."""

    expansion = 4

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 folded: bool = False, quantized: bool = False):
        super().__init__()
        norm = _norm_factory(folded or quantized)
        conv = _conv_factory(folded, quantized)
        out = filters * 4
        self.Conv_0 = conv(in_channels, filters, 1)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3, stride, 1)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, out, 1)
        self.BatchNorm_2 = norm(out)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or in_channels != out:
            self.conv_proj = conv(in_channels, out, 1, stride)
            self.norm_proj = norm(out)
        self.out_channels = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)

    def forward_quantized(self, x, out_scale, dtype):
        """As ``ResNetBlock.forward_quantized`` (``rxtpu/models/resnet.py:88-106``)."""
        y = self.Conv_0(x, out_scale=self.Conv_1.in_scale, relu_out=True)
        y = self.Conv_1(y, out_scale=self.Conv_2.in_scale, relu_out=True)
        residual = x
        if self.conv_proj is not None:
            residual = self.conv_proj(x, out_scale=self.conv_proj.out_scale)
        return self.Conv_2(y, out_scale=out_scale, relu_out=True, residual=residual,
                           out_dtype=dtype)


class ResNet(nn.Module):
    """Feature extractor: stem + 4 stages + global mean pool -> [N, F].

    The input is cast to ``compute_dtype``: bf16 under ``torch.autocast``
    (f32 parameters) or after ``.to(torch.bfloat16)`` (the folded twin).
    Quantized, the compute dtype is ``forward``'s ``dtype`` (the int8
    buffers have none; ``TwoSitesNN`` passes its head's), and an int8 input
    is taken as already quantized at ``conv_init.in_scale``.
    """

    def __init__(self, stage_sizes: Sequence[int], block_cls: Type[nn.Module],
                 num_filters: int = 64, in_channels: int = NB_CHANNELS,
                 folded: bool = False, stem_input: bool = False,
                 fuse_blocks: bool = False, quantized: bool = False):
        super().__init__()
        self.stem_input = stem_input
        self.fuse_blocks = fuse_blocks
        self.quantized = quantized
        if quantized:
            self.conv_init = QuantStemConv(in_channels, num_filters)
        else:
            self.conv_init = _conv_factory(folded, quantized)(in_channels, num_filters, 7, 2, 3)
        self.bn_init = _norm_factory(folded or quantized)(num_filters)
        self.block_names = []
        channels = num_filters
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                block = block_cls(channels, num_filters * 2**i, stride, folded, quantized)
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, block)
                self.block_names.append(name)
                channels = block.out_channels
        self.num_features = channels

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if self.quantized:
            return self._forward_quantized(x, dtype)
        x = x.to(compute_dtype(self.conv_init.weight))
        if not self.stem_input:
            x = F.relu(self.bn_init(self.conv_init(x)))
            x = F.max_pool2d(x, 3, 2, 1)
        fuse = self.fuse_blocks and self.training
        flat = None  # x as [N, H*W, C] bf16 inside a run of fused blocks
        for name in self.block_names:
            block = getattr(self, name)
            if fuse and isinstance(block, BottleneckBlock) and block.Conv_1.stride == (1, 1):
                if flat is None:
                    n, c, h, w = x.shape
                    dtype = x.dtype
                    flat = x.permute(0, 2, 3, 1).reshape(n, h * w, c).to(torch.bfloat16)
                flat = fused_bottleneck(block, flat, h, w)
                continue
            if flat is not None:
                x, flat = _to_nchw(flat, h, w, dtype), None
            x = block(x)
        if flat is not None:
            x = _to_nchw(flat, h, w, dtype)
        return x.mean(dim=(2, 3))

    def _forward_quantized(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """NCHW views (bf16, or int8 at ``conv_init.in_scale``) -> features in
        ``dtype``: the stem conv (ReLU, requantized to the first block's
        scale), the int8 max pool, then blocks that each requantize to the next
        block's ``Conv_0.in_scale``; the last emits ``dtype``."""
        if dtype is None:
            raise ValueError("the quantized backbone needs the compute dtype")
        blocks = [getattr(self, name) for name in self.block_names]
        if x.dtype != torch.int8:
            x = x.to(dtype)
        # the stem reads the NCHW views (quantizing float ones); NHWC from its output on
        x = self.conv_init(x, out_scale=blocks[0].Conv_0.in_scale, relu_out=True)
        x = quant_max_pool(x)
        for k, block in enumerate(blocks):
            nxt = blocks[k + 1].Conv_0.in_scale if k + 1 < len(blocks) else None
            x = block.forward_quantized(x, nxt, dtype)
        return x.mean(dim=(1, 2)).to(dtype)


def _to_nchw(flat: torch.Tensor, height: int, width: int, dtype: torch.dtype) -> torch.Tensor:
    n, _, c = flat.shape
    return flat.reshape(n, height, width, c).permute(0, 3, 1, 2).to(dtype).contiguous()


_ARCHS = {
    "resnet18": ([2, 2, 2, 2], ResNetBlock),
    "resnet34": ([3, 4, 6, 3], ResNetBlock),
    "resnet50": ([3, 4, 6, 3], BottleneckBlock),
    "resnet101": ([3, 4, 23, 3], BottleneckBlock),
    "resnet152": ([3, 8, 36, 3], BottleneckBlock),
}


def make_backbone(arch: str, folded: bool = False, stem_input: bool = False,
                  fuse_blocks: bool = False, quantized: bool = False) -> nn.Module:
    """A ResNet, or DenseNet-121 (``rxtpu/models/resnet.py:337-345``): its
    ``fuse_blocks`` is dropped (bottleneck fusion is ResNet's) and
    ``folded`` or ``stem_input`` raise ``ValueError`` (BN folding and the
    fused stem are ResNet's)."""
    if arch == "densenet121":
        from rxtpu_torch.models.densenet import densenet121

        if folded:
            raise ValueError("densenet121 does not support BN folding")
        if stem_input:
            raise ValueError("densenet121 does not support the fused stem")
        return densenet121(quantized=quantized)
    if arch not in _ARCHS:
        raise ValueError(f"unknown backbone {arch!r}")
    stage_sizes, block_cls = _ARCHS[arch]
    return ResNet(stage_sizes, block_cls, folded=folded, stem_input=stem_input,
                  fuse_blocks=fuse_blocks, quantized=quantized)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """rxtpu's initial distributions, in place, from ``generator`` (CPU).

    Convs: normal with std sqrt(2 / fan_out) (``rxtpu/models/resnet.py:179``,
    ``rxtpu/models/densenet.py:136-139``); linears: flax's default, LeCun
    truncated normal (std sqrt(1 / fan_in) / 0.8796, cut at two std) and
    zero biases (``rxtpu/models/heads.py:35``); the ArcFace head's class
    weights its own way (``ArcFaceHead.init_weight_``); BN: scale one, bias
    zero, running mean zero and variance one, except the last BN of each
    residual branch, whose scale starts at zero
    (``rxtpu/models/resnet.py:74,122``; DenseNet has none such).
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
        elif hasattr(mod, "init_weight_"):
            mod.init_weight_(generator)
    for mod in model.modules():
        if isinstance(mod, BottleneckBlock) and isinstance(mod.BatchNorm_2, BatchNorm):
            mod.BatchNorm_2.weight.zero_()
        elif isinstance(mod, ResNetBlock) and isinstance(mod.BatchNorm_1, BatchNorm):
            mod.BatchNorm_1.weight.zero_()
    return model
