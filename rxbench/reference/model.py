"""Plain PyTorch reference of the benchmark's models, in float32.

``TwoSites`` over a ResNet-50 (He et al., arXiv:1512.03385) or DenseNet-121
(Huang et al., arXiv:1608.06993) backbone with a 6-channel stem, and an MLP
or ArcFace (Deng et al., arXiv:1801.07698) head, written from the published
descriptions and rxtpu's model layout: nothing here imports the program.
Module names follow rxtpu's parameter tree, so a state dict maps one to one
onto the program's model and the benchmark hands both the same weights.

BatchNorm has three modes: ``train`` (batch statistics, biased variance,
running statistics untouched: the comparison reads parameters only),
``eval`` (running statistics) and ``calibrate`` (batch statistics, each
variance raised to at least a tenth of its layer's median, written into the
running statistics and used as in eval: how the benchmark gives a predict
cell's random model sound statistics). Dropout draws its mask as
the program's step does: ``torch.rand`` of the batch's shape from the step's
generator, kept below ``1 - rate``.

``quant`` (a ``Float8``, or None) rounds every conv and linear: the
control computes through it in float8, as the program computes in bf16
under autocast.
``checkpoint=True`` recomputes each block in the backward, so the float32
step at the timed batch fits on the card.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint as _checkpoint

# calibrated running variances are at least this share of their layer's
# median: a channel that happened to be constant over the calibration batch
# would otherwise scale every later input by up to 1/sqrt(eps)
VAR_FLOOR = 0.1
# the last BN of each residual branch starts at a tenth of the others' scale,
# where rxtpu starts it at zero: every leaf learns, and the random net's
# sensitivity to rounding stays near a trained one's
BRANCH_END, BRANCH_SCALE = "BatchNorm_2.weight", 0.1


class Ctx:
    """What every layer reads: the BN mode, the float8 rounding, the
    dropout generator."""

    def __init__(self):
        self.bn_mode = "train"
        self.quant: Optional["Float8"] = None
        self.generator: Optional[torch.Generator] = None


class BN(nn.Module):
    def __init__(self, ctx: Ctx, n: int, eps: float = 1e-5):
        super().__init__()
        self.ctx, self.eps = ctx, eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        dims = [0] + list(range(2, x.ndim))
        mode = self.ctx.bn_mode
        if mode == "eval":
            mean, var = self.running_mean, self.running_var
        else:
            mean = x.mean(dims)
            var = (x - mean.view(shape)).square().mean(dims)
            if mode == "calibrate":
                with torch.no_grad():
                    self.running_mean.copy_(mean)
                    self.running_var.copy_(torch.maximum(var, VAR_FLOOR * var.median()))
                mean, var = self.running_mean, self.running_var
        return ((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
                * self.weight.view(shape) + self.bias.view(shape))


class Conv(nn.Conv2d):
    def __init__(self, ctx: Ctx, cin: int, cout: int, k: int, stride: int = 1, pad: int = 0):
        super().__init__(cin, cout, k, stride, pad, bias=False)
        self.ctx = ctx

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.ctx.quant
        if q is None:
            return super().forward(x)
        return q.output(self._conv_forward(q.operand(x), q.operand(self.weight), None))


class Linear(nn.Linear):
    def __init__(self, ctx: Ctx, cin: int, cout: int):
        super().__init__(cin, cout)
        self.ctx = ctx

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.ctx.quant
        if q is None:
            return super().forward(x)
        return q.output(F.linear(q.operand(x), q.operand(self.weight), self.bias))


class Dropout(nn.Module):
    def __init__(self, ctx: Ctx, rate: float):
        super().__init__()
        self.ctx, self.rate = ctx, rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.ctx.bn_mode != "train" or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        u = torch.rand(x.shape, generator=self.ctx.generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _maybe_checkpoint(fn, x, on: bool):
    if on and torch.is_grad_enabled():
        return _checkpoint(fn, x, use_reentrant=False)
    return fn(x)


class Bottleneck(nn.Module):
    def __init__(self, ctx: Ctx, cin: int, f: int, stride: int):
        super().__init__()
        self.Conv_0, self.BatchNorm_0 = Conv(ctx, cin, f, 1), BN(ctx, f)
        self.Conv_1, self.BatchNorm_1 = Conv(ctx, f, f, 3, stride, 1), BN(ctx, f)
        self.Conv_2, self.BatchNorm_2 = Conv(ctx, f, 4 * f, 1), BN(ctx, 4 * f)
        self.proj = stride != 1 or cin != 4 * f
        if self.proj:
            self.conv_proj, self.norm_proj = Conv(ctx, cin, 4 * f, 1, stride), BN(ctx, 4 * f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        r = self.norm_proj(self.conv_proj(x)) if self.proj else x
        return F.relu(r + y)


class ResNet50(nn.Module):
    stages = (3, 4, 6, 3)

    def __init__(self, ctx: Ctx, in_channels: int = 6, checkpoint: bool = False):
        super().__init__()
        self.checkpoint = checkpoint
        self.conv_init, self.bn_init = Conv(ctx, in_channels, 64, 7, 2, 3), BN(ctx, 64)
        self.blocks: List[str] = []
        c = 64
        for i, n in enumerate(self.stages):
            for j in range(n):
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, Bottleneck(ctx, c, 64 * 2 ** i, 2 if i and not j else 1))
                self.blocks.append(name)
                c = 4 * 64 * 2 ** i
        self.num_features = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _maybe_checkpoint(
            lambda t: F.max_pool2d(F.relu(self.bn_init(self.conv_init(t))), 3, 2, 1),
            x, self.checkpoint)
        for name in self.blocks:
            x = _maybe_checkpoint(getattr(self, name), x, self.checkpoint)
        return x.mean(dim=(2, 3))


class DenseLayer(nn.Module):
    def __init__(self, ctx: Ctx, cin: int, growth: int):
        super().__init__()
        self.BatchNorm_0, self.Conv_0 = BN(ctx, cin), Conv(ctx, cin, 4 * growth, 1)
        self.BatchNorm_1 = BN(ctx, 4 * growth)
        self.Conv_1 = Conv(ctx, 4 * growth, growth, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Conv_1(F.relu(self.BatchNorm_1(self.Conv_0(F.relu(self.BatchNorm_0(x))))))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, ctx: Ctx, cin: int, cout: int):
        super().__init__()
        self.BatchNorm_0, self.Conv_0 = BN(ctx, cin), Conv(ctx, cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.Conv_0(F.relu(self.BatchNorm_0(x))), 2, 2)


class DenseNet121(nn.Module):
    blocks_per_stage, growth = (6, 12, 24, 16), 32

    def __init__(self, ctx: Ctx, in_channels: int = 6, checkpoint: bool = False):
        super().__init__()
        self.checkpoint = checkpoint
        self.conv_init, self.bn_init = Conv(ctx, in_channels, 64, 7, 2, 3), BN(ctx, 64)
        self.order: List[str] = []
        c = 64
        for i, n in enumerate(self.blocks_per_stage):
            for j in range(n):
                name = f"block{i + 1}_layer{j + 1}"
                self.add_module(name, DenseLayer(ctx, c, self.growth))
                self.order.append(name)
                c += self.growth
            if i != len(self.blocks_per_stage) - 1:
                name = f"transition{i + 1}"
                self.add_module(name, Transition(ctx, c, c // 2))
                self.order.append(name)
                c //= 2
        self.bn_final = BN(ctx, c)
        self.num_features = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _maybe_checkpoint(
            lambda t: F.max_pool2d(F.relu(self.bn_init(self.conv_init(t))), 3, 2, 1),
            x, self.checkpoint)
        for name in self.order:
            x = _maybe_checkpoint(getattr(self, name), x, self.checkpoint)
        return F.relu(self.bn_final(x)).mean(dim=(2, 3))


class MLPHead(nn.Module):
    def __init__(self, ctx: Ctx, cin: int, classes: int, features: int, dropout: float):
        super().__init__()
        self.bn1, self.bn2 = BN(ctx, cin), BN(ctx, features)
        self.drop = Dropout(ctx, dropout)
        self.fc1, self.fc2 = Linear(ctx, cin, features), Linear(ctx, features, classes)

    def forward(self, x: torch.Tensor, labels=None) -> torch.Tensor:
        x = F.relu(self.fc1(self.drop(self.bn1(x))))
        return self.fc2(self.drop(self.bn2(x)))


class ArcFaceHead(nn.Module):
    def __init__(self, ctx: Ctx, cin: int, classes: int, features: int, dropout: float,
                 margin: float, scale: float):
        super().__init__()
        self.ctx, self.margin, self.scale = ctx, margin, scale
        self.bn1, self.bn2 = BN(ctx, cin), BN(ctx, features)
        self.drop = Dropout(ctx, dropout)
        self.fc1 = Linear(ctx, cin, features)
        self.weight = nn.Parameter(torch.empty(features, classes))

    def forward(self, x: torch.Tensor, labels=None) -> torch.Tensor:
        emb = self.bn2(F.relu(self.fc1(self.drop(self.bn1(x)))))
        emb_n = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-12)
        w_n = self.weight / (torch.linalg.vector_norm(self.weight, dim=0, keepdim=True) + 1e-12)
        cos = torch.clamp(emb_n @ w_n, -1.0 + 1e-7, 1.0 - 1e-7)
        if labels is None or self.ctx.bn_mode != "train":
            return self.scale * cos
        target = torch.cos(torch.arccos(cos) + self.margin)
        onehot = F.one_hot(labels.long(), cos.shape[-1]).to(cos.dtype)
        return self.scale * (onehot * target + (1.0 - onehot) * cos)


class TwoSites(nn.Module):
    """Views [B, G, C, H, W] -> logits [B, classes]: one backbone pass over
    the B*G views, features averaged over each third of G (image, negative
    control, positive control), concatenated for the head."""

    def __init__(self, cfg: dict, checkpoint: bool = False):
        super().__init__()
        self.ctx = Ctx()
        backbones = {"resnet50": ResNet50, "densenet121": DenseNet121}
        self.backbone = backbones[cfg["backbone"]](self.ctx, cfg["in_channels"], checkpoint)
        cin = 3 * self.backbone.num_features
        if cfg["head"] == "arcface":
            self.head = ArcFaceHead(self.ctx, cin, cfg["nb_classes"], cfg["size_features"],
                                    cfg["dropout"], cfg["arcface_margin"], cfg["arcface_scale"])
        else:
            self.head = MLPHead(self.ctx, cin, cfg["nb_classes"], cfg["size_features"],
                                cfg["dropout"])

    def forward(self, views: torch.Tensor, labels=None) -> torch.Tensor:
        b, g = views.shape[:2]
        feats = self.backbone(views.reshape((b * g,) + tuple(views.shape[2:])))
        grouped = feats.reshape(b, 3, g // 3, -1).mean(dim=2).reshape(b, -1)
        return self.head(grouped, labels)


def _float8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` at a per-tensor scale that maps its largest
    magnitude to ``top``, and back."""
    scale = top / x.abs().amax().clamp(min=1e-30)
    return ((x * scale).to(dtype).to(x.dtype) / scale).nan_to_num(0.0)


class _E4M3(torch.autograd.Function):
    """float8 e4m3 on the way forward; the gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        return _float8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return g


class _E5M2Grad(torch.autograd.Function):
    """Unchanged on the way forward; the gradient in float8 e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _float8(g, torch.float8_e5m2, 57344.0)


class Float8:
    """float8 training as H100 recipes compute a conv or linear: inputs and
    weights in e4m3, the gradient of the output in e5m2, each at a
    per-tensor scale; products accumulate in float32 and outputs are not
    rounded."""

    operand = staticmethod(_E4M3.apply)
    output = staticmethod(_E5M2Grad.apply)


def weight_std(name: str, shape) -> float:
    """The benchmark's spread for a leaf of unit-normal draws: He over the
    fan-in for conv kernels, LeCun over the fan-in for linear weights (the
    ArcFace class weights over their rows), 0.1 around one for BN scales
    and 0.1 for BN shifts and linear biases."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 4:
        return math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
    if len(shape) == 2:
        return math.sqrt(1.0 / (shape[0] if name == "head.weight" else shape[1]))
    if leaf in ("weight", "bias"):
        return 0.1
    raise ValueError(f"no spread for {name} {tuple(shape)}")


@torch.no_grad()
def seeded_state(model: nn.Module, seed: int, device) -> dict:
    """Float32 parameters for every leaf of ``model`` from ``seed``: one
    normal draw on ``device`` for all of them, cut in state-dict order and
    scaled by ``weight_std``; BN scales are 1 + 0.1 N (a tenth of that at
    the end of a residual branch), running statistics zero and one. Returns a state dict (shared by program and reference)."""
    sd = model.state_dict()
    params = {n: t for n, t in sd.items() if not n.endswith(("running_mean", "running_var"))}
    total = sum(t.numel() for t in params.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for n, t in sd.items():
        if n.endswith("running_mean"):
            out[n] = torch.zeros(t.shape, device=device)
            continue
        if n.endswith("running_var"):
            out[n] = torch.ones(t.shape, device=device)
            continue
        v = flat[at:at + t.numel()].view(t.shape) * weight_std(n, t.shape)
        at += t.numel()
        if t.ndim == 1 and n.endswith("weight"):  # a BN scale
            v = v + 1.0
            if n.endswith(BRANCH_END):
                v = v * BRANCH_SCALE
        out[n] = v
    return out
