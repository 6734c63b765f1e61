"""Classification heads (counterpart of ``rxtpu/models/heads.py``).

``MLPHead``: BatchNorm1d -> Dropout -> Linear -> ReLU -> BatchNorm1d ->
Dropout -> Linear over the concatenated [img, neg, pos] features, in the
compute dtype (bf16 under autocast). Dropout draws its mask from its own
generator (``rxtpu_torch.models.norm.Dropout``). With ``folded=True`` the
two BNs live inside fc1/fc2 (``rxtpu_torch.infer.fold``) and the head is two
matmuls. Logits come out in at least f32.

``ArcFaceHead`` (BASELINE config 4): BatchNorm1d -> Dropout -> Linear ->
ReLU -> BatchNorm1d to the embedding, then cosines against L2-normalised
class weights, with the additive angular margin on the target class in
train mode when labels are given.

``tp_group`` (rxtpu's ``--model-parallel``): each 2-D kernel of the head
(the MLP head's fc1 and fc2, the ArcFace head's fc1) is a
``ColumnParallelLinear`` over that process group, holding its rank's rows
of the weight once ``rxtpu_torch.parallel.place_state`` has sliced them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rxtpu_torch.models.norm import BatchNorm, Dropout
from rxtpu_torch.models.resnet import compute_dtype
from rxtpu_torch.parallel.multihost import copy_to_group, gather_last_dim


class ColumnParallelLinear(nn.Linear):
    """``nn.Linear`` split on its output dim over ``group`` (None: the plain
    layer). Each rank holds ``weight`` rows ``[r*k, (r+1)*k)`` of the whole
    ``[out, in]`` weight and computes that slice of the output, which is
    gathered over the group; the replicated bias is added after the gather.
    The input reaches every rank whole, so its gradient, partial on each
    rank, is summed over the group; the gather's backward keeps the rank's
    own slice (every rank computes the same loss from the whole output)."""

    def __init__(self, in_features: int, out_features: int, group: Optional[object] = None):
        super().__init__(in_features, out_features)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return super().forward(x)
        size = torch.distributed.get_world_size(self.group)
        if self.weight.shape[0] * size != self.out_features:
            raise RuntimeError(f"{tuple(self.weight.shape)} is not a 1/{size} shard of "
                               f"[{self.out_features}, {self.in_features}]: place_state first")
        y = gather_last_dim(F.linear(copy_to_group(x, self.group), self.weight), self.group)
        return y + self.bias.to(y.dtype)


class MLPHead(nn.Module):
    def __init__(self, in_features: int, nb_classes: int,
                 size_features: int = 1024, dropout: float = 0.3,
                 folded: bool = False, tp_group: Optional[object] = None):
        super().__init__()
        self.folded = folded
        if not folded:
            self.bn1 = BatchNorm(in_features)
            self.bn2 = BatchNorm(size_features)
        self.drop = Dropout(dropout)
        self.fc1 = ColumnParallelLinear(in_features, size_features, tp_group)
        self.fc2 = ColumnParallelLinear(size_features, nb_classes, tp_group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = compute_dtype(self.fc1.weight)
        x = x.to(dtype)
        if not self.folded:
            x = self.drop(self.bn1(x))
        x = F.relu(self.fc1(x))
        if not self.folded:
            x = self.drop(self.bn2(x))
        return self.fc2(x).to(torch.promote_types(dtype, torch.float32))


class ArcFaceHead(nn.Module):
    """The cosine-margin head (``rxtpu/models/heads.py:62-105``).

    The embedding path runs in the compute dtype (bf16 under autocast); the
    embedding then goes to f32 and everything after it runs with autocast
    off, in f32, as rxtpu's does: the L2 norms (``+1e-12``), ``cos =
    clip(emb_n @ w_n, -1+1e-7, 1-1e-7)`` with TF32 off on the card, and in
    train mode with ``labels`` ``scale*cos(arccos(cos) + margin)`` on the
    target class. Otherwise it returns ``scale*cos``. ``weight`` is
    ``[size_features, nb_classes]``, rxtpu's layout.
    """

    def __init__(self, in_features: int, nb_classes: int, size_features: int = 1024,
                 dropout: float = 0.3, margin: float = 0.3, scale: float = 30.0,
                 tp_group: Optional[object] = None):
        super().__init__()
        self.margin, self.scale = margin, scale
        self.folded = False  # nothing folds into this head (rxtpu/models/twosites.py:78)
        self.bn1 = BatchNorm(in_features)
        self.drop = Dropout(dropout)
        self.fc1 = ColumnParallelLinear(in_features, size_features, tp_group)
        self.bn2 = BatchNorm(size_features)
        self.weight = nn.Parameter(torch.empty(size_features, nb_classes))
        nn.init.normal_(self.weight, 0.0, math.sqrt(1.0 / size_features))

    @torch.no_grad()
    def init_weight_(self, generator: torch.Generator) -> None:
        """rxtpu's ``variance_scaling(1.0, "fan_in", "normal")``: a truncated
        normal with std sqrt(1 / size_features) / 0.8796, cut at two std."""
        std = math.sqrt(1.0 / self.weight.shape[0]) / 0.87962566103423978
        w = torch.empty(self.weight.shape)
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        self.weight.copy_(w)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.to(compute_dtype(self.fc1.weight))
        x = self.bn2(F.relu(self.fc1(self.drop(self.bn1(x)))))
        emb = x.to(torch.promote_types(x.dtype, torch.float32))
        with torch.autocast(emb.device.type, enabled=False), _no_tf32(emb.device):
            w = self.weight.to(emb.dtype)
            emb_n = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-12)
            w_n = w / (torch.linalg.vector_norm(w, dim=0, keepdim=True) + 1e-12)
            cos = torch.clamp(emb_n @ w_n, -1.0 + 1e-7, 1.0 - 1e-7)
            if labels is None or not self.training:
                return self.scale * cos
            target = torch.cos(torch.arccos(cos) + self.margin)
            onehot = F.one_hot(labels.long(), cos.shape[-1]).to(cos.dtype)
            return self.scale * (onehot * target + (1.0 - onehot) * cos)


@contextlib.contextmanager
def _no_tf32(device: torch.device):
    """TF32 off for the float32 matmuls inside, on a CUDA device."""
    saved = torch.backends.cuda.matmul.allow_tf32
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
