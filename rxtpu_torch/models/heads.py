"""Classification heads (counterpart of ``rxtpu/models/heads.py``).

``MLPHead``: BatchNorm1d -> Dropout -> Linear -> ReLU -> BatchNorm1d ->
Dropout -> Linear over the concatenated [img, neg, pos] features. With
``folded=True`` the two BNs live inside fc1/fc2 (``rxtpu_torch.infer.fold``)
and the head is two matmuls. Logits come out in at least f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rxtpu_torch.models.resnet import BatchNorm


class MLPHead(nn.Module):
    def __init__(self, in_features: int, nb_classes: int,
                 size_features: int = 1024, dropout: float = 0.3,
                 folded: bool = False):
        super().__init__()
        self.folded = folded
        if not folded:
            self.bn1 = BatchNorm(in_features)
            self.bn2 = BatchNorm(size_features)
        self.drop = nn.Dropout(dropout)
        self.fc1 = nn.Linear(in_features, size_features)
        self.fc2 = nn.Linear(size_features, nb_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.fc1.weight.dtype
        x = x.to(dtype)
        if not self.folded:
            x = self.drop(self.bn1(x))
        x = F.relu(self.fc1(x))
        if not self.folded:
            x = self.drop(self.bn2(x))
        return self.fc2(x).to(torch.promote_types(dtype, torch.float32))
