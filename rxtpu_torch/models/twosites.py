"""TwoSitesNN: control-conditioned classifier over grouped views
(counterpart of ``rxtpu/models/twosites.py``).

x: [B, G, C, H, W] with G divisible by 3. The G axis folds into the batch
for one backbone pass; features regroup as [B, 3, G/3, F] and are averaged
over each third of G (view order ``[img_s1, img_s2, neg_s1, neg_s2, pos_s1,
pos_s2]`` at G=6, the two-site test layout), then concatenate to [B, 3F]
for the head. ``set_dropout_generator`` points the head's dropout at a
generator (the train step's per-step generator). ``stem_input=True``: x
holds the stem's output maps ``[B, G, 64, Po, Po]`` (the fused stem K5).
``fuse_blocks=True``: the backbone's stride-1 bottlenecks run fused in train
mode (K6/K7, ``rxtpu_torch.models.fused``). ``quantized=True``: the W8A8 int8
backbone (``rxtpu_torch.models.resnet``) and the folded head, as
``rxtpu_torch.infer.quant.prepare_quantized`` builds it.
"""

from __future__ import annotations

import torch
from torch import nn

from rxtpu_torch.models.heads import MLPHead
from rxtpu_torch.models.norm import Dropout
from rxtpu_torch.models.resnet import compute_dtype, make_backbone


class TwoSitesNN(nn.Module):
    def __init__(self, backbone: str = "resnet50", nb_classes: int = 1108,
                 size_features: int = 1024, dropout: float = 0.3,
                 head: str = "mlp", control_calibration: bool = False,
                 folded: bool = False, stem_input: bool = False,
                 fuse_blocks: bool = False, quantized: bool = False):
        super().__init__()
        if head != "mlp":
            raise NotImplementedError(f"the {head!r} head is not ported yet")
        # constructor arguments, so fold_for_inference can build the twin
        self.arch = dict(backbone=backbone, nb_classes=nb_classes,
                         size_features=size_features, dropout=dropout,
                         head=head, control_calibration=control_calibration,
                         fuse_blocks=fuse_blocks)
        self.control_calibration = control_calibration
        self.backbone = make_backbone(backbone, folded=folded, stem_input=stem_input,
                                      fuse_blocks=fuse_blocks, quantized=quantized)
        self.head = MLPHead(3 * self.backbone.num_features, nb_classes,
                            size_features, dropout, folded=folded or quantized)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, g = x.shape[0], x.shape[1]
        if g % 3:
            raise ValueError(f"G-view axis must be divisible by 3, got {g}")
        x = x.reshape((b * g,) + tuple(x.shape[2:]))
        if self.backbone.quantized:  # int8 buffers: compute in the head's dtype
            feats = self.backbone(x, compute_dtype(self.head.fc1.weight))
        else:
            feats = self.backbone(x)
        f = feats.shape[-1]
        grouped = feats.reshape(b, 3, g // 3, f).mean(dim=2)
        if self.control_calibration:
            # plate-effect calibration against the negative control
            img, neg, pos = grouped.unbind(1)
            grouped = torch.stack([img - neg, neg, pos - neg], dim=1)
        return self.head(grouped.reshape(b, 3 * f))

    def set_dropout_generator(self, generator) -> None:
        for mod in self.modules():
            if isinstance(mod, Dropout):
                mod.generator = generator
