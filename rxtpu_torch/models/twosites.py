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
backbone (``rxtpu_torch.models.resnet`` or ``.densenet``) and the head, folded
for a ResNet; DenseNet's head stays unfolded, in f32 parameters, and runs in
``quant_dtype`` under autocast (rxtpu's ``MLPHead(dtype, param_dtype=f32)``),
as ``rxtpu_torch.infer.quant.prepare_quantized`` builds it.

``DummyClassifier`` is the random-logit stand-in of ``--debug`` on the CPU
(local mode), rxtpu's ``DummyClassifier`` drawn from a ``torch.Generator``.

``mesh`` (``rxtpu_torch.parallel.make_mesh``, rxtpu's ``--distributed`` and
``--model-parallel``): every train-mode BN of the backbone and the head
reduces over the data ranks (``mesh.bn_group``, rxtpu's ``bn_axis_name``),
the head's kernels split over the model ranks (``mesh.tp_group``); the
fused blocks (K6/K7) sum their BN sums over the data ranks too, as rxtpu's
fused blocks see the whole batch under GSPMD. The mesh is not part of
``arch``: the eval and int8 twins are plain single-rank models.

``head="arcface"`` is the cosine-margin head (BASELINE config 4, with
``control_calibration`` its control-well embedding calibration):
``forward(x, labels)`` passes the labels to it, and in train mode the target
class takes the margin. The MLP head ignores them.
"""

from __future__ import annotations

import torch
from torch import nn

from typing import Optional

from rxtpu_torch.models.heads import ArcFaceHead, MLPHead
from rxtpu_torch.models.norm import BatchNorm, Dropout
from rxtpu_torch.models.resnet import compute_dtype, make_backbone


class TwoSitesNN(nn.Module):
    def __init__(self, backbone: str = "resnet50", nb_classes: int = 1108,
                 size_features: int = 1024, dropout: float = 0.3,
                 head: str = "mlp", control_calibration: bool = False,
                 arcface_margin: float = 0.3, arcface_scale: float = 30.0,
                 folded: bool = False, stem_input: bool = False,
                 fuse_blocks: bool = False, quantized: bool = False, mesh=None):
        super().__init__()
        if head not in ("mlp", "arcface"):
            raise ValueError(f"unknown head {head!r}")
        if head == "arcface" and (folded or quantized):
            raise ValueError("BN folding and int8 support the mlp head only")
        # constructor arguments, so the eval twins and prepare_quantized rebuild the model
        self.arch = dict(backbone=backbone, nb_classes=nb_classes,
                         size_features=size_features, dropout=dropout,
                         head=head, control_calibration=control_calibration,
                         arcface_margin=arcface_margin, arcface_scale=arcface_scale,
                         fuse_blocks=fuse_blocks)
        self.control_calibration = control_calibration
        bn_group = None if mesh is None else mesh.bn_group
        tp_group = None if mesh is None else mesh.tp_group
        self.backbone = make_backbone(backbone, folded=folded, stem_input=stem_input,
                                      fuse_blocks=fuse_blocks, quantized=quantized)
        in_features = 3 * self.backbone.num_features
        if head == "arcface":
            self.head = ArcFaceHead(in_features, nb_classes, size_features, dropout,
                                    arcface_margin, arcface_scale, tp_group=tp_group)
        else:
            # a quantized ResNet's head is folded; DenseNet's keeps its BNs
            fold_head = folded or (quantized and backbone.startswith("resnet"))
            self.head = MLPHead(in_features, nb_classes, size_features, dropout,
                                folded=fold_head, tp_group=tp_group)
        for mod in self.modules():
            if isinstance(mod, BatchNorm):
                mod.group = bn_group
        self.quant_dtype: Optional[torch.dtype] = None  # set by prepare_quantized

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, g = x.shape[0], x.shape[1]
        if g % 3:
            raise ValueError(f"G-view axis must be divisible by 3, got {g}")
        x = x.reshape((b * g,) + tuple(x.shape[2:]))
        if self.backbone.quantized:  # int8 buffers: compute in quant_dtype or the head's
            dtype = self.quant_dtype or compute_dtype(self.head.fc1.weight)
            feats = self.backbone(x, dtype)
        else:
            feats = self.backbone(x)
        f = feats.shape[-1]
        grouped = feats.reshape(b, 3, g // 3, f).mean(dim=2)
        if self.control_calibration:
            # plate-effect calibration against the negative control
            img, neg, pos = grouped.unbind(1)
            grouped = torch.stack([img - neg, neg, pos - neg], dim=1)
        grouped = grouped.reshape(b, 3 * f)
        if isinstance(self.head, ArcFaceHead):
            return self.head(grouped, labels)
        if self.backbone.quantized and not self.head.folded:
            # no cast cache: the step may run under CUDA graph capture
            with torch.autocast(x.device.type, dtype=dtype, enabled=dtype != torch.float32,
                                cache_enabled=False):
                return self.head(grouped)
        return self.head(grouped)

    def set_dropout_generator(self, generator, rows=None) -> None:
        """Every dropout's generator, and ``rows`` (first, total) of the
        global batch that this rank's rows are (None: the whole batch)."""
        for mod in self.modules():
            if isinstance(mod, Dropout):
                mod.generator, mod.rows = generator, rows


class DummyClassifier:
    """Random logits for ``--debug`` local runs (``rxtpu/models/twosites.py:99-118``):
    ``[batch, nb_classes]`` integers uniform in [-10000, 10000), over 10000,
    in f32, from a generator seeded with ``seed``; one draw per call, on the
    input's device."""

    def __init__(self, nb_classes: int, seed: int = 0):
        self.nb_classes = nb_classes
        self.generator = torch.Generator().manual_seed(seed)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        ints = torch.randint(-10000, 10000, (x.shape[0], self.nb_classes),
                             generator=self.generator)
        return (ints.to(torch.float32) / 10000.0).to(x.device)
