"""Post-training W8A8 int8 inference (counterpart of ``rxtpu/infer/quant.py``,
for ResNet backbones with the MLP head; DenseNet-121 is not ported).

1. ``calibrate(model, batches, crop_size)``: the BN-folded twin in the
   compute dtype runs on K1's bf16 views of a few (unlabeled) batches, and
   every conv's input and output absmax is recorded (``ConvObserver``),
   max-reduced across batches.
2. ``prepare_quantized(model, qstats)``: from the f32 folded state dict,
   symmetric per-out-channel int8 weights (``w_scale = max(absmax/127,
   1e-12)``, ``kernel_q = clip(round(kf / w_scale))``) and per-tensor
   activation scales (``in_scale``, ``out_scale = absmax/127``), once per
   model, in a ``TwoSitesNN(quantized=True)`` whose folded head computes in
   the compute dtype.
3. ``QuantPredictor``: the predict step on it, with ``Predictor``'s TTA and
   average semantics. With transforms (the CLI always passes them, ``--tta
   none`` as ``[identity]``) K1 writes bf16 views and the stem conv
   quantizes them; without, K1 writes int8 views at ``conv_init.in_scale``
   in its one pass (quantize-at-source).
"""

from __future__ import annotations

import functools
from typing import Dict, Iterable, List, Optional

import torch

from rxtpu_torch.infer.fold import fold_for_inference, fold_state_dict, foldable
from rxtpu_torch.infer.predict import View, average_variants
from rxtpu_torch.models.quant import ConvObserver
from rxtpu_torch.models.twosites import TwoSitesNN
from rxtpu_torch.ops.crop_norm import eval_batch_normalize
from rxtpu_torch.ops.int8_conv import pack_weight

QStats = Dict[str, Dict[str, torch.Tensor]]  # conv name in the backbone -> in/out absmax


def quantizable(model) -> bool:
    """int8 inference builds on BN folding: a resnet backbone with the mlp head."""
    return foldable(model)


def _require_quantizable(model) -> None:
    if not quantizable(model):
        arch = getattr(model, "arch", {})
        raise ValueError(
            "int8 inference supports resnet backbones with the mlp head (densenet121 "
            f"is not ported yet), got {arch.get('backbone')!r}/{arch.get('head')!r}")


@torch.inference_mode()
def calibrate(model: TwoSitesNN, batches: Iterable[Dict[str, torch.Tensor]],
              crop_size: Optional[int] = None, dtype: torch.dtype = torch.bfloat16) -> QStats:
    """Each backbone conv's input and output absmax (f32 scalars) over
    ``batches`` (``images``, ``mean``, ``std`` on the model's device), through
    the normalize and folded forward the predict step uses, in ``dtype``."""
    _require_quantizable(model)
    twin = fold_for_inference(model).to(dtype)
    n = 0
    with ConvObserver(twin.backbone) as observer:
        for batch in batches:
            twin(eval_batch_normalize(batch["images"], batch["mean"], batch["std"], crop_size))
            n += 1
    if n == 0:
        raise ValueError("calibration needs at least one batch")
    return observer.stats


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(absmax.to(torch.float32).reshape(()) / 127.0, 1e-12)


def quantize_variables(folded: Dict[str, torch.Tensor], qstats: QStats
                       ) -> Dict[str, torch.Tensor]:
    """A folded state dict (``fold_state_dict``) and calibration stats -> the
    state dict of a ``TwoSitesNN(quantized=True)``: int8 backbone convs, and
    the folded head as it is."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in folded.items():
        if key.startswith("head."):
            out[key] = value
        elif key.endswith(".weight"):
            prefix = key[: -len("weight")]
            conv = prefix[len("backbone."):-1]
            kf = value.to(torch.float32)
            w_scale = torch.clamp_min(kf.abs().amax(dim=(1, 2, 3)) / 127.0, 1e-12)
            kq = torch.clamp(torch.round(kf / w_scale[:, None, None, None]), -127.0, 127.0)
            out[prefix + "kernel_q"] = pack_weight(kq.to(torch.int8))
            out[prefix + "w_scale"] = w_scale
            out[prefix + "bias"] = folded[prefix + "bias"].to(torch.float32)
            out[prefix + "in_scale"] = _scale(qstats[conv]["in_absmax"])
            # the projections requantize at it: their int8 output is a
            # residual branch, with no consumer conv to take a scale from
            out[prefix + "out_scale"] = _scale(qstats[conv]["out_absmax"])
    return out


@torch.no_grad()
def prepare_quantized(model: TwoSitesNN, qstats: QStats,
                      dtype: torch.dtype = torch.bfloat16) -> TwoSitesNN:
    """Fold and quantize ``model``'s weights once: a ``TwoSitesNN(quantized=True)``
    in eval mode on the model's device, computing in ``dtype``."""
    _require_quantizable(model)
    quantized = TwoSitesNN(**{**model.arch, "fuse_blocks": False}, quantized=True)
    quantized.load_state_dict(quantize_variables(fold_state_dict(model.state_dict()), qstats))
    quantized.head.to(dtype)  # the backbone computes in the head's dtype
    return quantized.to(next(model.parameters()).device).eval()


class QuantPredictor:
    """The int8 predict step (rxtpu's ``make_quantized_predict_step``) on a
    model from ``prepare_quantized``: raw batch -> K1 -> the W8A8 backbone ->
    f32 probabilities, averaged over ``transforms`` as ``Predictor`` does.
    ``transforms`` empty or None: K1 emits int8 views at the stem conv's
    ``in_scale`` and the model runs once on them."""

    def __init__(self, qmodel: TwoSitesNN, crop_size: Optional[int] = None,
                 transforms: Optional[List[View]] = None, average: str = "probs"):
        if average not in ("probs", "logits"):
            raise ValueError(f"unknown tta average mode {average!r}")
        self.net, self.average = qmodel, average
        self.front = functools.partial(eval_batch_normalize, crop_size=crop_size)
        if transforms:
            self.transforms = list(transforms)
        else:
            self.transforms = [lambda v: v]
            self.front = functools.partial(self.front,
                                           quant_scale=qmodel.backbone.conv_init.in_scale)

    @torch.inference_mode()
    def __call__(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """{images uint8 [B,G,C,H,W], mean/std f32 [B,C]} -> f32 probs [B, classes]."""
        views = self.front(batch["images"], batch["mean"], batch["std"])
        return average_variants(self.net, views, self.transforms, self.average)
