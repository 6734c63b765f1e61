"""Post-training W8A8 int8 inference (counterpart of ``rxtpu/infer/quant.py``):
ResNet backbones with the MLP head, and DenseNet-121 with the MLP head.

1. ``calibrate(model, batches, crop_size)``: the BN-folded twin (DenseNet's
   unfolded eval model, under autocast) in the compute dtype runs on K1's
   bf16 views of a few (unlabeled) batches, and every conv's input and
   output absmax, scalar and per channel, is recorded (``ConvObserver``),
   with DenseNet's stored segments after the stem's ReLU and each
   transition's pool; max-reduced across batches.
2. ``prepare_quantized(model, qstats)``: symmetric per-out-channel int8
   weights (``w_scale = max(absmax/127, 1e-12)``, ``kernel_q =
   clip(round(kf / w_scale))``), once per model, in a
   ``TwoSitesNN(quantized=True)``. A ResNet's come from the f32 folded
   state dict, with per-tensor activation scales (``in_scale``, ``out_scale
   = absmax/127``), and its folded head computes in the compute dtype.
   DenseNet's (``quantize_densenet_backbone``) keep each pre-activation BN as
   a ``QuantPreNorm`` affine, fold the two post-conv BNs (``bn_init``, each
   layer's second) into their convs, quantize activations per channel (each
   consumer conv bakes its input scale vector into ``kernel_q``), and keep
   the head unfolded with its running statistics.
3. ``QuantPredictor``: the predict step on it, with ``Predictor``'s TTA and
   average semantics. With transforms (the CLI always passes them, ``--tta
   none`` as ``[identity]``) K1 writes bf16 views and the stem conv
   quantizes them; without, K1 writes int8 views at ``conv_init.in_scale``
   in its one pass (quantize-at-source).
4. ``make_scanned_quantized_predict_step``: ``QuantPredictor`` over windows
   of K batches, one CUDA graph replay per window on the card
   (``rxtpu_torch.train.step.WindowStep``).
"""

from __future__ import annotations

import functools
from typing import TYPE_CHECKING, Any, Dict, Iterable, List, Optional

import torch

from rxtpu_torch.infer.fold import (
    _affine, fold_for_inference, fold_state_dict, foldable, unfolded_twin,
)
from rxtpu_torch.infer.predict import View, average_variants
from rxtpu_torch.models.quant import ConvObserver
from rxtpu_torch.models.twosites import TwoSitesNN
from rxtpu_torch.ops.crop_norm import eval_batch_normalize
from rxtpu_torch.ops.int8_conv import pack_weight

if TYPE_CHECKING:  # train.step imports infer.fold: no import cycle at run time
    from rxtpu_torch.train.step import WindowStep

# conv name in the backbone -> {in_absmax, in_absmax_ch, out_absmax, out_absmax_ch};
# DenseNet's segment observations (stem_absmax, transition{i}_absmax, and _ch) -> tensor
QStats = Dict[str, Any]


def _is_densenet(model) -> bool:
    return (isinstance(model, TwoSitesNN) and model.arch["backbone"] == "densenet121"
            and model.arch["head"] == "mlp")


def quantizable(model) -> bool:
    """A resnet backbone with the mlp head (through BN folding), or densenet121
    with the mlp head (its pre-activation BNs as explicit affines), as
    ``rxtpu/infer/quant.py:39-48``."""
    return foldable(model) or _is_densenet(model)


def _require_quantizable(model) -> None:
    if not quantizable(model):
        arch = getattr(model, "arch", {})
        raise ValueError(
            "int8 inference supports resnet backbones with the mlp head and densenet121, "
            f"got {arch.get('backbone')!r}/{arch.get('head')!r}")


@torch.inference_mode()
def calibrate(model: TwoSitesNN, batches: Iterable[Dict[str, torch.Tensor]],
              crop_size: Optional[int] = None, dtype: torch.dtype = torch.bfloat16,
              group=None) -> QStats:
    """Each backbone conv's input and output absmax (f32, scalar and per
    channel), and DenseNet's segment ranges, over ``batches`` (``images``,
    ``mean``, ``std`` on the model's device), through the normalize and the
    eval forward the predict step uses (folded, or DenseNet's unfolded), in
    ``dtype``. With a process ``group`` (each rank's ``batches`` its slices)
    every observation is max-reduced over the ranks: every rank derives the
    same ``qstats``, those of the whole batches (MAX is exact), as rxtpu
    calibrates on globally assembled batches."""
    _require_quantizable(model)
    if _is_densenet(model):
        twin = unfolded_twin(model, dtype)
        observed = twin.net.backbone
    else:
        twin = fold_for_inference(model).to(dtype)
        observed = twin.backbone
    n = 0
    with ConvObserver(observed) as observer:
        for batch in batches:
            twin(eval_batch_normalize(batch["images"], batch["mean"], batch["std"], crop_size))
            n += 1
    if n == 0:
        raise ValueError("calibration needs at least one batch")
    if group is not None:
        for v in _leaves(observer.stats):
            torch.distributed.all_reduce(v, op=torch.distributed.ReduceOp.MAX, group=group)
    return observer.stats


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a ``QStats`` tree, in its (insertion) order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(absmax.to(torch.float32).reshape(()) / 127.0, 1e-12)


def _qconv_entry(prefix: str, kernel: torch.Tensor, in_absmax=None, out_absmax=None,
                 mul=None, add=None, in_absmax_ch=None) -> Dict[str, torch.Tensor]:
    """One ``QuantConv``'s buffers under ``prefix`` (rxtpu's ``_qconv_entry``,
    ``rxtpu/infer/quant.py:135-176``), from its OIHW f32 kernel. ``mul``
    folds a following eval BN's scale in (per output channel); ``add`` is the
    bias (that BN's shift, or a folded conv's bias). ``in_absmax_ch``
    quantizes the input per channel: the scale vector ``s_in`` goes into the
    kernel (``W * s_in[i]``, exact: the conv is linear per input channel),
    is kept as ``in_scale_vec`` for the producer, and ``in_scale`` is 1. ``out_absmax`` (scalar or per channel)
    gives ``out_scale``."""
    kf = kernel.to(torch.float32)
    if mul is not None:
        kf = kf * mul[:, None, None, None]
    d: Dict[str, torch.Tensor] = {}
    if in_absmax_ch is not None:
        s_in = torch.clamp_min(in_absmax_ch.to(torch.float32) / 127.0, 1e-12)
        kf = kf * s_in[None, :, None, None]
        d["in_scale_vec"] = s_in
        d["in_scale"] = torch.tensor(1.0)
    else:
        d["in_scale"] = _scale(in_absmax)
    w_scale = torch.clamp_min(kf.abs().amax(dim=(1, 2, 3)) / 127.0, 1e-12)
    kq = torch.clamp(torch.round(kf / w_scale[:, None, None, None]), -127.0, 127.0)
    d["kernel_q"] = pack_weight(kq.to(torch.int8))
    d["w_scale"] = w_scale
    d["bias"] = add.to(torch.float32) if add is not None else torch.zeros(kernel.shape[0])
    if out_absmax is not None:
        d["out_scale"] = torch.clamp_min(out_absmax.to(torch.float32) / 127.0, 1e-12)
    return {f"{prefix}.{k}": v for k, v in d.items()}


def quantize_densenet_backbone(sd: Dict[str, torch.Tensor], qstats: QStats
                               ) -> Dict[str, torch.Tensor]:
    """An unfolded DenseNet ``TwoSitesNN`` state dict and its calibration
    stats -> the quantized backbone's state dict entries
    (``rxtpu/infer/quant.py:179-236``): pre-activation BNs as ``mul``/``add``;
    ``bn_init`` folded into ``conv_init`` (per-tensor input scale, output
    per channel at the stem's segment range) and each layer's ``BatchNorm_1``
    into its ``Conv_0``, which requantizes at ``Conv_1``'s input range;
    ``Conv_1`` at its output range, and each transition's conv at its pooled
    segment's range, all per channel."""
    out: Dict[str, torch.Tensor] = {}
    mul, add = _affine(sd, "backbone.bn_init")
    out.update(_qconv_entry("backbone.conv_init", sd["backbone.conv_init.weight"],
                            in_absmax=qstats["conv_init"]["in_absmax"],
                            out_absmax=qstats["stem_absmax_ch"], mul=mul, add=add))
    scopes = dict.fromkeys(k.split(".")[1] for k in sd if k.startswith("backbone."))
    for scope in scopes:
        p = f"backbone.{scope}"
        if scope.startswith("block"):
            mul1, add1 = _affine(sd, f"{p}.BatchNorm_0")
            mul2, add2 = _affine(sd, f"{p}.BatchNorm_1")
            out[f"{p}.BatchNorm_0.mul"], out[f"{p}.BatchNorm_0.add"] = mul1, add1
            out.update(_qconv_entry(f"{p}.Conv_0", sd[f"{p}.Conv_0.weight"],
                                    in_absmax_ch=qstats[f"{scope}.Conv_0"]["in_absmax_ch"],
                                    out_absmax=qstats[f"{scope}.Conv_1"]["in_absmax_ch"],
                                    mul=mul2, add=add2))
            out.update(_qconv_entry(f"{p}.Conv_1", sd[f"{p}.Conv_1.weight"],
                                    in_absmax_ch=qstats[f"{scope}.Conv_1"]["in_absmax_ch"],
                                    out_absmax=qstats[f"{scope}.Conv_1"]["out_absmax_ch"]))
        elif scope.startswith("transition"):
            mul1, add1 = _affine(sd, f"{p}.BatchNorm_0")
            out[f"{p}.BatchNorm_0.mul"], out[f"{p}.BatchNorm_0.add"] = mul1, add1
            out.update(_qconv_entry(f"{p}.Conv_0", sd[f"{p}.Conv_0.weight"],
                                    in_absmax_ch=qstats[f"{scope}.Conv_0"]["in_absmax_ch"],
                                    out_absmax=qstats[f"{scope}_absmax_ch"]))
        elif scope == "bn_final":
            out[f"{p}.mul"], out[f"{p}.add"] = _affine(sd, p)
    return out


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
            prefix = key[: -len(".weight")]
            stats = qstats[prefix[len("backbone."):]]
            # every conv keeps an out_scale: the projections requantize at it
            # (their int8 output is a residual branch, with no consumer conv
            # to take a scale from)
            out.update(_qconv_entry(prefix, value, in_absmax=stats["in_absmax"],
                                    out_absmax=stats["out_absmax"].reshape(()),
                                    add=folded[prefix + ".bias"]))
    return out


@torch.no_grad()
def prepare_quantized(model: TwoSitesNN, qstats: QStats,
                      dtype: torch.dtype = torch.bfloat16) -> TwoSitesNN:
    """Quantize ``model``'s weights once: a ``TwoSitesNN(quantized=True)`` in eval
    mode on the model's device, computing in ``dtype``. A ResNet is folded
    first and its folded head cast to ``dtype``; DenseNet's head stays
    unfolded in f32 and runs under autocast (``rxtpu/infer/quant.py:264-274``)."""
    _require_quantizable(model)
    quantized = TwoSitesNN(**{**model.arch, "fuse_blocks": False}, quantized=True)
    sd = model.state_dict()
    if _is_densenet(model):
        q = quantize_densenet_backbone(sd, qstats)
        q.update({k: v for k, v in sd.items() if k.startswith("head.")})
        quantized.load_state_dict(q)
    else:
        quantized.load_state_dict(quantize_variables(fold_state_dict(sd), qstats))
        quantized.head.to(dtype)
    quantized.quant_dtype = dtype
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


def make_scanned_quantized_predict_step(qmodel: TwoSitesNN, crop_size: Optional[int] = None,
                                        transforms: Optional[List[View]] = None,
                                        average: str = "probs", window: int = 2
                                        ) -> WindowStep:
    """``QuantPredictor`` over windows of ``window`` batches -> [K, B, classes],
    each slice the per-batch step's (``rxtpu/infer/quant.py:303``)."""
    from rxtpu_torch.train.step import make_scanned_predict_step

    return make_scanned_predict_step(QuantPredictor(qmodel, crop_size, transforms, average),
                                     window)
