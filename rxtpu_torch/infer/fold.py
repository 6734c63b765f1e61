"""Fold eval-mode BatchNorm into conv/linear weights (counterpart of
``rxtpu/infer/fold.py``).

Eval BN is ``y = x*mul + add`` with ``mul = weight/sqrt(var+eps)`` and
``add = bias - mean*mul``, all in f32:

- conv then BN (the backbone): ``bn(conv(x, W)) == conv(x, W*mul) + add``,
  ``mul`` scales the kernel's output channels and ``add`` becomes its bias;
- BN then Linear (the MLP head): ``fc(bn(x)) == x @ (W*mul).T + (W@add + b)``,
  ``mul`` scales the weight's input columns.

``fold`` gives the eval and predict steps their twin and the op in front
of it: K1, or with ``fused_stem`` the kernel K5 and a twin that takes the
stem's maps (rxtpu's ``_make_fused_stem_apply``). A model that does not fold
(DenseNet, or the ArcFace head) evaluates unfolded on K1's views, with its
running statistics (``rxtpu/train/step.py:151-174``): an f32 copy in eval
mode run under ``torch.autocast`` in the compute dtype (``Autocast``), so each
BN forms ``mul`` and ``add`` in f32 from f32 parameters and casts only them,
as rxtpu's does; casting the copy itself to bf16 would round the BN's weight
and running variance before the ``rsqrt``.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from rxtpu_torch.models.twosites import TwoSitesNN
from rxtpu_torch.ops.crop_norm import eval_batch_normalize
from rxtpu_torch.ops.fused_stem import eval_batch_stem

# raw batch (images uint8 [B, G, C, H, W], mean/std f32 [B, C]) -> the twin's input
Front = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

EPS = 1e-5

# conv -> the BN that follows it, besides the numbered Conv_i/BatchNorm_i pairs
_PAIRS = {"conv_init": "bn_init", "conv_proj": "norm_proj"}
_HEAD_PAIRS = (("head.bn1", "head.fc1"), ("head.bn2", "head.fc2"))


def _affine(sd: Dict[str, torch.Tensor], bn: str):
    """The eval BN's f32 (mul, add), as rxtpu forms them: the square root
    correctly rounded (taken in f64; torch's f32 sqrt on the CPU is not
    always), so both packages give the same bits."""
    root = torch.sqrt((sd[f"{bn}.running_var"].float() + EPS).double()).float()
    mul = sd[f"{bn}.weight"].float() / root
    add = sd[f"{bn}.bias"].float() - sd[f"{bn}.running_mean"].float() * mul
    return mul, add


def _bn_of(conv: str) -> str:
    prefix, _, last = conv.rpartition(".")
    bn = "BatchNorm_" + last[len("Conv_"):] if last.startswith("Conv_") else _PAIRS[last]
    return f"{prefix}.{bn}" if prefix else bn


def fold_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An unfolded TwoSitesNN state_dict -> the one a ``folded=True`` twin loads."""
    out: Dict[str, torch.Tensor] = {}
    convs = [k[: -len(".weight")] for k, v in sd.items()
             if k.endswith(".weight") and v.ndim == 4]
    for conv in convs:
        mul, add = _affine(sd, _bn_of(conv))
        w = sd[f"{conv}.weight"]
        out[f"{conv}.weight"] = (w.float() * mul[:, None, None, None]).to(w.dtype)
        out[f"{conv}.bias"] = add
    for bn, fc in _HEAD_PAIRS:
        mul, add = _affine(sd, bn)
        w = sd[f"{fc}.weight"]
        wf = w.float()
        out[f"{fc}.weight"] = (wf * mul[None, :]).to(w.dtype)
        out[f"{fc}.bias"] = wf @ add + sd[f"{fc}.bias"].float()
    return out


def foldable(model) -> bool:
    """True when BN folding supports the model: a resnet backbone with the
    mlp head (``rxtpu/infer/fold.py:96``)."""
    return (isinstance(model, TwoSitesNN) and model.arch["backbone"].startswith("resnet")
            and model.arch["head"] == "mlp")


def _twin(model: TwoSitesNN, sd: Dict[str, torch.Tensor], folded: bool = True,
          stem_input: bool = False) -> TwoSitesNN:
    # the twin is eval-only: never fused (rxtpu/train/step.py:162,195)
    twin = TwoSitesNN(**{**model.arch, "fuse_blocks": False}, folded=folded,
                      stem_input=stem_input)
    twin.load_state_dict(sd)
    device = next(model.parameters()).device
    return twin.to(device).eval()


class Autocast(nn.Module):
    """``net`` (f32 parameters) computing in ``dtype``: under ``torch.autocast``
    for bf16 or f16, as it is for f32. The autocast cast cache is off (the
    same numbers; each call casts its weights anew), as CUDA graph capture
    needs (``rxtpu_torch.train.step.WindowStep``)."""

    def __init__(self, net: nn.Module, dtype: torch.dtype):
        super().__init__()
        self.net, self.dtype = net, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        low = self.dtype in (torch.bfloat16, torch.float16)
        with torch.autocast(x.device.type, dtype=self.dtype, enabled=low,
                            cache_enabled=False):
            return self.net(x)


@torch.no_grad()
def unfolded_twin(model: TwoSitesNN, dtype: torch.dtype) -> Autocast:
    """An eval-mode f32 copy of ``model`` (same device) computing in ``dtype``."""
    return Autocast(_twin(model, model.state_dict(), folded=False), dtype)


@torch.no_grad()
def fold_for_inference(model: TwoSitesNN) -> TwoSitesNN:
    """A ``folded=True`` twin of ``model`` (eval mode, same device) holding
    the folded weights."""
    return _twin(model, fold_state_dict(model.state_dict()))


@torch.no_grad()
def fold(model: TwoSitesNN, crop_size: Optional[int], dtype: torch.dtype,
         fused_stem: bool = False) -> Tuple[TwoSitesNN, Front]:
    """(twin, front) of the eval and predict steps: ``twin(front(images,
    mean, std))`` are the logits of a raw batch.

    Unfused, ``front`` is K1 (bf16 views, center-cropped to ``crop_size``)
    and ``twin`` the folded model in ``dtype`` or, for a model that does not
    fold, ``unfolded_twin``. With ``fused_stem``, ``front``
    is K5 (the stem's maps in ``dtype``) and ``twin`` the folded model with
    ``stem_input=True``. K5 takes the stem's folded bias in f32, as rxtpu
    passes it: from the folded state dict, before the twin's cast rounds it.
    Its weight is cast to bf16 here once, as the kernel reads it. Raises
    ``ValueError`` with ``fused_stem`` for a model that does not fold
    (``rxtpu/train/step.py:190``).
    """
    if not fused_stem:
        twin = fold_for_inference(model).to(dtype) if foldable(model) \
            else unfolded_twin(model, dtype)
        return twin, functools.partial(eval_batch_normalize, crop_size=crop_size)
    if not foldable(model):
        raise ValueError("fused_stem=True needs a BN-foldable model (resnet backbone + "
                         f"mlp head); got {type(model).__name__} "
                         f"{getattr(model, 'arch', None)}")
    sd = fold_state_dict(model.state_dict())
    front = functools.partial(eval_batch_stem,
                              weight=sd["backbone.conv_init.weight"].to(torch.bfloat16),
                              conv_bias=sd["backbone.conv_init.bias"], crop_size=crop_size,
                              out_dtype=dtype)
    return _twin(model, sd, stem_input=True).to(dtype), front
