"""Fold eval-mode BatchNorm into conv/linear weights (counterpart of
``rxtpu/infer/fold.py``).

Eval BN is ``y = x*mul + add`` with ``mul = weight/sqrt(var+eps)`` and
``add = bias - mean*mul``, all in f32:

- conv then BN (the backbone): ``bn(conv(x, W)) == conv(x, W*mul) + add``,
  ``mul`` scales the kernel's output channels and ``add`` becomes its bias;
- BN then Linear (the MLP head): ``fc(bn(x)) == x @ (W*mul).T + (W@add + b)``,
  ``mul`` scales the weight's input columns.
"""

from __future__ import annotations

from typing import Dict

import torch

from rxtpu_torch.models.twosites import TwoSitesNN

EPS = 1e-5

# conv -> the BN that follows it, besides the numbered Conv_i/BatchNorm_i pairs
_PAIRS = {"conv_init": "bn_init", "conv_proj": "norm_proj"}
_HEAD_PAIRS = (("head.bn1", "head.fc1"), ("head.bn2", "head.fc2"))


def _affine(sd: Dict[str, torch.Tensor], bn: str):
    mul = sd[f"{bn}.weight"].float() / torch.sqrt(sd[f"{bn}.running_var"].float() + EPS)
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


@torch.no_grad()
def fold_for_inference(model: TwoSitesNN) -> TwoSitesNN:
    """A ``folded=True`` twin of ``model`` (eval mode, same device) holding
    the folded weights."""
    folded = TwoSitesNN(**model.arch, folded=True)
    folded.load_state_dict(fold_state_dict(model.state_dict()))
    device = next(model.parameters()).device
    return folded.to(device).eval()
