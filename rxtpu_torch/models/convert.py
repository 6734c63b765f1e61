"""Weights carried across from rxtpu's flax tree to the port's modules.

``from_flax(params, batch_stats)`` walks rxtpu's nested numpy tree and
returns a flat state_dict whose names are the port's module names
(``backbone.stage1_block1.Conv_0.weight``, ``head.fc1.bias``, ...):

- conv kernels HWIO -> OIHW;
- Dense kernels (in, out) -> Linear weights (out, in);
- BN ``scale``/``bias`` -> ``weight``/``bias``, batch stats ``mean``/``var``
  -> ``running_mean``/``running_var``;
- the ArcFace head's ``weight`` ([size_features, nb_classes]) as it is.

A BN-folded tree (convs with a bias) and DenseNet's tree convert the same
way. ``from_flax_quantized`` converts rxtpu's prepared int8 tree (``qvars``,
``rxtpu/infer/quant.py:prepare_quantized``) to the state dict of a
``TwoSitesNN(quantized=True)``: HWIO ``kernel_q`` -> K-major ``[O, kh*kw*I]``,
the scales (scalars, or DenseNet's ``in_scale_vec`` and vector
``out_scale``s), biases and ``QuantPreNorm`` affines (``mul``, ``add``) as
they are; DenseNet's unfolded head comes with its ``batch_stats``.
``qstats_from_flax`` flattens rxtpu's calibration tree to the port's: each
conv's name to its ``{in_absmax, in_absmax_ch, out_absmax, out_absmax_ch}``,
and DenseNet's segment observations (``stem_absmax``, ``transition{i}_absmax``
and their ``_ch``) by their own names.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaf(key: str, value: Any, stats: bool):
    a = np.asarray(value)
    if stats:
        return _STAT_NAMES[key], a
    if key == "kernel":
        return "weight", (a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T)
    if key == "scale":
        return "weight", a
    if key in ("bias", "weight"):
        return key, a
    raise KeyError(f"unexpected flax leaf {key!r}")


def _walk(tree: Mapping, prefix: str, stats: bool, out: Dict[str, torch.Tensor]):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _walk(value, f"{prefix}{key}.", stats, out)
            continue
        name, a = _leaf(key, value, stats)
        out[prefix + name] = torch.from_numpy(np.array(a, order="C"))  # a writable copy


def from_flax(params: Mapping, batch_stats: Optional[Mapping] = None
              ) -> Dict[str, torch.Tensor]:
    """rxtpu ``(params, batch_stats)`` -> the port's state_dict."""
    out: Dict[str, torch.Tensor] = {}
    _walk(params, "", False, out)
    if batch_stats:
        _walk(batch_stats, "", True, out)
    return out


def from_flax_quantized(qparams: Mapping, batch_stats: Optional[Mapping] = None
                        ) -> Dict[str, torch.Tensor]:
    """rxtpu ``qvars["params"]`` (and, for DenseNet, ``qvars["batch_stats"]``)
    -> the state dict of ``TwoSitesNN(quantized=True)``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
                continue
            a = np.asarray(value)
            if key == "kernel_q":  # HWIO -> [O, kh*kw*I], (ky, kx, ci) order
                a = a.transpose(3, 0, 1, 2).reshape(a.shape[3], -1)
            out[prefix + key] = torch.from_numpy(np.array(a, order="C"))

    walk(qparams["backbone"], "backbone.")
    _walk(qparams["head"], "head.", False, out)
    if batch_stats:
        _walk(batch_stats["head"], "head.", True, out)
    return out


def qstats_from_flax(qstats: Mapping) -> Dict[str, Any]:
    """rxtpu's ``calibrate`` tree -> the port's absmax stats."""
    out: Dict[str, Any] = {}

    def walk(tree: Mapping, prefix: str):
        if "in_absmax" in tree:
            out[prefix[:-1]] = {k: torch.tensor(np.asarray(v, np.float32))
                                for k, v in tree.items()}
            return
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
            else:  # a segment observation (DenseNet's stem and transitions)
                out[prefix + key] = torch.tensor(np.asarray(value, np.float32))

    walk(qstats["backbone"], "")
    return out
