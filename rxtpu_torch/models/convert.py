"""Weights carried across from rxtpu's flax tree to the port's modules.

``from_flax(params, batch_stats)`` walks rxtpu's nested numpy tree and
returns a flat state_dict whose names are the port's module names
(``backbone.stage1_block1.Conv_0.weight``, ``head.fc1.bias``, ...):

- conv kernels HWIO -> OIHW;
- Dense kernels (in, out) -> Linear weights (out, in);
- BN ``scale``/``bias`` -> ``weight``/``bias``, batch stats ``mean``/``var``
  -> ``running_mean``/``running_var``.

A BN-folded tree (convs with a bias) converts the same way.
``from_flax_quantized`` converts rxtpu's prepared int8 tree (``qvars``,
``rxtpu/infer/quant.py:prepare_quantized``) to the state dict of a
``TwoSitesNN(quantized=True)``: HWIO ``kernel_q`` -> K-major ``[O, kh*kw*I]``,
the scales and biases as they are. ``qstats_from_flax`` flattens rxtpu's
calibration tree to the port's ``{conv name: {in_absmax, out_absmax}}``
(the per-channel ranges, DenseNet's, are left out).
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
    if key == "bias":
        return "bias", a
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


def from_flax_quantized(qparams: Mapping) -> Dict[str, torch.Tensor]:
    """rxtpu ``qvars["params"]`` -> the state dict of ``TwoSitesNN(quantized=True)``."""
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
    return out


def qstats_from_flax(qstats: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """rxtpu's ``calibrate`` tree -> the port's per-conv absmax stats."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}

    def walk(tree: Mapping, prefix: str):
        if "in_absmax" in tree:
            out[prefix[:-1]] = {k: torch.tensor(np.asarray(tree[k], np.float32))
                                for k in ("in_absmax", "out_absmax")}
            return
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")

    walk(qstats["backbone"], "")
    return out
