"""Weights carried across from rxtpu's flax tree to the port's modules.

``from_flax(params, batch_stats)`` walks rxtpu's nested numpy tree and
returns a flat state_dict whose names are the port's module names
(``backbone.stage1_block1.Conv_0.weight``, ``head.fc1.bias``, ...):

- conv kernels HWIO -> OIHW;
- Dense kernels (in, out) -> Linear weights (out, in);
- BN ``scale``/``bias`` -> ``weight``/``bias``, batch stats ``mean``/``var``
  -> ``running_mean``/``running_var``.

A BN-folded tree (convs with a bias) converts the same way.
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
