"""Checkpoint loading (counterpart of ``load_checkpoint`` in
``rxtpu/train/checkpoint.py``).

Two formats load:

- the port's own: ``torch.save({"format": "rxtpu_torch", "state_dict": ...})``,
  read back with ``weights_only=True``;
- an rxtpu pickle ``{"params", "batch_stats", "opt_state", "step", ...}``.
  It pickles optax state, which a host without JAX cannot unpickle, so a
  restricted unpickler stubs every class under optax/flax/jax/jaxlib/chex
  and admits nothing else but numpy and plain containers. Only ``params``
  and ``batch_stats`` are kept; they go through ``convert.from_flax``.
"""

from __future__ import annotations

import os
import pickle
import zipfile
from typing import Dict

import torch

from rxtpu_torch.models.convert import from_flax

FORMAT = "rxtpu_torch"
_STUBBED = ("optax", "flax", "jax", "jaxlib", "chex", "orbax")
_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int", "float",
             "complex", "bool", "str", "bytes", "bytearray", "slice", "range"}


class _Stub:
    """Stand-in for a JAX-side class: accepts any construction and state."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _RxtpuUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if root in _STUBBED:
            return type(name, (_Stub,), {"__module__": module})
        if root == "numpy" or (module, name) in (
                ("collections", "OrderedDict"), ("copyreg", "_reconstructor"),
                ("_codecs", "encode")):
            return super().find_class(module, name)
        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to load {module}.{name} from a checkpoint")


def load_rxtpu_pickle(path: str) -> Dict[str, torch.Tensor]:
    """An rxtpu pickle checkpoint -> the port's state_dict."""
    with open(path, "rb") as f:
        payload = _RxtpuUnpickler(f).load()
    return from_flax(payload["params"], payload["batch_stats"])


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Atomic write of the port's own format."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"format": FORMAT,
                "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()}}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A state_dict for the port's ``TwoSitesNN`` from either format."""
    if os.path.isdir(path):
        raise NotImplementedError("orbax checkpoints are not ported yet")
    if zipfile.is_zipfile(path):
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if payload.get("format") != FORMAT:
            raise ValueError(f"{path} is not an {FORMAT} checkpoint")
        return payload["state_dict"]
    return load_rxtpu_pickle(path)
