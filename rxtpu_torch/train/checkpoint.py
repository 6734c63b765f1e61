"""Checkpoints (counterpart of ``rxtpu/train/checkpoint.py``).

Two formats load:

- the port's own: ``torch.save({"format": "rxtpu_torch", "state_dict": ...,
  "optimizer": ..., "step": ..., ...})``, read back with
  ``weights_only=True``. A training checkpoint carries the optimizer's
  state, ``step``, ``epoch``, ``batch_in_epoch``, ``best_metric`` and
  ``epochs_without_improvement`` besides the model's ``state_dict``;
- an rxtpu pickle ``{"params", "batch_stats", "opt_state", "step", ...}``.
  It pickles optax state, which a host without JAX cannot unpickle, so a
  restricted unpickler stubs every class under optax/flax/jax/jaxlib/chex
  and admits nothing else but numpy and plain containers. Only ``params``
  and ``batch_stats`` are kept; they go through ``convert.from_flax``. Its
  optax state is not carried over, so training does not resume from one.

``BestCheckpointer`` saves on a strict improvement of the metric (the first
call always saves); ``checkpoint_exists`` is the phase-skip / resume test.
"""

from __future__ import annotations

import os
import pickle
import zipfile
from typing import Any, Dict, Optional

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


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                    optimizer: Optional[torch.optim.Optimizer] = None, **meta) -> None:
    """Atomic write of the port's own format: the model's ``state_dict``,
    the optimizer's state when given, and plain ``meta`` values (``step``,
    ``epoch``, ``batch_in_epoch``, ``best_metric``, ...)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    payload = {"format": FORMAT, "state_dict": _to_cpu(dict(state_dict)), **meta}
    if optimizer is not None:
        payload["optimizer"] = _to_cpu(optimizer.state_dict())
    torch.save(payload, tmp)
    os.replace(tmp, path)


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(path)


def is_port_format(path: str) -> bool:
    """True for the port's own format (a ``torch.save`` zip), False for an
    rxtpu pickle."""
    return zipfile.is_zipfile(path)


def load_train_state(path: str) -> Dict[str, Any]:
    """The whole payload of a training checkpoint in the port's format."""
    if os.path.isdir(path):
        raise NotImplementedError("orbax checkpoints are not ported yet")
    if not is_port_format(path):
        raise NotImplementedError(
            f"{path} is an rxtpu pickle: resuming from its optax state is not "
            "ported (its weights load for the test phase)")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not an {FORMAT} checkpoint")
    return payload


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A state_dict for the port's ``TwoSitesNN`` from either format."""
    if is_port_format(path):
        return load_train_state(path)["state_dict"]
    if os.path.isdir(path):
        raise NotImplementedError("orbax checkpoints are not ported yet")
    return load_rxtpu_pickle(path)


class BestCheckpointer:
    """Save-on-improvement tracker: ``update(metric, payload)`` saves
    ``payload`` (``save_checkpoint`` keywords) with ``best_metric`` when
    ``metric`` beats the best seen; the first call always saves."""

    def __init__(self, path: str):
        self.path = path
        self.best: Optional[float] = None

    def update(self, metric: float, payload: Dict[str, Any]) -> bool:
        if self.best is None or metric > self.best:
            self.best = float(metric)
            save_checkpoint(self.path, **{**payload, "best_metric": self.best})
            return True
        return False
