"""Checkpoints (counterpart of ``rxtpu/train/checkpoint.py``).

Two formats load:

- the port's own: ``torch.save({"format": "rxtpu_torch", "state_dict": ...,
  "optimizer": ..., "step": ..., ...})``, read back with
  ``weights_only=True``. A training checkpoint carries the optimizer's
  state, ``step``, ``epoch``, ``batch_in_epoch``, ``best_metric`` and
  ``epochs_without_improvement`` besides the model's ``state_dict``;
- an rxtpu pickle ``{"params", "batch_stats", "opt_state", "step", ...}``
  (``rxtpu/train/loop.py:149-155``). It pickles optax state, which a host
  without JAX cannot import, so a restricted unpickler stands a tuple in for
  every class under optax/flax/jax/jaxlib/chex (optax's states are
  namedtuples: their fields stay readable by name) and admits nothing else
  but numpy and plain containers. ``params`` and ``batch_stats`` go through
  ``convert.from_flax``, and so does the nesterov trace of ``optax.sgd``'s
  state (``rxtpu/train/optim.py:53-71``), which ``load_train_state`` returns
  by parameter name as ``trace`` (``optim.sgd_state_from_trace`` makes it
  the optimizer's momentum).

``save_rxtpu_pickle`` writes the second format from the port's weights and
momentum, with optax's state classes named by module and class as optax
pickles them, so rxtpu resumes from it. ``BestCheckpointer`` saves on a
strict improvement of the metric (the first call always saves);
``checkpoint_exists`` is the phase-skip / resume test.
"""

from __future__ import annotations

import collections
import operator
import os
import pickle
import zipfile
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from rxtpu_torch.models.convert import from_flax, to_flax

FORMAT = "rxtpu_torch"
_STUBBED = ("optax", "flax", "jax", "jaxlib", "chex", "orbax")
_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int", "float",
             "complex", "bool", "str", "bytes", "bytearray", "slice", "range"}


# optax's state namedtuples in rxtpu's ``optax.sgd(schedule, momentum, nesterov)``
# chain, by class: (module optax pickles them under, field names)
_OPTAX_STATES = {
    "TraceState": ("optax.transforms._accumulation", ("trace",)),
    "ScaleByScheduleState": ("optax._src.transform", ("count",)),
}


class _Stub(tuple):
    """Stand-in for a JAX-side class: its constructor arguments as a tuple
    (optax's states read their fields by name, as properties); any other
    pickled state is dropped."""

    def __new__(cls, *args, **kwargs):
        return tuple.__new__(cls, args)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


def _stub_class(module: str, name: str) -> type:
    fields = _OPTAX_STATES[name][1] if module.startswith("optax") and name in _OPTAX_STATES \
        else ()
    attrs = {f: property(operator.itemgetter(i)) for i, f in enumerate(fields)}
    return type(name, (_Stub,), {"__module__": module, **attrs})


class _RxtpuUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if root in _STUBBED:
            return _stub_class(module, name)
        if root == "numpy" or (module, name) in (
                ("collections", "OrderedDict"), ("copyreg", "_reconstructor"),
                ("_codecs", "encode")):
            return super().find_class(module, name)
        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to load {module}.{name} from a checkpoint")


def read_rxtpu_pickle(path: str) -> Dict[str, Any]:
    """An rxtpu pickle's payload, JAX-side objects stood in for."""
    with open(path, "rb") as f:
        return _RxtpuUnpickler(f).load()


def load_rxtpu_pickle(path: str) -> Dict[str, torch.Tensor]:
    """An rxtpu pickle checkpoint -> the port's state_dict."""
    payload = read_rxtpu_pickle(path)
    return from_flax(payload["params"], payload["batch_stats"])


def _rxtpu_train_state(path: str) -> Dict[str, Any]:
    """An rxtpu rolling or best pickle -> the port's payload, with the nesterov
    trace by parameter name (``trace``) where the port has ``optimizer``."""
    saved = read_rxtpu_pickle(path)
    opt_state = saved.get("opt_state")
    if not (isinstance(opt_state, tuple) and len(opt_state) == 2
            and [type(s).__name__ for s in opt_state] == list(_OPTAX_STATES)):
        raise ValueError(f"{path} holds no optax.sgd state (TraceState, "
                         "ScaleByScheduleState) to resume from")
    trace_state, schedule_state = opt_state
    step = int(np.asarray(saved["step"]))
    count = int(np.asarray(schedule_state.count))
    if count != step:
        raise ValueError(f"{path}: step {step} but the lr schedule's count is {count}")
    payload = {"state_dict": from_flax(saved["params"], saved["batch_stats"]),
               "trace": from_flax(trace_state.trace), "step": step}
    for key in ("epoch", "batch_in_epoch", "best_metric", "epochs_without_improvement"):
        if key in saved:
            payload[key] = saved[key]
    return payload


class _OptaxPickler(pickle._Pickler):
    """Writes the stand-ins of optax's state classes under optax's own
    module and class names, so that rxtpu unpickles real optax states."""

    def save_global(self, obj, name=None):
        target = getattr(obj, "_optax_global", None)
        if target is None:
            return super().save_global(obj, name)
        self.save(target[0])
        self.save(target[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _optax_state_class(name: str) -> type:
    module, fields = _OPTAX_STATES[name]
    cls = collections.namedtuple(name, fields)
    cls._optax_global = (module, name)
    return cls


_TraceState, _ScaleByScheduleState = map(_optax_state_class, _OPTAX_STATES)


def _sorted(tree: Any) -> Any:
    """Dicts with their keys sorted at every level, as rxtpu's ``_to_host``
    (a ``jax.tree_util.tree_map``) rebuilds them before pickling."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def save_rxtpu_pickle(path: str, state_dict: Dict[str, torch.Tensor],
                      momentum: Dict[str, torch.Tensor], step: int, **meta) -> None:
    """Atomic write of rxtpu's rolling payload (``rxtpu/train/loop.py:149-155``
    and ``:227-234``, pickle protocol 4): ``params`` and ``batch_stats`` in
    flax's layout, ``opt_state`` as ``optax.sgd``'s ``(TraceState(trace),
    ScaleByScheduleState(count))`` with the momentum as the trace, ``step``
    as an int32 scalar, then ``meta`` (``epoch``, ``batch_in_epoch``,
    ``best_metric``, ``epochs_without_improvement``) as they are; every
    dict's keys sorted, as rxtpu writes them."""
    params, batch_stats = to_flax(state_dict)
    trace, _ = to_flax(momentum)
    count = np.asarray(step, np.int32)
    payload = _sorted({"params": params, "batch_stats": batch_stats,
                       "opt_state": (_TraceState(_sorted(trace)), _ScaleByScheduleState(count)),
                       "step": count, **meta})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _OptaxPickler(f, protocol=4).dump(payload)
    os.replace(tmp, path)


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                    optimizer: Union[torch.optim.Optimizer, Dict, None] = None,
                    **meta) -> None:
    """Atomic write of the port's own format: the model's ``state_dict``,
    the optimizer's state when given (the optimizer or its ``state_dict``),
    and plain ``meta`` values (``step``, ``epoch``, ``batch_in_epoch``,
    ``best_metric``, ...)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    payload = {"format": FORMAT, "state_dict": _to_cpu(dict(state_dict)), **meta}
    if optimizer is not None:
        opt = optimizer if isinstance(optimizer, dict) else optimizer.state_dict()
        payload["optimizer"] = _to_cpu(opt)
    torch.save(payload, tmp)
    os.replace(tmp, path)


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(path)


def assert_consistent_checkpoint_view(*paths: str) -> None:
    """Every rank must see the same checkpoint files: the phase-skip and
    resume gates branch on ``checkpoint_exists``, and ranks that disagree
    would take different paths and hang on mismatched collectives
    (``rxtpu/train/checkpoint.py:124``). No-op outside a process group."""
    from rxtpu_torch.parallel.multihost import all_gather_rows, comm_device, is_distributed

    if not is_distributed():
        return
    local = torch.tensor([[int(checkpoint_exists(p)) for p in paths]], dtype=torch.int32,
                         device=comm_device())
    view = all_gather_rows(local).cpu()
    if not bool((view == view[0]).all()):
        raise RuntimeError(
            "checkpoint visibility differs across ranks (per-path exists flags by rank: "
            f"{view.tolist()}): the checkpoint directory must live on storage that every "
            "rank shares")


def is_port_format(path: str) -> bool:
    """True for the port's own format (a ``torch.save`` zip), False for an
    rxtpu pickle."""
    return zipfile.is_zipfile(path)


def load_train_state(path: str) -> Dict[str, Any]:
    """The whole payload of a training checkpoint in either format: the
    port's own as saved, or an rxtpu pickle's weights as a ``state_dict``,
    its nesterov trace by parameter name as ``trace``, its ``step`` (checked
    against the lr schedule's count) and its loop fields."""
    if os.path.isdir(path):
        raise NotImplementedError("orbax checkpoints are not ported yet")
    if not is_port_format(path):
        return _rxtpu_train_state(path)
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
    ``metric`` beats the best seen; the first call always saves. With
    ``write=False`` (a rank other than 0) it tracks the best and writes
    nothing."""

    def __init__(self, path: str, write: bool = True):
        self.path = path
        self.write = write
        self.best: Optional[float] = None

    def update(self, metric: float, payload: Dict[str, Any]) -> bool:
        if self.best is None or metric > self.best:
            self.best = float(metric)
            if self.write:
                save_checkpoint(self.path, **{**payload, "best_metric": self.best})
            return True
        return False
