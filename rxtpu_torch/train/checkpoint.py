"""Checkpoints (counterpart of ``rxtpu/train/checkpoint.py``).

Three formats load:

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
  the optimizer's momentum);
- an orbax directory, rxtpu's ``--checkpoint-backend orbax``
  (``rxtpu/train/checkpoint.py:152-199``), read without orbax, tensorstore
  or zarr: ``_METADATA``'s tree (orbax's key types: a sequence index or a
  dict key; ``None``, ``{}``, ``[]`` and ``()`` kept as such) over zarr v2
  arrays, which sit in an OCDBT store (``rxtpu_torch.train.ocdbt``, what
  orbax writes by default) or in plain directories (``use_ocdbt: false``).
  ``load_checkpoint_orbax`` returns the tree that rxtpu's returns: optax's
  state as ``[{"trace": ...}, {"count": ...}]``, numpy arrays of the saved
  dtypes. A missing path whose ``.old`` directory exists, which a crash in
  the middle of the save's swap leaves, loads ``.old``.

``save_rxtpu_pickle`` writes the second format from the port's weights and
momentum, with optax's state classes named by module and class as optax
pickles them, so rxtpu resumes from it; ``save_checkpoint_orbax`` writes the
third in orbax's plain zarr v2 layout (one zstd chunk per array), so that
rxtpu's ``load_checkpoint_orbax`` restores it, with rxtpu's atomic swap
(``.tmp``, ``.old``). ``save_checkpoint(..., backend="orbax")`` writes a
training state in that layout as rxtpu's rolling payload. ``BestCheckpointer``
saves on a strict improvement of the metric (the first call always saves);
``checkpoint_exists`` is the phase-skip / resume test.
"""

from __future__ import annotations

import collections
import json
import operator
import os
import pickle
import shutil
import time
import zipfile
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

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
    return _train_state(saved, trace_state.trace, step)


_LOOP_META = ("epoch", "batch_in_epoch", "best_metric", "epochs_without_improvement")


def _train_state(saved: Dict[str, Any], trace: Any, step: int) -> Dict[str, Any]:
    """rxtpu's payload -> the port's: weights and trace by name, the loop's
    fields as Python scalars (``best_metric`` may be None)."""
    payload = {"state_dict": from_flax(saved["params"], saved["batch_stats"]),
               "trace": from_flax(trace), "step": step}
    for key in _LOOP_META:
        if key in saved:
            payload[key] = None if saved[key] is None else np.asarray(saved[key]).item()
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


def rxtpu_payload(state_dict: Dict[str, torch.Tensor], momentum: Dict[str, torch.Tensor],
                  step: int, opt_state: Callable = lambda trace, count: [
                      {"trace": trace}, {"count": count}], **meta) -> Dict[str, Any]:
    """rxtpu's rolling payload (``rxtpu/train/loop.py:149-155`` and
    ``:227-234``) as rxtpu's ``_to_host`` leaves it: ``params`` and
    ``batch_stats`` in flax's layout, ``opt_state`` from
    ``opt_state(trace, count)`` with the momentum as the trace, ``step`` as
    an int32 scalar, then ``meta`` (``epoch``, ``batch_in_epoch``,
    ``best_metric``, ``epochs_without_improvement``) as numpy scalars (None
    stays None); every dict's keys sorted. The default ``opt_state`` is the
    list of dicts that orbax restores optax's state as."""
    params, batch_stats = to_flax(state_dict)
    trace, _ = to_flax(momentum)
    count = np.asarray(step, np.int32)
    meta = {k: None if v is None else np.asarray(v) for k, v in meta.items()}
    return _sorted({"params": params, "batch_stats": batch_stats,
                    "opt_state": opt_state(_sorted(trace), count), "step": count, **meta})


def save_rxtpu_pickle(path: str, state_dict: Dict[str, torch.Tensor],
                      momentum: Dict[str, torch.Tensor], step: int, **meta) -> None:
    """Atomic write of rxtpu's rolling payload (``rxtpu_payload``) as rxtpu
    pickles it (protocol 4), ``opt_state`` as ``optax.sgd``'s
    ``(TraceState(trace), ScaleByScheduleState(count))``."""
    payload = rxtpu_payload(
        state_dict, momentum, step,
        opt_state=lambda trace, count: (_TraceState(trace), _ScaleByScheduleState(count)),
        **meta)
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
                    backend: str = "pickle",
                    momentum: Optional[Dict[str, torch.Tensor]] = None, **meta) -> None:
    """Atomic write of a checkpoint. ``backend="pickle"``: the port's own
    format, the model's ``state_dict``, the optimizer's state when given (the
    optimizer or its ``state_dict``), and plain ``meta`` values (``step``,
    ``epoch``, ``batch_in_epoch``, ``best_metric``, ...). ``backend="orbax"``:
    rxtpu's rolling payload in an orbax directory (``save_checkpoint_orbax``),
    the ``momentum`` by parameter name as optax's trace, and ``meta`` with
    its ``step``."""
    if backend == "orbax":
        if momentum is None:
            raise ValueError("an orbax checkpoint holds optax's trace: pass the momentum "
                             "by parameter name")
        save_checkpoint_orbax(path, rxtpu_payload(state_dict, momentum, **meta))
        return
    if backend != "pickle":
        raise ValueError(f"unknown checkpoint backend {backend!r} (pickle or orbax)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    payload = {"format": FORMAT, "state_dict": _to_cpu(dict(state_dict)), **meta}
    if optimizer is not None:
        opt = optimizer if isinstance(optimizer, dict) else optimizer.state_dict()
        payload["optimizer"] = _to_cpu(opt)
    torch.save(payload, tmp)
    os.replace(tmp, path)


def checkpoint_exists(path: str) -> bool:
    """The phase-skip / resume test: true also for the ``.old`` directory
    that a crash in the middle of an orbax save's swap leaves
    (``rxtpu/train/checkpoint.py:114-121``)."""
    return os.path.exists(path) or os.path.isdir(path + ".old")


def is_orbax_checkpoint(path: str) -> bool:
    """rxtpu's auto-detect (``rxtpu/train/checkpoint.py:99-110``): a
    directory, or a missing ``path`` whose ``.old`` is one; a stale ``.old``
    does not shadow a newer file at ``path``."""
    return os.path.isdir(path) or (not os.path.exists(path) and os.path.isdir(path + ".old"))


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
    """The whole payload of a training checkpoint in any format: the port's
    own as saved, or an rxtpu pickle's or orbax directory's weights as a
    ``state_dict``, its nesterov trace by parameter name as ``trace``, its
    ``step`` (checked against the lr schedule's count) and its loop fields
    as Python scalars."""
    if is_orbax_checkpoint(path):
        return _orbax_train_state(path)
    if not is_port_format(path):
        return _rxtpu_train_state(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not an {FORMAT} checkpoint")
    return payload


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A state_dict for the port's ``TwoSitesNN`` from any format."""
    if is_orbax_checkpoint(path):
        saved = load_checkpoint_orbax(path)
        return from_flax(saved["params"], saved["batch_stats"])
    if is_port_format(path):
        return load_train_state(path)["state_dict"]
    return load_rxtpu_pickle(path)


# ---- orbax directories (rxtpu/train/checkpoint.py:152-199) ------------------

_ORBAX_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                  "StandardCheckpointHandler")
_SEQUENCE, _DICT = 1, 2  # orbax's key types in _METADATA
_EMPTY = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": tuple}
_ARRAYS = ("np.ndarray", "jax.Array")  # leaves restored as numpy arrays
_ZSTD_LEVEL = 1  # the level orbax's zarr arrays are written at


class _Node(dict):
    """A container of the restored tree while it is built: its key type."""
    key_type: Optional[int] = None


def _orbax_tree(tree_metadata: Dict[str, Any], leaf: Callable[[Tuple[str, ...], str], Any]):
    """The tree that ``_METADATA``'s ``tree_metadata`` describes, leaves from
    ``leaf(keys, value_type)``: a sequence index makes a list, a dict key a
    dict, as orbax restores them without a target."""
    root = _Node()
    for name, entry in tree_metadata.items():
        keys = entry["key_metadata"]
        node = root
        for depth, k in enumerate(keys):
            if k["key_type"] not in (_SEQUENCE, _DICT):
                raise ValueError(f"{name}: orbax key type {k['key_type']} (this reader knows "
                                 f"{_SEQUENCE}, a sequence index, and {_DICT}, a dict key)")
            if node.key_type not in (None, k["key_type"]):
                raise ValueError(f"{name}: a container holds both sequence and dict keys")
            node.key_type = k["key_type"]
            if depth < len(keys) - 1:
                node = node.setdefault(k["key"], _Node())
            else:
                node[k["key"]] = leaf(tuple(str(x["key"]) for x in keys),
                                      entry["value_metadata"]["value_type"])

    def finish(node):
        if not isinstance(node, _Node):
            return node
        if node.key_type == _SEQUENCE:
            if sorted(node, key=int) != [str(i) for i in range(len(node))]:
                raise ValueError(f"sequence indices {sorted(node)} are not 0..{len(node) - 1}")
            return [finish(node[str(i)]) for i in range(len(node))]
        return {k: finish(v) for k, v in node.items()}

    return finish(root)


class _Chunk(NamedTuple):
    array: int  # index in _ZarrReads.arrays
    where: Tuple[slice, ...]  # the region of the array it fills
    shape: Tuple[int, ...]
    dtype: np.dtype
    order: str
    data: bytes
    zstd: bool


class _ZarrReads:
    """Zarr v2 arrays of one store, their chunks decompressed together.
    Every chunk must be there: orbax writes each one (its
    ``store_array_data_equal_to_fill_value``) and refuses to read a missing
    one, so the ``fill_value`` stands in for nothing."""

    def __init__(self, get: Callable[[str], Optional[bytes]], where: str):
        self.get, self.where = get, where
        self.arrays: List[np.ndarray] = []
        self.chunks: List[_Chunk] = []

    def add(self, name: str) -> int:
        """Plan the read of array ``name``; returns its index."""
        raw = self.get(f"{name}/.zarray")
        if raw is None:
            if self.get(f"{name}/zarr.json") is not None:
                raise ValueError(f"{self.where}: {name} is a zarr3 array (zarr.json); this "
                                 "reader covers zarr v2")
            raise ValueError(f"{self.where}: no {name}/.zarray")
        meta = json.loads(raw)
        what = f"{self.where}: {name}/.zarray"
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{what}: zarr_format {meta.get('zarr_format')} (this reader "
                             "covers 2)")
        compressor = meta.get("compressor")
        if compressor is not None and compressor.get("id") != "zstd":
            raise ValueError(f"{what}: compressor {compressor.get('id')!r} (this reader "
                             "covers zstd and none)")
        if meta.get("filters"):
            raise ValueError(f"{what}: filters {meta['filters']} (this reader covers none)")
        order = meta.get("order", "C")
        if order not in ("C", "F"):
            raise ValueError(f"{what}: order {order!r}")
        try:
            dtype = np.dtype(meta["dtype"])
        except TypeError:
            raise ValueError(f"{what}: dtype {meta['dtype']!r} is not covered") from None
        if dtype.kind not in "biufc" or dtype.fields is not None:
            raise ValueError(f"{what}: dtype {meta['dtype']!r} is not covered")
        shape, chunk_shape = tuple(meta["shape"]), tuple(meta["chunks"])
        if len(chunk_shape) != len(shape) or min(chunk_shape, default=1) < 1:
            raise ValueError(f"{what}: chunks {list(chunk_shape)} for shape {list(shape)}")
        sep = meta.get("dimension_separator", ".")
        index = len(self.arrays)
        self.arrays.append(np.empty(shape, dtype.newbyteorder("=")))
        grid = [-(-n // c) for n, c in zip(shape, chunk_shape)]
        for pos in np.ndindex(*grid):
            key = f"{name}/{sep.join(map(str, pos)) if pos else '0'}"
            data = self.get(key)
            if data is None:  # orbax stores every chunk, and refuses to fill a missing one
                raise ValueError(f"{self.where}: chunk {key} is missing")
            where = tuple(slice(p * c, min((p + 1) * c, n))
                          for p, c, n in zip(pos, chunk_shape, shape))
            self.chunks.append(_Chunk(index, where, chunk_shape, dtype, order, data,
                                      compressor is not None))
        return index

    def read(self) -> List[np.ndarray]:
        """Every planned array, its chunks decompressed in the codec's pool."""
        from rxtpu_torch.data.decode import inflate_each

        packed = [i for i, c in enumerate(self.chunks) if c.zstd]
        bufs = [c.data for c in self.chunks]
        plain = inflate_each([bufs[i] for i in packed],
                             [int(np.prod(self.chunks[i].shape)) * self.chunks[i].dtype.itemsize
                              for i in packed])
        for i, b in zip(packed, plain):
            bufs[i] = b
        for c, buf in zip(self.chunks, bufs):
            if len(buf) != int(np.prod(c.shape)) * c.dtype.itemsize:
                raise ValueError(f"{self.where}: a chunk of {len(buf)} bytes for "
                                 f"{list(c.shape)} x {c.dtype}")
            values = np.frombuffer(buf, c.dtype).reshape(c.shape, order=c.order)
            self.arrays[c.array][c.where] = values[tuple(slice(0, w.stop - w.start)
                                                         for w in c.where)]
        return self.arrays


def _store_reader(path: str, meta: Dict[str, Any]) -> Callable[[str], Optional[bytes]]:
    """Key -> bytes of the checkpoint's zarr store: its OCDBT store, or its
    plain directories."""
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: use_zarr3 is set; this reader covers zarr v2 arrays")
    use_ocdbt = meta.get("use_ocdbt")
    if use_ocdbt is None:  # an older _METADATA: the store says what it is
        use_ocdbt = os.path.exists(os.path.join(path, "manifest.ocdbt"))
    if use_ocdbt:
        from rxtpu_torch.train.ocdbt import read_ocdbt

        store = read_ocdbt(path)
        return lambda key: store.get(key.encode())

    def read_file(key: str) -> Optional[bytes]:
        full = os.path.join(path, *key.split("/"))
        if not os.path.isfile(full):
            return None
        with open(full, "rb") as f:
            return f.read()
    return read_file


def load_checkpoint_orbax(path: str) -> Dict[str, Any]:
    """The tree that rxtpu's ``load_checkpoint_orbax`` (orbax's
    ``StandardCheckpointer().restore`` without a target) returns for the
    directory ``path``, or for ``path.old`` when ``path`` is missing."""
    path = os.path.abspath(path)
    if not os.path.exists(path) and os.path.exists(path + ".old"):
        path = path + ".old"  # crash mid-swap: the demoted copy is complete
    try:
        with open(os.path.join(path, "_METADATA")) as f:
            meta = json.load(f)
    except OSError as e:
        raise ValueError(f"{path} is not an orbax checkpoint: {e}") from None
    zarr = _ZarrReads(_store_reader(path, meta), path)

    def plan(keys: Tuple[str, ...], value_type: str) -> Any:
        if value_type in _EMPTY:
            return _EMPTY[value_type]()
        if value_type not in _ARRAYS and value_type != "scalar":
            raise ValueError(f"{path}: leaf {keys} of value type {value_type!r} is not "
                             "covered")
        return _Planned(zarr.add(".".join(keys)), value_type == "scalar")

    tree = _orbax_tree(meta["tree_metadata"], plan)
    arrays = zarr.read()

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        if isinstance(node, list):
            return [fill(v) for v in node]
        if isinstance(node, _Planned):
            a = arrays[node.array]
            return a.item() if node.scalar else a
        return node

    return fill(tree)


class _Planned(NamedTuple):
    """A leaf of the restored tree whose array is still to be read."""
    array: int
    scalar: bool  # orbax's "scalar" leaves restore as Python numbers


def _remove(path: str) -> None:
    if os.path.isdir(path) and not os.path.islink(path):
        shutil.rmtree(path)
    elif os.path.lexists(path):
        os.remove(path)


def _orbax_leaves(tree: Any, keys: Tuple[Tuple[str, int], ...] = ()):
    """(keys with their orbax key types, leaf) in jax's flattening order:
    dict keys sorted, sequences by index; None and empty containers are
    leaves."""
    if isinstance(tree, dict) and tree:
        for k in sorted(tree):
            yield from _orbax_leaves(tree[k], keys + ((str(k), _DICT),))
    elif isinstance(tree, (list, tuple)) and tree:
        for i, v in enumerate(tree):
            yield from _orbax_leaves(v, keys + ((str(i), _SEQUENCE),))
    else:
        yield keys, tree


def _orbax_leaf(value: Any) -> Tuple[str, Optional[np.ndarray]]:
    """A leaf's orbax value type and its array (None for an empty one)."""
    if value is None:
        return "None", None
    for name, kind in (("Dict", dict), ("List", list), ("Tuple", tuple)):
        if isinstance(value, kind):
            return name, None
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    a = np.asarray(value)  # Python numbers too, as rxtpu's _to_host makes them
    a = a if a.flags.c_contiguous else a.copy(order="C")  # 0-d stays 0-d
    if a.dtype.kind not in "biufc" or a.size == 0:
        raise ValueError(f"orbax saves no {a.dtype} array of shape {a.shape}")
    return "np.ndarray", a


def _write_orbax_dir(path: str, payload: Dict[str, Any]) -> None:
    """``payload`` as orbax's plain zarr v2 layout (``use_ocdbt: false``) in
    the new directory ``path``: ``_CHECKPOINT_METADATA``, ``_METADATA`` and
    one directory per array, its ``.zarray`` and one zstd chunk."""
    from rxtpu_torch.data.decode import compress_each

    init_ns = time.time_ns()
    tree_metadata, arrays = {}, []
    for keys, value in _orbax_leaves(payload):
        if not keys:
            raise ValueError("an orbax checkpoint's payload is a non-empty container")
        value_type, array = _orbax_leaf(value)
        tree_metadata[str(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": {"value_type": value_type,
                               "skip_deserialize": array is None}}
        if array is not None:
            arrays.append((".".join(k for k, _ in keys), array))
    os.makedirs(path)
    chunks = compress_each([a for _, a in arrays], level=_ZSTD_LEVEL)
    for (name, a), chunk in zip(arrays, chunks):
        os.makedirs(os.path.join(path, name))
        zarray = {"chunks": list(a.shape), "compressor": {"id": "zstd", "level": _ZSTD_LEVEL},
                  "dimension_separator": ".", "dtype": a.dtype.str, "fill_value": None,
                  "filters": None, "order": "C", "shape": list(a.shape), "zarr_format": 2}
        with open(os.path.join(path, name, ".zarray"), "w") as f:
            f.write(json.dumps(zarray, sort_keys=True, separators=(",", ":")))
        with open(os.path.join(path, name, ".".join("0" * max(a.ndim, 1))), "wb") as f:
            f.write(chunk)
    with open(os.path.join(path, "_METADATA"), "w") as f:  # dumps: the C encoder
        f.write(json.dumps({"tree_metadata": tree_metadata, "use_ocdbt": False,
                            "use_zarr3": False, "store_array_data_equal_to_fill_value": True,
                            "custom_metadata": None}))
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
        f.write(json.dumps({"item_handlers": _ORBAX_HANDLER, "metrics": {},
                            "performance_metrics": {}, "init_timestamp_nsecs": init_ns,
                            "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}))


def save_checkpoint_orbax(path: str, payload: Dict[str, Any]) -> None:
    """An orbax directory at ``path`` that rxtpu's ``load_checkpoint_orbax``
    restores to ``payload``'s tree (numpy or CPU tensor leaves, ``None`` and
    empty containers; sequences restore as lists), with rxtpu's atomic swap
    (``rxtpu/train/checkpoint.py:166-187``): written to ``path.tmp``, the
    old checkpoint demoted to ``path.old``, the new one promoted, ``.old``
    removed. A crash leaves ``path`` or ``path.old`` whole, and the loaders
    find either. One process writes (rank 0 in a process group)."""
    path = os.path.abspath(path)
    tmp, old = path + ".tmp", path + ".old"
    _remove(tmp)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _write_orbax_dir(tmp, payload)
    _remove(old)
    if os.path.lexists(path):
        os.replace(path, old)
    os.replace(tmp, path)
    _remove(old)


def _orbax_train_state(path: str) -> Dict[str, Any]:
    """An rxtpu orbax directory -> the port's payload, as
    ``_rxtpu_train_state`` makes it from a pickle of the same state."""
    saved = load_checkpoint_orbax(path)
    opt_state = saved.get("opt_state")
    if not (isinstance(opt_state, list) and len(opt_state) == 2
            and [sorted(s) if isinstance(s, dict) else None for s in opt_state]
            == [["trace"], ["count"]]):
        raise ValueError(f"{path} holds no optax.sgd state ([{{'trace'}}, {{'count'}}]) to "
                         "resume from")
    step = int(np.asarray(saved["step"]))
    count = int(np.asarray(opt_state[1]["count"]))
    if count != step:
        raise ValueError(f"{path}: step {step} but the lr schedule's count is {count}")
    return _train_state(saved, opt_state[0]["trace"], step)


class BestCheckpointer:
    """Save-on-improvement tracker: ``update(metric, payload)`` saves
    ``payload`` (``save_checkpoint`` keywords) with ``best_metric`` when
    ``metric`` beats the best seen; the first call always saves, in the
    ``backend``'s format. With ``write=False`` (a rank other than 0) it
    tracks the best and writes nothing."""

    def __init__(self, path: str, write: bool = True, backend: str = "pickle"):
        self.path = path
        self.write = write
        self.backend = backend
        self.best: Optional[float] = None

    def update(self, metric: float, payload: Dict[str, Any]) -> bool:
        if self.best is None or metric > self.best:
            self.best = float(metric)
            if self.write:
                save_checkpoint(self.path, backend=self.backend,
                                **{**payload, "best_metric": self.best})
            return True
        return False
