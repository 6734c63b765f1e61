"""``--checkpoint-backend orbax`` on the port, on the CPU, without orbax in the port.

rxtpu writes its orbax checkpoints here with orbax and tensorstore (a tiny
resnet18's rolling payload, optax's real ``sgd`` nesterov state inside),
and the port reads and writes them with neither:

- (1) ``rxtpu_torch.train.ocdbt.read_ocdbt``'s key -> bytes map equals
  tensorstore's ``ocdbt`` kvstore on rxtpu's directories, on a save of two
  processes merged by orbax (the root's tree pointing into
  ``ocdbt.process_0/`` and ``ocdbt.process_1/``) and on a store tensorstore
  wrote with small nodes (a B+tree of three levels, values in data files,
  two versions);
- (2) ``load_checkpoint_orbax`` equals rxtpu's ``load_checkpoint_orbax``:
  structure (lists, dicts, ``None``, ``{}``), dtypes, shapes and bytes, from
  OCDBT (one process and two), from orbax's plain zarr layout and from
  arrays rewritten by
  tensorstore with several chunks (ragged at the edges), Fortran order and
  a fill value;
- (3) the port's ``save_checkpoint_orbax`` directory restores in rxtpu to
  the tree of rxtpu's own save of the same state, ``tree_metadata`` equal;
- (4) ``load_train_state`` of rxtpu's orbax directory equals that of rxtpu's
  pickle of the same state;
- (5) the ``.old`` and ``.tmp`` rules of rxtpu's atomic swap;
- (6) a damaged node or manifest, an unknown compressor, zarr3 and a
  missing chunk raise errors that name them;
- (7) the port's CLI trains, resumes and tests under ``--checkpoint-backend
  orbax`` to the weights, momentum and submission of the same runs under
  ``pickle``;
- (8) rxtpu's own restore gives optax's state as ``[dict, dict]``, on which
  optax's ``sgd`` cannot step: rxtpu's ``--resume`` from orbax is held here
  as it stands, so a change in orbax's restore shows.
"""

from __future__ import annotations

import json
import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

import rxtpu_torch.cli as port_cli
from rxtpu.config import Config, ModelConfig, TrainConfig
from rxtpu.train.checkpoint import load_checkpoint_orbax as rx_load_orbax
from rxtpu.train.checkpoint import save_checkpoint as rx_save_checkpoint
from rxtpu.train.optim import make_optimizer
from rxtpu.train.setup import build_model as rx_build_model
from rxtpu_torch.train import checkpoint as port_ckpt
from rxtpu_torch.train.checkpoint import (
    checkpoint_exists, is_orbax_checkpoint, load_checkpoint, load_checkpoint_orbax,
    load_train_state, save_checkpoint, save_checkpoint_orbax,
)
from rxtpu_torch.train.ocdbt import OcdbtError, read_manifest, read_ocdbt

KW = dict(backbone="resnet18", nb_classes=8, size_features=16)
META = dict(epoch=2, batch_in_epoch=3, best_metric=0.25, epochs_without_improvement=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rx_state():
    """rxtpu's train state of a tiny resnet18 at step 5: the model's tree
    (traced, not run) filled from a seed, and the real optax state of
    rxtpu's optimizer (sgd, nesterov, on its lr schedule) with a seeded
    trace."""
    cfg = Config(model=ModelConfig(**KW), train=TrainConfig(bs_per_device=2), experiment_id="o")
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: rx_build_model(cfg).init(
        {"params": key, "dropout": key}, jnp.zeros((1, 3, 32, 32, 6)), train=False))
    rng = np.random.default_rng(0)

    def seeded(tree):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(size=a.shape).astype(a.dtype)), tree)

    params = seeded(shapes["params"])
    trace_state, schedule_state = make_optimizer(0.1, 2, 1).init(params)
    assert type(trace_state) is optax.TraceState
    opt_state = (trace_state._replace(trace=seeded(trace_state.trace)),
                 schedule_state._replace(count=jnp.asarray(5, jnp.int32)))
    return SimpleNamespace(params=params, batch_stats=seeded(shapes["batch_stats"]),
                           opt_state=opt_state, step=jnp.asarray(5, jnp.int32))


def _payload(state, **meta):
    """rxtpu's rolling payload (``rxtpu/train/loop.py:149-155``)."""
    return {"params": state.params, "batch_stats": state.batch_stats,
            "opt_state": state.opt_state, "step": state.step, **meta}


PAYLOADS = {"rolling": META, "first_best": dict(best_metric=None)}


@pytest.fixture(scope="module")
def rx_dirs(rx_state, tmp_path_factory):
    """rxtpu's orbax checkpoints (OCDBT) and its pickles of the same
    payloads; ``first_best`` has ``best_metric`` None and no batch_stats."""
    root = tmp_path_factory.mktemp("rx_orbax")
    out = {}
    for name, meta in PAYLOADS.items():
        payload = _payload(rx_state, **meta)
        if name == "first_best":
            payload["batch_stats"] = {}
        rx_save_checkpoint(str(root / f"{name}.ckpt"), payload, backend="orbax")
        rx_save_checkpoint(str(root / f"{name}.pkl"), payload)
        out[name] = str(root / f"{name}.ckpt")
    return out


def _tensorstore_map(path: str):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{os.path.abspath(path)}/"}).result()
    return {k: kv.read(k).result().value for k in kv.list().result()}


def _assert_same_tree(got, want, where="payload"):
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _assert_same_tree(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert (got.dtype, got.shape) == (want.dtype, want.shape), where
        assert got.tobytes() == want.tobytes(), where
    else:
        assert got == want, where


def _btree_store(path: str) -> None:
    """A store tensorstore writes with small nodes: three levels, values in
    data files past 16 bytes, two versions (the newest overwrites keys)."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                          "config": {"max_decoded_node_bytes": 300,
                                     "max_inline_value_bytes": 16}}).result()
    for version in range(2):
        with ts.Transaction() as txn:
            for i in range(40):
                kv.with_transaction(txn)[f"key/{i:03d}/v"] = bytes([i + version]) * (i + 1)


def _pod_store(src: str, dst: str) -> None:
    """``src``'s store as a save of two processes leaves it: each process's
    own OCDBT store under ``ocdbt.process_<i>/`` holding every other array,
    written with orbax's per-process options, then merged into the root by
    orbax's own merge, whose tree points into both."""
    import asyncio

    from etils import epath
    from orbax.checkpoint._src.serialization import ocdbt_utils

    os.makedirs(dst)
    for name in ("_METADATA", "_CHECKPOINT_METADATA"):
        shutil.copy(os.path.join(src, name), dst)
    values = _tensorstore_map(src)
    arrays = sorted({k.split(b"/")[0] for k in values})
    for pid in (0, 1):
        spec = ocdbt_utils.ts_utils.build_kvstore_tspec(dst, use_ocdbt=True, process_id=pid)
        ocdbt_utils.ts_utils.add_ocdbt_write_options(spec)
        spec.pop("cache_pool", None)
        kv = ts.KvStore.open(spec).result()
        with ts.Transaction() as txn:
            for k, v in values.items():
                if k.split(b"/")[0] in arrays[pid::2]:
                    kv.with_transaction(txn)[k] = v
    asyncio.run(ocdbt_utils.merge_ocdbt_per_process_files(
        epath.Path(dst), ts.Context({"cache_pool#ocdbt": {}}), use_zarr3=False))
    assert sorted(os.listdir(dst)) == ["_CHECKPOINT_METADATA", "_METADATA", "d",
                                       "manifest.ocdbt", "ocdbt.process_0", "ocdbt.process_1"]


@pytest.mark.parametrize("store", ["rolling", "first_best", "process_0", "pod", "btree"])
def test_ocdbt_reader_matches_tensorstore(rx_dirs, tmp_path, store):
    if store == "btree":
        path = str(tmp_path / "btree")
        _btree_store(path)
        assert read_manifest(path)["root_height"] == 2
    elif store == "process_0":  # the sub-store one process of a save leaves
        path = os.path.join(rx_dirs["rolling"], "ocdbt.process_0")
    elif store == "pod":
        path = str(tmp_path / "pod")
        _pod_store(rx_dirs["rolling"], path)
        assert read_ocdbt(path) == _tensorstore_map(rx_dirs["rolling"])
    else:
        path = rx_dirs[store]
    got, want = read_ocdbt(path), _tensorstore_map(path)
    assert list(got) == sorted(want) and got == want
    if store == "rolling":
        # the chunks past the inline limit lie in the process's data files
        assert b"params.backbone.conv_init.kernel/0.0.0.0" in got
        assert b"opt_state.1.count/0" in got


RECHUNKED = ("params.backbone.conv_init.kernel", "params.head.fc1.kernel",
             "params.head.bn1.bias", "opt_state.0.trace.head.fc2.kernel")


def _rechunked(src: str, dst: str) -> None:
    """``src`` (an orbax directory) with ``RECHUNKED`` rewritten by
    tensorstore's zarr driver: three chunks along each axis (ragged at the
    edge), Fortran order, zstd level 3, a fill value of 0.5, and the first
    chunk all 0.5, stored all the same (orbax refuses a missing chunk)."""
    shutil.copytree(src, dst)
    meta = json.load(open(os.path.join(dst, "_METADATA")))
    for name in RECHUNKED:
        kvstore = ({"driver": "ocdbt", "base": f"file://{dst}/", "path": f"{name}/"}
                   if meta["use_ocdbt"] else {"driver": "file", "path": f"{dst}/{name}/"})
        spec = {"driver": "zarr", "kvstore": kvstore, "store_data_equal_to_fill_value": True}
        values = ts.open(spec).result().read().result()
        chunks = [-(-n // 3) for n in values.shape]
        values[tuple(slice(0, c) for c in chunks)] = 0.5
        new = ts.open({**spec, "metadata": {
            "chunks": chunks, "order": "F" if values.ndim > 1 else "C", "fill_value": 0.5,
            "dtype": "<f4",
            "shape": list(values.shape), "compressor": {"id": "zstd", "level": 3}},
            "create": True, "delete_existing": True}).result()
        new.write(values).result()


@pytest.mark.parametrize("layout", ["ocdbt", "ocdbt_first_best", "ocdbt_pod", "plain",
                                    "ocdbt_rechunked", "plain_rechunked"])
def test_load_checkpoint_orbax_matches_rxtpu(rx_state, rx_dirs, tmp_path, layout):
    path = rx_dirs["first_best" if layout == "ocdbt_first_best" else "rolling"]
    if layout == "ocdbt_pod":
        _pod_store(path, str(tmp_path / "pod"))
        path = str(tmp_path / "pod")
    if layout.startswith("plain"):  # orbax's other layout: zarr directories
        path = str(tmp_path / "plain")
        with ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False)) as c:
            c.save(path, jax.tree_util.tree_map(np.asarray, _payload(rx_state, **META)))
        assert not os.path.exists(os.path.join(path, "manifest.ocdbt"))
    if layout.endswith("rechunked"):
        _rechunked(path, str(tmp_path / "rechunked"))
        path = str(tmp_path / "rechunked")
        zarray = json.loads(read_ocdbt(path)[b"params.head.fc1.kernel/.zarray"]
                            if layout.startswith("ocdbt") else
                            open(os.path.join(path, "params.head.fc1.kernel", ".zarray")).read())
        assert (zarray["chunks"], zarray["order"], zarray["fill_value"]) == ([512, 6], "F", 0.5)
    want = rx_load_orbax(path)
    got = load_checkpoint_orbax(path)
    _assert_same_tree(got, want)
    if layout == "ocdbt_first_best":
        assert got["best_metric"] is None and got["batch_stats"] == {}
    else:
        assert got["best_metric"].dtype == np.float64 and got["epoch"].dtype == np.int64
    assert got["step"].dtype == np.int32 and got["step"].shape == ()
    if layout.endswith("rechunked"):
        kernel = got["params"]["backbone"]["conv_init"]["kernel"]
        assert (kernel[:3, :3, :2, :22] == 0.5).all() and (kernel != 0.5).mean() > 0.9


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_port_orbax_save_restores_in_rxtpu(rx_dirs, tmp_path, name):
    """The port saves rxtpu's payload from its own weights and momentum (as
    ``load_train_state`` gives them); rxtpu restores it to the tree of its
    own save of the same state."""
    saved = load_train_state(rx_dirs[name].replace(".ckpt", ".pkl")) if name == "rolling" \
        else None
    if saved is None:  # no batch_stats: rxtpu's tree straight to the port's layer
        tree = rx_load_orbax(rx_dirs[name])
        path = str(tmp_path / "port.ckpt")
        save_checkpoint_orbax(path, tree)
    else:
        path = str(tmp_path / "port.ckpt")
        meta = {k: saved[k] for k in META}
        save_checkpoint(path, saved["state_dict"], backend="orbax", momentum=saved["trace"],
                        step=saved["step"], **meta)
        assert not port_ckpt.is_port_format(path) and is_orbax_checkpoint(path)
    _assert_same_tree(rx_load_orbax(path), rx_load_orbax(rx_dirs[name]))
    tree = [json.load(open(os.path.join(p, "_METADATA")))["tree_metadata"]
            for p in (path, rx_dirs[name])]
    assert tree[0] == tree[1]
    meta = json.load(open(os.path.join(path, "_METADATA")))
    assert (meta["use_ocdbt"], meta["use_zarr3"]) == (False, False)
    assert sorted(os.listdir(tmp_path)) == ["port.ckpt"]  # no .tmp or .old left


def test_load_train_state_orbax_equals_pickle(rx_dirs):
    got = load_train_state(rx_dirs["rolling"])
    want = load_train_state(rx_dirs["rolling"].replace(".ckpt", ".pkl"))
    assert sorted(got) == sorted(want) == sorted(["state_dict", "trace", "step", *META])
    for key in ("state_dict", "trace"):
        assert list(got[key]) == list(want[key])
        for k in want[key]:
            assert got[key][k].dtype == want[key][k].dtype
            assert torch.equal(got[key][k], want[key][k]), (key, k)
    assert got["step"] == want["step"] == 5
    for k, v in META.items():
        assert type(got[k]) is type(want[k]) is type(v) and got[k] == want[k] == v, k
    assert any(t.any() for t in got["trace"].values())
    # the best checkpoint's weights, as the test phase loads them
    best = load_checkpoint(rx_dirs["first_best"])
    for k, v in load_checkpoint(rx_dirs["first_best"].replace(".ckpt", ".pkl")).items():
        assert torch.equal(best[k], v), k


def test_old_and_tmp_rules(rx_dirs, tmp_path, monkeypatch):
    path = str(tmp_path / "last.ckpt")
    saved = load_train_state(rx_dirs["rolling"])
    args = dict(backend="orbax", momentum=saved["trace"], step=saved["step"], **META)
    # a crash between the swap's two renames leaves only path.old
    real_replace = os.replace
    calls = []

    def crash_on_promote(src, dst):
        calls.append(dst)
        if src.endswith(".tmp"):
            raise KeyboardInterrupt
        real_replace(src, dst)

    save_checkpoint(path, saved["state_dict"], **args)
    monkeypatch.setattr(os, "replace", crash_on_promote)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(path, saved["state_dict"], **{**args, "epoch": 3})
    monkeypatch.undo()
    assert calls == [path + ".old", path]
    assert not os.path.exists(path) and os.path.isdir(path + ".old")
    assert os.path.isdir(path + ".tmp")  # the new checkpoint, never promoted
    assert checkpoint_exists(path) and is_orbax_checkpoint(path)
    assert load_train_state(path)["epoch"] == 2  # the demoted copy
    assert load_checkpoint_orbax(path)["epoch"] == 2
    # the next save clears the stale .tmp and .old
    save_checkpoint(path, saved["state_dict"], **{**args, "epoch": 4})
    assert sorted(os.listdir(tmp_path)) == ["last.ckpt"]
    assert load_train_state(path)["epoch"] == 4
    # a stale .old directory does not shadow a newer file at path
    shutil.copytree(path, path + ".old")
    shutil.rmtree(path)
    save_checkpoint(path, saved["state_dict"], optimizer=None, step=7, epoch=5)
    assert not is_orbax_checkpoint(path) and checkpoint_exists(path)
    assert load_train_state(path)["epoch"] == 5 and port_ckpt.is_port_format(path)
    # without .old, a missing path is no checkpoint
    shutil.rmtree(path + ".old")
    os.remove(path)
    assert not checkpoint_exists(path) and not is_orbax_checkpoint(path)


def _flip_byte(path: str, at: int) -> None:
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0x40]))


@pytest.mark.parametrize("damage", ["node_crc", "manifest_crc", "compressor", "zarr3_flag",
                                    "zarr3_array", "missing_chunk"])
def test_orbax_errors_name_what_they_met(rx_dirs, tmp_path, damage):
    path = str(tmp_path / "ck")
    shutil.copytree(rx_dirs["rolling"], path)
    if damage == "node_crc":
        node = os.path.join(path, "d", os.listdir(os.path.join(path, "d"))[0])
        _flip_byte(node, 20)
        with pytest.raises(OcdbtError, match="bad checksum"):
            read_ocdbt(path)
        with pytest.raises(OcdbtError, match="B\\+tree node d/.*bad checksum"):
            load_checkpoint_orbax(path)
        return
    if damage == "manifest_crc":
        _flip_byte(os.path.join(path, "manifest.ocdbt"), 30)
        with pytest.raises(OcdbtError, match="manifest.ocdbt: bad checksum"):
            load_train_state(path)
        return
    if damage.startswith("zarr3"):
        meta_path = os.path.join(path, "_METADATA")
        meta = json.load(open(meta_path))
        if damage == "zarr3_flag":
            meta["use_zarr3"] = True
            json.dump(meta, open(meta_path, "w"))
            with pytest.raises(ValueError, match="use_zarr3"):
                load_checkpoint_orbax(path)
            return
        # a plain layout whose step array is zarr3 (zarr.json, no .zarray)
        plain = str(tmp_path / "plain")
        save_checkpoint_orbax(plain, rx_load_orbax(path))
        os.rename(os.path.join(plain, "step", ".zarray"), os.path.join(plain, "step", "zarr.json"))
        with pytest.raises(ValueError, match="step is a zarr3 array"):
            load_checkpoint_orbax(plain)
        return
    plain = str(tmp_path / "plain")
    save_checkpoint_orbax(plain, rx_load_orbax(path))
    if damage == "missing_chunk":  # orbax refuses it too: no fill value stands in
        os.remove(os.path.join(plain, "params.head.fc1.kernel", "0.0"))
        with pytest.raises(ValueError, match="NOT_FOUND"):
            rx_load_orbax(plain)
        with pytest.raises(ValueError, match="chunk params.head.fc1.kernel/0.0 is missing"):
            load_checkpoint_orbax(plain)
        return
    zarray = os.path.join(plain, "params.head.fc1.kernel", ".zarray")
    meta = json.load(open(zarray))
    meta["compressor"] = {"id": "blosc", "cname": "lz4"}
    json.dump(meta, open(zarray, "w"))
    with pytest.raises(ValueError, match="params.head.fc1.kernel/.zarray: compressor 'blosc'"):
        load_checkpoint(plain)


@pytest.fixture(scope="module")
def train_fixture(tmp_path_factory):
    from rxtpu_torch.data.synthetic import make_train_fixture

    root = tmp_path_factory.mktemp("orbaxfx")
    fx = make_train_fixture(str(root), nb_classes=8, n_experiments=3, wells_per_experiment=6,
                            n_test_wells=5, img_size=64)
    return fx, ["--pack", fx["pack_dir"], "--data-dir", fx["data_dir"], "--stats", fx["stats"]]


ARGV = ["--experiment_id", "fx", "--nb-classes", "8", "--backbone", "resnet18",
        "--crop-size", "48", "--batch-size", "2", "--split-by-experiment", "--no-plate-leak",
        "--checkpoint-every-steps", "4", "--device", "cpu"]


def _momentum(saved, model_names):
    if "trace" in saved:
        return saved["trace"]
    slots = saved["optimizer"]["state"]
    return {n: slots[i]["momentum_buffer"] for i, n in enumerate(model_names)}


def test_port_cli_orbax_matches_pickle(train_fixture, tmp_path, monkeypatch):
    """One epoch, a ``--resume`` for a second, then the test phase, under
    each backend from the same seed: the same weights, momentum and
    submission bytes, the orbax checkpoints being orbax directories that
    rxtpu restores."""
    from rxtpu_torch.models.twosites import TwoSitesNN

    fx, paths = train_fixture
    names = [n for n, _ in TwoSitesNN(**KW).named_parameters()]
    runs = {}
    for backend in ("orbax", "pickle"):
        run = tmp_path / backend
        run.mkdir()
        monkeypatch.chdir(run)
        argv = ARGV + paths + ["--checkpoint-backend", backend]
        assert port_cli.main(argv + ["--epochs", "1"]) == 0
        first = load_train_state("models/last_fx.ckpt")
        assert port_cli.main(argv + ["--epochs", "2", "--resume"]) == 0
        last = load_train_state("models/last_fx.ckpt")
        assert (first["epoch"], first["step"], last["epoch"], last["step"]) == (1, 6, 2, 12)
        runs[backend] = (first, last, load_checkpoint("models/best_model_fx.ckpt"),
                         (run / "submission_fx.csv").read_bytes())
        if backend == "orbax":
            for name in ("best_model_fx.ckpt", "last_fx.ckpt"):
                assert os.path.isdir(f"models/{name}")
                assert sorted(os.listdir("models")) == ["best_model_fx.ckpt", "last_fx.ckpt"]
            rx_last = rx_load_orbax("models/last_fx.ckpt")
            assert int(rx_last["step"]) == 12 and int(rx_last["opt_state"][1]["count"]) == 12
    for i, (o, p) in enumerate(zip(runs["orbax"][:2], runs["pickle"][:2])):
        for k, v in p["state_dict"].items():
            assert torch.equal(o["state_dict"][k], v), (i, k)
        mo, mp = _momentum(o, names), _momentum(p, names)
        assert set(mo) == set(mp) == set(names)
        for n in names:
            assert torch.equal(mo[n], mp[n]), (i, n)
        assert (o["epoch"], o["best_metric"], o["epochs_without_improvement"]) == \
            (p["epoch"], p["best_metric"], p["epochs_without_improvement"])
    for k, v in runs["pickle"][2].items():
        assert torch.equal(runs["orbax"][2][k], v), k
    assert runs["orbax"][3] == runs["pickle"][3]


def test_rxtpu_orbax_restores_opt_state_as_dicts(rx_dirs, rx_state):
    """rxtpu's ``load_checkpoint_orbax`` gives optax's state as a list of
    dicts, and optax's sgd cannot step from it (``rxtpu/train/loop.py:123-129``
    puts it into the state as it is): the port reads the trace and the count
    by position and name instead."""
    restored = rx_load_orbax(rx_dirs["rolling"])["opt_state"]
    assert type(restored) is list and [type(s) for s in restored] == [dict, dict]
    assert sorted(restored[0]) == ["trace"] and sorted(restored[1]) == ["count"]
    opt = optax.sgd(0.1, momentum=0.9, nesterov=True)
    with pytest.raises(AttributeError, match="'dict' object has no attribute 'trace'"):
        opt.update(rx_state.params, restored, rx_state.params)


def test_committed_ocdbt_fixture_matches_rxtpu():
    """``tests/data/orbax_ocdbt`` (rxtpu's OCDBT save, which ``chip_smoke.py``
    reads on the card's host, where no orbax is installed): the port's read
    equals rxtpu's restore and the expected arrays beside it, and its store
    equals tensorstore's."""
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "orbax_ocdbt")
    path = os.path.join(here, "ckpt")
    got = load_checkpoint_orbax(path)
    _assert_same_tree(got, rx_load_orbax(path))
    assert read_ocdbt(path) == _tensorstore_map(path)
    expected = np.load(os.path.join(here, "expected.npz"))
    with open(os.path.join(here, "expected.json")) as f:
        tree = json.load(f)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        if isinstance(node, list):
            return [fill(v) for v in node]
        return None if node is None else expected[node]

    _assert_same_tree(got, fill(tree))
    assert got["best_metric"] is None and got["batch_stats"] == {}
    sizes = {k: len(v) for k, v in read_ocdbt(path).items()}
    assert sizes[b"params.dense.kernel/0.0"] > 1024  # its chunk lies in a data file
