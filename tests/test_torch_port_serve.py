"""rxtpu_torch's test phase against rxtpu's, on the CPU.

- the predict step (BN fold on, f32 model) against rxtpu's
  ``make_tta_predict_step`` on one batch;
- plate-leak assignment, plate groups from ``train.csv``, the submission
  bytes and the test-mode Pipeline batches against rxtpu's;
- an rxtpu pickle checkpoint (with its optax state) through the restricted
  unpickler;
- the package imports with JAX, flax, optax, pandas, sklearn, tensorboardX,
  rxtpu, cv2 and PIL blocked, and
  ``chip_smoke.py`` refuses to run without a card or without the package;
- the slice as a whole: rxtpu's CLI trains a tiny resnet18 checkpoint on a
  raw pack, then both CLIs run the test phase on it in f32 and must write
  the same submission, byte for byte, also with ``--predict-scan-window 2``
  and, for the port, from the JPEG tree without ``--pack``.
"""

from __future__ import annotations

import io
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

import rxtpu.cli as rx_cli
import rxtpu_torch.cli as port_cli
from rxtpu.data.pack import PackStore as RxPackStore
from rxtpu.data.pipeline import Pipeline as RxPipeline
from rxtpu.data.records import build_plate_groups as rx_build_plate_groups
from rxtpu.data.records import load_metadata as rx_load_metadata
from rxtpu.data.records import read_metadata_csvs as rx_read_metadata_csvs
from rxtpu.data.synthetic import (
    make_plate_balanced_synthetic_dataset, make_plate_balanced_train_df,
)
from rxtpu.infer import plate_leak as rx_plate_leak
from rxtpu.infer.submit import write_submission as rx_write_submission
from rxtpu.infer.tta import make_tta_predict_step
from rxtpu.models.twosites import TwoSitesNN as FlaxTwoSitesNN
from rxtpu.tools import main as rx_tools_main
from rxtpu.train.step import TrainState
from rxtpu_torch.data.pack import PackStore
from rxtpu_torch.data.pipeline import Pipeline
from rxtpu_torch.data.records import build_plate_groups, load_metadata, read_csv, read_metadata_csvs
from rxtpu_torch.infer import plate_leak
from rxtpu_torch.infer.predict import Predictor, predict_dataset
from rxtpu_torch.infer.submit import write_submission
from rxtpu_torch.models.convert import from_flax
from rxtpu_torch.models.twosites import TwoSitesNN
from rxtpu_torch.train.checkpoint import load_checkpoint
from test_torch_port_models import randomize_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("crop,tta,average", [(None, "none", "probs"),
                                               (32, "dihedral", "logits")])
def test_predict_matches_rxtpu_predict_step(crop, tta, average):
    kw = dict(backbone="resnet18", nb_classes=8, size_features=16)
    flax_model = FlaxTwoSitesNN(**kw, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, 6, 6, 48, 48), dtype=np.uint8)
    mean = rng.uniform(0.1, 0.6, (2, 6)).astype(np.float32)
    std = rng.uniform(0.05, 0.3, (2, 6)).astype(np.float32)
    variables = randomize_flax(flax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32, 6)), train=False), 1)
    state = TrainState.create(variables["params"], variables["batch_stats"],
                              optax.identity(), None)
    step = make_tta_predict_step(flax_model, crop, tta, average)
    ref = np.asarray(step(state, {"images": jnp.asarray(images), "mean": jnp.asarray(mean),
                                  "std": jnp.asarray(std)}))

    port = TwoSitesNN(**kw)
    port.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    predictor = Predictor(port.eval(), crop, tta, average, dtype=torch.float32)
    got = predictor({"images": torch.from_numpy(images), "mean": torch.from_numpy(mean),
                     "std": torch.from_numpy(std)}).numpy()
    assert got.shape == (2, 8) and got.dtype == np.float32
    assert ref.max() - ref.min() > 1e-3  # not a uniform (degenerate) softmax
    # probabilities move by at most about half the logit error, whose bound
    # is atol 1e-4 * max(1, max|logit|) (tests/test_torch_parity.py:319)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_plate_leak_matches_rxtpu():
    rng = np.random.default_rng(0)
    n, c = 24, 16
    probs = rng.dirichlet(np.ones(c), size=n)
    plates = rng.integers(1, 5, n)
    groups = np.stack([rng.permutation([1, 2, 3, 4]) for _ in range(c)])
    for etype in range(4):
        masked = plate_leak.apply_plate_mask(probs, plates, groups, etype)
        np.testing.assert_array_equal(
            masked, rx_plate_leak.apply_plate_mask(probs, plates, groups, etype))
        for method in ("greedy", "hungarian", "argmax"):
            np.testing.assert_array_equal(
                plate_leak.constrained_predict(probs, plates, groups, etype, method),
                rx_plate_leak.constrained_predict(probs, plates, groups, etype, method))
    zero_row = probs.copy()
    zero_row[3] = 0.0
    np.testing.assert_array_equal(plate_leak.rescale(zero_row.copy()),
                                  rx_plate_leak.rescale(zero_row.copy()))
    np.testing.assert_array_equal(plate_leak.greedy_assign(probs[:c]),
                                  rx_plate_leak.greedy_assign(probs[:c]))
    # greedy_jax: rxtpu's f32 device loop, bit-equal (the port's on the CPU)
    for etype in range(4):
        got = plate_leak.constrained_predict(probs, plates, groups, etype, "greedy_jax")
        assert got.dtype == np.float32
        np.testing.assert_array_equal(
            got, rx_plate_leak.constrained_predict(probs, plates, groups, etype, "greedy_jax"))


def test_build_plate_groups_matches_pandas(tmp_path):
    # all-tie counts (one row per plate per experiment), then unequal counts
    # (duplicated rows): descending count first, ties by first appearance
    df_ties = make_plate_balanced_train_df(40, experiments=("A-01", "B-02", "C-03"), seed=3)
    df_counts = pd.concat([df_ties, df_ties.sample(n=60, random_state=4)])
    for i, df in enumerate((df_ties, df_counts)):
        path = str(tmp_path / f"train{i}.csv")
        df.to_csv(path, index=False)
        np.testing.assert_array_equal(
            build_plate_groups(read_csv(path), nb_classes=40),
            rx_build_plate_groups(pd.read_csv(path), nb_classes=40))
    # a sirna seen on 2 plates only cannot give its group
    first = df_ties[df_ties.sirna == 5].plate.iloc[0]
    two_plates = df_ties[~((df_ties.sirna == 5) & (df_ties.plate == first))]
    two_plates.to_csv(tmp_path / "bad.csv", index=False)
    with pytest.raises(ValueError, match="sirna 5"):
        build_plate_groups(read_csv(str(tmp_path / "bad.csv")), nb_classes=40)


def test_submission_bytes_match_rxtpu(tmp_path):
    ids = [f"U2OS-01_{p}_B{w:02d}" for p in (1, 2) for w in range(3, 9)]
    preds = np.random.default_rng(0).integers(0, 1108, len(ids)).astype(np.float64)
    rx_dir, port_dir = tmp_path / "rx", tmp_path / "port"
    rx_dir.mkdir()
    port_dir.mkdir()
    rx_path = rx_write_submission(pd.DataFrame({"id_code": ids, "plate": 1}), preds,
                                  "x", str(rx_dir))
    port_path = write_submission(ids, preds, "x", str(port_dir))
    with open(rx_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()


def test_pipeline_batches_bit_equal_to_rxtpu(synthetic_root, tmp_path):
    root, _ = synthetic_root
    rx_tools_main(["pack", "--data", root, "--out", str(tmp_path), "--splits", "test"])
    pack = str(tmp_path / "test.rxpack")
    rng = np.random.default_rng(0)
    rows, ctrl = rx_read_metadata_csvs(os.path.join(root, "metadata"), "test")
    stats = {e: {"mean": rng.uniform(0.2, 0.6, 6), "std": rng.uniform(0.1, 0.3, 6)}
             for e in rows.experiment.unique()}
    rx_pipe = RxPipeline(rx_load_metadata(rows, ctrl, "test"), RxPackStore(pack), stats,
                         5, "test", 64, seed=7, shuffle=False, drop_last=False)
    port_rows, port_ctrl = read_metadata_csvs(os.path.join(root, "metadata"), "test")
    pipe = Pipeline(load_metadata(port_rows, port_ctrl, "test"), PackStore(pack), stats,
                    5, seed=7)
    want, got = list(rx_pipe.epoch(0)), list(pipe.epoch(0))
    assert len(got) == len(want) == 3  # 12 wells in batches of 5: the last one padded
    for g, w in zip(got, want):
        assert g["id_codes"] == w["id_codes"]
        for k in ("images", "mean", "std", "valid"):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # the positive control really is drawn (2 per plate in this fixture)
    drawn = {tuple(b["images"][i, 4, 0, 0, :4]) for b in got for i in range(5)}
    assert len(drawn) > 1


def test_rxtpu_pickle_checkpoint_loads_without_jax_classes(tmp_path):
    from rxtpu.config import Config, ModelConfig, TrainConfig
    from rxtpu.train.checkpoint import save_checkpoint
    from rxtpu.train.setup import build_model, create_train_state

    cfg = Config(model=ModelConfig(backbone="resnet18", nb_classes=4, size_features=8),
                 train=TrainConfig(), experiment_id="ck")
    state, _ = create_train_state(cfg, build_model(cfg), steps_per_epoch=2)
    path = str(tmp_path / "best.ckpt")
    save_checkpoint(path, {"params": state.params, "batch_stats": state.batch_stats,
                           "opt_state": state.opt_state, "step": state.step})
    sd = load_checkpoint(path)
    want = from_flax(jax.device_get(state.params), jax.device_get(state.batch_stats))
    assert sorted(sd) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k].numpy(), err_msg=k)
    TwoSitesNN("resnet18", nb_classes=4, size_features=8).load_state_dict(sd)

    import pickle

    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    bad = str(tmp_path / "bad.ckpt")
    with open(bad, "wb") as f:
        pickle.dump({"params": Evil()}, f)
    with pytest.raises(pickle.UnpicklingError):
        load_checkpoint(bad)


_IMPORT_ALL = """
import sys, importlib, importlib.util, pkgutil
for name in ("jax", "jaxlib", "flax", "optax", "pandas", "sklearn", "tensorboardX",
             "rxtpu", "cv2", "PIL", "orbax", "tensorstore", "zarr", "numcodecs"):
    sys.modules[name] = None
import rxtpu_torch
mods = [m.name for m in pkgutil.walk_packages(rxtpu_torch.__path__, "rxtpu_torch.")]
for m in mods:
    importlib.import_module(m)
assert {"rxtpu_torch.tools", "rxtpu_torch.data.decode", "rxtpu_torch.ops.int8_conv",
        "rxtpu_torch.models.quant", "rxtpu_torch.infer.quant",
        "rxtpu_torch.models.densenet", "rxtpu_torch.models.heads",
        "rxtpu_torch.utils", "rxtpu_torch.utils.profiling", "rxtpu_torch.parallel",
        "rxtpu_torch.parallel.mesh", "rxtpu_torch.parallel.dp",
        "rxtpu_torch.parallel.multihost", "rxtpu_torch.analysis", "rxtpu_torch.entry",
        "rxtpu_torch.ops.batchnorm", "rxtpu_torch.ops.maxpool",
        "rxtpu_torch.train.ocdbt"} <= set(mods), mods
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(len(mods))
"""


def test_port_imports_without_jax_pandas_or_rxtpu(tmp_path):
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30  # every module of the package was walked
    # chip_smoke.py exits non-zero, printing no result, without a card here
    # and, anywhere, in a directory that holds nothing else of the repository
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    for cwd, script in ((REPO, "chip_smoke.py"), (str(tmp_path), "chip_smoke.py")):
        run = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                             text=True, timeout=120,
                             env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert run.returncode != 0
        assert '"ok"' not in run.stdout


def _f32(resolve):
    def patched(args):
        cfg = resolve(args)
        cfg.model.compute_dtype = "float32"
        return cfg
    return patched


@pytest.fixture(scope="module")
def trained_root(tmp_path_factory):
    """rxtpu trains a tiny resnet18 on a raw pack (tests/test_e2e.py:75-121)
    and writes its f32 test-phase submission."""
    root = tmp_path_factory.mktemp("slice")
    manifest = make_plate_balanced_synthetic_dataset(
        str(root / "data"), nb_classes=8, n_train_experiments=10,
        n_test_experiments=1, test_types=(0,), img_size=48)
    cwd = os.getcwd()
    os.chdir(root)
    mp = pytest.MonkeyPatch()
    try:
        rx_tools_main(["pack", "--data", "data", "--out", "packs"])
        mp.setattr(rx_cli, "resolve_config", _f32(rx_cli.resolve_config))
        assert rx_cli.main(ARGV) == 0
    finally:
        mp.undo()
        os.chdir(cwd)
    return root, manifest


ARGV = ["--experiment_id", "slice", "--nb-classes", "8", "--backbone", "resnet18",
        "--epochs", "1", "--batch-size", "2", "--crop-size", "32",
        "--experiment-types", "0", "--pack", "packs"]


def test_slice_submission_identical_to_rxtpu(trained_root, monkeypatch):
    root, manifest = trained_root
    monkeypatch.chdir(root)
    monkeypatch.setattr(port_cli, "resolve_config", _f32(port_cli.resolve_config))
    os.makedirs("port_out", exist_ok=True)
    assert port_cli.main(ARGV + ["--device", "cpu", "--out-dir", "port_out"]) == 0
    with open("submission_slice.csv", "rb") as a, \
            open("port_out/submission_slice.csv", "rb") as b:
        want, got = a.read(), b.read()
    assert got == want
    sub = pd.read_csv(io.BytesIO(got))
    assert len(sub) == len(manifest["test"]) == 8
    pg = manifest["plate_groups"]
    assert all(pg[r.sirna, 0] == int(r.id_code.split("_")[1]) for r in sub.itertuples())


def test_slice_jpeg_submission_identical_to_rxtpu(trained_root, monkeypatch):
    """rxtpu's default input: the port's CLI without ``--pack`` reads the JPEG
    tree under ``data/`` (preloaded bytes, libjpeg on the CPU; the source
    size from a JPEG header) and writes the submission rxtpu wrote from its
    pack of the same tree, byte for byte."""
    root, _ = trained_root
    monkeypatch.chdir(root)
    monkeypatch.setattr(port_cli, "resolve_config", _f32(port_cli.resolve_config))
    os.makedirs("port_jpeg", exist_ok=True)
    argv = ARGV[:ARGV.index("--pack")]
    assert port_cli.main(argv + ["--device", "cpu", "--out-dir", "port_jpeg"]) == 0
    with open("submission_slice.csv", "rb") as a, \
            open("port_jpeg/submission_slice.csv", "rb") as b:
        assert b.read() == a.read()


def test_slice_scan_window_submission_identical(trained_root, monkeypatch):
    """``--predict-scan-window 2``: both CLIs predict windows of 2 batches
    (the port's makes 2 per-batch calls a window on the CPU, one graph
    replay on the card); both write the submission of rxtpu's window 1,
    byte for byte."""
    root, _ = trained_root
    monkeypatch.chdir(root)
    with open("submission_slice.csv", "rb") as f:
        want = f.read()  # rxtpu, window 1
    for out in ("rx_scan", "port_scan"):
        os.makedirs(out, exist_ok=True)
    with monkeypatch.context() as mp:
        mp.setattr(rx_cli, "resolve_config", _f32(rx_cli.resolve_config))
        assert rx_cli.main(ARGV + ["--predict-scan-window", "2", "--out-dir", "rx_scan"]) == 0
    monkeypatch.setattr(port_cli, "resolve_config", _f32(port_cli.resolve_config))
    assert port_cli.main(ARGV + ["--device", "cpu", "--predict-scan-window", "2",
                                 "--out-dir", "port_scan"]) == 0
    for out in ("rx_scan", "port_scan"):
        with open(os.path.join(out, "submission_slice.csv"), "rb") as f:
            assert f.read() == want, out


def test_slice_probs_do_not_depend_on_batch_size(trained_root):
    """rxtpu predicts with global batch 2 x 8 virtual devices, the port with
    2 x 1: with BN folded, eval is per sample, so the batch size must not
    change a single probability."""
    root, _ = trained_root
    from rxtpu_torch.data.stats import load_stats

    model = TwoSitesNN("resnet18", nb_classes=8)
    model.load_state_dict(load_checkpoint(str(root / "models" / "best_model_slice.ckpt")))
    step = Predictor(model.eval(), dtype=torch.float32)
    rows, ctrl = read_metadata_csvs(str(root / "data" / "metadata"), "test")
    index = load_metadata(rows, ctrl, "test")
    store = PackStore(str(root / "packs" / "test.rxpack"))
    stats = load_stats(str(root / "stats_experiments.json"))
    results = [predict_dataset(step, Pipeline(index, store, stats, bs), torch.device("cpu"))
               for bs in (2, 16)]
    assert results[0][1] == results[1][1] == [r["id_code"] for r in rows]
    # torch's CPU convolutions block the batch differently at 2 and 16 rows,
    # so sums round differently in the last bits (measured: up to 1.5e-8 on
    # probabilities ~0.12, about one f32 ulp); allow a few ulps, no more
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=5e-7, atol=0)


def test_port_cli_on_synthetic_fixture(tmp_path, monkeypatch, capsys):
    """chip_smoke's test-phase run at a tiny size: the numpy-only fixture,
    a seeded random checkpoint in the port's format, the CLI in bf16 and
    with ``--quantize int8``."""
    import json

    from rxtpu_torch.data.synthetic import make_test_fixture, randomize_
    from rxtpu_torch.train.checkpoint import save_checkpoint

    fx = make_test_fixture(str(tmp_path), nb_classes=40, n_test_wells=12, img_size=48)
    monkeypatch.chdir(tmp_path)
    argv = ["--experiment_id", "fx", "--pack", fx["pack_dir"], "--data-dir", fx["data_dir"],
            "--stats", fx["stats"], "--nb-classes", "40", "--backbone", "resnet18",
            "--batch-size", "4", "--device", "cpu"]
    # without a best checkpoint the CLI trains first; this fixture holds no
    # train split (test_torch_port_trainloop.py trains on one)
    with pytest.raises(FileNotFoundError, match="train_controls.csv"):
        port_cli.main(argv)
    assert "########## TRAINING ##########" in capsys.readouterr().out
    save_checkpoint("models/best_model_fx.ckpt",
                    randomize_(TwoSitesNN("resnet18", nb_classes=40), seed=0).state_dict())
    assert port_cli.main(argv) == 0
    sub = pd.read_csv("submission_fx.csv")
    assert list(sub.id_code) == [r["id_code"] for r in fx["test_rows"]]
    pg = fx["plate_groups"]
    plates = sub.id_code.str.split("_").str[1].astype(int)
    assert (pg[sub.sirna, 0] == plates).all()
    assert all(g.sirna.is_unique for _, g in sub.groupby(plates))  # one-to-one per plate
    # --quantize int8: calibrated on the opening batches, the W8A8 test phase
    os.makedirs("int8")
    assert port_cli.main(argv + ["--quantize", "int8", "--out-dir", "int8"]) == 0
    sub8 = pd.read_csv("int8/submission_fx.csv")
    assert list(sub8.id_code) == list(sub.id_code)
    assert (pg[sub8.sirna, 0] == plates).all()
    assert all(g.sirna.is_unique for _, g in sub8.groupby(plates))
    # --assign-method greedy_jax on the run's device: the same plate-leak
    # assignment as greedy here; --profile traces training and the test
    # phase, and the best checkpoint skips training; --distributed with no cluster runs at world 1
    # (rxtpu's warning) and writes the same submission
    os.makedirs("gj")
    assert port_cli.main(argv + ["--assign-method", "greedy_jax", "--profile",
                                 "--out-dir", "gj"]) == 0
    sub_gj = pd.read_csv("gj/submission_fx.csv")
    assert list(sub_gj.id_code) == list(sub.id_code)
    assert list(sub_gj.sirna) == list(sub.sirna)
    assert os.listdir("board/fx/profile") == ["predict"]  # no training trace
    assert os.path.exists("board/fx/profile/predict/spans.jsonl")
    os.makedirs("dist")
    assert port_cli.main(argv + ["--distributed", "--out-dir", "dist"]) == 0
    assert "continuing single-process" in capsys.readouterr().err
    with open("dist/submission_fx.csv", "rb") as a, open("submission_fx.csv", "rb") as b:
        assert a.read() == b.read()
    assert not torch.distributed.is_initialized()
    with pytest.raises(SystemExit, match="supports resnet backbones with the mlp head and "
                                         "densenet121, got resnet18/arcface"):
        port_cli.main(argv + ["--quantize", "int8", "--head", "arcface"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli.main(argv[:-2])
    with open(fx["pack"] + ".json") as f:
        meta = json.load(f)
    meta["compress"] = "lz4"
    with open(fx["pack"] + ".json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="unknown pack compression 'lz4'"):
        PackStore(fx["pack"])
