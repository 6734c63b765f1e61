"""rxtpu_torch's training slice against rxtpu's, on the CPU.

- train / val ``Pipeline`` batches bit-equal to rxtpu's over the same raw
  pack (epochs 0 and 1, a mid-epoch start, two-site views);
- ``stratified_split`` and ``split_by_experiment``: rxtpu's rows in rxtpu's
  order, without sklearn or pandas;
- the slice in lockstep: from the same pack and weights, two train steps on
  the views each side's shear augment makes from rxtpu's draws, then one
  validation, in f32;
- the CLI on the numpy fixture: a tiny resnet18 trains, writes its best and
  last checkpoints and a submission, and a run stopped mid-epoch resumes to
  the same final weights as a run that was not stopped.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import rxtpu_torch.cli as port_cli
from rxtpu.config import Config, ModelConfig, TrainConfig
from rxtpu.data.pack import PackStore as RxPackStore
from rxtpu.data.pipeline import Pipeline as RxPipeline
from rxtpu.data.records import load_metadata as rx_load_metadata
from rxtpu.data.records import read_metadata_csvs as rx_read_metadata_csvs
from rxtpu.data.records import split_by_experiment as rx_split_by_experiment
from rxtpu.data.records import stratified_split as rx_stratified_split
from rxtpu.ops.shear import augment_batch_shear as rx_augment_batch_shear
from rxtpu.ops.warp import sample_affine_params as rx_sample_affine_params
from rxtpu.tools import main as rx_tools_main
from rxtpu.train.setup import build_model as rx_build_model
from rxtpu.train.setup import create_train_state as rx_create_train_state
from rxtpu.train.step import make_eval_step as rx_make_eval_step
from rxtpu.train.step import make_train_step as rx_make_train_step
from rxtpu_torch.data.pack import PackStore
from rxtpu_torch.data.pipeline import Pipeline
from rxtpu_torch.data.records import (
    load_metadata, read_metadata_csvs, split_by_experiment, stratified_split,
)
from rxtpu_torch.models.convert import from_flax
from rxtpu_torch.models.twosites import TwoSitesNN
from rxtpu_torch.ops.shear import apply_affine_shear
from rxtpu_torch.train import loop as port_loop
from rxtpu_torch.train.checkpoint import load_checkpoint, load_train_state
from rxtpu_torch.train.optim import make_schedule
from rxtpu_torch.train.step import TrainState, make_train_step

SRC, CROP = 64, 48


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run as fast on one intra-op thread, and the suite runs
    test files in parallel workers that would otherwise each start one
    thread per core and contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def train_pack(synthetic_root, tmp_path_factory):
    root, _ = synthetic_root
    out = tmp_path_factory.mktemp("trainpack")
    rx_tools_main(["pack", "--data", root, "--out", str(out), "--splits", "train"])
    rows, ctrl = rx_read_metadata_csvs(os.path.join(root, "metadata"), "train")
    port_rows, port_ctrl = read_metadata_csvs(os.path.join(root, "metadata"), "train")
    rng = np.random.default_rng(0)
    stats = {e: {"mean": rng.uniform(0.2, 0.6, 6), "std": rng.uniform(0.1, 0.3, 6)}
             for e in rows.experiment.unique()}
    pack = str(out / "train.rxpack")
    return (rx_load_metadata(rows, ctrl, "train"), load_metadata(port_rows, port_ctrl, "train"),
            pack, stats)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["id_codes"] == w["id_codes"]
        for k in ("images", "labels", "mean", "std", "valid"):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("mode,two_site", [("train", False), ("val", False), ("train", True)])
def test_pipeline_batches_bit_equal_to_rxtpu(train_pack, mode, two_site):
    rx_index, index, pack, stats = train_pack
    kw = dict(seed=3, two_site=two_site)
    if mode == "val":
        kw.update(shuffle=False, drop_last=False)
    rx_pipe = RxPipeline(rx_index, RxPackStore(pack), stats, 5, mode, SRC, **kw)
    pipe = Pipeline(index, PackStore(pack), stats, 5, mode, **kw)
    assert len(pipe) == len(rx_pipe) == (2 if mode == "train" else 3)
    for epoch in (0, 1):
        want = list(rx_pipe.epoch(epoch))
        _assert_batches_equal(list(pipe.epoch(epoch)), want)
        assert want[0]["images"].shape[1] == (6 if two_site else 3)
    _assert_batches_equal(list(pipe.epoch(1, start_batch=1)), list(rx_pipe.epoch(1, start_batch=1)))
    if mode == "train":
        # shuffled per epoch, one random site per view
        e0, e1 = list(pipe.epoch(0)), list(pipe.epoch(1))
        assert e0[0]["id_codes"] != e1[0]["id_codes"]


def _split_frame(n=240, seed=0):
    rng = np.random.default_rng(seed)
    exps = ["HUVEC-01", "HUVEC-02", "HUVEC-03", "HUVEC-04", "U2OS-01", "U2OS-02",
            "RPE-01", "RPE-02", "RPE-03"]
    return pd.DataFrame({"id_code": [f"w{i}" for i in range(n)],
                         "experiment": rng.choice(exps, n), "plate": rng.integers(1, 5, n),
                         "well": "B03", "sirna": rng.integers(0, 10, n)})


@pytest.mark.parametrize("stratify,frac", [(True, 0.1), (True, 0.25), (False, 0.1)])
def test_stratified_split_matches_rxtpu(stratify, frac):
    df = _split_frame()
    want_train, want_val = rx_stratified_split(df, frac, 42, stratify_by_sirna=stratify)
    got_train, got_val = stratified_split(df.to_dict("records"), frac, 42, stratify)
    assert [r["id_code"] for r in got_train] == list(want_train.id_code)
    assert [r["id_code"] for r in got_val] == list(want_val.id_code)


def test_split_by_experiment_matches_rxtpu():
    df = _split_frame(seed=1)
    for seed in (42, 7):
        want_train, want_val = rx_split_by_experiment(df, seed)
        got_train, got_val = split_by_experiment(df.to_dict("records"), seed)
        assert [r["id_code"] for r in got_train] == list(want_train.id_code)
        assert [r["id_code"] for r in got_val] == list(want_val.id_code)
        assert len(got_val) > 0 and set(r["experiment"] for r in got_val).isdisjoint(
            r["experiment"] for r in got_train)


def test_slice_in_lockstep_with_rxtpu(train_pack):
    """Two train steps and one validation, from the same pack and weights.
    Each side augments its own batch with rxtpu's draws through its own shear
    passes; both steps then run with ``augment="none"``.

    The two sides' bf16 views differ by one bf16 ulp in ~2.5e-4 of their
    values (where XLA's FMA moves an f32 shear result across a bf16 rounding
    boundary; ``tests/test_torch_port_augment.py``), and train-mode BNs
    amplify that: measured, the loss differs by 2e-5 at step 0 and 1.3e-4 at
    step 1, the validation loss by 2.7e-3 and the parameter updates by 4.1e-3
    relative L2. The bounds are 1e-3, 1e-2 and 2e-2."""
    rx_index, index, pack, stats = train_pack
    b, seed = 4, 0
    cfg = Config(model=ModelConfig(backbone="resnet18", nb_classes=8, size_features=16,
                                   dropout=0.0, compute_dtype="float32"),
                 train=TrainConfig(bs_per_device=b, lr=0.02, nb_epochs=2), experiment_id="ls")
    flax_model = rx_build_model(cfg)
    rx_train = RxPipeline(rx_index, RxPackStore(pack), stats, b, "train", SRC, seed=seed)
    train = Pipeline(index, PackStore(pack), stats, b, "train", seed=seed)
    state, lr = rx_create_train_state(cfg, flax_model, steps_per_epoch=len(rx_train))
    port = TwoSitesNN("resnet18", nb_classes=8, size_features=16, dropout=0.0)
    params0 = from_flax(jax.device_get(state.params), jax.device_get(state.batch_stats))
    port.load_state_dict(params0)
    pstate = TrainState.create(port, make_schedule(lr, 2, len(train)),
                               weight_decay=cfg.train.weight_decay)
    rx_step = rx_make_train_step(flax_model, CROP, donate=False, augment="none")
    step = make_train_step(port, CROP, augment="none", compute_dtype=torch.float32)
    base_key = jax.random.PRNGKey(seed)

    for i, (rx_batch, batch) in enumerate(zip(rx_train.epoch(0), train.epoch(0))):
        if i == 2:
            break
        np.testing.assert_array_equal(batch["images"], rx_batch["images"])
        aug_key, _ = jax.random.split(jax.random.fold_in(base_key, i))
        images, mean, std = (jnp.asarray(rx_batch[k]) for k in ("images", "mean", "std"))
        rx_views = rx_augment_batch_shear(images, mean, std, aug_key, crop_size=CROP)
        params = [torch.from_numpy(np.array(p))
                  for p in rx_sample_affine_params(aug_key, b * 3, SRC, CROP, True)]
        views = apply_affine_shear(*(torch.from_numpy(batch[k]) for k in ("images", "mean", "std")),
                                   *params, crop_size=CROP)
        state, m = rx_step(state, {"images": rx_views, "labels": jnp.asarray(rx_batch["labels"]),
                                   "mean": mean, "std": std}, base_key, jnp.asarray(True))
        pm = step(pstate, {"images": views, "labels": torch.from_numpy(batch["labels"]),
                           "mean": torch.from_numpy(batch["mean"]),
                           "std": torch.from_numpy(batch["std"])}, seed, True)
        ref_views = np.transpose(np.asarray(rx_views.astype(jnp.float32)), (0, 1, 4, 2, 3))
        np.testing.assert_allclose(views.float().numpy(), ref_views, rtol=2.0**-7, atol=1e-6)
        assert (views.float().numpy() != ref_views).mean() < 1e-3
        np.testing.assert_allclose(float(pm["loss"]), float(m["loss"]), rtol=1e-3)

    val_kw = dict(seed=seed, shuffle=False, drop_last=False)
    rx_eval = rx_make_eval_step(flax_model, CROP)
    want = {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
    for batch in RxPipeline(rx_index, RxPackStore(pack), stats, b, "val", SRC, **val_kw).epoch(0):
        batch.pop("id_codes")
        for k, v in rx_eval(state, {k: jnp.asarray(v) for k, v in batch.items()}).items():
            want[k] += float(v)
    got = port_loop.evaluate(pstate, Pipeline(index, PackStore(pack), stats, b, "val", **val_kw),
                             torch.device("cpu"), CROP, torch.float32)
    assert want["count"] == len(index)
    np.testing.assert_allclose(got["loss"], want["loss_sum"] / want["count"], rtol=1e-2)
    assert got["accuracy"] == want["correct"] / want["count"]

    ref = from_flax(jax.device_get(state.params), jax.device_get(state.batch_stats))
    final = port.state_dict()
    num = den = 0.0
    for k in ref:
        u = final[k].numpy() - params0[k].numpy()
        u_ref = ref[k].numpy() - params0[k].numpy()
        num += float(np.linalg.norm(u - u_ref)) ** 2
        den += float(np.linalg.norm(u_ref)) ** 2
    assert den > 0 and (num / den) ** 0.5 < 2e-2


ARGV = ["--experiment_id", "fx", "--nb-classes", "8", "--backbone", "resnet18",
        "--crop-size", "48", "--epochs", "2", "--batch-size", "2", "--split-by-experiment",
        "--no-plate-leak", "--checkpoint-every-steps", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def train_fixture(tmp_path_factory):
    from rxtpu_torch.data.synthetic import make_train_fixture

    root = tmp_path_factory.mktemp("trainfx")
    fx = make_train_fixture(str(root), nb_classes=8, n_experiments=3, wells_per_experiment=6,
                            n_test_wells=5, img_size=SRC)
    return fx, ["--pack", fx["pack_dir"], "--data-dir", fx["data_dir"], "--stats", fx["stats"]]


class _Stop(Exception):
    pass


def test_port_cli_trains_and_resumes(train_fixture, tmp_path, monkeypatch):
    fx, paths = train_fixture
    argv = ARGV + paths
    run_a, run_b = tmp_path / "a", tmp_path / "b"
    run_a.mkdir()
    run_b.mkdir()
    monkeypatch.chdir(run_a)
    assert port_cli.main(argv) == 0
    for name in ("best_model_fx.ckpt", "last_fx.ckpt"):
        assert load_train_state(f"models/{name}")["format"] == "rxtpu_torch"
    last = load_train_state("models/last_fx.ckpt")
    assert last["epoch"] == 2 and last["step"] == 12 and "batch_in_epoch" not in last  # 6/epoch
    assert last["optimizer"]["state"]  # momentum buffers travel with the weights
    sub = pd.read_csv("submission_fx.csv")
    assert list(sub.id_code) == [r["id_code"] for r in fx["test_rows"]]
    assert sub.sirna.between(0, 7).all()

    # run b is stopped after its 9th step (mid epoch 2), then resumed
    monkeypatch.chdir(run_b)
    real = port_loop.make_train_step

    def stopping(*a, **k):
        fn = real(*a, **k)

        def step(state, *args):
            if state.step == 9:
                raise _Stop
            return fn(state, *args)
        return step

    monkeypatch.setattr(port_loop, "make_train_step", stopping)
    with pytest.raises(_Stop):
        port_cli.main(argv)
    mid = load_train_state("models/last_fx.ckpt")
    assert mid["epoch"] == 2 and mid["batch_in_epoch"] == 3 and mid["step"] == 9
    monkeypatch.setattr(port_loop, "make_train_step", real)
    assert port_cli.main(argv + ["--resume"]) == 0
    want = load_checkpoint(str(run_a / "models" / "last_fx.ckpt"))
    got = load_checkpoint("models/last_fx.ckpt")
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with open(run_a / "submission_fx.csv", "rb") as f_a, open("submission_fx.csv", "rb") as f_b:
        assert f_a.read() == f_b.read()
    # resuming the finished run trains nothing and still writes the submission
    os.remove("submission_fx.csv")
    assert port_cli.main(argv + ["--resume"]) == 0
    assert torch.equal(load_checkpoint("models/last_fx.ckpt")["head.fc2.weight"],
                       want["head.fc2.weight"])
    assert os.path.exists("submission_fx.csv")


def test_port_cli_refuses_what_is_not_ported(train_fixture, tmp_path, monkeypatch):
    """``--checkpoint-backend orbax`` and ``--patience 0`` exit; ``--profile``
    traces training into ``board/{id}/profile``; ``--debug`` on the CPU runs
    rxtpu's local mode; a pickle without optax's sgd state does not resume."""
    fx, paths = train_fixture
    monkeypatch.chdir(tmp_path)
    argv = ARGV + paths
    with pytest.raises(SystemExit, match="not ported"):
        port_cli.main(argv + ["--checkpoint-backend", "orbax"])
    with pytest.raises(SystemExit, match="patience"):
        port_cli.main(argv + ["--early-stopping", "--patience", "0"])
    assert port_cli.main(argv + ["--profile", "--epochs", "1"]) == 0
    import glob
    import json

    traces = glob.glob("board/fx/profile/*.pt.trace.json")
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert "aten::convolution" in names and "aten::cross_entropy_loss" in names
    os.makedirs("local")
    monkeypatch.chdir(tmp_path / "local")
    assert port_cli.main(argv + ["--debug"]) == 0  # DummyClassifier's submission
    assert list(pd.read_csv("submission_fx.csv").id_code) == [r["id_code"]
                                                              for r in fx["test_rows"]]
    import pickle

    with open("models/last_fx.ckpt", "wb") as f:
        pickle.dump({"params": {}, "opt_state": None}, f)
    with pytest.raises(ValueError, match="no optax.sgd state"):
        port_cli.main(argv + ["--resume"])


def test_port_cli_pretrained_freeze_and_early_stopping(train_fixture, tmp_path, monkeypatch,
                                                       capsys):
    """--pretrained-path ports a torchvision resnet18 and trains the head only
    in epoch 1; --early-stopping --patience 1 stops after the first epoch
    whose val accuracy only ties the best (this fixture's accuracy is flat)."""
    from rxtpu.models.pretrained import synthetic_resnet_state_dict
    from rxtpu_torch.models.pretrained import port_torch_resnet

    fx, paths = train_fixture
    monkeypatch.chdir(tmp_path)
    sd = {k: torch.from_numpy(v) for k, v in synthetic_resnet_state_dict("resnet18").items()}
    torch.save(sd, "resnet18.pth")
    argv = ARGV + paths + ["--pretrained-path", "resnet18.pth", "--epochs", "3",
                           "--early-stopping", "--patience", "1"]
    assert port_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "head is unfrozen" in out and "EarlyStopping: stop after 1 epochs" in out
    assert "Turn on all the layers" not in out  # epoch 3 never ran
    last = load_train_state("models/last_fx.ckpt")
    assert last["epoch"] == 1 and last["epochs_without_improvement"] == 1
    ported = port_torch_resnet(sd, last["state_dict"], "resnet18")
    for k, v in last["state_dict"].items():
        if k.startswith("backbone.") and not k.endswith(("running_mean", "running_var")):
            assert torch.equal(v, ported[k]), k  # frozen: still the pretrained weights
    assert not torch.equal(last["state_dict"]["head.fc2.weight"],
                           load_train_state("models/best_model_fx.ckpt")["state_dict"]
                           ["head.fc2.weight"])
