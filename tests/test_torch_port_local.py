"""rxtpu's ``--debug`` local mode and ``--profile`` on the port, on the CPU.

rxtpu's local mode is ``--debug`` on a CPU backend (``rxtpu/cli.py:126``);
the port's is ``--debug --device cpu``:

- ``resolve_config`` field by field against rxtpu's, with and without
  ``--backbone``, ``--crop-size`` and ``--pretrained-path``; ``--debug`` on
  the card stays non-local;
- both CLIs end to end on one synthetic tree: the unstratified split's rows,
  the plate groups read from ``{data}/full_metadata/train.csv``, the
  submission's ids in rxtpu's order with a valid plate-leak assignment (the
  sirnas come from each side's own ``DummyClassifier`` draws), and
  ``--quantize int8``'s refusal with rxtpu's message;
- ``DummyClassifier``'s logits: shape, range, the 1e-4 grid, the seed;
- ``rxtpu_torch.utils.profiling``: ``trace`` writes a TensorBoard trace,
  ``profile_step_loop``'s summary has rxtpu's keys.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import shutil
import time

import numpy as np
import pandas as pd
import pytest
import torch

import rxtpu.cli as rx_cli
import rxtpu.data.records as rx_records
import rxtpu_torch.cli as port_cli
import rxtpu_torch.data.records as port_records
from rxtpu.data.synthetic import make_plate_balanced_synthetic_dataset
from rxtpu.tools import main as rx_tools_main
from rxtpu.utils import profile_step_loop as rx_profile_step_loop
from rxtpu_torch.models.twosites import DummyClassifier
from rxtpu_torch.utils.profiling import profile_step_loop, trace


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(cfg) -> dict:
    out = {}
    for part in ("data", "model", "train"):
        out.update({f"{part}.{k}": v for k, v in dataclasses.asdict(getattr(cfg, part)).items()})
    out.update(debug=cfg.debug, local=cfg.local, experiment_id=cfg.experiment_id)
    return out


@pytest.mark.parametrize("extra", [[], ["--backbone", "resnet34"], ["--crop-size", "40"],
                                   ["--pretrained-path", "r18.pth"],
                                   ["--backbone", "densenet121", "--crop-size", "64",
                                    "--batch-size", "3", "--epochs", "2"]])
def test_resolve_config_local_matches_rxtpu(extra):
    argv = ["--debug", "--experiment_id", "loc", "--nb-classes", "8"] + extra
    want = _flat(rx_cli.resolve_config(rx_cli.build_argparser().parse_args(argv)))
    got = _flat(port_cli.resolve_config(
        port_cli.build_argparser().parse_args(argv + ["--device", "cpu"])))
    assert got == want
    assert got["local"] and got["debug"]
    assert got["model.pretrained"] == ("--pretrained-path" in extra)
    if not extra:
        assert (got["model.backbone"], got["data.crop_size"], got["train.nb_epochs"],
                got["train.bs_per_device"], got["train.nb_examples"]) == ("resnet18", 48, 5, 2, 2)


def test_debug_on_the_card_is_not_local():
    args = port_cli.build_argparser().parse_args(["--debug", "--experiment_id", "c"])
    cfg = port_cli.resolve_config(args)  # --device cuda (the default): no card needed here
    assert cfg.debug and not cfg.local
    assert (cfg.model.backbone, cfg.data.crop_size, cfg.train.nb_epochs) == ("resnet50", 364, 100)
    assert cfg.train.nb_examples == cfg.train.bs_per_device == 16
    assert port_cli.decoder_threads(cfg) == port_cli.DECODER_THREADS


def test_dummy_classifier_logits():
    x = torch.zeros(4096, 6, 3, 2, 2, dtype=torch.uint8)
    a = DummyClassifier(nb_classes=37, seed=3)
    logits = a(x)
    assert logits.shape == (4096, 37) and logits.dtype == torch.float32
    v = logits.numpy()
    assert v.min() >= -1.0 and v.max() < 1.0
    ints = v.astype(np.float64) * 10000.0
    np.testing.assert_allclose(ints, np.round(ints), atol=1e-3)  # the 1e-4 grid
    assert np.unique(np.round(ints)).size > 10000  # spread over the grid's 20000 values
    assert abs(v.mean()) < 0.01 and 0.56 < v.std() < 0.60  # uniform on [-1, 1): std 0.577
    assert not torch.equal(a(x), logits)  # one draw per call
    assert torch.equal(DummyClassifier(nb_classes=37, seed=3)(x), logits)
    assert not torch.equal(DummyClassifier(nb_classes=37, seed=4)(x), logits)


def _spy(monkeypatch, module, name, log):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        log.append((args, kwargs, out))
        return out
    monkeypatch.setattr(module, name, spy)


def _ids(rows) -> list:
    return list(rows["id_code"]) if isinstance(rows, pd.DataFrame) else [r["id_code"]
                                                                        for r in rows]


def test_local_mode_end_to_end_matches_rxtpu(tmp_path, monkeypatch):
    """rxtpu's ``--debug`` on the CPU and the port's ``--debug --device cpu``
    on the same tree: resnet18 at crop 48, 5 epochs of one batch of 2, the
    unstratified split, plate groups from ``full_metadata``, DummyClassifier's
    test phase."""
    manifest = make_plate_balanced_synthetic_dataset(
        str(tmp_path / "data"), nb_classes=8, n_train_experiments=3, n_test_experiments=1,
        test_types=(0,), img_size=48)
    os.makedirs(tmp_path / "data" / "full_metadata")
    shutil.copy(tmp_path / "data" / "metadata" / "train.csv",
                tmp_path / "data" / "full_metadata" / "train.csv")
    monkeypatch.chdir(tmp_path)
    rx_tools_main(["pack", "--data", "data", "--out", "packs"])
    argv = ["--debug", "--experiment_id", "loc", "--nb-classes", "8", "--pack", "../packs",
            "--data-dir", "../data", "--stats", "../stats_experiments.json"]
    splits = {"rx": [], "port": []}
    reads = {"rx": [], "port": []}
    _spy(monkeypatch, rx_records, "stratified_split", splits["rx"])
    _spy(monkeypatch, port_records, "stratified_split", splits["port"])
    _spy(monkeypatch, pd, "read_csv", reads["rx"])
    _spy(monkeypatch, port_records, "read_csv", reads["port"])
    for side, cli, extra in (("rx", rx_cli, []), ("port", port_cli, ["--device", "cpu"])):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        assert cli.main(argv + extra) == 0, side
        assert os.path.exists("models/best_model_loc.ckpt")

    # the unstratified split: the same rows, in the same order
    (rx_args, rx_kw, (rx_train, rx_val)), = splits["rx"]
    (_, kw, (train, val)), = splits["port"]
    assert rx_kw == kw == {"stratify_by_sirna": False}
    assert _ids(train) == _ids(rx_train) and _ids(val) == _ids(rx_val)
    assert len(val) == 3 and len(train) == 21  # 24 rows, ceil(10%) held out
    # plate groups from full_metadata/train.csv, on both sides
    full = os.path.join("..", "data", "full_metadata", "train.csv")
    assert full in [a[0] for a, _, _ in reads["rx"]]
    assert full in [a[0] for a, _, _ in reads["port"]]

    sub_rx = pd.read_csv(tmp_path / "rx" / "submission_loc.csv")
    sub = pd.read_csv(tmp_path / "port" / "submission_loc.csv")
    assert list(sub.columns) == list(sub_rx.columns) == ["id_code", "sirna"]
    assert list(sub.id_code) == list(sub_rx.id_code) == list(manifest["test"].id_code)
    assert sub.sirna.dtype.kind == "i"
    pg = manifest["plate_groups"]
    plates = sub.id_code.str.split("_").str[1].astype(int)
    for s in (sub, sub_rx):
        assert (pg[s.sirna, 0] == plates).all()
        assert all(g.sirna.is_unique for _, g in s.groupby(plates))

    # --quantize int8 needs a trained model: both refuse with one message
    messages = []
    for side, cli, extra in (("rx", rx_cli, []), ("port", port_cli, ["--device", "cpu"])):
        monkeypatch.chdir(tmp_path / side)
        with pytest.raises(SystemExit) as exc:
            cli.main(argv + extra + ["--quantize", "int8"])
        messages.append(str(exc.value))
    assert messages[0] == messages[1] == (
        "--quantize int8 needs a trained model (unavailable with --debug local's "
        "DummyClassifier)")


def test_profile_trace_and_step_loop(tmp_path):
    logdir = str(tmp_path / "profile")
    with trace(logdir):
        torch.nn.functional.conv2d(torch.randn(1, 2, 8, 8), torch.randn(3, 2, 3, 3))
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert "aten::conv2d" in {e.get("name") for e in json.load(f)["traceEvents"]}
    with trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not os.path.exists(tmp_path / "off")

    calls = []

    def step(b):
        calls.append(b)
        time.sleep(0.01)
        return {"loss": torch.tensor(float(b))}

    summary = profile_step_loop(step, iter(range(5)), logdir=str(tmp_path / "loop"),
                                max_steps=3)
    assert calls == [0, 1, 2]
    assert sorted(summary) == sorted(rx_profile_step_loop(lambda b: b, iter(range(2))))
    assert summary["step_time_s"] > 0.005 and 0 <= summary["input_stall_pct"] <= 100
    assert len(glob.glob(str(tmp_path / "loop" / "*.pt.trace.json"))) == 1
