"""The reference against the port at tiny sizes on the CPU: the same
batches, the same augment, the same forward, train step and predict
arithmetic in float32 (the port's plain CPU versions of its kernels)."""

import json
import tempfile

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rxbench import check, spec
from rxbench.inputs import make_dataset
from rxbench.modes.predict import calibrated_state, normalized
from rxbench.modes.train import initial_state
from rxbench.reference import augment as ra
from rxbench.reference import batches as rb
from rxbench.reference.model import TwoSites
from rxbench.run import Job
from rxtpu_torch.data.pack import PackStore
from rxtpu_torch.data.pipeline import Pipeline
from rxtpu_torch.data.records import load_metadata
from rxtpu_torch.infer.fold import fold
from rxtpu_torch.models.twosites import TwoSitesNN
from rxtpu_torch.ops import augment_batch_shear
from rxtpu_torch.train.optim import make_schedule
from rxtpu_torch.train.step import TrainState, make_train_step, step_generators

SEED = 2 ** 31 + 77
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def train_ds():
    tr = {"mode": "train", "input": "raw_pack", "src": 64, "experiments": 1, "unique_views": 6}
    with tempfile.TemporaryDirectory() as d:
        yield make_dataset(tr, SEED, d, CPU)


def _port_model(cfg):
    return TwoSitesNN(backbone=cfg["backbone"], nb_classes=cfg["nb_classes"],
                      size_features=cfg["size_features"], dropout=cfg["dropout"],
                      head=cfg["head"], arcface_margin=cfg["arcface_margin"],
                      arcface_scale=cfg["arcface_scale"])


def _cfg(name):
    with open(f"{spec.ROOT}/rxbench/configs/{name}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("index", [0, 1])
def test_train_batches_equal_the_pipelines(train_ds, index):
    pipe = Pipeline(load_metadata(train_ds.rows, train_ds.control_rows, "train"),
                    PackStore(train_ds.pack_path), train_ds.stats, batch_size=4, mode="train",
                    seed=SEED)
    gen = pipe.epoch(1, start_batch=index)
    b = next(gen)
    gen.close()
    r = rb.train_batch(train_ds, SEED, 1, index, 4, CPU)
    assert np.array_equal(b["images"], r["images"].numpy())
    assert np.array_equal(b["labels"], r["labels"].numpy())
    assert np.array_equal(b["mean"], r["mean"].numpy()) and np.array_equal(b["std"],
                                                                           r["std"].numpy())


def test_test_rows_equal_the_pipelines(train_ds):
    pipe = Pipeline(load_metadata(train_ds.rows, train_ds.control_rows, "test"),
                    PackStore(train_ds.pack_path), train_ds.stats, batch_size=4, mode="test",
                    seed=SEED)
    gen = pipe.epoch(0, start_batch=2)
    b = next(gen)
    gen.close()
    r, ids = rb.test_rows(train_ds, [8, 9, 10, 11], SEED, CPU)
    assert np.array_equal(b["images"], r["images"].numpy()) and b["id_codes"] == ids


@pytest.mark.parametrize("step", [0, 5])
def test_augment_equals_the_ports(train_ds, step):
    b = rb.train_batch(train_ds, SEED, 1, 0, 4, CPU)
    aug, _ = step_generators(SEED, step, CPU)
    port = augment_batch_shear(b["images"], b["mean"], b["std"], aug, crop_size=48,
                               out_dtype=torch.float32)
    ref = ra.augment(b["images"], b["mean"], b["std"], ra.draws(SEED, step, 12, 64, 48), 48)
    assert torch.equal(port, ref)


@pytest.mark.parametrize("name", ["resnet50-mlp", "densenet121-arcface"])
def test_train_steps_agree_in_float32(train_ds, name):
    """Three steps in lockstep on the same float32 views (the port's
    ``augment="none"``): losses and first gradients agree."""
    cfg = _cfg(name)
    init = initial_state(cfg, SEED, CPU)
    port = _port_model(cfg)
    port.load_state_dict(init)
    state = TrainState.create(port, make_schedule(0.004, 100, 100, True), 0.9, True,
                              cfg["weight_decay"])
    step = make_train_step(port, 48, augment="none", compute_dtype=torch.float32)
    ref = TwoSites(cfg)
    ref.load_state_dict(init)
    for s in range(2):
        b = rb.train_batch(train_ds, SEED, 1, s, 8, CPU)
        views = ra.augment(b["images"], b["mean"], b["std"], ra.draws(SEED, s, 24, 64, 48), 48)
        labels = b["labels"].long()
        m = step(state, {**b, "images": views}, SEED, True)
        ref.ctx.generator = torch.Generator().manual_seed(ra.step_seed(SEED, s, 1))
        loss = F.cross_entropy(ref(views, labels), labels)
        assert float(m["loss"]) == pytest.approx(float(loss), rel=1e-4)
        if s == 0:
            grads = torch.autograd.grad(loss, list(ref.parameters()))
            g_port = {n: state.optimizer.state[p]["momentum_buffer"].clone()
                      for n, p in port.named_parameters()}
            g_ref = {n: g + cfg["weight_decay"] * init[n]
                     for (n, _), g in zip(ref.named_parameters(), grads)}
            assert set(g_ref) == set(g_port)
            numbers = check.train_numbers(
                {"losses": [0.0], "logits1": [], "g1": g_port, "delta": g_port},
                {"losses": [1.0], "logits1": [], "g1": g_ref, "delta": g_ref},
                {n: cfg["weight_decay"] * init[n] for n in g_ref})
            assert numbers["grad1_gap"] < 0.05
        with torch.no_grad():  # keep the reference in lockstep
            mine = dict(ref.named_parameters())
            for n, p in port.named_parameters():
                mine[n].copy_(p)


def test_predict_arithmetic_agrees_in_float32():
    cell = spec.load().cell("resnet50-mlp.predict")
    cell.traffic = {**cell.traffic, "src": 64, "experiments": 1, "unique_views": 6}
    with tempfile.TemporaryDirectory() as d:
        job = Job(cell, SEED, 0.0, False, CPU, d)
        ds = job.dataset()
        weights = calibrated_state(job, ds)
        port = _port_model(cell.config)
        port.load_state_dict(weights)
        twin, _ = fold(port.eval(), None, torch.float32)
        ref = TwoSites(cell.config)
        ref.load_state_dict(weights)
        ref.ctx.bn_mode = "eval"
        batch, _ = rb.test_rows(ds, [20, 21, 22], SEED, CPU)
        views = normalized(batch)
        with torch.no_grad():
            a, b = twin(views), ref(views)
    assert (a - b).abs().max() < 1e-3 * b.abs().max()
