"""A run with its timed path broken underneath comes out not correct: a
step that leaves the state unchanged, a step over half of the batch (the
mean over the rest), an answer altered where it is produced. The control
(float8 for the train cell, the port's int8 path for the predict cell)
at the cell's own size fails the cell's limits, on the card."""

import pytest
import torch

from conftest import tiny_cell
from rxbench import run

CPU = "cpu"
SEED = 2 ** 31 + 99


def _unchanged(real):
    def make(model, *a, **kw):
        step = real(model, *a, **kw)

        def broken(state, batch, seed, trainable):
            with torch.no_grad():
                saved = [p.clone() for p in state.model.parameters()]
            m = step(state, batch, seed, trainable)
            with torch.no_grad():
                for p, s in zip(state.model.parameters(), saved):
                    p.copy_(s)
            state.optimizer.state.clear()
            return m
        return broken
    return make


def _half(real):
    def make(model, *a, **kw):
        step = real(model, *a, **kw)

        def broken(state, batch, seed, trainable):
            n = batch["images"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()}, seed, trainable)
        return broken
    return make


def test_an_unbroken_train_run_is_correct():
    # 16 wells: at 8 the train step's BNs see too few rows to be steady
    res = run.execute(tiny_cell("resnet50-mlp.train", bs_per_device=16), SEED, 0.1, False,
                      CPU)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("fault", [_unchanged, _half])
def test_train_faults_are_not_correct(monkeypatch, fault):
    import rxtpu_torch.train.step as port_step

    monkeypatch.setattr(port_step, "make_train_step", fault(port_step.make_train_step))
    res = run.execute(tiny_cell("resnet50-mlp.train"), SEED, 0.1, False, CPU)
    assert res["correct"] is False and res["failed"] >= 1


def test_an_altered_answer_is_not_correct(monkeypatch):
    from rxtpu_torch.infer.predict import Predictor

    real = Predictor.__call__

    def altered(self, batch):  # each answer is its neighbour's
        return real(self, batch).roll(1, 0)

    monkeypatch.setattr(Predictor, "__call__", altered)
    res = run.execute(tiny_cell("resnet50-mlp.predict", bs_per_device=4), SEED, 0.1, False,
                      CPU)
    assert res["correct"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["resnet50-mlp.train", "resnet50-mlp.predict"])
def test_control_fails_at_the_cells_size(card, workload):
    from rxbench import spec
    from rxbench.check import judge
    from rxbench.readings import predict_readings, train_readings
    import tempfile

    cell = spec.load().cell(workload)
    with tempfile.TemporaryDirectory() as d:
        job = run.Job(cell, SEED, 0.0, False, card, d)
        fn = train_readings if cell.traffic["mode"] == "train" else predict_readings
        numbers = fn(job, {"control"})["control"]
    numbers.pop("worst_leaves", None)
    assert not all(c["ok"] for c in judge(numbers, cell.limits).values())
