"""``--resume`` from rxtpu's pickle on the port, on the CPU.

- ``save_rxtpu_pickle`` against a pickle rxtpu itself wrote for the same
  weights: unpickled with optax, the same tree (optax's ``TraceState`` and
  ``ScaleByScheduleState``), the same arrays bit for bit, and rxtpu takes a
  step from it;
- rxtpu's rolling payload, written at an epoch end, mid-epoch and in a
  pretrained run's head-only epoch by rxtpu's train step and its
  ``save_checkpoint``: the port's momentum buffers after loading are rxtpu's
  trace after the layout change, bit for bit (zeros where the backbone is
  frozen, and set), and the next step equals rxtpu's next step (loss rtol
  1e-5, gradient norms rtol 1e-3, parameter updates within
  ``tests/test_torch_port_train.py``'s limits);
- the CLI: rxtpu's CLI is stopped mid-epoch and the port's ``--resume``
  carries on from rxtpu's rolling pickle: the epoch, the batch, the best
  metric, the epochs without improvement and the replayed batch ids.
"""

from __future__ import annotations

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rxtpu.cli as rx_cli
import rxtpu.data.pipeline as rx_pipeline
import rxtpu.train.loop as rx_loop
import rxtpu_torch.cli as port_cli
import rxtpu_torch.data.pipeline as port_pipeline
from rxtpu.config import Config, ModelConfig, TrainConfig
from rxtpu.data.synthetic import make_plate_balanced_synthetic_dataset
from rxtpu.tools import main as rx_tools_main
from rxtpu.train.checkpoint import save_checkpoint as rx_save_checkpoint
from rxtpu.train.setup import build_model as rx_build_model
from rxtpu.train.setup import create_train_state as rx_create_train_state
from rxtpu.train.step import make_train_step as rx_make_train_step
from rxtpu_torch.models.convert import from_flax
from rxtpu_torch.models.twosites import TwoSitesNN
from rxtpu_torch.train import loop as port_loop
from rxtpu_torch.train import optim
from rxtpu_torch.train.checkpoint import (
    is_port_format, load_train_state, save_rxtpu_pickle,
)
from rxtpu_torch.train.step import TrainState, make_train_step

KW = dict(backbone="resnet18", nb_classes=8, size_features=16)
B = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rx_run():
    """rxtpu's state and its jitted train step, and per-step batches."""
    cfg = Config(model=ModelConfig(**KW, dropout=0.0, compute_dtype="float32"),
                 train=TrainConfig(bs_per_device=B, lr=0.05, nb_epochs=3), experiment_id="r")
    model = rx_build_model(cfg)
    state, lr = rx_create_train_state(cfg, model, steps_per_epoch=1)
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(B, 3, 6, 48, 48)).astype(np.float32),
                rng.integers(0, 8, B).astype(np.int32)) for _ in range(3)]
    return cfg, state, lr, rx_make_train_step(model, 48, donate=False, augment="none"), batches


def _rx_step(rx_run, state, i, trainable):
    _, _, _, step, batches = rx_run
    views, labels = batches[i]
    return step(state, {"images": jnp.asarray(np.transpose(views, (0, 1, 3, 4, 2))),
                        "labels": jnp.asarray(labels), "mean": jnp.zeros((B, 6)),
                        "std": jnp.ones((B, 6))}, jax.random.PRNGKey(0), jnp.asarray(trainable))


def _rel(u: np.ndarray, u_ref: np.ndarray) -> float:
    return float(np.linalg.norm(u - u_ref) / max(np.linalg.norm(u_ref), 1e-30))


def _rolling_payload(state, **meta):
    """rxtpu's rolling checkpoint payload (``rxtpu/train/loop.py:149-155``)."""
    return {"params": state.params, "batch_stats": state.batch_stats,
            "opt_state": state.opt_state, "step": state.step, **meta}


def test_save_rxtpu_pickle_matches_rxtpus_own(rx_run, tmp_path):
    _, state, _, _, _ = rx_run
    state, _ = _rx_step(rx_run, state, 0, True)
    meta = dict(epoch=1, batch_in_epoch=1, best_metric=0.25, epochs_without_improvement=2)
    rx_path, path = str(tmp_path / "rx.ckpt"), str(tmp_path / "port.ckpt")
    rx_save_checkpoint(rx_path, _rolling_payload(state, **meta))
    loaded = load_train_state(rx_path)
    assert loaded["step"] == 1 and {k: loaded[k] for k in meta} == meta
    save_rxtpu_pickle(path, loaded["state_dict"], loaded["trace"], loaded["step"], **meta)
    assert not is_port_format(path)
    with open(rx_path, "rb") as f:
        want = pickle.load(f)
    with open(path, "rb") as f:
        got = pickle.load(f)
    assert list(got) == list(want)  # keys sorted, as rxtpu's tree_map leaves them
    assert type(got["opt_state"][0]) is type(want["opt_state"][0]) is optax.TraceState
    assert type(got["opt_state"][1]) is optax.ScaleByScheduleState
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # rxtpu takes its next step from the port's pickle as from its own
    resumed = [state.replace(step=p["step"], params=p["params"], batch_stats=p["batch_stats"],
                             opt_state=p["opt_state"]) for p in (got, want)]
    (_, m_got), (_, m_want) = (_rx_step(rx_run, st, 1, True) for st in resumed)
    assert float(m_got["loss"]) == float(m_want["loss"])


@pytest.mark.parametrize("case", ["epoch_end", "mid_epoch", "pretrained"])
def test_resumed_step_matches_rxtpu(rx_run, tmp_path, case):
    cfg, state, lr, _, batches = rx_run
    trainable = case != "pretrained"  # a pretrained run's head-only epochs
    for i in range(2):
        state, _ = _rx_step(rx_run, state, i, trainable)
    meta = dict(epoch=1, best_metric=0.125, epochs_without_improvement=0)
    if case == "mid_epoch":
        meta.update(epoch=2, batch_in_epoch=1)
    path = str(tmp_path / "last_r.ckpt")
    rx_save_checkpoint(path, _rolling_payload(state, **meta))

    # the port loads it as run_training does
    saved = load_train_state(path)
    port = TwoSitesNN(**KW, dropout=0.0)
    port.load_state_dict(saved["state_dict"])
    pstate = TrainState.create(port, optim.make_schedule(lr, 3, 1),
                               weight_decay=cfg.train.weight_decay)
    names = [n for n, _ in port.named_parameters()]
    pstate.optimizer.load_state_dict(optim.sgd_state_from_trace(pstate.optimizer, names,
                                                                saved["trace"]))
    pstate.step = saved["step"]
    assert pstate.step == int(state.step) == 2
    trace = from_flax(jax.device_get(state.opt_state[0].trace))
    for n, p in zip(names, port.parameters()):
        buf = pstate.optimizer.state[p]["momentum_buffer"]
        assert buf.dtype == p.dtype and torch.equal(buf, trace[n]), n
        if not trainable and n.startswith("backbone."):
            assert not buf.any(), n
    assert any(pstate.optimizer.state[p]["momentum_buffer"].any() for p in port.parameters())

    # the next step on both sides
    params0 = {k: v.clone() for k, v in port.state_dict().items()}
    state, m = _rx_step(rx_run, state, 2, trainable)
    views, labels = batches[2]
    step = make_train_step(port, 48, augment="none", compute_dtype=torch.float32)
    pm = step(pstate, {"images": torch.from_numpy(views), "labels": torch.from_numpy(labels),
                       "mean": torch.zeros(B, 6), "std": torch.ones(B, 6)}, 0, trainable)
    assert pstate.step == int(state.step) == 3
    np.testing.assert_allclose(float(pm["loss"]), float(m["loss"]), rtol=1e-5)
    assert float(pm["lr"]) == pytest.approx(float(m["lr"]), rel=1e-6)
    for k in ("grad_norm", "grad_norm/backbone", "grad_norm/head"):
        np.testing.assert_allclose(float(pm[k]), float(m[k]), rtol=1e-3, err_msg=k)
    ref = from_flax(jax.device_get(state.params), jax.device_get(state.batch_stats))
    got = port.state_dict()
    num = den = 0.0
    for k in ref:
        u, u_ref = (got[k] - params0[k]).numpy(), (ref[k] - params0[k]).numpy()
        if not trainable and k in names and k.startswith("backbone."):
            # frozen: unchanged to the bit, momentum still exactly zero
            assert torch.equal(got[k], params0[k]), k
            p = dict(port.named_parameters())[k]
            assert not pstate.optimizer.state[p]["momentum_buffer"].any(), k
            continue
        if np.linalg.norm(u_ref) > 0:
            assert _rel(u, u_ref) < 3e-2, (k, _rel(u, u_ref))
        num += float(np.linalg.norm(u - u_ref)) ** 2
        den += float(np.linalg.norm(u_ref)) ** 2
    assert den > 0 and (num / den) ** 0.5 < 1e-3


class _Stop(Exception):
    pass


ARGV = ["--experiment_id", "rs", "--nb-classes", "8", "--backbone", "resnet18",
        "--epochs", "2", "--crop-size", "32", "--split-by-experiment",
        "--checkpoint-every-steps", "1", "--no-plate-leak", "--pack", "packs"]
# rxtpu's batch is per device, and its tests run 8 CPU devices: one global
# batch of 8 on both sides
RX_BATCH, PORT_BATCH = ["--batch-size", "1"], ["--batch-size", "8"]


def test_port_cli_resumes_rxtpu_cli_checkpoint(tmp_path, monkeypatch, capsys):
    """rxtpu's CLI trains and is stopped after step 6 (mid epoch 2 of 4
    steps each); the port's ``--resume`` picks up rxtpu's rolling pickle."""
    make_plate_balanced_synthetic_dataset(str(tmp_path / "data"), nb_classes=8,
                                          n_train_experiments=6, n_test_experiments=1,
                                          test_types=(0,), img_size=48)
    monkeypatch.chdir(tmp_path)
    rx_tools_main(["pack", "--data", "data", "--out", "packs"])
    real_step = rx_loop.make_train_step

    def stopping(*a, **k):
        fn = real_step(*a, **k)
        calls = []

        def step(*args):
            if len(calls) == 6:
                raise _Stop
            calls.append(1)
            return fn(*args)
        return step

    rx_train_pipes = []
    real_rx_init = rx_pipeline.Pipeline.__init__

    def rx_init(self, *a, **k):
        real_rx_init(self, *a, **k)
        if self.mode == "train":
            rx_train_pipes.append(self)

    monkeypatch.setattr(rx_loop, "make_train_step", stopping)
    monkeypatch.setattr(rx_pipeline.Pipeline, "__init__", rx_init)
    with pytest.raises(_Stop):
        rx_cli.main(ARGV + RX_BATCH)
    monkeypatch.undo()
    monkeypatch.chdir(tmp_path)
    with open("models/last_rs.ckpt", "rb") as f:
        rx_saved = pickle.load(f)
    assert (rx_saved["epoch"], rx_saved["batch_in_epoch"], int(rx_saved["step"])) == (2, 2, 6)
    assert not is_port_format("models/best_model_rs.ckpt")

    # the port resumes: the loop's state, the best metric it starts from and
    # the train batches it replays
    replayed = []
    real_epoch = port_pipeline.Pipeline.epoch

    def epoch(self, e, start_batch=0):
        for b in real_epoch(self, e, start_batch=start_batch):
            if self.mode == "train":
                replayed.append((e, b["id_codes"]))
            yield b
    bests = []

    class Best(port_loop.BestCheckpointer):
        def update(self, metric, payload):
            bests.append(self.best)
            improved = super().update(metric, payload)
            bests.append(improved)
            return improved

    monkeypatch.setattr(port_pipeline.Pipeline, "epoch", epoch)
    monkeypatch.setattr(port_loop, "BestCheckpointer", Best)
    capsys.readouterr()
    assert port_cli.main(ARGV + PORT_BATCH + ["--resume", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Resumed mid-epoch 2 at batch 2 (step 6)" in out
    assert bests[0] == rx_saved["best_metric"]  # the first validation compares to rxtpu's best
    want = [b["id_codes"] for b in rx_train_pipes[0].epoch(2, start_batch=2)]
    assert [e for e, _ in replayed] == [2] * len(want) and len(want) == 2
    assert [ids for _, ids in replayed] == want
    last = load_train_state("models/last_rs.ckpt")
    assert last["format"] == "rxtpu_torch" and last["epoch"] == 2 and last["step"] == 8
    improved = bests[1]
    assert last["epochs_without_improvement"] == (
        0 if improved else rx_saved["epochs_without_improvement"] + 1)
    # rxtpu's best checkpoint stays until a better one is written
    assert is_port_format("models/best_model_rs.ckpt") == improved
    assert os.path.exists("submission_rs.csv")
