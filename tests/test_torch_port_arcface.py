"""rxtpu_torch's ArcFace head (BASELINE config 4) against rxtpu's, on the CPU.

- ``ArcFaceHead`` against rxtpu's with dropout 0, in f32: eval logits
  (``scale * cos``), train logits with labels (the margin on the target
  class only), and the cross-entropy and its gradients (``jax.grad``
  against autograd);
- ``TwoSitesNN(head="arcface", control_calibration=True)`` on a shallow
  DenseNet: eval and train logits;
- one SGD step of the port's train step against rxtpu's in lockstep (loss
  rtol 1e-5, gradient norms rtol 1e-3, as
  ``tests/test_torch_port_train.py:126``), DenseNet + ArcFace + calibration;
- the ``EvalStep`` sums on a ResNet with the ArcFace head, which does not fold;
- the CLI: rxtpu's CLI trains a ``densenet121 --head arcface --calibrate``
  model briefly (blocks 2/2/2/2) and writes its f32 submission; the port's
  CLI test phase on rxtpu's checkpoint writes the same bytes; ``--quantize
  int8 --head arcface`` exits with rxtpu's message.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import rxtpu.cli as rx_cli
import rxtpu_torch.cli as port_cli
from rxtpu.config import Config, ModelConfig, TrainConfig
from rxtpu.data.synthetic import make_plate_balanced_synthetic_dataset
from rxtpu.models.heads import ArcFaceHead as RxArcFaceHead
from rxtpu.models.twosites import TwoSitesNN as FlaxTwoSitesNN
from rxtpu.tools import main as rx_tools_main
from rxtpu.train.setup import build_model as rx_build_model
from rxtpu.train.setup import create_train_state as rx_create_train_state
from rxtpu.train.step import TrainState as RxTrainState
from rxtpu.train.step import make_eval_step as rx_make_eval_step
from rxtpu.train.step import make_train_step as rx_make_train_step
from rxtpu.train.step import cross_entropy as rx_cross_entropy
from rxtpu_torch.models.convert import from_flax
from rxtpu_torch.models.heads import ArcFaceHead
from rxtpu_torch.models.twosites import TwoSitesNN
from rxtpu_torch.train import optim
from rxtpu_torch.train.step import EvalStep, TrainState, make_train_step
from test_torch_port_densenet import _nchw, randomize_port, shallow_densenet, to_flax
from test_torch_port_models import assert_logits_close

KW = dict(nb_classes=8, size_features=16, head="arcface")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_arcface_head_matches_rxtpu():
    """Eval logits, train logits with labels and the loss with its gradients,
    f32. Measured: logits within 2e-6 of their scale, gradients within 1e-5
    relative L2."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 48)).astype(np.float32)
    labels = rng.integers(0, 8, 6).astype(np.int32)
    rx = RxArcFaceHead(nb_classes=8, size_features=16, dropout=0.0, dtype=jnp.float32)
    head = randomize_port(ArcFaceHead(48, 8, 16, dropout=0.0), 1)
    assert tuple(head.weight.shape) == (16, 8)
    variables = to_flax({f"head.{k}": v for k, v in head.state_dict().items()})
    variables = {k: v["head"] for k, v in variables.items()}

    want = np.asarray(jax.jit(lambda v, x: rx.apply(v, x, train=False))(variables, jnp.asarray(x)))
    got = head.eval()(torch.from_numpy(x)).detach().numpy()
    assert_logits_close(got, want)
    assert np.abs(want).max() <= 30.0  # scale * cos

    def rx_loss(params):
        logits, _ = rx.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             jnp.asarray(x), train=True, labels=jnp.asarray(labels),
                             mutable=["batch_stats"])
        return rx_cross_entropy(logits, jnp.asarray(labels)), logits

    (loss_ref, logits_ref), grads = jax.jit(jax.value_and_grad(rx_loss, has_aux=True))(
        variables["params"])
    logits = head.train()(torch.from_numpy(x), torch.from_numpy(labels))
    assert_logits_close(logits.detach().numpy(), np.asarray(logits_ref))
    plain = head(torch.from_numpy(x)).detach().numpy()  # train mode, no labels: no margin
    onehot = np.eye(8, dtype=bool)[labels]
    margin = logits.detach().numpy()
    np.testing.assert_array_equal(margin[~onehot], plain[~onehot])
    assert (margin[onehot] < plain[onehot]).all()  # cos(t + m) < cos(t)
    loss = F.cross_entropy(logits, torch.from_numpy(labels).long())
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    loss.backward()
    want_g = from_flax(jax.device_get(grads))
    for name, p in head.named_parameters():
        g, g_ref = p.grad.numpy(), want_g[name].numpy()
        assert np.linalg.norm(g_ref) > 0, name
        assert np.linalg.norm(g - g_ref) <= 1e-4 * np.linalg.norm(g_ref), name


def test_two_sites_arcface_calibrated_matches_rxtpu():
    """``TwoSitesNN(head="arcface", control_calibration=True)`` on a shallow
    DenseNet: eval logits against rxtpu's. In train mode with labels (8 wells
    of 64^2 views), rxtpu's f32 logits lie 1.1e-4 of max|logit| from the
    port's, past the eval bound: the train-mode BNs amplify f32 rounding
    (``test_two_sites_densenet_train_forward_matches_rxtpu``), and the head's
    norms turn the embedding's error into the scaled cosines'. So the train
    logits are held to the same forward in f64 (measured 2.3e-5 of
    max|logit|; limit 5e-5) and, on
    rxtpu's, to the margin: the labels reach the head, the target class alone
    moves."""
    with shallow_densenet():
        flax_model = FlaxTwoSitesNN(backbone="densenet121", **KW, dropout=0.0,
                                    control_calibration=True, dtype=jnp.float32)
        port = randomize_port(TwoSitesNN("densenet121", **KW, dropout=0.0,
                                         control_calibration=True), 2)
        x = np.random.default_rng(1).normal(size=(8, 3, 64, 64, 6)).astype(np.float32)
        labels = np.array([1, 5, 2, 7, 0, 3, 3, 6], np.int32)
        variables = to_flax(port.state_dict())
        ref_eval, (ref_train, _), (ref_plain, _) = jax.jit(lambda v, x, y: (
            flax_model.apply(v, x, train=False),
            flax_model.apply(v, x, train=True, labels=y, mutable=["batch_stats"]),
            flax_model.apply(v, x, train=True, mutable=["batch_stats"])))(
            variables, jnp.asarray(x), jnp.asarray(labels))
        f64 = TwoSitesNN("densenet121", **KW, dropout=0.0, control_calibration=True)
    assert port.arch["head"] == "arcface" and port.arch["arcface_margin"] == 0.3
    f64.load_state_dict(port.state_dict())
    with torch.no_grad():
        got = port.eval()(_nchw(x)).numpy()
        got_train = port.train()(_nchw(x), labels=torch.from_numpy(labels)).numpy()
        exact = f64.double().train()(_nchw(x).double(), labels=torch.from_numpy(labels))
    assert_logits_close(got, np.asarray(ref_eval))
    exact = exact.numpy()
    assert np.abs(got_train - exact).max() < 5e-5 * np.abs(exact).max()
    onehot = np.eye(8, dtype=bool)[labels]
    rx_margin = np.asarray(ref_train) - np.asarray(ref_plain)
    assert (rx_margin[~onehot] == 0).all() and (rx_margin[onehot] < 0).all()


def test_sgd_step_arcface_densenet_matches_rxtpu():
    """One SGD step of DenseNet + ArcFace + control calibration in lockstep
    with rxtpu's (labels into the head, so the margin logits feed the loss)."""
    b = 4
    with shallow_densenet():
        cfg = Config(model=ModelConfig(backbone="densenet121", **KW, dropout=0.0,
                                       control_calibration=True, compute_dtype="float32"),
                     train=TrainConfig(bs_per_device=b, lr=0.05, nb_epochs=3),
                     experiment_id="a")
        flax_model = rx_build_model(cfg)
        state, lr = rx_create_train_state(cfg, flax_model, steps_per_epoch=1)
        rng = np.random.default_rng(0)
        views = rng.normal(size=(b, 3, 6, 32, 32)).astype(np.float32)
        labels = rng.integers(0, 8, b).astype(np.int32)
        rx_step = rx_make_train_step(flax_model, 32, donate=False, augment="none")
        _, m = rx_step(state, {"images": jnp.asarray(np.transpose(views, (0, 1, 3, 4, 2))),
                               "labels": jnp.asarray(labels), "mean": jnp.zeros((b, 6)),
                               "std": jnp.ones((b, 6))},
                       jax.random.PRNGKey(0), jnp.asarray(True))
        port = TwoSitesNN("densenet121", **KW, dropout=0.0, control_calibration=True)
    port.load_state_dict(from_flax(jax.device_get(state.params),
                                   jax.device_get(state.batch_stats)))
    pstate = TrainState.create(port, optim.make_schedule(lr, 3, 1),
                               weight_decay=cfg.train.weight_decay)
    step = make_train_step(port, 32, augment="none", compute_dtype=torch.float32)
    pm = step(pstate, {"images": torch.from_numpy(views), "labels": torch.from_numpy(labels),
                       "mean": torch.zeros(b, 6), "std": torch.ones(b, 6)}, 0, True)
    assert sorted(pm) == sorted(m)
    np.testing.assert_allclose(float(pm["loss"]), float(m["loss"]), rtol=1e-5)
    assert float(pm["accuracy"]) == float(m["accuracy"])
    for k in ("grad_norm", "grad_norm/backbone", "grad_norm/head"):
        np.testing.assert_allclose(float(pm[k]), float(m[k]), rtol=1e-3, err_msg=k)


def test_eval_step_arcface_matches_rxtpu():
    """A ResNet with the ArcFace head does not fold: ``EvalStep`` evaluates it
    unfolded; its sums against rxtpu's eval step."""
    kw = dict(backbone="resnet18", **KW)
    flax_model = FlaxTwoSitesNN(**kw, dtype=jnp.float32)
    port = randomize_port(TwoSitesNN(**kw), 4)
    variables = to_flax(port.state_dict())
    state = RxTrainState.create(variables["params"], variables["batch_stats"],
                                optax.identity(), None)
    rng = np.random.default_rng(6)
    batch = {"images": rng.integers(0, 256, (4, 3, 6, 64, 64), dtype=np.uint8),
             "labels": rng.integers(0, 8, 4).astype(np.int32),
             "mean": rng.uniform(0.1, 0.6, (4, 6)).astype(np.float32),
             "std": rng.uniform(0.05, 0.3, (4, 6)).astype(np.float32),
             "valid": np.array([1, 1, 1, 0], np.float32)}
    ref = rx_make_eval_step(flax_model, 48)(state, {k: jnp.asarray(v) for k, v in batch.items()})
    got = EvalStep(port, 48, torch.float32)({k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(got["count"]) == float(ref["count"]) == 3.0
    assert float(got["correct"]) == float(ref["correct"])
    np.testing.assert_allclose(float(got["loss_sum"]), float(ref["loss_sum"]), rtol=1e-5)
    with pytest.raises(ValueError, match="BN-foldable"):
        EvalStep(port, 48, torch.float32, fused_stem=True)
    with pytest.raises(ValueError, match="mlp head only"):
        TwoSitesNN(**kw, quantized=True)


def _f32(resolve):
    def patched(args):
        cfg = resolve(args)
        cfg.model.compute_dtype = "float32"
        return cfg
    return patched


ARGV = ["--experiment_id", "arc", "--nb-classes", "8", "--backbone", "densenet121",
        "--head", "arcface", "--calibrate", "--epochs", "1", "--batch-size", "2",
        "--crop-size", "32", "--experiment-types", "0", "--tta", "flips", "--pack", "packs"]


def test_cli_densenet_arcface_submission_identical_to_rxtpu(tmp_path, monkeypatch):
    """rxtpu's CLI trains ``densenet121 --head arcface --calibrate`` (blocks
    2/2/2/2) for an epoch and writes its f32 submission (``--tta flips``);
    the port's CLI test phase on that checkpoint writes the same bytes.
    ``--quantize int8`` with the ArcFace head exits with rxtpu's message."""
    make_plate_balanced_synthetic_dataset(
        str(tmp_path / "data"), nb_classes=8, n_train_experiments=10,
        n_test_experiments=1, test_types=(0,), img_size=48)
    monkeypatch.chdir(tmp_path)
    with shallow_densenet():
        rx_tools_main(["pack", "--data", "data", "--out", "packs"])
        monkeypatch.setattr(rx_cli, "resolve_config", _f32(rx_cli.resolve_config))
        assert rx_cli.main(ARGV) == 0
        monkeypatch.setattr(port_cli, "resolve_config", _f32(port_cli.resolve_config))
        os.makedirs("port_out")
        assert port_cli.main(ARGV + ["--device", "cpu", "--out-dir", "port_out"]) == 0
        for cli in (rx_cli, port_cli):
            with pytest.raises(SystemExit, match="supports resnet backbones with the mlp head "
                                                 "and densenet121, got densenet121/arcface"):
                cli.main(ARGV + ["--quantize", "int8"]
                         + (["--device", "cpu"] if cli is port_cli else []))
    with open("submission_arc.csv", "rb") as a, open("port_out/submission_arc.csv", "rb") as b:
        want, got = a.read(), b.read()
    assert got == want and len(want.splitlines()) > 2
