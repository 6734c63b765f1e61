"""rxtpu_torch's scanned predict and eval steps (``WindowStep``: one CUDA
graph replay per window of K batches on the card, K per-batch calls on the
CPU) against its per-batch steps and rxtpu's scanned steps, on the CPU.

- ``predict_dataset`` in windows of K=3 over a 5-batch pipeline (the tail
  window padded by its last batch, the last batch by empty rows) against
  the per-batch drain, bit for bit: a tiny ResNet and a tiny DenseNet at
  64^2 sources and crop 48, f32, with and without TTA (``flips``,
  ``logits``), and in int8 with and without transforms;
- rxtpu's ``make_scanned_predict_step``, ``make_scanned_tta_predict_step``
  (``flips``, ``logits``) and ``make_scanned_quantized_predict_step``
  against the port's on weights carried across by ``models/convert.py``,
  at the per-batch tests' tolerances; ``make_scanned_eval_step``'s sums;
- the CLI with ``--predict-scan-window 3`` writes the window-1 submission's
  bytes, in bf16 and with ``--quantize int8``;
- a ``gpu`` test (skipped without a card) holds the graph replay against
  the per-batch step, two replays against each other, and the launch
  counts under replay.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rxtpu.infer import calibrate as rx_calibrate
from rxtpu.infer import prepare_quantized as rx_prepare_quantized
from rxtpu.infer.quant import make_scanned_quantized_predict_step as rx_scanned_quantized
from rxtpu.infer.tta import make_scanned_tta_predict_step as rx_scanned_tta
from rxtpu.infer.tta import tta_transforms as rx_tta_transforms
from rxtpu.models.twosites import TwoSitesNN as FlaxTwoSitesNN
from rxtpu.train.step import TrainState as RxTrainState
from rxtpu.train.step import make_scanned_eval_step as rx_scanned_eval
from rxtpu.train.step import make_scanned_predict_step as rx_scanned_predict
from rxtpu_torch import cli as port_cli
from rxtpu_torch.data.pack import PackStore
from rxtpu_torch.data.pipeline import Pipeline
from rxtpu_torch.data.records import load_metadata, read_metadata_csvs
from rxtpu_torch.data.stats import load_stats
from rxtpu_torch.data.synthetic import make_test_fixture, randomize_
from rxtpu_torch.infer.predict import (
    Predictor, make_scanned_tta_predict_step, predict_dataset, tta_transforms,
)
from rxtpu_torch.infer.quant import (
    QuantPredictor, calibrate, make_scanned_quantized_predict_step, prepare_quantized,
)
from rxtpu_torch.models.convert import from_flax, from_flax_quantized
from rxtpu_torch.models.twosites import TwoSitesNN
from rxtpu_torch.ops.crop_norm import crop_normalize
from rxtpu_torch.train.checkpoint import save_checkpoint
from rxtpu_torch.train.step import EvalStep, make_scanned_eval_step, make_scanned_predict_step
from test_torch_port_densenet import shallow_densenet
from test_torch_port_models import randomize_flax

KW = dict(backbone="resnet18", nb_classes=8, size_features=16)
K, CROP = 3, 48
RX_CROP = 24  # rxtpu's comparisons: 32^2 sources (its jitted steps compile faster)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def test_pipe(tmp_path_factory):
    """A 5-batch test pipeline (9 wells, batches of 2: the last holds one)."""
    fx = make_test_fixture(str(tmp_path_factory.mktemp("scan")), nb_classes=16,
                           n_test_wells=9, img_size=64)
    rows, ctrl = read_metadata_csvs(fx["data_dir"] + "/metadata", "test")
    pipe = Pipeline(load_metadata(rows, ctrl, "test"), PackStore(fx["pack"]),
                    load_stats(fx["stats"]), 2)
    assert len(pipe) == 5
    return pipe


def _step(backbone, mode, pipe):
    model = randomize_(TwoSitesNN(backbone, nb_classes=16, size_features=16), seed=0).eval()
    tta = "flips" if mode.endswith("flips") else "none"
    if not mode.startswith("int8"):
        return Predictor(model, CROP, tta, "logits", dtype=torch.float32)
    calib = next(iter(pipe.epoch(0)))
    qstats = calibrate(model, [{k: torch.from_numpy(calib[k]) for k in ("images", "mean", "std")}],
                       CROP, torch.float32)
    return QuantPredictor(prepare_quantized(model, qstats, torch.float32), CROP,
                          tta_transforms(tta) if tta != "none" else None, "logits")


@pytest.mark.parametrize("mode", ["f32", "f32_flips", "int8", "int8_flips"])
@pytest.mark.parametrize("backbone", ["resnet18", "densenet121"])
def test_scanned_predict_bit_equal_to_per_batch(test_pipe, backbone, mode):
    """Windows of 3 over 5 batches (3 + 2 and a pad slice) give the per-batch
    drain's probabilities and ids exactly; in f32, the CLI's shared
    ``scan_step`` too."""
    cpu = torch.device("cpu")
    with shallow_densenet():
        step = _step(backbone, mode, test_pipe)
        want, want_ids = predict_dataset(step, test_pipe, cpu)
        scan = {"scan_window": K} if mode != "f32" else \
            {"scan_step": make_scanned_predict_step(step, K)}
        got, got_ids = predict_dataset(step, test_pipe, cpu, **scan)
    assert want.shape == (9, 16) and len(want_ids) == 9
    assert got_ids == want_ids
    np.testing.assert_array_equal(got, want)


def test_window_step_shapes_and_cpu_path():
    """The runner's window check, and its K per-batch calls on the CPU."""
    calls = []

    def step(batch):
        calls.append(batch["images"].shape)
        return batch["images"].float().sum((1, 2, 3, 4, 5))[:, None]

    scan = make_scanned_predict_step(step, 2)
    images = torch.arange(2 * 3 * 1 * 1 * 1 * 2 * 2, dtype=torch.uint8).reshape(2, 3, 1, 1, 1, 2, 2)
    out = scan({"images": images, "mean": torch.zeros(2, 3, 1), "std": torch.ones(2, 3, 1)})
    assert out.shape == (2, 3, 1) and calls == [(3, 1, 1, 1, 2, 2)] * 2
    torch.testing.assert_close(out[1], images[1].float().sum((1, 2, 3, 4, 5))[:, None])
    assert scan.graph is None  # no graph on the CPU
    with pytest.raises(ValueError, match="window of 2"):
        scan({"images": images[:1], "mean": torch.zeros(1, 3, 1), "std": torch.ones(1, 3, 1)})
    with pytest.raises(ValueError, match="at least one"):
        make_scanned_predict_step(step, 0)


def _flax_pair(seed=2):
    """rxtpu's f32 flax resnet18 and state with random BN statistics, and the
    port's model with the same weights (``tests/test_torch_port_stem.py``)."""
    flax_model = FlaxTwoSitesNN(**KW, dtype=jnp.float32)
    variables = randomize_flax(flax_model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 3, 32, 32, 6)), train=False), seed + 1)
    fc2 = variables["params"]["head"]["fc2"]
    fc2["kernel"] = fc2["kernel"] * 0.1  # logits of a few units: a softmax far from one-hot
    state = RxTrainState.create(variables["params"], variables["batch_stats"],
                                optax.identity(), None)
    port = TwoSitesNN(**KW)
    port.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    return flax_model, state, port.eval()


def _window(rng, g, labels=False, src=32):
    w = {"images": rng.integers(0, 256, (K, 2, g, 6, src, src), dtype=np.uint8),
         "mean": rng.uniform(0.2, 0.6, (K, 2, 6)).astype(np.float32),
         "std": rng.uniform(0.1, 0.4, (K, 2, 6)).astype(np.float32)}
    if labels:
        w["labels"] = rng.integers(0, 8, (K, 2)).astype(np.int32)
        w["valid"] = np.ones((K, 2), np.float32)
        w["valid"][-1, 1] = 0.0
    return w


def _jax(w):
    return {k: jnp.asarray(v) for k, v in w.items()}


def _torch(w):
    return {k: torch.from_numpy(v) for k, v in w.items()}


@pytest.mark.parametrize("kind", ["predict", "tta_flips_logits", "int8", "int8_identity"])
def test_scanned_predict_matches_rxtpu(kind):
    """The port's scanned steps against rxtpu's on one window of 3 at 32^2 sources and crop 24: f32
    probabilities within the eval logits' atol (``tests/test_torch_parity.py:319``,
    1e-4); int8 with ``test_quant_predictor_matches_rxtpu``'s limits (the
    same argmax, atol 2e-3)."""
    flax_model, state, port = _flax_pair()
    w = _window(np.random.default_rng(3), 6)
    if kind == "predict":
        got = make_scanned_predict_step(Predictor(port, None, dtype=torch.float32), K)(_torch(w))
        want = rx_scanned_predict(flax_model, None)(state, _jax(w))
    elif kind == "tta_flips_logits":
        got = make_scanned_tta_predict_step(port, RX_CROP, "flips", "logits", K,
                                            torch.float32)(_torch(w))
        want = rx_scanned_tta(flax_model, RX_CROP, "flips", "logits")(state, _jax(w))
    else:
        calib = {k: jnp.asarray(v[0]) for k, v in w.items()}
        qvars = rx_prepare_quantized(flax_model, state,
                                     rx_calibrate(flax_model, state, [calib], RX_CROP))
        qnet = TwoSitesNN(**KW, quantized=True)
        qnet.load_state_dict(from_flax_quantized(jax.device_get(qvars)["params"]))
        identity = kind == "int8_identity"
        got = make_scanned_quantized_predict_step(
            qnet.eval(), RX_CROP, tta_transforms("none") if identity else None, "probs",
            K)(_torch(w))
        want = rx_scanned_quantized(
            flax_model, RX_CROP, transforms=rx_tta_transforms("none") if identity else None)(
            qvars, _jax(w))
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape == (K, 2, 8)
    assert want.max() - want.min() > 1e-3  # not a uniform softmax
    if kind.startswith("int8"):
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_scanned_eval_step_matches_rxtpu_and_per_batch():
    """``make_scanned_eval_step``'s sums over a window of 3 (one padding row)
    against rxtpu's (loss rtol 1e-5, counts and correct equal) and against 3
    ``EvalStep`` calls summed in f32, bit for bit."""
    flax_model, state, port = _flax_pair(seed=4)
    w = _window(np.random.default_rng(5), 3, labels=True)
    step = EvalStep(port, RX_CROP, torch.float32)
    got = make_scanned_eval_step(step, K)(_torch(w))
    want = rx_scanned_eval(flax_model, RX_CROP)(state, _jax(w))
    assert float(got["count"]) == float(want["count"]) == 2 * K - 1
    assert float(got["correct"]) == float(want["correct"])
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]), rtol=1e-5)
    per = [step({k: v[i] for k, v in _torch(w).items()}) for i in range(K)]
    for key in got:
        assert torch.equal(got[key], torch.stack([m[key] for m in per]).sum(0)), key


def test_cli_scan_window_submission_bytes(tmp_path, monkeypatch):
    """``--predict-scan-window 3`` over 7 test batches (windows 3, 3 and 1 +
    2 pad slices) writes window 1's submission bytes, in bf16 and with
    ``--quantize int8`` (the windowed step built after the calibration)."""
    fx = make_test_fixture(str(tmp_path), nb_classes=40, n_test_wells=14, img_size=48)
    monkeypatch.chdir(tmp_path)
    save_checkpoint("models/best_model_sw.ckpt",
                    randomize_(TwoSitesNN("resnet18", nb_classes=40), seed=0).state_dict())
    argv = ["--experiment_id", "sw", "--pack", fx["pack_dir"], "--data-dir", fx["data_dir"],
            "--stats", fx["stats"], "--nb-classes", "40", "--backbone", "resnet18",
            "--batch-size", "2", "--device", "cpu"]
    for extra in ([], ["--quantize", "int8"]):
        subs = []
        for window in ("1", "3"):
            out = f"out{len(extra)}_{window}"
            os.makedirs(out)
            assert port_cli.main(argv + extra + ["--predict-scan-window", window,
                                                 "--out-dir", out]) == 0
            with open(f"{out}/submission_sw.csv", "rb") as f:
                subs.append(f.read())
        assert subs[0] == subs[1] and subs[0].count(b"\n") == 15


@pytest.mark.gpu
def test_graph_replay_matches_per_batch_on_card():
    """On the card: the window's graph replay against the per-batch step on
    each slice, bit for bit; two replays of one window bit-equal; K1 counted
    once per slice per replay, and not for the warm-up or the capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph replays only on the card")
    dev = torch.device("cuda")
    model = randomize_(TwoSitesNN("resnet18", nb_classes=16, size_features=16), seed=0)
    step = Predictor(model.to(dev).eval(), CROP, dtype=torch.bfloat16)
    w = {k: v.to(dev) for k, v in _torch(_window(np.random.default_rng(6), 6, src=64)).items()}
    scan = make_scanned_predict_step(step, K)
    crop_normalize.launches = 0
    first = scan(w).clone()
    second = scan(w).clone()
    torch.cuda.synchronize()
    assert scan.graph is not None and crop_normalize.launches == 2 * K
    per = torch.stack([step({k: v[i] for k, v in w.items()}) for i in range(K)])
    assert torch.equal(first, second) and torch.equal(first, per)
