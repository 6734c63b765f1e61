"""rxtpu_torch's W8A8 int8 inference against rxtpu's, on the CPU.

- K8's plain version ``int8_conv_reference`` against rxtpu's ``QuantConv``
  on the same int8 inputs and parameters, for each ResNet conv kind (stem
  7x7/2 with 6 channels, 1x1/1, 3x3/1, 3x3/2, the 1x1/2 projection), with and
  without residual (int8 or float), ReLU and requantize: the int32 sums
  equal, .5 ties rounded alike, float outputs equal, int8 outputs equal
  but for the +-1 flips that XLA CPU's FMA contraction may cause
  (``ROADMAP.md`` queue 3; measured: none);
- ``quant_max_pool`` bit-equal; ``calibrate``'s ranges within rtol 1e-5;
  ``quantize_variables`` on the same f32 folded weights and stats bit-equal;
- the whole ``QuantPredictor`` on rxtpu's prepared weights (``qvars``
  carried across by ``from_flax_quantized``), with TTA transforms (the
  CLI's path: bf16 views, the stem quantizes) and without (K1 writes int8
  views), for resnet18 and resnet50; the port's own int8 path against its
  f32 forward within ``tests/test_quant.py``'s limits; the CLI's guards;
- DenseNet-121's int8 (blocks 2/2/2/2, crop 32 of 48^2 sources): K8's
  plain version with a per-channel requantize against rxtpu's ``QuantConv``
  with a vector ``out_scale`` at DenseNet's conv kinds (the stem, 1x1 from
  Cin 992, 3x3 to Cout 32, the transition's float output), fed a
  per-channel ``(int8, scale vector)`` pair; ``QuantPreNorm``;
  ``calibrate`` with every per-channel and segment range;
  ``quantize_densenet_backbone`` bit-equal; ``QuantPredictor`` on rxtpu's
  DenseNet ``qvars`` with and without transforms.

The kernel runs only on a card: the ``gpu`` test holds it against the plain
version there. Shapes follow ``tests/test_quant.py``: crop 24 of 32^2
sources, 7 classes, 16 head features, f32 compute.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxtpu.config import Config, DataConfig, ModelConfig, TrainConfig
from rxtpu.infer import calibrate as rx_calibrate
from rxtpu.infer import make_quantized_predict_step
from rxtpu.infer import prepare_quantized as rx_prepare_quantized
from rxtpu.infer import quantize_variables as rx_quantize_variables
from rxtpu.infer.quant import quantize_densenet_backbone as rx_quantize_densenet_backbone
from rxtpu.infer.fold import fold_variables
from rxtpu.infer.tta import tta_transforms as rx_tta_transforms
from rxtpu.models.quant import QuantConv as RxQuantConv
from rxtpu.models.quant import QuantPreNorm as RxQuantPreNorm
from rxtpu.models.quant import quant_max_pool as rx_quant_max_pool
from rxtpu.train import build_model, create_train_state
from rxtpu_torch import cli as port_cli
from rxtpu_torch.infer.predict import Predictor, tta_transforms
from rxtpu_torch.infer.quant import (
    QuantPredictor, calibrate, prepare_quantized, quantizable, quantize_densenet_backbone,
    quantize_variables,
)
from rxtpu_torch.models.convert import from_flax, from_flax_quantized, qstats_from_flax
from rxtpu_torch.models.quant import QuantPreNorm, quant_max_pool
from rxtpu_torch.models.twosites import TwoSitesNN
from rxtpu_torch.ops.int8_conv import (
    int8_conv, int8_conv_reference, int8_conv_sums, int8_stem_conv, int8_stem_conv_reference,
    pack_stem_weight, pack_weight, quantize,
)
from test_torch_port_densenet import shallow_densenet
from test_torch_port_models import randomize_flax

CROP, SRC, CLASSES = 24, 32, 7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# K8's plain version against rxtpu's QuantConv
# ---------------------------------------------------------------------------

# (label, N, H, W, Cin, Cout, kernel, stride, padding): ResNet's conv kinds,
# odd sizes and channel counts that are not multiples of a tile
CONV_KINDS = [
    ("stem 7x7/2", 2, 21, 18, 6, 16, 7, 2, 3),
    ("1x1/1", 2, 9, 7, 32, 24, 1, 1, 0),
    ("3x3/1", 2, 9, 7, 32, 24, 3, 1, 1),
    ("3x3/2", 2, 9, 7, 32, 40, 3, 2, 1),
    ("1x1/2 proj", 2, 9, 7, 32, 48, 1, 2, 0),
]
# (requantize, relu, residual): the epilogues the forward uses, and the rest
EPILOGUES = [(False, False, None), (False, True, None), (True, True, None),
             (True, False, None), (True, True, "int8"), (False, True, "int8"),
             (True, True, "float"), (False, False, "float")]
FLIP_SHARE = 1e-3  # int8 outputs: at most this share off by one (FMA contraction)


def _conv_case(kind, seed):
    _, n, h, w, cin, cout, k, s, p = kind
    rng = np.random.default_rng(seed)
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    return dict(
        xq=rng.integers(-127, 128, (n, h, w, cin), dtype=np.int8),
        kq=rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8),  # HWIO
        w_scale=rng.uniform(0.5, 1.5, cout).astype(np.float32) / 127.0,
        bias=rng.normal(0.0, 1.0, cout).astype(np.float32),
        in_scale=np.float32(0.7 / (127.0 * np.sqrt(k * k * cin))),
        out_scale=np.float32(1.3 / 127.0),
        rq=rng.integers(-127, 128, (n, ho, wo, cout), dtype=np.int8),
        rs=np.float32(0.9 / 127.0),
        rf=rng.normal(0.0, 1.0, (n, ho, wo, cout)).astype(np.float32),
    )


def _rx_conv(kind, c, requant, relu, res, dtype=jnp.float32):
    _, _, _, _, _, cout, k, s, p = kind
    mod = RxQuantConv(features=cout, kernel_size=(k, k), strides=(s, s),
                      padding=[(p, p), (p, p)], dtype=dtype)
    params = {"params": {"kernel_q": jnp.asarray(c["kq"]), "w_scale": jnp.asarray(c["w_scale"]),
                         "bias": jnp.asarray(c["bias"]), "in_scale": jnp.asarray(c["in_scale"])}}
    residual = {None: None, "int8": (jnp.asarray(c["rq"]), jnp.asarray(c["rs"])),
                "float": jnp.asarray(c["rf"])}[res]
    out = mod.apply(params, (jnp.asarray(c["xq"]), jnp.asarray(c["in_scale"])),
                    out_scale=jnp.asarray(c["out_scale"]) if requant else None,
                    relu_out=relu, residual=residual)
    return np.asarray(out[0] if requant else out)


def _port_conv(kind, c, requant, relu, res, dtype=torch.float32):
    _, _, _, _, _, _, k, s, p = kind
    t = {key: torch.from_numpy(np.asarray(v)) for key, v in c.items()}
    weight = pack_weight(t["kq"].permute(3, 2, 0, 1))
    residual = {None: None, "int8": t["rq"], "float": t["rf"]}[res]
    return int8_conv(t["xq"], weight, t["w_scale"] * t["in_scale"], t["bias"], k, s, p,
                     residual=residual, residual_scale=t["rs"] if res == "int8" else None,
                     relu=relu, inv_out_scale=(1.0 / t["out_scale"]) if requant else None,
                     out_dtype=dtype)


@pytest.mark.parametrize("kind", CONV_KINDS, ids=[k[0] for k in CONV_KINDS])
def test_int8_conv_sums_equal_rxtpu(kind):
    """The f64 conv's int32 sums are rxtpu's int8 conv's, exactly."""
    _, _, _, _, _, _, k, s, p = kind
    c = _conv_case(kind, 0)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(c["xq"]), jnp.asarray(c["kq"]), (s, s), [(p, p), (p, p)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    got = int8_conv_sums(torch.from_numpy(c["xq"]),
                         pack_weight(torch.from_numpy(c["kq"]).permute(3, 2, 0, 1)), k, s, p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the largest sum ResNet-50 can form, 127^2 * 4608, is exact in float64
    big = torch.full((1, 3, 3, 512), -127, dtype=torch.int8)
    wbig = torch.full((1, 9 * 512), 127, dtype=torch.int8)
    assert int(int8_conv_sums(big, wbig, 3, 1, 0)) == -127 * 127 * 4608


@pytest.mark.parametrize("kind", CONV_KINDS, ids=[k[0] for k in CONV_KINDS])
def test_int8_conv_reference_matches_rxtpu_quantconv(kind):
    """Every epilogue against rxtpu's QuantConv on the same int8 operands,
    applied op by op (no jit, so XLA contracts nothing into an FMA).
    Measured over these and 3 more seeds per case (203,776 int8 outputs):
    float outputs bit-equal, no int8 output off. Under jit XLA's CPU may
    contract the dequant's multiply-add, which the port never does: the
    int8 bound allows FLIP_SHARE of the outputs off by one."""
    flips = total = 0
    for seed, (requant, relu, res) in enumerate(EPILOGUES):
        c = _conv_case(kind, seed)
        want = _rx_conv(kind, c, requant, relu, res)
        got = _port_conv(kind, c, requant, relu, res).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        if requant:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1
            flips, total = flips + int((diff > 0).sum()), total + diff.size
            assert np.abs(want).max() == 127 and (want == 0).any()  # clip and zero both hit
        else:
            np.testing.assert_array_equal(got, want)
    assert flips <= FLIP_SHARE * total


def test_int8_conv_bf16_output_and_ties_match_rxtpu():
    """The last block's bf16 output, and requantize inputs that land on .5
    ties (scale 1, bias 0.5 or -0.5, out scale 1: exact whatever the
    contraction) round half to even, as jnp.round."""
    kind = CONV_KINDS[2]
    c = _conv_case(kind, 5)
    want = _rx_conv(kind, c, False, True, "int8", jnp.bfloat16)
    got = _port_conv(kind, c, False, True, "int8", torch.bfloat16)
    assert got.dtype == torch.bfloat16
    up = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert (up <= 2.0 ** -8 * np.abs(np.asarray(want, np.float32))).all()  # one bf16 ulp
    c = _conv_case(kind, 6)
    c["xq"] = (c["xq"] // 32).astype(np.int8)   # small sums: ties inside the clip range
    c["kq"] = (c["kq"] // 64).astype(np.int8)
    cout = c["bias"].shape[0]
    c["w_scale"] = np.ones(cout, np.float32)
    c["in_scale"] = np.float32(1.0)
    c["out_scale"] = np.float32(1.0)
    c["bias"] = np.where(np.arange(cout) % 2 == 0, 0.5, -0.5).astype(np.float32)
    want = _rx_conv(kind, c, True, False, None)
    got = _port_conv(kind, c, True, False, None).numpy()
    np.testing.assert_array_equal(got, want)
    acc = int8_conv_sums(torch.from_numpy(c["xq"]),
                         pack_weight(torch.from_numpy(c["kq"]).permute(3, 2, 0, 1)), 3, 1, 1)
    v = acc.numpy() + c["bias"]
    tie = (np.abs(v) < 127) & (np.abs(v - np.trunc(v)) == 0.5)
    assert tie.mean() > 0.9  # nearly every output is a tie, both ways of even
    np.testing.assert_array_equal(got[tie], np.round(v[tie]))


def test_int8_conv_argument_checks():
    x = torch.zeros(1, 5, 5, 8, dtype=torch.int8)
    w = torch.zeros(4, 72, dtype=torch.int8)
    one = torch.ones(4)
    with pytest.raises(ValueError, match="weight"):
        int8_conv(x, w[:, :70], one, one, 3, 1, 1)
    with pytest.raises(ValueError, match="x must be int8"):
        int8_conv(x.float(), w, one, one, 3, 1, 1)
    with pytest.raises(ValueError, match="residual_scale"):
        int8_conv(x, w, one, one, 3, 1, 1, residual=torch.zeros(1, 5, 5, 4, dtype=torch.int8))
    with pytest.raises(ValueError, match="residual must be"):
        int8_conv(x, w, one, one, 3, 1, 1, residual=torch.zeros(1, 5, 5, 3))
    with pytest.raises(ValueError, match="out_dtype"):
        int8_conv(x, w, one, one, 3, 1, 1, out_dtype=torch.float16)
    out = int8_conv(x, w, one, one, 3, 2, 1, inv_out_scale=torch.tensor(2.0))
    assert out.dtype == torch.int8 and tuple(out.shape) == (1, 3, 3, 4)


def test_quant_max_pool_matches_rxtpu():
    rng = np.random.default_rng(3)
    for shape in ((2, 9, 7, 5), (1, 16, 16, 64), (3, 4, 5, 3)):
        q = rng.integers(-127, 128, shape, dtype=np.int8)
        q[0, 0] = -127  # a corner of minima: the pad must not win
        want, ws = rx_quant_max_pool((jnp.asarray(q), jnp.float32(0.25)))
        got, gs = quant_max_pool((torch.from_numpy(q), torch.tensor(0.25)))
        assert got.dtype == torch.int8 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(gs) == float(ws)


# ---------------------------------------------------------------------------
# calibration, quantization and the predict step against rxtpu
# ---------------------------------------------------------------------------

def _cfg(backbone):
    return Config(data=DataConfig(path_data="x", crop_size=CROP, src_size=SRC),
                  model=ModelConfig(backbone=backbone, nb_classes=CLASSES, pretrained=False,
                                    size_features=16, compute_dtype="float32", head="mlp"),
                  train=TrainConfig(), experiment_id="q")


def _batch(rng, n=4):
    return {"images": rng.integers(0, 256, (n, 6, 6, SRC, SRC), dtype=np.uint8),
            "mean": rng.uniform(0.3, 0.5, (n, 6)).astype(np.float32),
            "std": rng.uniform(0.15, 0.25, (n, 6)).astype(np.float32)}


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module", params=["resnet18", "resnet50"])
def quant_setup(request):
    """rxtpu's model with random BN statistics (so the folds are not trivial),
    its calibration on two batches and its prepared int8 tree, and the port's
    model with the same weights."""
    cfg = _cfg(request.param)
    model = build_model(cfg)
    state, _ = create_train_state(cfg, model, steps_per_epoch=1)
    v = randomize_flax({"params": state.params, "batch_stats": state.batch_stats}, 1)
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
    rng = np.random.default_rng(0)
    calib, test = [_batch(rng), _batch(rng)], _batch(rng)
    qstats = rx_calibrate(model, state, [_jax(b) for b in calib], CROP)
    port = TwoSitesNN(request.param, nb_classes=CLASSES, size_features=16)
    port.load_state_dict(from_flax(jax.device_get(state.params),
                                   jax.device_get(state.batch_stats)))
    return dict(model=model, state=state, qstats=jax.device_get(qstats),
                qvars=rx_prepare_quantized(model, state, qstats), port=port.eval(),
                calib=calib, test=test, arch=request.param)


def test_calibrate_matches_rxtpu(quant_setup):
    s = quant_setup
    got = calibrate(s["port"], [_torch(b) for b in s["calib"]], CROP, torch.float32)
    want = qstats_from_flax(s["qstats"])
    assert sorted(got) == sorted(want)
    assert "conv_init" in got and "stage2_block1.conv_proj" in got
    for name in want:
        for key in ("in_absmax", "out_absmax"):
            np.testing.assert_allclose(float(got[name][key]), float(want[name][key]),
                                       rtol=1e-5, err_msg=f"{name} {key}")
    assert min(float(e["in_absmax"]) for e in got.values()) > 0


def test_quantize_variables_bit_equal_to_rxtpu(quant_setup):
    """The same f32 folded weights and stats give the same int8 tree: rxtpu's
    ``quantize_variables`` run op by op (its jitted ``prepare_quantized``
    may reassociate the fold, ``tests/test_quant.py:94-96``)."""
    s = quant_setup
    folded = fold_variables(s["state"].params, s["state"].batch_stats)
    want = from_flax_quantized(jax.device_get(
        rx_quantize_variables(folded, s["qstats"]))["params"])
    got = quantize_variables(from_flax(jax.device_get(folded)["params"]),
                             qstats_from_flax(s["qstats"]))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
    assert got["backbone.conv_init.kernel_q"].shape == (64, 7 * 7 * 6)


@pytest.mark.parametrize("transforms", ["identity", None])
def test_quant_predictor_matches_rxtpu(quant_setup, transforms):
    """rxtpu's prepared tree in the port: the CLI's path (``--tta none`` is
    ``[identity]``: bf16 views, the stem quantizes) and quantize-at-source
    (no transforms: K1 writes int8 views). Measured on these inputs: the
    same argmax on every row, probabilities within 2.2e-6 (the f32 sums of
    the head and of the epilogues' contraction); the limit allows requantize
    flips."""
    s = quant_setup
    qnet = TwoSitesNN(s["arch"], nb_classes=CLASSES, size_features=16, quantized=True)
    qnet.load_state_dict(from_flax_quantized(jax.device_get(s["qvars"])["params"]))
    port_t = tta_transforms("none") if transforms else None
    step = QuantPredictor(qnet.eval(), CROP, port_t)
    views = step.front(*(torch.from_numpy(s["test"][k]) for k in ("images", "mean", "std")))
    assert views.dtype == (torch.bfloat16 if transforms else torch.int8)
    rx_step = make_quantized_predict_step(
        s["model"], CROP, transforms=rx_tta_transforms("none") if transforms else None)
    want = np.asarray(rx_step(s["qvars"], _jax(s["test"])))
    got = step(_torch(s["test"])).numpy()
    assert got.shape == want.shape == (4, CLASSES) and got.dtype == np.float32
    assert want.max() - want.min() > 1e-3  # not a uniform softmax
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_port_int8_tracks_its_f32_forward(quant_setup):
    """The port's own calibration and quantization, against its f32 folded
    predict step: ``tests/test_quant.py:108-109``'s limits."""
    s = quant_setup
    qstats = calibrate(s["port"], [_torch(b) for b in s["calib"]], CROP, torch.float32)
    qnet = prepare_quantized(s["port"], qstats, torch.float32)
    assert qnet.backbone.conv_init.kernel_q.dtype == torch.int8
    assert qnet.head.fc1.weight.dtype == torch.float32
    pq = QuantPredictor(qnet, CROP, tta_transforms("none"))(_torch(s["test"])).numpy()
    pf = Predictor(s["port"], CROP, dtype=torch.float32)(_torch(s["test"])).numpy()
    np.testing.assert_allclose(pq.sum(-1), 1.0, rtol=1e-5)
    assert (pq.argmax(-1) == pf.argmax(-1)).mean() >= 0.75
    assert np.abs(pq - pf).max() < 0.08


def test_quant_guards(tmp_path, monkeypatch):
    assert quantizable(TwoSitesNN("resnet18", nb_classes=4, size_features=8))
    assert not quantizable(torch.nn.Linear(2, 2))
    with pytest.raises(ValueError, match="resnet backbones with the mlp head"):
        calibrate(torch.nn.Linear(2, 2), [])
    model = TwoSitesNN("resnet18", nb_classes=4, size_features=8).eval()
    with pytest.raises(ValueError, match="at least one batch"):
        calibrate(model, [])
    with pytest.raises(ValueError, match="average"):
        QuantPredictor(model, average="mean")
    # the CLI: --calib-batches below 1 and the ArcFace head, which int8 does
    # not support (rxtpu/cli.py:479-484); --distributed with no cluster runs
    # at world 1 and writes the plain run's submission
    from rxtpu_torch.data.synthetic import make_test_fixture, randomize_
    from rxtpu_torch.train.checkpoint import save_checkpoint

    fx = make_test_fixture(str(tmp_path), nb_classes=8, n_test_wells=4, img_size=32)
    monkeypatch.chdir(tmp_path)
    save_checkpoint("models/best_model_g.ckpt",
                    randomize_(TwoSitesNN("resnet18", nb_classes=8), seed=0).state_dict())
    argv = ["--experiment_id", "g", "--pack", fx["pack_dir"], "--data-dir", fx["data_dir"],
            "--stats", fx["stats"], "--nb-classes", "8", "--backbone", "resnet18",
            "--batch-size", "2", "--device", "cpu", "--quantize", "int8"]
    with pytest.raises(SystemExit, match="--calib-batches must be >= 1"):
        port_cli.main(argv + ["--calib-batches", "0"])
    with pytest.raises(SystemExit, match="supports resnet backbones with the mlp head and "
                                         "densenet121, got resnet18/arcface"):
        port_cli.main(argv + ["--head", "arcface"])
    # more calibration batches than the experiment has; greedy_jax and
    # --profile (training skipped: the test phase's trace alone) run on the
    # int8 path too
    assert port_cli.main(argv + ["--calib-batches", "5", "--assign-method", "greedy_jax",
                                 "--profile"]) == 0
    assert (tmp_path / "submission_g.csv").exists()
    assert [d.name for d in (tmp_path / "board" / "g" / "profile").iterdir()] == ["predict"]
    assert (tmp_path / "board" / "g" / "profile" / "predict" / "spans.jsonl").exists()
    (tmp_path / "dist").mkdir()
    assert port_cli.main(argv + ["--calib-batches", "5", "--assign-method", "greedy_jax",
                                 "--distributed", "--out-dir", str(tmp_path / "dist")]) == 0
    assert (tmp_path / "dist" / "submission_g.csv").read_bytes() == \
        (tmp_path / "submission_g.csv").read_bytes()
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# DenseNet-121's int8: K8 with a per-channel requantize, QuantPreNorm, the
# calibration, the quantized tree and the predict step against rxtpu
# ---------------------------------------------------------------------------

# (label, N, H, W, Cin, Cout, kernel, stride, padding, output): DenseNet's conv
# kinds the ResNet ones lack, fed a per-channel (int8, scale vector) pair
DENSENET_KINDS = [
    ("stem 7x7/2 to 64", 2, 21, 18, 6, 64, 7, 2, 3, "int8 relu"),
    ("1x1 Cin 992 to 128", 2, 5, 4, 992, 128, 1, 1, 0, "int8 relu"),
    ("3x3 128 to Cout 32", 2, 9, 7, 128, 32, 3, 1, 1, "int8"),
    ("transition 1x1 256 to 128", 2, 8, 6, 256, 128, 1, 1, 0, "float"),
]
D_CROP, D_SRC = 32, 48


def _vector_case(kind, seed):
    c = _conv_case(kind[:9], seed)
    rng = np.random.default_rng(100 + seed)
    cout = kind[5]
    c["in_scale"] = np.float32(1.0)  # a vector-scale pair: the scales live in kernel_q
    c["svec"] = rng.uniform(0.5, 2.0, kind[4]).astype(np.float32) / 127.0
    c["w_scale"] = (c["w_scale"] / np.sqrt(kind[6] ** 2 * kind[4])).astype(np.float32)
    c["out_vec"] = rng.uniform(0.3, 3.0, cout).astype(np.float32) / 127.0
    return c


@pytest.mark.parametrize("kind", DENSENET_KINDS, ids=[k[0] for k in DENSENET_KINDS])
def test_int8_conv_vector_requantize_matches_rxtpu(kind):
    """K8's plain version with ``inv_out_scale`` one per output channel against
    rxtpu's ``QuantConv`` with a vector ``out_scale``, on a pair whose vector
    scale makes ``in_scale`` 1 (``rxtpu/models/quant.py:144-150``); the
    transition's float output in f32 and bf16. Measured: no int8 output off;
    the bound allows FLIP_SHARE of them off by one."""
    _, _, _, _, _, cout, k, s, p, out = kind
    flips = total = 0
    for seed in range(3):
        c = _vector_case(kind, seed)
        mod = RxQuantConv(features=cout, kernel_size=(k, k), strides=(s, s),
                          padding=[(p, p), (p, p)], dtype=jnp.float32)
        params = {"params": {key: jnp.asarray(c[name]) for key, name in
                             (("kernel_q", "kq"), ("w_scale", "w_scale"), ("bias", "bias"),
                              ("in_scale", "in_scale"))}}
        pair = (jnp.asarray(c["xq"]), jnp.asarray(c["svec"]))
        weight = pack_weight(torch.from_numpy(c["kq"]).permute(3, 2, 0, 1))
        scale = torch.from_numpy(c["w_scale"]) * 1.0
        relu = out == "int8 relu"
        if out == "float":
            for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
                mod = mod.clone(dtype=jdt)
                want = np.asarray(mod.apply(params, pair).astype(jnp.float32))
                got = int8_conv(torch.from_numpy(c["xq"]), weight, scale,
                                torch.from_numpy(c["bias"]), k, s, p, out_dtype=tdt)
                np.testing.assert_array_equal(got.float().numpy(), want)
            continue
        want, wscale = mod.apply(params, pair, out_scale=jnp.asarray(c["out_vec"]),
                                 relu_out=relu)
        got = int8_conv(torch.from_numpy(c["xq"]), weight, scale, torch.from_numpy(c["bias"]),
                        k, s, p, relu=relu,
                        inv_out_scale=(1.0 / torch.from_numpy(c["out_vec"])).float())
        want = np.asarray(want)
        assert got.dtype == torch.int8 and got.shape == want.shape
        assert np.abs(want).max() == 127 and (want == 0).any()
        diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1
        flips, total = flips + int((diff > 0).sum()), total + diff.size
    assert flips <= FLIP_SHARE * total


def test_int8_stem_vector_requantize_matches_rxtpu():
    """K8's stem entry from bf16 NCHW views with DenseNet's 64-channel
    requantize (``stem_absmax_ch``) against rxtpu's stem ``QuantConv``."""
    c = _vector_case(DENSENET_KINDS[0], 7)
    c["in_scale"] = np.float32(1.0 / 32.0)
    rng = np.random.default_rng(8)
    views = jnp.asarray(rng.normal(0.0, 2.0, (2, 21, 18, 6)), jnp.bfloat16)
    mod = RxQuantConv(features=64, kernel_size=(7, 7), strides=(2, 2),
                      padding=[(3, 3), (3, 3)], dtype=jnp.float32)
    params = {"params": {"kernel_q": jnp.asarray(c["kq"]), "w_scale": jnp.asarray(c["w_scale"]),
                         "bias": jnp.asarray(c["bias"]), "in_scale": jnp.asarray(c["in_scale"])}}
    want, _ = mod.apply(params, views, out_scale=jnp.asarray(c["out_vec"]), relu_out=True)
    x = torch.from_numpy(np.array(views.astype(jnp.float32))).to(torch.bfloat16)
    in_scale = torch.tensor(c["in_scale"])
    kq = pack_weight(torch.from_numpy(c["kq"]).permute(3, 2, 0, 1))
    got = int8_stem_conv(x.permute(0, 3, 1, 2).contiguous(), pack_stem_weight(kq),
                         torch.from_numpy(c["w_scale"]) * in_scale, torch.from_numpy(c["bias"]),
                         in_scale, relu=True,
                         inv_out_scale=(1.0 / torch.from_numpy(c["out_vec"])).float())
    want = np.asarray(want)
    assert (want > 0).any() and (want == 0).any()
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= FLIP_SHARE
    with pytest.raises(ValueError, match="inv_out_scale"):
        int8_conv(torch.zeros(1, 3, 3, 16, dtype=torch.int8), torch.zeros(8, 16, dtype=torch.int8),
                  torch.ones(8), torch.ones(8), 1, inv_out_scale=torch.ones(4))


def test_quant_pre_norm_matches_rxtpu():
    """DenseNet's int8 pre-activation BN: ``relu(q * (svec * mul) + add)``
    requantized per channel, and its f32 form (``out_scale=None``), bit-equal
    to rxtpu's run op by op."""
    rng = np.random.default_rng(9)
    c = 96
    q = rng.integers(-127, 128, (2, 5, 6, c), dtype=np.int8)
    svec = rng.uniform(0.5, 2.0, c).astype(np.float32) / 127.0
    mul = rng.uniform(0.5, 1.5, c).astype(np.float32)
    add = rng.normal(0.0, 0.3, c).astype(np.float32)
    out_scale = rng.uniform(0.3, 1.5, c).astype(np.float32) / 127.0
    rx = RxQuantPreNorm(c)
    params = {"params": {"mul": jnp.asarray(mul), "add": jnp.asarray(add)}}
    norm = QuantPreNorm(c)
    norm.mul.copy_(torch.from_numpy(mul))
    norm.add.copy_(torch.from_numpy(add))
    pair = (torch.from_numpy(q), torch.from_numpy(svec))
    for scale in (out_scale, None):
        want = rx.apply(params, (jnp.asarray(q), jnp.asarray(svec)),
                        out_scale=None if scale is None else jnp.asarray(scale))
        got = norm(pair, None if scale is None else torch.from_numpy(scale))
        if scale is None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
            assert (np.asarray(want[0]) == 127).any() and (np.asarray(want[0]) == 0).any()


def _d_batch(rng, n=4):
    return {"images": rng.integers(0, 256, (n, 6, 6, D_SRC, D_SRC), dtype=np.uint8),
            "mean": rng.uniform(0.3, 0.5, (n, 6)).astype(np.float32),
            "std": rng.uniform(0.15, 0.25, (n, 6)).astype(np.float32)}


@pytest.fixture(scope="module")
def densenet_setup():
    """rxtpu's shallow DenseNet with the MLP head (random BN statistics), its
    calibration on two batches and its prepared int8 tree, and the port's
    model with the same weights; built and run with blocks 2/2/2/2."""
    with shallow_densenet():
        cfg = Config(data=DataConfig(path_data="x", crop_size=D_CROP, src_size=D_SRC),
                     model=ModelConfig(backbone="densenet121", nb_classes=CLASSES,
                                       pretrained=False, size_features=16,
                                       compute_dtype="float32", head="mlp"),
                     train=TrainConfig(), experiment_id="qd")
        model = build_model(cfg)
        state, _ = create_train_state(cfg, model, steps_per_epoch=1)
        v = randomize_flax({"params": state.params, "batch_stats": state.batch_stats}, 1)
        state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
        rng = np.random.default_rng(0)
        calib, test = [_d_batch(rng), _d_batch(rng)], _d_batch(rng)
        qstats = jax.device_get(rx_calibrate(model, state, [_jax(b) for b in calib], D_CROP))
        qvars = jax.device_get(rx_prepare_quantized(model, state, qstats))
        steps = {t: make_quantized_predict_step(
            model, D_CROP, transforms=rx_tta_transforms("none") if t else None)
            for t in (True, False)}
        want = {t: np.asarray(step(qvars, _jax(test))) for t, step in steps.items()}
        port = TwoSitesNN("densenet121", nb_classes=CLASSES, size_features=16)
        port.load_state_dict(from_flax(jax.device_get(state.params),
                                       jax.device_get(state.batch_stats)))
        qnet = TwoSitesNN("densenet121", nb_classes=CLASSES, size_features=16, quantized=True)
        qnet.load_state_dict(from_flax_quantized(qvars["params"], qvars["batch_stats"]))
        qstats_port = calibrate(port.eval(), [_torch(b) for b in calib], D_CROP, torch.float32)
        own = prepare_quantized(port, qstats_port, torch.float32)
    return dict(state=jax.device_get(state), qstats=qstats, qvars=qvars, want=want, port=port,
                qnet=qnet.eval(), qstats_port=qstats_port, own=own, calib=calib, test=test)


def test_calibrate_densenet_matches_rxtpu(densenet_setup):
    """Every conv's scalar and per-channel ranges, and the stem's and each
    transition's segment ranges, within rtol 1e-5 (per channel, and 1e-5 of
    the largest channel's for the small ones)."""
    s = densenet_setup
    got, want = s["qstats_port"], qstats_from_flax(s["qstats"])
    assert sorted(got) == sorted(want)
    assert {"stem_absmax", "stem_absmax_ch", "transition3_absmax_ch"} <= set(got)
    for name, entry in want.items():
        pairs = entry.items() if isinstance(entry, dict) else [("", entry)]
        for key, w in pairs:
            g = got[name][key] if key else got[name]
            assert g.shape == w.shape, (name, key)
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-5 * float(w.max()), err_msg=f"{name} {key}")
    assert got["stem_absmax_ch"].shape == (64,)
    assert got["block1_layer1.Conv_0"]["in_absmax_ch"].shape == (64,)


def test_quantize_densenet_backbone_bit_equal_to_rxtpu(densenet_setup):
    """The same f32 weights and stats give rxtpu's int8 tree bit for bit:
    rxtpu's ``quantize_densenet_backbone`` run op by op (its jitted
    ``prepare_quantized`` may contract the BN affine's multiply-add)."""
    s = densenet_setup
    params, stats = s["state"].params["backbone"], s["state"].batch_stats["backbone"]
    want = from_flax_quantized({"backbone": rx_quantize_densenet_backbone(
        params, stats, s["qstats"]["backbone"]), "head": {}})
    got = quantize_densenet_backbone(s["port"].state_dict(), qstats_from_flax(s["qstats"]))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert got["backbone.block1_layer1.Conv_0.in_scale_vec"].shape == (64,)
    assert got["backbone.block1_layer1.Conv_0.out_scale"].shape == (128,)
    assert got["backbone.conv_init.out_scale"].shape == (64,)


@pytest.mark.parametrize("transforms", [True, False], ids=["identity", "none"])
def test_quant_predictor_densenet_matches_rxtpu(densenet_setup, transforms):
    """rxtpu's DenseNet ``qvars`` in the port (the head unfolded, with its
    statistics): bf16 views the stem quantizes, or K1's int8 views. The same
    argmax on every row and the ResNet tests' probability bound."""
    s = densenet_setup
    step = QuantPredictor(s["qnet"], D_CROP, tta_transforms("none") if transforms else None)
    got = step(_torch(s["test"])).numpy()
    want = s["want"][transforms]
    assert got.shape == want.shape == (4, CLASSES) and got.dtype == np.float32
    assert want.max() - want.min() > 1e-3
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_port_int8_densenet_tracks_its_f32_forward(densenet_setup):
    """The port's own DenseNet calibration and quantization against its f32
    unfolded predict step: ``tests/test_quant.py``'s limits."""
    s = densenet_setup
    qnet = s["own"]
    assert qnet.head.bn1.weight.dtype == torch.float32 and not qnet.head.folded
    assert qnet.backbone.block1_layer1.Conv_1.kernel_q.dtype == torch.int8
    with shallow_densenet():
        pf = Predictor(s["port"], D_CROP, dtype=torch.float32)(_torch(s["test"])).numpy()
    pq = QuantPredictor(qnet, D_CROP, tta_transforms("none"))(_torch(s["test"])).numpy()
    np.testing.assert_allclose(pq.sum(-1), 1.0, rtol=1e-5)
    assert (pq.argmax(-1) == pf.argmax(-1)).mean() >= 0.75
    assert np.abs(pq - pf).max() < 0.08


@pytest.mark.gpu
def test_int8_conv_kernel_matches_plain_on_card():
    """The CUDA kernel against the plain version on the card, bit for bit, on
    every conv kind and epilogue, and the stem entry from bf16 and int8 NCHW
    views; the launch counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the int8_conv kernel runs only on the card")
    bits = {torch.int8: torch.int8, torch.bfloat16: torch.int16, torch.float32: torch.int32}
    rng = np.random.default_rng(5)
    for shape in ((2, 6, 64, 64), (1, 6, 37, 21)):
        x = torch.from_numpy(rng.normal(0.0, 2.0, shape).astype(np.float32)).cuda()
        kq = torch.from_numpy(rng.integers(-127, 128, (64, 294), dtype=np.int8)).cuda()
        in_scale = torch.tensor(1.0 / 32.0, device="cuda")
        scale = torch.full((64,), 2e-4, device="cuda")
        bias = torch.linspace(-1.0, 1.0, 64, device="cuda")
        views = x.to(torch.bfloat16)
        for v in (views, quantize(views, in_scale)):
            for requant, relu, _ in EPILOGUES[:4]:
                args = (v, pack_stem_weight(kq), scale, bias, in_scale)
                kw = dict(relu=relu, inv_out_scale=torch.tensor(4.0, device="cuda")
                          if requant else None)
                before = int8_conv.launches
                got = int8_stem_conv(*args, **kw)
                want = int8_stem_conv_reference(*args, **kw)
                torch.cuda.synchronize()
                assert int8_conv.launches == before + 1
                assert torch.equal(got.view(bits[got.dtype]), want.view(bits[want.dtype]))
    for kind in CONV_KINDS:
        for seed, (requant, relu, res) in enumerate(EPILOGUES):
            c = {k: torch.from_numpy(np.asarray(v)).cuda()
                 for k, v in _conv_case(kind, seed).items()}
            _, _, _, _, _, _, k, s, p = kind
            args = (c["xq"], pack_weight(c["kq"].permute(3, 2, 0, 1)),
                    c["w_scale"] * c["in_scale"], c["bias"], k, s, p)
            kw = dict(residual={None: None, "int8": c["rq"], "float": c["rf"]}[res],
                      residual_scale=c["rs"] if res == "int8" else None, relu=relu,
                      inv_out_scale=(1.0 / c["out_scale"]) if requant else None)
            before = int8_conv.launches
            got = int8_conv(*args, **kw)
            want = int8_conv_reference(*args, **kw)
            torch.cuda.synchronize()
            assert int8_conv.launches == before + 1
            assert got.dtype == want.dtype
            assert torch.equal(got.view(bits[got.dtype]), want.view(bits[want.dtype]))


@pytest.mark.gpu
def test_int8_conv_vector_requantize_matches_plain_on_card():
    """K8's per-channel requantize (``int8_conv`` and ``int8_stem_conv``) against
    the plain version on the card, bit for bit, at DenseNet's conv kinds; two
    launches bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the int8_conv kernel runs only on the card")
    for seed, kind in enumerate(DENSENET_KINDS):
        c = {k: torch.from_numpy(np.asarray(v)).cuda() for k, v in _vector_case(kind, seed).items()}
        _, _, _, _, _, _, k, s, p, out = kind
        args = (c["xq"], pack_weight(c["kq"].permute(3, 2, 0, 1)), c["w_scale"] * 1.0,
                c["bias"], k, s, p)
        kw = (dict(out_dtype=torch.float32) if out == "float" else
              dict(relu=out == "int8 relu", inv_out_scale=(1.0 / c["out_vec"]).float()))
        got, again = int8_conv(*args, **kw), int8_conv(*args, **kw)
        want = int8_conv_reference(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got, again)
    c = {k: torch.from_numpy(np.asarray(v)).cuda()
         for k, v in _vector_case(DENSENET_KINDS[0], 9).items()}
    views = torch.randn(2, 6, 64, 64, device="cuda").to(torch.bfloat16)
    in_scale = torch.tensor(1.0 / 32.0, device="cuda")
    args = (views, pack_stem_weight(pack_weight(c["kq"].permute(3, 2, 0, 1))),
            c["w_scale"] * in_scale, c["bias"], in_scale)
    kw = dict(relu=True, inv_out_scale=(1.0 / c["out_vec"]).float())
    got, want = int8_stem_conv(*args, **kw), int8_stem_conv_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
