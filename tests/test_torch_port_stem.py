"""rxtpu_torch's fused eval stem (K5) and its eval/predict steps against
rxtpu's, on the CPU.

- the port's plain K5 against rxtpu's op-by-op ``reference_stem`` and
  against its Pallas ``fused_stem`` in interpret mode, and the border
  semantics (the zero pad comes after the normalize);
- ``ResNet(stem_input=True)`` on the stem's maps against the folded backbone
  that runs its own stem;
- ``EvalStep`` / ``Predictor`` with ``fused_stem=True`` against rxtpu's
  ``make_eval_step`` / ``make_predict_step(fused_stem=True)``, weights carried
  across by ``from_flax``;
- rxtpu's scanned steps over a window of K batches against the port's
  per-batch steps (the port's own scanned steps are in
  ``test_torch_port_scan.py``), and ``predict_dataset`` with the fused stem against the unfused
  predictor over an odd number of batches. The CLI with
  ``--predict-scan-window 2`` against window 1 and rxtpu's CLI is in
  ``test_torch_port_serve.py``, beside the trained checkpoint it needs;
- an emulation of the CUDA kernel's tiling and operand indices (window
  cells, tap offsets, weight repack and swizzle, M row -> conv pixel, the
  per-tile pool) against the plain version.

The kernel itself runs only on a card: the ``gpu`` test holds it against
the plain version there. Shapes are tiny: 64^2 sources, crops 48, 47 and
none, 2 views, 16 stem channels; resnet18 with 8 classes for the steps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from rxtpu.config import Config, DataConfig, ModelConfig, TrainConfig
from rxtpu.models.twosites import TwoSitesNN as FlaxTwoSitesNN
from rxtpu.ops.fused_stem import fused_stem as rx_fused_stem
from rxtpu.ops.fused_stem import reference_stem as rx_reference_stem
from rxtpu.ops.fused_stem import stem_out_size as rx_stem_out_size
from rxtpu.train.setup import build_model as rx_build_model
from rxtpu.train.setup import create_train_state as rx_create_train_state
from rxtpu.train.step import TrainState as RxTrainState
from rxtpu.train.step import (
    make_eval_step, make_predict_step, make_scanned_eval_step, make_scanned_predict_step,
)
from rxtpu_torch.data.pack import PackStore
from rxtpu_torch.data.pipeline import Pipeline
from rxtpu_torch.data.records import load_metadata, read_metadata_csvs
from rxtpu_torch.data.stats import load_stats
from rxtpu_torch.data.synthetic import make_test_fixture, randomize_
from rxtpu_torch.infer.fold import fold, fold_for_inference, fold_state_dict
from rxtpu_torch.infer.predict import Predictor, predict_dataset
from rxtpu_torch.models.convert import from_flax
from rxtpu_torch.models.resnet import make_backbone
from rxtpu_torch.models.twosites import TwoSitesNN
from rxtpu_torch.ops.fused_stem import (
    eval_batch_stem, fused_stem, fused_stem_reference, stem_out_size,
)
from rxtpu_torch.train.step import EvalStep
from test_torch_port_models import randomize_flax

KW = dict(backbone="resnet18", nb_classes=8, size_features=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run as fast on one intra-op thread, and the suite runs
    test files in parallel workers that would otherwise each start one
    thread per core and contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stem_data(n=2, c=6, h=64, m=16, seed=0):
    """``tests/test_fused_stem.py:11``'s inputs; the weight as rxtpu's HWIO."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, c, h, h), dtype=np.uint8)
    std = rng.uniform(0.1, 0.4, (n, c)).astype(np.float32)
    mean = rng.uniform(0.2, 0.6, (n, c)).astype(np.float32)
    scale = (1.0 / (255.0 * std)).astype(np.float32)
    bias = (-mean / std).astype(np.float32)
    w = (rng.standard_normal((7, 7, c, m)) * 0.1).astype(np.float32)
    cb = (rng.standard_normal(m) * 0.5).astype(np.float32)
    return images, scale, bias, w, cb


def _port_stem(images, scale, bias, w, cb, crop, out_dtype=torch.float32):
    weight = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))  # HWIO -> OIHW
    return fused_stem(torch.from_numpy(images), torch.from_numpy(scale),
                      torch.from_numpy(bias), weight, torch.from_numpy(cb), crop, out_dtype)


def _rx_args(images, scale, bias, w, cb):
    return tuple(jnp.asarray(a) for a in (images, scale, bias, w, cb))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("crop", [48, 47, None])
def test_plain_stem_matches_rxtpu_reference(crop, seed):
    """Both sides round the normalized crop and the weight to bf16 and run the
    conv in f32: measured bit-equal at these seeds (XLA's and oneDNN's f32
    convs summed alike here). The bound, 1e-5 * max|out|, is ten f32 ulps of
    the largest output: room for another summation order, while one bf16 ulp
    flip of an input (what an FMA-contracted normalize would give) moves an
    output by 1e-4 * max|out| or more at these weights, and fails."""
    data = _stem_data(seed=seed)
    got = _port_stem(*data, crop).numpy()
    want = np.asarray(rx_reference_stem(*_rx_args(*data), crop_size=crop))
    po = stem_out_size(crop or 64)
    assert po == rx_stem_out_size(crop or 64)
    assert got.shape == want.shape == (2, 16, po, po) and got.dtype == np.float32
    scale = np.abs(want).max()
    assert scale > 1.0 and (want == 0).mean() < 0.5  # not a dead, all-ReLU'd output
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)
    # bf16 output is the f32 result rounded once
    bf16 = _port_stem(*data, crop, torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, torch.from_numpy(got).to(torch.bfloat16))


def test_plain_stem_matches_rxtpu_interpret_kernel():
    """rxtpu's Pallas kernel in interpret mode, at ``tests/test_fused_stem.py:35``'s
    tolerance. Interpret mode multiplies f32 activations that it never rounds
    to bf16 (``fused_stem.py:98,215``); the port rounds them, as the TPU kernel
    and ``reference_stem`` do, so the gap is bf16 rounding of the
    activations (measured 1.9e-2 at max|out| 13.8)."""
    data = _stem_data()
    got = _port_stem(*data, 48).numpy()
    want = np.asarray(rx_fused_stem(*_rx_args(*data), crop_size=48, out_dtype=jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_stem_zero_pad_semantics():
    """The conv pads the cropped, normalized image with zeros
    (``tests/test_fused_stem.py:69``): the border rows and columns match
    rxtpu's reference, and differ from padding the raw crop before the
    normalize."""
    images, scale, bias, w, cb = _stem_data(n=1, h=32)
    got = _port_stem(images, scale, bias, w, cb, 16).numpy()
    want = np.asarray(rx_reference_stem(*_rx_args(images, scale, bias, w, cb), crop_size=16))
    for edge in (np.s_[:, :, 0, :], np.s_[:, :, :, -1], np.s_[:, :, -1, :], np.s_[:, :, :, 0]):
        np.testing.assert_allclose(got[edge], want[edge], atol=1e-5 * np.abs(want).max(),
                                   rtol=0)
    # padding first gives the pad the value of a normalized 0 pixel, -mean/std
    crop = images[:, :, 8:24, 8:24]
    padded = np.pad(crop, ((0, 0), (0, 0), (3, 3), (3, 3))).astype(np.float32)
    x = torch.from_numpy(padded * scale[:, :, None, None] + bias[:, :, None, None])
    x = x.to(torch.bfloat16).float()
    wk = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).to(torch.bfloat16)
    y = torch.relu(F.conv2d(x, wk.float(), stride=2) + torch.from_numpy(cb)[None, :, None, None])
    pad_first = F.max_pool2d(y, 3, 2, 1).numpy()
    assert np.abs(pad_first[:, :, 0, :] - got[:, :, 0, :]).max() > 0.1


def test_plain_stem_rejects_bad_input():
    images, scale, bias, w, cb = (torch.from_numpy(a) for a in _stem_data())
    weight = w.permute(3, 2, 0, 1).contiguous()
    ok = (images, scale, bias, weight, cb)
    for i, bad in ((0, images.float()), (1, scale[:1]), (2, bias.double()),
                   (3, weight[:, :3]), (4, cb[:8])):
        args = list(ok)
        args[i] = bad
        with pytest.raises(ValueError):
            fused_stem(*args, 48)
    with pytest.raises(ValueError):
        fused_stem(*ok, 65)
    with pytest.raises(ValueError):
        fused_stem(*ok, 48, torch.float16)


def _folded_models(seed=0):
    """A randomized resnet18 TwoSitesNN of the port (f32) and rxtpu's flax
    model + state with the same weights. The last layer is scaled down so
    that the logits span a few units and the softmax is far from one-hot."""
    flax_model = FlaxTwoSitesNN(**KW, dtype=jnp.float32)
    variables = randomize_flax(flax_model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 3, 32, 32, 6)), train=False), seed + 1)
    fc2 = variables["params"]["head"]["fc2"]
    fc2["kernel"] = fc2["kernel"] * 0.1
    state = RxTrainState.create(variables["params"], variables["batch_stats"],
                                optax.identity(), None)
    port = TwoSitesNN(**KW)
    port.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    return flax_model, state, port.eval()


def test_stem_input_resnet_equals_folded_backbone():
    """The stem_input twin on the stem's maps is the folded backbone after its
    own stem, bit for bit, and keeps the stem's weights in its state dict."""
    port = randomize_(TwoSitesNN(**KW), seed=0).eval()
    folded = fold_for_inference(port)
    sd = folded.backbone.state_dict()
    stem_net = make_backbone("resnet18", folded=True, stem_input=True)
    stem_net.load_state_dict(sd)  # strict: conv_init is still there
    assert sorted(stem_net.state_dict()) == sorted(sd)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 6, 48, 48)).astype(np.float32))
    b = folded.backbone
    with torch.no_grad():
        maps = F.max_pool2d(F.relu(b.conv_init(x)), 3, 2, 1)
        want = b(x)
        got = stem_net.eval()(maps)
    assert torch.equal(got, want)
    # the fused-stem twin carries the stem's f32 bias through a bf16 cast;
    # K5's weight is the twin's bf16 one
    twin, front = fold(port, 48, torch.bfloat16, fused_stem=True)
    full = fold_state_dict(port.state_dict())
    bias, weight = front.keywords["conv_bias"], front.keywords["weight"]
    assert twin.backbone.stem_input and bias.dtype == torch.float32
    assert torch.equal(bias, full["backbone.conv_init.bias"])
    assert twin.backbone.conv_init.bias.dtype == torch.bfloat16
    assert not torch.equal(twin.backbone.conv_init.bias.float(), bias)
    assert torch.equal(weight, twin.backbone.conv_init.weight)


def _raw_batch(rng, b, g, valid=None):
    batch = {"images": rng.integers(0, 256, (b, g, 6, 64, 64), dtype=np.uint8),
             "labels": rng.integers(0, 8, b).astype(np.int32),
             "mean": rng.uniform(0.2, 0.6, (b, 6)).astype(np.float32),
             "std": rng.uniform(0.1, 0.4, (b, 6)).astype(np.float32)}
    if valid is not None:
        batch["valid"] = np.asarray(valid, np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_fused_eval_step_matches_rxtpu():
    """``EvalStep(fused_stem=True)`` against ``make_eval_step(fused_stem=True)``
    at ``tests/test_fused_stem.py:64-66``'s tolerance (loss_sum rtol 2e-2,
    correct equal): rxtpu's interpret kernel leaves the activations unrounded."""
    cfg = Config(data=DataConfig(path_data="unused", crop_size=48, src_size=64),
                 model=ModelConfig(**KW, pretrained=False, compute_dtype="float32"),
                 train=TrainConfig(bs_per_device=2), experiment_id="fstem")
    flax_model = rx_build_model(cfg)
    state, _ = rx_create_train_state(cfg, flax_model, steps_per_epoch=2)
    variables = randomize_flax({"params": state.params, "batch_stats": state.batch_stats}, 5)
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    batch = _raw_batch(np.random.default_rng(0), 4, 3, valid=[1, 1, 1, 0])
    want = make_eval_step(flax_model, 48, fused_stem=True)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    port = TwoSitesNN(**KW)
    port.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    got = EvalStep(port.eval(), 48, torch.float32, fused_stem=True)(_torch(batch))
    assert float(got["count"]) == float(want["count"]) == 3.0
    assert float(got["correct"]) == float(want["correct"])
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]), rtol=2e-2)
    with pytest.raises(ValueError, match="foldable"):
        EvalStep(torch.nn.Linear(4, 4), 48, fused_stem=True)


@pytest.mark.parametrize("crop", [None, 48])
def test_fused_predictor_matches_rxtpu(crop):
    """``Predictor(fused_stem=True)`` against ``make_predict_step(fused_stem=True)``.
    The probabilities differ by the activations' bf16 rounding that rxtpu's
    interpret kernel leaves out (measured 5.3e-5 uncropped and 1.3e-4 at crop
    48, on probabilities from 0.003 to 0.65); the bound is 1e-3."""
    flax_model, state, port = _folded_models()
    batch = _raw_batch(np.random.default_rng(1), 2, 6)
    del batch["labels"]
    want = np.asarray(make_predict_step(flax_model, crop, fused_stem=True)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = Predictor(port, crop, dtype=torch.float32, fused_stem=True)(_torch(batch)).numpy()
    assert got.shape == want.shape == (2, 8)
    assert want.max() < 0.9 and want.max() - want.min() > 0.1  # neither one-hot nor uniform
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    with pytest.raises(ValueError, match="TTA"):
        Predictor(port, crop, tta="flips", fused_stem=True)


def test_rxtpu_scanned_steps_match_port_per_batch():
    """rxtpu's scanned eval and predict steps over a window of K batches
    against the port's per-batch steps on each batch: probabilities to the
    predict atol of ``test_torch_port_serve.py`` (1e-4), loss sums to rtol
    1e-5 as ``test_torch_port_train.py``'s eval, counts and correct equal."""
    flax_model, state, port = _folded_models(seed=2)
    rng = np.random.default_rng(3)
    k = 3
    evals = [_raw_batch(rng, 2, 3, valid=[1, 1]) for _ in range(k)]
    evals[-1]["valid"][1] = 0.0
    preds = [_raw_batch(rng, 2, 6) for _ in range(k)]
    for b in preds:
        del b["labels"]
    step = EvalStep(port, 48, torch.float32)
    per = [step(_torch(b)) for b in evals]
    got = {key: sum(float(m[key]) for m in per) for key in per[0]}
    want = make_scanned_eval_step(flax_model, 48)(
        state, {key: jnp.asarray(np.stack([b[key] for b in evals])) for key in evals[0]})
    assert got["count"] == float(want["count"]) == 2 * k - 1
    assert got["correct"] == float(want["correct"])
    np.testing.assert_allclose(got["loss_sum"], float(want["loss_sum"]), rtol=1e-5)

    predictor = Predictor(port, None, dtype=torch.float32)
    probs = np.stack([predictor(_torch(b)).numpy() for b in preds])
    want_p = np.asarray(make_scanned_predict_step(flax_model, None)(
        state, {key: jnp.asarray(np.stack([b[key] for b in preds])) for key in preds[0]}))
    assert probs.shape == want_p.shape == (k, 2, 8)
    np.testing.assert_allclose(probs, want_p, atol=1e-4, rtol=0)


def test_predict_dataset_fused_stem(tmp_path):
    """``predict_dataset`` over 5 batches of 2 (the last one padded) with the
    fused and the unfused predictor: the same ids, in ``test.csv``'s order,
    and probabilities within 1e-4. The two round differently: the unfused
    f32 twin convolves the bf16 views with the f32 weight, K5 rounds the
    weight to bf16 too (measured 1.1e-5, on probabilities from 0.038 to
    0.080)."""
    fx = make_test_fixture(str(tmp_path), nb_classes=16, n_test_wells=9, img_size=48)
    rows, ctrl = read_metadata_csvs(fx["data_dir"] + "/metadata", "test")
    index = load_metadata(rows, ctrl, "test")
    store, stats = PackStore(fx["pack"]), load_stats(fx["stats"])
    model = randomize_(TwoSitesNN("resnet18", nb_classes=16), seed=0).eval()
    cpu = torch.device("cpu")
    assert len(Pipeline(index, store, stats, 2)) == 5
    out = {f: predict_dataset(Predictor(model, 32, dtype=torch.float32, fused_stem=f),
                              Pipeline(index, store, stats, 2), cpu) for f in (False, True)}
    assert out[False][1] == out[True][1] == [r["id_code"] for r in rows]
    assert out[False][0].shape == out[True][0].shape == (9, 16)
    assert out[False][0].max() - out[False][0].min() > 0.02  # not uniform
    np.testing.assert_allclose(out[True][0], out[False][0], atol=1e-4, rtol=0)


def test_eval_batch_stem_views_and_counter():
    """The G views fold into K5's batch, each with its sample's scale and
    bias; on the CPU the launch counter does not move."""
    rng = np.random.default_rng(4)
    batch = _torch(_raw_batch(rng, 2, 3))
    w = torch.from_numpy(rng.standard_normal((64, 6, 7, 7)).astype(np.float32) * 0.1)
    cb = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    before = fused_stem.launches
    maps = eval_batch_stem(batch["images"], batch["mean"], batch["std"], w, cb, 48,
                           torch.float32)
    assert fused_stem.launches == before
    assert maps.shape == (2, 3, 64, 12, 12)
    scale = (1.0 / (255.0 * batch["std"]))
    bias = -batch["mean"] / batch["std"]
    for i in range(2):
        for j in range(3):
            want = fused_stem_reference(batch["images"][i, j][None], scale[i][None],
                                        bias[i][None], w, cb, 48, torch.float32)
            assert torch.equal(maps[i, j], want[0])


# K5's tiling, mirrored from rxtpu_torch/csrc/fused_stem.cu's constants
K5_PR, K5_PC = 4, 16                         # pooled rows, columns per tile
K5_CR, K5_CC = 2 * K5_PR + 1, 2 * K5_PC + 1  # conv rows, columns per tile: 9, 33
K5_PIX = K5_CR * K5_CC                       # 297 conv outputs
K5_SR, K5_SC = 4 * K5_PR + 7, 4 * K5_PC + 7  # window rows, columns: 23, 71
K5_EVEN = (K5_SC + 1) // 2                   # even columns first: 36
K5_TAPS = 49                                 # K = 49 taps x 8 channels, then a zero tap
K5_ROWS = 5 * 4 * 16                         # 5 warps x 4 m16 tiles: M padded to 320
K5_ABS, K5_REL = np.float32(2.0 ** -17), np.float32(2.0 ** -18)
K5_LIST = 680                                # conv outputs listed per tile


def _k5_tap_offset(tap):
    """``tap_offset``: the cell offset of tap (ky, kx)."""
    ky, kx = tap // 7, tap % 7
    return ky * K5_SC + (kx & 1) * K5_EVEN + (kx >> 1)


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)


def _k5_at_risk(v, b):
    """``rounding_at_risk``: v within kAbs + kRel |v| of the midpoint half a
    bf16 ulp (of v's binade) from b = bf16(v); negative v only near 0."""
    gap = K5_REL * np.abs(v) + K5_ABS
    half = ((v.view(np.uint32) & np.uint32(0x7F800000)) - np.uint32(8 << 23)).view(np.float32)
    return (v > -gap) & (np.abs(v - b) + gap >= half)


def _sequential_conv(x, w2, cb, gr, gc):
    """The conv outputs at (gr, gc) before the ReLU, summed in the plain
    version's order (c, ky, kx), one f32 addition at a time (a bf16 x bf16
    product is exact in f32), then the f32 bias: the kernel's exact path."""
    c, crop = x.shape[0], x.shape[1]
    acc = np.zeros(np.broadcast(gr, w2[:, 0]).shape, np.float32)
    for t in range(c * 49):
        ci, ky, kx = t // 49, t % 49 // 7, t % 7
        y, xx = 2 * gr - 3 + ky, 2 * gc - 3 + kx
        inside = (y >= 0) & (y < crop) & (xx >= 0) & (xx < crop)
        xv = np.where(inside, x[ci, np.clip(y, 0, crop - 1), np.clip(xx, 0, crop - 1)], 0)
        acc = acc + (w2[:, t] * xv).astype(np.float32)
    return acc + cb


def _k5_emulate(images, scale, bias, weight, conv_bias, crop):
    """K5 built by the kernel's own indices on the CPU, with a float64 GEMM
    rounded to f32 and moved by up to half the gap that the kernel allows
    for the tensor cores' sums: the weight repack ([m][tap]
    cells of 8 channels, a zero cell for the pad tap), the window (HWC8 cells,
    even source columns before the odd ones, zero outside the crop), every A
    operand read at its lane's cell plus its tap's offset, M row -> conv pixel
    with the pad rows on cell 0, the conv tile before the ReLU (-inf outside
    the conv output), and the per-tile 3x3/2 pool, then the ReLU, with ragged
    tiles cut at the edge. Returns (f32 output, bf16 output); the bf16 one
    takes the exact path: every listed conv output (rounding_at_risk) within
    one bf16 step of a pooled window's maximum is summed again in the plain
    version's order. Every output is written exactly once."""
    n, c, h, _ = images.shape
    off = (h - crop) // 2
    x = images[:, :, off:off + crop, off:off + crop].astype(np.float32)
    x = x * scale[:, :, None, None]  # numpy rounds each op: __fmul_rn, then __fadd_rn
    x = x + bias[:, :, None, None]
    x = _bf16(x).float().numpy()
    w2 = _bf16(weight.reshape(64, c * 49)).float().numpy()
    w_s = np.zeros((64 * K5_TAPS + 1, 8), np.float32)  # then the zero cell
    for tap in range(K5_TAPS):
        w_s[np.arange(64) * K5_TAPS + tap, :c] = w2[:, tap::49]
    k = np.arange(8 * (K5_TAPS + 1))
    tap_k, c_k = k // 8, k % 8
    b_cell = np.where(tap_k[:, None] < K5_TAPS, np.arange(64)[None, :] * K5_TAPS + tap_k[:, None],
                      64 * K5_TAPS)
    b_mat = w_s[b_cell, c_k[:, None]].astype(np.float64)                 # [400, 64]
    conv_o = (crop - 1) // 2 + 1
    pool_o = (conv_o - 1) // 2 + 1
    tiles_y, tiles_x = -(-pool_o // K5_PR), -(-pool_o // K5_PC)
    outs = {d: np.zeros((n, 64, pool_o, pool_o), np.float32) for d in ("f32", "bf16")}
    written = np.zeros((n, 64, pool_o, pool_o), np.int32)
    mr = np.arange(K5_ROWS)
    mr_a = np.where(mr < K5_PIX, mr, 0)
    a_cell = 2 * (mr_a // K5_CC) * K5_SC + mr_a % K5_CC
    cell = a_cell[:, None] + _k5_tap_offset(np.minimum(tap_k, K5_TAPS - 1))[None, :]
    assert cell.max() < K5_SR * K5_SC
    rows, cols = np.arange(K5_SR), np.arange(K5_SC)
    win_cell = rows[:, None] * K5_SC + (cols & 1)[None, :] * K5_EVEN + (cols >> 1)[None, :]
    assert sorted(win_cell.ravel()) == list(range(K5_SR * K5_SC))
    mr_t = np.arange(K5_PIX)
    for v in range(n):
        for t in range(tiles_y * tiles_x):
            py0, px0 = t // tiles_x * K5_PR, t % tiles_x * K5_PC
            y = 4 * py0 - 5 + rows[:, None]
            xx = 4 * px0 - 5 + cols[None, :]
            inside = (y >= 0) & (y < crop) & (xx >= 0) & (xx < crop)
            win = np.zeros((K5_SR * K5_SC, 8), np.float32)
            vals = x[v][:, np.clip(y, 0, crop - 1), np.clip(xx, 0, crop - 1)]  # [c, SR, SC]
            win[win_cell.ravel(), :c] = np.where(inside, vals, 0.0).reshape(c, -1).T
            a = win[cell, c_k].astype(np.float64)                          # [320, 400]
            acc = (a @ b_mat)[:K5_PIX].astype(np.float32)                  # the pad rows dropped
            r = 2 * py0 - 1 + mr_t // K5_CC
            s = 2 * px0 - 1 + mr_t % K5_CC
            live = (r >= 0) & (r < conv_o) & (s >= 0) & (s < conv_o)
            pre = acc + conv_bias[None, :]
            # the tensor cores' sums are only held within kAbs + kRel |v| of
            # the plain version's: move each by up to half of that
            sign = ((mr_t[:, None] * 7 + np.arange(64)[None, :] * 13) % 3 - 1).astype(np.float32)
            pre = pre + sign * np.float32(0.5) * (K5_ABS + K5_REL * np.abs(pre))
            pre = pre.astype(np.float32)
            tile32 = np.where(live[:, None], pre, -np.inf).astype(np.float32)
            tile16 = _bf16(tile32).float().numpy()
            # the list, and the outputs within one bf16 step of a window's maximum
            risky = live[:, None] & _k5_at_risk(pre, _bf16(pre).float().numpy())
            listed = np.argwhere(risky)
            assert len(listed) <= K5_LIST
            t16 = tile16.reshape(K5_CR, K5_CC, 64)
            for p, m in listed:
                pr, pc = p // K5_CC, p % K5_CC
                needed = False
                for py in range(max(0, (pr - 1) // 2), min(K5_PR - 1, pr // 2) + 1):
                    for px in range(max(0, (pc - 1) // 2), min(K5_PC - 1, pc // 2) + 1):
                        if py0 + py >= pool_o or px0 + px >= pool_o:
                            continue
                        top = _bf16(t16[2 * py:2 * py + 3, 2 * px:2 * px + 3, m].max())
                        if float(top) > 0:
                            floor = float(torch.tensor([top.view(torch.int16) - 1],
                                                       dtype=torch.int16).view(torch.bfloat16))
                        else:
                            floor = -2 * float(K5_ABS)
                        needed |= bool(tile16[p, m] >= floor)
                if needed:
                    exact = _sequential_conv(x[v], w2[m:m + 1], conv_bias[m],
                                             np.array(r[p]), np.array(s[p]))
                    tile16[p, m] = _bf16(exact).float().item()
            for d, tile in (("f32", tile32), ("bf16", tile16)):
                tile = tile.reshape(K5_CR, K5_CC, 64)
                for py in range(K5_PR):
                    for q in range(K5_PC):
                        oy, ox = py0 + py, px0 + q
                        if oy < pool_o and ox < pool_o:
                            win3 = tile[2 * py:2 * py + 3, 2 * q:2 * q + 3]
                            outs[d][v, :, oy, ox] = np.maximum(win3.max(axis=(0, 1)), 0.0)
                            written[v, :, oy, ox] += d == "f32"
    assert (written == 1).all()
    return outs["f32"], outs["bf16"]


@pytest.mark.parametrize("crop", [48, 47, None])
def test_k5_index_emulation_matches_plain(crop):
    """The emulation of K5's tiling, operand indices and exact path: f32
    against the plain version within 1e-5 * max|out| (sum order only), and
    bf16 bit-equal to the bf16 of a plain conv summed in order (c, ky, kx),
    the plain version's order on the card, itself within 1e-5 * max|out| of
    the plain version here. At crop 48 and 47 one 16-column tile is wider
    than the 12 pooled columns and the last tile's rows are ragged;
    uncropped, 4 tiles per view fill the 16^2 maps."""
    images, scale, bias, w, cb = _stem_data(seed=7, m=64)
    weight = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
    size = crop or 64
    got32, got16 = _k5_emulate(images, scale, bias, weight, cb, size)
    want = _port_stem(images, scale, bias, w, cb, crop).numpy()
    assert got32.shape == want.shape
    top = np.abs(want).max()
    assert top > 1.0 and (want == 0).mean() < 0.5
    np.testing.assert_allclose(got32, want, atol=1e-5 * top, rtol=0)
    # the plain conv in order (c, ky, kx), pooled
    off = (64 - size) // 2
    x = images[:, :, off:off + size, off:off + size].astype(np.float32)
    x = _bf16(x * scale[:, :, None, None] + bias[:, :, None, None]).float().numpy()
    w2 = _bf16(weight.reshape(64, -1)).float().numpy()
    conv_o = (size - 1) // 2 + 1
    gr, gc = np.meshgrid(np.arange(conv_o), np.arange(conv_o), indexing="ij")
    seq = np.stack([_sequential_conv(x[v], w2[:, :, None, None], cb[:, None, None], gr, gc)
                    for v in range(len(x))])
    seq = F.max_pool2d(torch.relu(torch.from_numpy(seq)), 3, 2, 1)
    np.testing.assert_allclose(seq.numpy(), want, atol=1e-5 * top, rtol=0)
    assert torch.equal(torch.from_numpy(got16).to(torch.bfloat16), seq.to(torch.bfloat16))


def _bf16_within_one_ulp(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Non-negative bf16 values within one unit in the last place."""
    m = torch.maximum(a.abs(), b.abs()).float()
    ulp = torch.where(m > 0, torch.exp2(torch.floor(torch.log2(m)) - 7), torch.zeros_like(m))
    return bool(((a.float() - b.float()).abs() <= ulp).all())


@pytest.mark.gpu
def test_fused_stem_kernel_matches_plain_on_card():
    """The CUDA kernel against the plain version on the card (TF32 off):
    f32 output within 1e-5 * max|out| (only the f32 summation order differs),
    bf16 output within one ulp, and the launch counter. One view at crop 48
    leaves most persistent blocks without a tile (one 16-column tile is wider
    than the 12 pooled columns); three views at crop 47 and 48 and uncropped
    run the persistent loop's tail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused_stem kernel runs only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    data = _stem_data(n=3, m=64, seed=5)
    images, scale, bias, w, cb = (torch.from_numpy(a).cuda() for a in data)
    weight = w.permute(3, 2, 0, 1).contiguous()
    for views, crop in ((3, None), (3, 48), (3, 47), (1, 48)):
        args = (images[:views], scale[:views], bias[:views], weight, cb, crop)
        for dt in (torch.float32, torch.bfloat16):
            before = fused_stem.launches
            out = fused_stem(*args, dt)
            ref = fused_stem_reference(*args, dt)
            torch.cuda.synchronize()
            assert fused_stem.launches == before + 1
            if dt == torch.float32:
                gap = float((out - ref).abs().max())
                assert gap <= 1e-5 * float(ref.abs().max()), (views, crop, gap)
            else:
                assert _bf16_within_one_ulp(out, ref), (views, crop)
