"""rxtpu_torch's DenseNet-121 backbone against rxtpu's, on the CPU.

The same numpy-seeded weights (random BN affines and running statistics)
go through rxtpu's flax DenseNet and, carried across by ``from_flax``,
through the port's. Shallow nets (blocks 2/2/2/2, growth 32) at 32^2 views,
the smallest that survive the five downsamples, and one full-depth
DenseNet-121 eval: features in f32 within atol 1e-4 * max(1, max|ref|);
the train-mode forward and its BN running statistics within
``tests/test_torch_port_train.py``'s bounds; the unfolded eval path
(``Predictor``) against rxtpu's TTA predict step; the pretrained port bit
for bit. In bf16 the transition's average pool rounds otherwise than
rxtpu's on the CPU (measured below: a third of the pooled values one bf16
ulp apart), so bf16 is held to that gap and to rxtpu's BN rounding.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

import rxtpu.models.densenet as rx_densenet
import rxtpu_torch.models.densenet as port_densenet
from rxtpu.infer.tta import make_tta_predict_step
from rxtpu.models.pretrained import port_torch_densenet121 as rx_port_densenet121
from rxtpu.models.twosites import TwoSitesNN as FlaxTwoSitesNN
from rxtpu.train.step import TrainState
from rxtpu_torch.infer.fold import Autocast, fold, foldable
from rxtpu_torch.infer.predict import Predictor
from rxtpu_torch.models.convert import from_flax
from rxtpu_torch.models.norm import BatchNorm
from rxtpu_torch.models.pretrained import (
    port_torch_densenet121, synthetic_densenet121_state_dict,
)
from rxtpu_torch.models.resnet import init_weights, make_backbone
from rxtpu_torch.models.twosites import TwoSitesNN
from rxtpu_torch.train.step import EvalStep
from test_torch_port_models import assert_logits_close, randomize_flax

SHALLOW = (2, 2, 2, 2)
KW = dict(backbone="densenet121", nb_classes=8, size_features=16)


@contextlib.contextmanager
def shallow_densenet():
    """``densenet121`` in both packages built with blocks 2/2/2/2: the
    TwoSitesNN, CLI and quantization paths at a test's size."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rx_densenet, "densenet121",
                   lambda **kw: rx_densenet.DenseNet(block_sizes=SHALLOW, **kw))
        mp.setattr(port_densenet, "densenet121",
                   lambda quantized=False: port_densenet.DenseNet(SHALLOW, quantized=quantized))
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def randomize_port(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Random weights (He normal over fan-out) and random BN affines and
    running statistics, as ``randomize_flax`` draws them, in place."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            leaf, shape = name.rsplit(".", 1)[-1], tuple(t.shape)
            if t.ndim == 4:
                v = rng.normal(0.0, np.sqrt(2.0 / (shape[0] * shape[2] * shape[3])), shape)
            elif leaf in ("weight", "running_var"):
                v = rng.uniform(0.5, 1.5, shape)
            else:
                v = rng.normal(0.0, 0.1, shape)
            t.copy_(torch.from_numpy(v.astype(np.float32)))
    return module


def to_flax(sd):
    """A port state dict -> rxtpu's ``{params, batch_stats}`` (``from_flax``'s
    inverse), so a tree needs no flax ``init``. The arrays are copies: JAX
    on the CPU may alias a numpy buffer, which the port's train-mode BNs
    update in place while rxtpu's dispatched computation may still read it."""
    params, stats = {}, {}
    names = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
    for key, t in sd.items():
        *path, leaf = key.split(".")
        a = t.detach().numpy().copy()
        if key == "head.weight":  # ArcFace's class weights
            tree = params
        elif leaf == "weight" and a.ndim > 1:  # conv HWIO, Dense (in, out)
            tree, leaf = params, "kernel"
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        else:
            tree = stats if leaf.startswith("running_") else params
            leaf = names[leaf]
        for p in path:
            tree = tree.setdefault(p, {})
        tree[leaf] = jnp.asarray(a)
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("blocks", [SHALLOW, (6, 12, 24, 16)], ids=["shallow", "densenet121"])
def test_densenet_eval_matches_rxtpu(blocks):
    flax_model = rx_densenet.DenseNet(block_sizes=blocks, dtype=jnp.float32)
    port = randomize_port(port_densenet.DenseNet(blocks), 1)
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 6)).astype(np.float32)
    variables = to_flax(port.state_dict())
    ref = np.asarray(jax.jit(lambda v, x: flax_model.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    assert from_flax(variables["params"], variables["batch_stats"]).keys() == \
        port.state_dict().keys()
    with torch.no_grad():
        out = port.eval()(_nchw(x)).numpy()
    assert out.shape == ref.shape == (2, port.num_features)
    assert port.num_features == (1024 if blocks != SHALLOW else 128)
    assert_logits_close(out, ref)


def test_two_sites_densenet_train_forward_matches_rxtpu():
    """Train mode: logits and the BN running statistics after one forward
    (``tests/test_torch_port_train.py:86-106``'s bounds), at 8 wells of 64^2
    views: each train-mode BN divides by its batch's std, and the smaller the
    batch of a late BN (2x2 maps here), the more it amplifies the f32
    rounding of what came before. Measured here: the port 6e-6 of max|logit|
    from the same forward in f64, rxtpu 7e-5; the port is held to 2e-5."""
    with shallow_densenet():
        flax_model = FlaxTwoSitesNN(**KW, dropout=0.0, dtype=jnp.float32)
        port = randomize_port(TwoSitesNN(**KW, dropout=0.0), 2)
        f64 = TwoSitesNN(**KW, dropout=0.0)
        x = np.random.default_rng(1).normal(size=(8, 3, 64, 64, 6)).astype(np.float32)
        variables = to_flax(port.state_dict())
        ref, mutated = jax.jit(lambda v, x: flax_model.apply(v, x, train=True,
                                                             mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
    f64.load_state_dict(port.state_dict())
    out = port.train()(_nchw(x))
    assert out.dtype == torch.float32 and out.shape == (8, 8)
    assert_logits_close(out.detach().numpy(), np.asarray(ref))
    exact = f64.double().train()(_nchw(x).double()).detach().numpy()
    scale = np.abs(exact).max()
    assert np.abs(out.detach().numpy() - exact).max() < 2e-5 * scale
    new = from_flax(variables["params"], mutated["batch_stats"])
    for k in ("backbone.bn_init.running_var", "backbone.block2_layer2.BatchNorm_1.running_mean",
              "backbone.transition3.BatchNorm_0.running_var", "backbone.bn_final.running_mean",
              "head.bn1.running_var"):
        np.testing.assert_allclose(port.state_dict()[k].numpy(), new[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_transition_pool_bf16_gap():
    """The transition's 2x2 average pool in bf16. rxtpu's (XLA on the CPU)
    adds the four bf16 values in bf16, rounding after each add; the port's
    ``F.avg_pool2d`` sums in f32 and rounds once. Measured here: 33% of the
    pooled values differ, by at most two ulps of the window's mean |value|
    (the grid rxtpu's partial sums round to; half of them by half of one).
    In f32 the two sum in another order: within two f32 ulps of it."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(8, 16, 16, 64)).astype(np.float32)
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        ja = jnp.asarray(a, jdt)
        want = np.asarray(nn.avg_pool(ja, (2, 2), strides=(2, 2)).astype(jnp.float32))
        t = torch.from_numpy(np.array(ja.astype(jnp.float32))).to(dtype)
        got = port_densenet.avg_pool_nhwc(t).float().numpy()
        f = np.asarray(ja.astype(jnp.float32))
        mean_abs = sum(np.abs(f[:, i::2, j::2]) for i in (0, 1) for j in (0, 1)) / 4
        ulp = 2.0 ** (np.floor(np.log2(mean_abs)) - (23 if dtype == torch.float32 else 7))
        assert (np.abs(got - want) <= 2 * ulp).all()
        if dtype == torch.float32:
            continue
        share = float((got != want).mean())
        assert 0.2 < share < 0.45, share


def test_port_torch_densenet121_matches_rxtpu():
    """The torchvision port on ``synthetic_densenet121_state_dict`` gives
    rxtpu's weights bit for bit, and the same draws."""
    sd = synthetic_densenet121_state_dict(3)
    from rxtpu.models.pretrained import synthetic_densenet121_state_dict as rx_synth

    want_sd = rx_synth(3)
    assert sorted(sd) == sorted(want_sd)
    assert all(np.array_equal(sd[k], want_sd[k]) for k in sd)
    port = TwoSitesNN(**KW)
    variables = to_flax(port.state_dict())  # rxtpu's tree for the same model
    params, stats = rx_port_densenet121(sd, variables["params"], variables["batch_stats"])
    want = from_flax(params, stats)
    got = port_torch_densenet121(sd, port.state_dict())
    backbone = [k for k in want if k.startswith("backbone.")]
    assert sorted(backbone) == sorted(k for k in got if k.startswith("backbone."))
    for k in backbone:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    port.load_state_dict(got)  # strict: every name maps


def _predict_case(head, seed):
    """A shallow DenseNet TwoSitesNN in rxtpu (random BN statistics) and the
    port, and a raw test batch."""
    flax_model = FlaxTwoSitesNN(**{**KW, "head": head}, dtype=jnp.float32)
    variables = randomize_flax(flax_model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 3, 32, 32, 6)), train=False), seed + 1)
    port = TwoSitesNN(**{**KW, "head": head})
    port.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    rng = np.random.default_rng(seed)
    batch = {"images": rng.integers(0, 256, (2, 6, 6, 48, 48), dtype=np.uint8),
             "mean": rng.uniform(0.1, 0.6, (2, 6)).astype(np.float32),
             "std": rng.uniform(0.05, 0.3, (2, 6)).astype(np.float32)}
    return flax_model, variables, port, batch


@pytest.mark.parametrize("head", ["mlp", "arcface"])
def test_unfolded_predictor_matches_rxtpu(head):
    """DenseNet, and DenseNet with the ArcFace head, do not fold: the
    ``Predictor`` runs them unfolded on K1's views, f32, ``--tta flips``,
    against rxtpu's TTA predict step (``_make_eval_apply``'s unfolded
    branch); probabilities within 1e-4 (``tests/test_torch_port_serve.py:89``)."""
    with shallow_densenet():
        flax_model, variables, port, batch = _predict_case(head, 4)
        state = TrainState.create(variables["params"], variables["batch_stats"],
                                  optax.identity(), None)
        step = make_tta_predict_step(flax_model, 32, "flips", "probs")
        ref = np.asarray(step(state, {k: jnp.asarray(v) for k, v in batch.items()}))
        predictor = Predictor(port.eval(), 32, "flips", "probs", dtype=torch.float32)
    assert not foldable(port)
    assert isinstance(predictor.net, Autocast)
    got = predictor({k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    assert got.shape == (2, 8) and got.dtype == np.float32
    assert ref.max() - ref.min() > 1e-3
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_unfolded_eval_bf16_keeps_bn_parameters_f32():
    """The unfolded twin computes in bf16 under autocast with f32 parameters:
    each BN forms ``mul`` and ``add`` from f32 weights and running statistics
    and rounds only them, as rxtpu's does. A running variance and weights
    that bf16 cannot hold (1 + 2^-9 rounds to 1) move the logits when cast
    first; the twin matches rxtpu's bf16 logits where a bf16 copy does not."""
    with shallow_densenet():
        flax_model = FlaxTwoSitesNN(**KW, dtype=jnp.bfloat16)
        variables = flax_model.init(jax.random.PRNGKey(5), jnp.zeros((1, 3, 32, 32, 6)),
                                    train=False)
        rng = np.random.default_rng(5)

        def leaf(path, x):  # values that bf16 rounds: 1 + k * 2^-9, k odd
            name = path[-1].key
            if name in ("scale", "var"):
                return jnp.asarray(1.0 + 2.0 ** -9 * (2 * rng.integers(1, 60, np.shape(x)) + 1),
                                   jnp.float32)
            if name in ("bias", "mean"):
                return jnp.asarray(rng.normal(0.0, 0.1, np.shape(x)), jnp.float32)
            return x

        variables = jax.tree_util.tree_map_with_path(leaf, variables)
        x = np.random.default_rng(6).normal(size=(2, 3, 32, 32, 6)).astype(np.float32)
        ref = np.asarray(jax.jit(lambda v, x: flax_model.apply(v, x, train=False))(
            variables, jnp.asarray(x)), np.float32)
        port = TwoSitesNN(**KW)
        port.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
        net, _ = fold(port, 32, torch.bfloat16)
        cast_first = TwoSitesNN(**KW)
        cast_first.load_state_dict(port.state_dict())
    views = _nchw(x).to(torch.bfloat16)
    with torch.no_grad():
        got = net(views).float().numpy()
        bad = cast_first.to(torch.bfloat16).eval()(views).float().numpy()
    scale = np.abs(ref).max()
    gap, bad_gap = np.abs(got - ref).max(), np.abs(bad - ref).max()
    # measured: the twin 0.7% of max|logit| from rxtpu's (bf16 convs and sums
    # round otherwise), the bf16 copy 1.6%
    print(f"bf16 logits: twin {gap / scale:.3g}, bf16 copy {bad_gap / scale:.3g} of max|logit|")
    assert gap < 1e-2 * scale, (gap, scale)
    assert bad_gap > 2 * gap, (gap, bad_gap)


def test_densenet_eval_step_and_guards():
    """``EvalStep`` on DenseNet evaluates unfolded; the fused stem, BN folding
    and ``stem_input`` raise on DenseNet, ``fuse_blocks`` is dropped, as in
    rxtpu (``rxtpu/models/resnet.py:337-345``)."""
    with shallow_densenet():
        flax_model, variables, port, batch = _predict_case("mlp", 7)
        from rxtpu.train.step import make_eval_step as rx_make_eval_step

        rng = np.random.default_rng(7)
        batch = {**batch, "images": batch["images"][:, :3],
                 "labels": rng.integers(0, 8, 2).astype(np.int32),
                 "valid": np.array([1, 1], np.float32)}
        state = TrainState.create(variables["params"], variables["batch_stats"],
                                  optax.identity(), None)
        ref = rx_make_eval_step(flax_model, 32)(state, {k: jnp.asarray(v)
                                                        for k, v in batch.items()})
        got = EvalStep(port, 32, torch.float32)({k: torch.from_numpy(v)
                                                 for k, v in batch.items()})
        assert float(got["count"]) == float(ref["count"]) == 2.0
        assert float(got["correct"]) == float(ref["correct"])
        np.testing.assert_allclose(float(got["loss_sum"]), float(ref["loss_sum"]), rtol=1e-5)
        with pytest.raises(ValueError, match="BN-foldable"):
            EvalStep(port, 32, torch.float32, fused_stem=True)
        with pytest.raises(ValueError, match="BN folding"):
            make_backbone("densenet121", folded=True)
        with pytest.raises(ValueError, match="fused stem"):
            make_backbone("densenet121", stem_input=True)
        fused = TwoSitesNN(**KW, fuse_blocks=True)
        assert isinstance(fused.backbone, port_densenet.DenseNet)
        fused.train()(torch.randn(2, 3, 6, 32, 32))  # runs the standard layers


def test_densenet_init_weights():
    """rxtpu's initial distributions: convs normal with std sqrt(2/fan_out),
    every BN at scale one (DenseNet has no zero-initialised last BN)."""
    model = TwoSitesNN(**KW)
    init_weights(model, torch.Generator().manual_seed(0))
    bns = [m for m in model.backbone.modules() if isinstance(m, BatchNorm)]
    assert len(bns) == 1 + 2 * 58 + 3 + 1  # stem, 58 layers, 3 transitions, final
    assert all(bool((m.weight == 1).all()) for m in bns)
    w = model.backbone.block3_layer24.Conv_0.weight
    fan_out = w.shape[0]  # 1x1: 128 outputs
    assert abs(float(w.std()) / (2.0 / fan_out) ** 0.5 - 1.0) < 0.05
