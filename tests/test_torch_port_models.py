"""rxtpu_torch models against rxtpu's flax models, in f32 on the CPU.

The same numpy-seeded weights (with random, non-trivial BN affines and
running statistics) go through rxtpu's flax modules and, carried across by
``rxtpu_torch.models.convert.from_flax``, through the port's modules. Eval
outputs agree to atol 1e-4 * max(1, max|out|), the bound of
``tests/test_torch_parity.py:319``, after a check that the output is not
degenerate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxtpu.infer.fold import fold_variables
from rxtpu.models import resnet as flax_resnet
from rxtpu.models.twosites import TwoSitesNN as FlaxTwoSitesNN
from rxtpu_torch.infer.fold import fold_for_inference, fold_state_dict
from rxtpu_torch.models import resnet as port_resnet
from rxtpu_torch.models.convert import from_flax
from rxtpu_torch.models.twosites import TwoSitesNN


def randomize_flax(variables, seed: int):
    """Random BN scale/bias/mean/var (rxtpu zero-inits the last BN scale of
    each block, which would hide the residual branch) and random biases."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == "scale":
            return jnp.asarray(rng.uniform(0.5, 1.5, shape), jnp.float32)
        if name == "bias":
            return jnp.asarray(rng.normal(0.0, 0.1, shape), jnp.float32)
        if name == "mean":
            return jnp.asarray(rng.normal(0.0, 0.1, shape), jnp.float32)
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, shape), jnp.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def assert_logits_close(port: np.ndarray, ref: np.ndarray):
    scale = np.abs(ref).max()
    assert scale > 1e-3  # a degenerate all-zero forward would pass trivially
    np.testing.assert_allclose(port, ref, atol=1e-4 * max(1.0, scale), rtol=0)


def _nhwc_to_nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


@pytest.mark.parametrize("arch", ["narrow_basic", "narrow_bottleneck", "resnet50"])
def test_backbone_eval_matches_rxtpu(arch):
    if arch == "resnet50":
        flax_model = flax_resnet.resnet50(dtype=jnp.float32)
        port = port_resnet.make_backbone("resnet50")
    else:
        block = "ResNetBlock" if arch == "narrow_basic" else "BottleneckBlock"
        flax_model = flax_resnet.ResNet(stage_sizes=(1, 1, 1, 1), num_filters=8,
                                        block_cls=getattr(flax_resnet, block),
                                        dtype=jnp.float32)
        port = port_resnet.ResNet((1, 1, 1, 1), getattr(port_resnet, block), num_filters=8)
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 6)).astype(np.float32)
    variables = randomize_flax(flax_model.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    ref = np.asarray(flax_model.apply(variables, jnp.asarray(x), train=False))
    port.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    with torch.no_grad():
        out = port.eval()(_nhwc_to_nchw(x)).numpy()
    assert out.shape == ref.shape
    assert_logits_close(out, ref)


def _two_sites(calibrate: bool, seed: int = 0):
    kw = dict(backbone="resnet18", nb_classes=8, size_features=16,
              control_calibration=calibrate)
    flax_model = FlaxTwoSitesNN(**kw, dtype=jnp.float32)
    x = np.random.default_rng(seed).normal(size=(2, 6, 48, 48, 6)).astype(np.float32)
    variables = randomize_flax(
        flax_model.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False), seed + 1)
    port = TwoSitesNN(**kw)
    port.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    return flax_model, variables, port.eval(), x


@pytest.mark.parametrize("calibrate", [False, True])
def test_two_sites_eval_matches_rxtpu(calibrate):
    flax_model, variables, port, x = _two_sites(calibrate)
    ref = np.asarray(flax_model.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        out = port(_nhwc_to_nchw(x)).numpy()
    assert out.shape == (2, 8) and out.dtype == np.float32
    assert_logits_close(out, ref)


def test_fold_matches_unfolded_and_rxtpu_fold():
    flax_model, variables, port, x = _two_sites(False, seed=3)
    folded = fold_for_inference(port)
    with torch.no_grad():
        views = _nhwc_to_nchw(x)
        assert_logits_close(folded(views).numpy(), port(views).numpy())
    # the folded weights themselves match rxtpu's fold, leaf by leaf
    ref = from_flax(fold_variables(variables["params"], variables["batch_stats"])["params"])
    got = fold_state_dict(port.state_dict())
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_batchnorm_refuses_train_mode():
    bn = port_resnet.BatchNorm(4)
    with pytest.raises(NotImplementedError):
        bn(torch.zeros(2, 4))
