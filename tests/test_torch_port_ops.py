"""rxtpu_torch K1 (crop_norm) against rxtpu's Pallas crop_normalize.

The port's plain version runs here on the CPU; rxtpu's Pallas kernel runs
in interpret mode off-TPU (``pallas_norm.py:60-61``). Inputs come from numpy
with a seed. bf16 and int8 outputs must be bit-equal (both sides round the
product and the sum separately, then round to nearest even); f32 uses the
atol of ``tests/test_augment.py:64``. The kernel itself runs only on a card:
the ``gpu`` test holds it against the plain version there.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxtpu.ops.pallas_norm import crop_normalize as jax_crop_normalize
from rxtpu.ops.pallas_norm import eval_batch_normalize as jax_eval_batch_normalize
from rxtpu_torch.ops.crop_norm import (
    crop_normalize, crop_normalize_reference, eval_batch_normalize,
)

H = 64
_TORCH = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}
_JAX = {"bf16": jnp.bfloat16, "int8": jnp.int8, "f32": jnp.float32}


def _planes(seed: int, n: int = 12, quant: bool = False):
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 256, (n, H, H), dtype=np.uint8)
    if quant:
        # x*0.5 - 64 lands on a .5 tie for every odd x (half-to-even decides),
        # x*1 - 128 reaches the -127 clip, the rest are ordinary scales
        scale = np.where(np.arange(n) % 3 == 0, 0.5,
                         np.where(np.arange(n) % 3 == 1, 1.0, rng.uniform(0.2, 2.0, n)))
        bias = np.where(np.arange(n) % 3 == 0, -64.0,
                        np.where(np.arange(n) % 3 == 1, -128.0, rng.uniform(-90, 10, n)))
    else:
        std = rng.uniform(0.05, 0.3, n).astype(np.float32)
        mean = rng.uniform(0.1, 0.6, n).astype(np.float32)
        scale, bias = 1.0 / (255.0 * std), -mean / std
    return planes, scale.astype(np.float32), bias.astype(np.float32)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _assert_same(port: np.ndarray, ref: np.ndarray, kind: str):
    if kind == "f32":
        np.testing.assert_allclose(port, ref, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(_bits(port), _bits(np.asarray(ref)))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("crop", [48, H])
@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
def test_crop_normalize_matches_rxtpu(kind, crop):
    planes, scale, bias = _planes(0, quant=kind == "int8")
    ref = np.asarray(jax_crop_normalize(jnp.asarray(planes), jnp.asarray(scale),
                                        jnp.asarray(bias), crop, _JAX[kind]))
    out = crop_normalize(torch.from_numpy(planes), torch.from_numpy(scale),
                         torch.from_numpy(bias), crop, _TORCH[kind])
    assert out.shape == (planes.shape[0], crop, crop) and out.dtype == _TORCH[kind]
    _assert_same(_to_numpy(out), ref, kind)
    if kind == "int8":
        ties = planes[::3] % 2 == 1
        assert ties.any()  # the half-to-even cases were exercised


@pytest.mark.parametrize("crop", [48, None])
@pytest.mark.parametrize("quant", [False, True])
def test_eval_batch_normalize_matches_rxtpu(crop, quant):
    rng = np.random.default_rng(1)
    b, g, c = 2, 6, 6
    images = rng.integers(0, 256, (b, g, c, H, H), dtype=np.uint8)
    mean = rng.uniform(0.1, 0.6, (b, c)).astype(np.float32)
    std = rng.uniform(0.05, 0.3, (b, c)).astype(np.float32)
    q = np.float32(0.037) if quant else None
    ref = jax_eval_batch_normalize(
        jnp.asarray(images), jnp.asarray(mean), jnp.asarray(std), crop,
        quant_scale=None if q is None else jnp.asarray(q))
    ref = np.transpose(np.asarray(ref), (0, 1, 4, 2, 3))  # NHWC -> NCHW
    out = eval_batch_normalize(torch.from_numpy(images), torch.from_numpy(mean),
                               torch.from_numpy(std), crop,
                               quant_scale=None if q is None else torch.tensor(q))
    size = crop or H
    assert out.shape == (b, g, c, size, size)
    _assert_same(_to_numpy(out), ref, "int8" if quant else "bf16")


def test_crop_normalize_rejects_bad_input():
    planes, scale, bias = _planes(2, n=3)
    p, s, b = (torch.from_numpy(a) for a in (planes, scale, bias))
    with pytest.raises(ValueError):
        crop_normalize(p.float(), s, b, 48)
    with pytest.raises(ValueError):
        crop_normalize(p, s[:2], b, 48)
    with pytest.raises(ValueError):
        crop_normalize(p, s, b, H + 1)
    with pytest.raises(ValueError):
        crop_normalize(p, s, b, 48, torch.float16)


@pytest.mark.gpu
def test_crop_norm_kernel_matches_plain_on_card():
    """The CUDA kernel against the plain version on the card, bit for bit,
    and the launch counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the crop_norm kernel runs only on the card")
    for kind in ("bf16", "int8", "f32"):
        planes, scale, bias = _planes(3, n=36, quant=kind == "int8")
        p, s, b = (torch.from_numpy(a).cuda() for a in (planes, scale, bias))
        for crop in (H, 48, 47):
            before = crop_normalize.launches
            out = crop_normalize(p, s, b, crop, _TORCH[kind])
            ref = crop_normalize_reference(p, s, b, crop, _TORCH[kind])
            torch.cuda.synchronize()
            assert crop_normalize.launches == before + 1
            _assert_same(_to_numpy(out.cpu()), _to_numpy(ref.cpu()), kind)
