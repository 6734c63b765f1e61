"""rxtpu_torch's augmentation (K2-K4, the shear pipeline, the exact warp and
the draws) against rxtpu's, on the CPU.

rxtpu's shear passes run here as Pallas kernels in interpret mode
(``shear.py:117-118``); the port's wrappers run their plain PyTorch
versions. Inputs come from numpy with a seed; 64^2 sources and 48^2 crops
(``tests/test_shear.py:11``).

Tolerances. The port rounds every product and sum of the lerp
``x*(1-f) + n*f`` on its own (as its CUDA kernels do, bit for bit). XLA's
CPU backend contracts ``n*f + x*(1-f)`` into one FMA (checked:
``fma(n, f, x*(1-f))`` reproduces rxtpu's interpret output exactly), and
``y*scale + bias`` likewise, so a pass differs from rxtpu's by at most an
ulp or two of its output: rtol 1e-6 (8 ulps) with atol 1e-5 (the bound of
``tests/test_shear.py:49``) for values near zero. An index or clamp error
moves values by O(1). bf16 outputs agree except where such an ulp crosses a
bf16 rounding boundary: there they differ by one bf16 ulp (at most 2^-7 of
the value).
The composed augment uses atol 1e-3: besides the FMA, tan/sin differ by an
ulp between XLA and torch, which moves a sample by ~1e-5 px.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxtpu.ops import shear as rx_shear
from rxtpu.ops import warp as rx_warp
from rxtpu_torch.ops import get_augment_fn
from rxtpu_torch.ops import shear as port_shear
from rxtpu_torch.ops import warp as port_warp

SRC, CROP = 64, 48


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run as fast on one intra-op thread, and the suite runs
    test files in parallel workers that would otherwise each start one
    thread per core and contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(port: torch.Tensor, ref, rtol=1e-6, atol=1e-5):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               rtol=rtol, atol=atol)


def _bf16_close(port: torch.Tensor, ref):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = port.float().numpy()
    np.testing.assert_allclose(got, ref, rtol=2.0**-7, atol=1e-6)
    assert (got != ref).mean() < 1e-3  # only rounding-boundary cases differ


def _pass_inputs(seed: int, p: int, h: int, w: int, uint8: bool):
    rng = np.random.default_rng(seed)
    if uint8:
        x = rng.integers(0, 256, (p, h, w), dtype=np.uint8)
    else:
        x = rng.uniform(0, 1, (p, h, w)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, p).astype(np.float32)
    bias = rng.uniform(-1.0, 1.0, p).astype(np.float32)
    return rng, x, scale, bias


def _shift(rng, shape, pad_lo, pad_hi):
    # beyond both ends, so k reaches 0 and kmax (the clamps)
    return rng.uniform(-pad_lo - 6, pad_hi + 6, shape).astype(np.float32)


@pytest.mark.parametrize("uint8", [True, False])
def test_shear_pass_matches_rxtpu(uint8):
    rng, x, scale, bias = _pass_inputs(0, 6, 16, SRC, uint8)
    pl, pr = rx_shear._pads(0.41422 * SRC / 2, 0, SRC, SRC)
    shift = _shift(rng, (6, 16), pl, pr)
    k, _ = port_shear.shift_params(_t(shift), SRC, SRC, pl, pr)
    assert int(k.min()) == 0 and int(k.max()) == SRC + pl + pr - SRC - 1
    ref = rx_shear.shear_pass(jnp.asarray(x), jnp.asarray(shift), SRC, pl, pr,
                              jnp.asarray(scale), jnp.asarray(bias))
    got = port_shear.shear_pass(_t(x), _t(shift), SRC, pl, pr, _t(scale), _t(bias))
    assert got.dtype == torch.float32 and got.shape == (6, 16, SRC)
    _close(got, ref)
    # without scale/bias (the identity normalize, rxtpu's default) and a
    # narrower output
    pl, pr = rx_shear._pads(0.41422 * SRC / 2, SRC - CROP, SRC, CROP)
    _close(port_shear.shear_pass(_t(x), _t(shift), CROP, pl, pr),
           rx_shear.shear_pass(jnp.asarray(x), jnp.asarray(shift), CROP, pl, pr))


def test_shear_pass_rows_matches_rxtpu():
    rng, x, _, _ = _pass_inputs(1, 6, SRC, SRC, False)
    pt, pb = rx_shear._pads(0.70712 * SRC / 2, SRC - CROP, SRC, CROP, lane_align=False)
    shift = _shift(rng, (6, SRC), pt, pb + SRC - CROP)
    k, _ = port_shear.shift_params(_t(shift), SRC, CROP, pt, pb)
    assert int(k.min()) == 0 and int(k.max()) == SRC + pt + pb - CROP - 1
    ref = rx_shear.shear_pass_rows(jnp.asarray(x), jnp.asarray(shift), CROP, pt, pb)
    got = port_shear.shear_pass_rows(_t(x), _t(shift), CROP, pt, pb)
    assert got.shape == (6, CROP, SRC)
    _close(got, ref)


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_shear_pass_finish_matches_rxtpu(out):
    rng, x, scale, bias = _pass_inputs(2, 8, CROP, SRC, False)
    pl, pr = rx_shear._pads(0.41422 * SRC / 2, SRC - CROP, SRC, CROP)
    shift = _shift(rng, (8, CROP), pl, pr + SRC - CROP)
    # all four (rrev, crev) combinations, twice each
    rrev = np.array([0, 1, 0, 1, 0, 1, 0, 1], bool)
    crev = np.array([0, 0, 1, 1, 0, 0, 1, 1], bool)
    jdt, tdt = (jnp.float32, torch.float32) if out == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref = rx_shear.shear_pass_finish(
        jnp.asarray(x), jnp.asarray(shift), CROP, pl, pr, jnp.asarray(scale),
        jnp.asarray(bias), jnp.asarray(rrev), jnp.asarray(crev), out_dtype=jdt)
    got = port_shear.shear_pass_finish(_t(x), _t(shift), CROP, pl, pr, _t(scale), _t(bias),
                                       _t(rrev), _t(crev), out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (8, CROP, CROP)
    if out == "f32":
        _close(got, ref)
    else:
        _bf16_close(got, ref)


def test_pads_and_angle_helpers_match_rxtpu():
    for args in ((0.41422 * 256, 0, 512, 512), (0.70712 * 256, 148, 512, 364),
                 (0.41422 * 256, 148, 512, 364), (0.41422 * 32, 0, SRC, SRC),
                 (0.70712 * 32, 16, SRC, CROP), (0.41422 * 32, 16, SRC, CROP)):
        for align in (True, False):
            assert port_shear._pads(*args, lane_align=align) == \
                rx_shear._pads(*args, lane_align=align)
    # the main-path pads: 512^2 sources, crop 364
    assert port_shear._pads(0.41422 * 256, 0, 512, 512) == (112, 144)
    assert port_shear._pads(0.70712 * 256, 148, 512, 364, lane_align=False) == (184, 184)
    angles = np.concatenate([np.linspace(-np.pi, np.pi, 101),
                             [np.pi / 4, -np.pi / 4, 3 * np.pi / 4]]).astype(np.float32)
    k_ref, phi_ref = rx_shear.decompose_angle(jnp.asarray(angles))
    k, phi = port_shear.decompose_angle(_t(angles))
    np.testing.assert_array_equal(k.numpy(), np.asarray(k_ref))
    np.testing.assert_array_equal(phi.numpy(), np.asarray(phi_ref))
    v, h, k90 = (np.array(a) for a in np.meshgrid([0, 1], [0, 1], [0, 1, 2, 3, -1]))
    v, h, k90 = v.ravel().astype(bool), h.ravel().astype(bool), k90.ravel().astype(np.int32)
    for got, want in zip(port_shear.dihedral_bits(_t(v), _t(h), _t(k90)),
                         rx_shear.dihedral_bits(jnp.asarray(v), jnp.asarray(h),
                                                jnp.asarray(k90))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dihedral_ops_match_rxtpu():
    rng = np.random.default_rng(3)
    planes = rng.integers(0, 256, (16, 12, 12), dtype=np.uint8)
    bits = [rng.integers(0, 2, 16).astype(bool) for _ in range(3)]
    k90 = rng.integers(0, 4, 16).astype(np.int32)
    np.testing.assert_array_equal(
        port_shear.dihedral(_t(planes), _t(bits[0]), _t(bits[1]), _t(k90)).numpy(),
        np.asarray(rx_shear.dihedral(jnp.asarray(planes), jnp.asarray(bits[0]),
                                     jnp.asarray(bits[1]), jnp.asarray(k90))))
    np.testing.assert_array_equal(
        port_shear.apply_dihedral_bits(_t(planes), *(_t(b) for b in bits)).numpy(),
        np.asarray(rx_shear.apply_dihedral_bits(jnp.asarray(planes),
                                                *(jnp.asarray(b) for b in bits))))


def _batch(seed: int = 0, b: int = 2, g: int = 3):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, g, 6, SRC, SRC), dtype=np.uint8)
    mean = rng.uniform(0.1, 0.6, (b, 6)).astype(np.float32)
    std = rng.uniform(0.05, 0.3, (b, 6)).astype(np.float32)
    return images, mean, std


def _nchw(a) -> np.ndarray:
    return np.transpose(np.asarray(jnp.asarray(a).astype(jnp.float32)), (0, 1, 4, 2, 3))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shear_apply_matches_rxtpu_given_its_draws(seed):
    images, mean, std = _batch(seed)
    key = jax.random.PRNGKey(seed)
    params = [_t(p) for p in rx_warp.sample_affine_params(key, 6, SRC, CROP, True)]
    # the draws cover rotation quadrants and flips (the dihedral bits)
    assert len(set(np.round(params[0].numpy() / (np.pi / 2)).astype(int) % 4)) >= 2
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = rx_shear.augment_batch_shear(jnp.asarray(images), jnp.asarray(mean),
                                           jnp.asarray(std), key, crop_size=CROP,
                                           out_dtype=jdt)
        got = port_shear.apply_affine_shear(_t(images), _t(mean), _t(std), *params,
                                            crop_size=CROP, out_dtype=tdt)
        assert got.shape == (2, 3, 6, CROP, CROP) and got.dtype == tdt
        if tdt == torch.float32:
            np.testing.assert_allclose(got.numpy(), _nchw(ref), atol=1e-3, rtol=0)
        else:
            ref32 = _nchw(ref)
            np.testing.assert_allclose(got.float().numpy(), ref32, rtol=2.0**-7, atol=1e-3)
            assert (got.float().numpy() != ref32).mean() < 1e-2


def test_v1_pipeline_matches_rxtpu_and_fused():
    rng = np.random.default_rng(5)
    planes = rng.integers(0, 256, (4, SRC, SRC), dtype=np.uint8)
    phi = rng.uniform(-np.pi / 4, np.pi / 4, 4).astype(np.float32)
    crop = rng.integers(0, SRC - CROP + 1, (4, 2)).astype(np.int32)
    scale = rng.uniform(0.01, 0.05, 4).astype(np.float32)
    bias = rng.uniform(-2, 0, 4).astype(np.float32)
    ref = rx_shear.rotate_crop_normalize(jnp.asarray(planes), jnp.asarray(phi),
                                         jnp.asarray(crop), CROP, jnp.asarray(scale),
                                         jnp.asarray(bias))
    got = port_shear.rotate_crop_normalize(_t(planes), _t(phi), _t(crop), CROP, _t(scale),
                                           _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3, rtol=0)
    no_rev = torch.zeros(4, dtype=torch.bool)
    fused = port_shear.rotate_crop_normalize_fused(_t(planes), _t(phi), _t(crop), CROP,
                                                   _t(scale), _t(bias), no_rev, no_rev)
    # v1 and fused differ only in the sampling order of pass 2 (test_shear.py:126)
    np.testing.assert_allclose(got.numpy(), fused.numpy(), atol=2e-3, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_gather_apply_matches_rxtpu_given_its_draws(seed):
    images, mean, std = _batch(seed + 10)
    key = jax.random.PRNGKey(seed)
    params = [_t(p) for p in rx_warp.sample_affine_params(key, 6, SRC, CROP, True)]
    ref = rx_warp.augment_batch(jnp.asarray(images), jnp.asarray(mean), jnp.asarray(std),
                                key, crop_size=CROP, out_dtype=jnp.float32)
    got = port_warp.apply_affine_warp(_t(images), _t(mean), _t(std), *params,
                                      crop_size=CROP, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), _nchw(ref), atol=1e-3, rtol=0)


def test_eval_mode_is_the_center_crop():
    """train=False: identity draws and the center crop. The port's three
    backends agree bit for bit; against rxtpu they agree to the FMA of the
    normalize (see the module docstring)."""
    images, mean, std = _batch(4)
    center = port_warp.center_crop_normalize_reference(_t(images), _t(mean), _t(std), CROP,
                                                       torch.float32)
    ref = rx_warp.center_crop_normalize_reference(jnp.asarray(images), jnp.asarray(mean),
                                                  jnp.asarray(std), CROP, jnp.float32)
    _close(center, _nchw(ref))
    for backend, rx_fn in (("shear", rx_shear.augment_batch_shear),
                           ("gather", rx_warp.augment_batch)):
        got = get_augment_fn(backend)(_t(images), _t(mean), _t(std), None, crop_size=CROP,
                                      train=False, out_dtype=torch.float32)
        np.testing.assert_array_equal(got.numpy(), center.numpy())
        want = rx_fn(jnp.asarray(images), jnp.asarray(mean), jnp.asarray(std),
                     jax.random.PRNGKey(0), crop_size=CROP, train=False,
                     out_dtype=jnp.float32)
        _close(got, _nchw(want))
    views = torch.ones(2, 3, 6, 8, 8)
    assert get_augment_fn("none")(views, None, None, None, crop_size=8) is views
    with pytest.raises(ValueError):
        get_augment_fn("nope")


def test_sample_affine_params_seeded_and_in_range():
    draw = lambda s: port_warp.sample_affine_params(  # noqa: E731
        torch.Generator().manual_seed(s), 4096, 512, 364, True)
    a, b, c = draw(7), draw(7), draw(8)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    angle, vflip, hflip, crop = a
    assert angle.dtype == torch.float32 and crop.dtype == torch.int32
    assert float(angle.min()) >= -np.pi and float(angle.max()) < np.pi
    assert float(angle.min()) < -3.0 and float(angle.max()) > 3.0
    for flip in (vflip, hflip):
        assert flip.dtype == torch.bool and 0.45 < flip.float().mean() < 0.55
    assert int(crop.min()) == 0 and int(crop.max()) == 512 - 364
    eval_draw = port_warp.sample_affine_params(None, 3, 512, 364, False)
    assert not eval_draw[0].any() and not eval_draw[1].any() and not eval_draw[2].any()
    assert (eval_draw[3] == 74).all()
    # reflect101 against rxtpu's fold, indices far outside both ends
    idx = np.arange(-200, 200, dtype=np.int32)
    np.testing.assert_array_equal(port_warp.reflect101(_t(idx), 37).numpy(),
                                  np.asarray(rx_warp.reflect101(jnp.asarray(idx), 37)))


def test_shear_wrappers_reject_bad_input():
    x = torch.zeros(2, 16, 16)
    with pytest.raises(ValueError):  # pads break the single-mirror invariant
        port_shear.shear_pass(x, torch.zeros(2, 16), 16, 15, 8)
    with pytest.raises(ValueError):
        port_shear.shear_pass(x.double(), torch.zeros(2, 16), 16, 8, 8)
    with pytest.raises(ValueError):
        port_shear.shear_pass(x, torch.zeros(2, 15), 16, 8, 8)
    with pytest.raises(ValueError):
        port_shear.shear_pass_rows(x.to(torch.uint8), torch.zeros(2, 16), 8, 8, 8)
    with pytest.raises(ValueError):
        port_shear.shear_pass_finish(x, torch.zeros(2, 16), 8, 8, 8, torch.ones(2),
                                     torch.zeros(2), torch.zeros(2), torch.zeros(2, dtype=bool))


@pytest.mark.gpu
def test_shear_kernels_match_plain_on_card():
    """K2, K3 and K4 against their plain versions on the card, bit for bit,
    at the test shapes, with masked tails (crop 47) and the launch counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the shear kernels run only on the card")

    def same(a, b):
        iv = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
        assert torch.equal(a.view(iv), b.view(iv))

    for crop in (CROP, 47):
        rng, x, scale, bias = _pass_inputs(6, 12, SRC, SRC, True)
        pl, pr = port_shear._pads(0.41422 * SRC / 2, 0, SRC, SRC)
        dev = torch.device("cuda")
        x8, sc, bi = _t(x).to(dev), _t(scale).to(dev), _t(bias).to(dev)
        shift = _t(_shift(rng, (12, SRC), pl, pr)).to(dev)
        k, f = port_shear.shift_params(shift, SRC, SRC, pl, pr)
        for xin in (x8, x8.float()):
            n = port_shear.shear_pass.launches
            out = port_shear.shear_pass(xin, shift, SRC, pl, pr, sc, bi)
            assert port_shear.shear_pass.launches == n + 1
            same(out, port_shear.shear_pass_reference(xin, k, f, SRC, pl, pr, sc, bi))
        pt, pb = port_shear._pads(0.70712 * SRC / 2, SRC - crop, SRC, crop, lane_align=False)
        shift2 = _t(_shift(rng, (12, SRC), pt, pb)).to(dev)
        k2, f2 = port_shear.shift_params(shift2, SRC, crop, pt, pb)
        s2 = port_shear.shear_pass_rows(out, shift2, crop, pt, pb)
        same(s2, port_shear.shear_pass_rows_reference(out, k2, f2, crop, pt, pb))
        pl3, pr3 = port_shear._pads(0.41422 * SRC / 2, SRC - crop, SRC, crop)
        shift3 = _t(_shift(rng, (12, crop), pl3, pr3)).to(dev)
        k3, f3 = port_shear.shift_params(shift3, SRC, crop, pl3, pr3)
        rrev = torch.arange(12, device=dev) % 2 == 1
        crev = torch.arange(12, device=dev) % 4 >= 2
        for dt in (torch.float32, torch.bfloat16):
            got = port_shear.shear_pass_finish(s2, shift3, crop, pl3, pr3, sc, bi, rrev, crev, dt)
            same(got, port_shear.shear_pass_finish_reference(s2, k3, f3, crop, pl3, pr3, sc,
                                                             bi, rrev, crev, dt))
        torch.cuda.synchronize()
