"""rxtpu_torch's fused train-mode bottleneck (K6 forward, K7 backward)
against rxtpu's, on the CPU.

- each plain body (``k1_reference`` ... ``b4_reference``) against rxtpu's
  Pallas body in interpret mode on the same operands, and the whole forward
  and backward (``bottleneck_fused`` through autograd against rxtpu's
  ``custom_vjp``), at rxtpu's test shapes: V=2 views of 8x8, F=8, C=32
  (identity) or 16 (projection); on a 15x15 plane that rxtpu splits into 4
  slabs padded to 256 pixels, the unpadded port equals the padded reference
  with its pad rows stripped;
- the layout helpers (round trip, rxtpu's tap order, ``from_flax``);
- ``fused_bottleneck`` on a port ``BottleneckBlock`` against the same block
  unfused: running statistics (Bessel), the state dict, the output and the
  gradients within rxtpu's own fused-vs-standard limits
  (``tests/test_fused_block.py``);
- ``ResNet(fuse_blocks=True)`` against rxtpu's on a tiny bottleneck net
  (stage_sizes [2], 8 filters, 16^2), and eval bit-equal with the flag on
  and off;
- the slice: one f32 train step of ``TwoSitesNN("resnet50",
  fuse_blocks=True)`` at 64^2 (B=4, G=3, augment "none" on the same views)
  in lockstep with rxtpu's, and the CLI with ``--fuse-blocks on`` on the
  numpy fixture.

Tolerances. Both sides round to bf16 at the same points; they differ in the
order of f32 sums, and XLA's CPU contracts ``v*scale + shift`` into an FMA
where the port rounds the product first. Either moves a value across a bf16
rounding boundary now and then: such an element differs by one bf16 ulp,
and a body that takes it as input by more where a BN shift cancels it. The
bounds are stated beside each comparison, a few times the reading on this
CPU, and all are tighter than rxtpu's fused-vs-standard limits (outputs
atol 0.1, statistics 5e-3, gradients 15% of max|grad| and 10% relative L2).

The CUDA kernels run only on a card: the ``gpu`` test holds them against
the plain versions there (``chip_smoke.py`` phase 2 does so at ResNet-50's
full width).
"""

from __future__ import annotations

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import rxtpu_torch.cli as port_cli
from rxtpu.config import Config, ModelConfig, TrainConfig
from rxtpu.models.resnet import BottleneckBlock as RxBottleneckBlock
from rxtpu.models.resnet import ResNet as RxResNet
from rxtpu.ops import fused_block as rx_fb
from rxtpu.train.setup import build_model as rx_build_model
from rxtpu.train.setup import create_train_state as rx_create_train_state
from rxtpu.train.step import make_train_step as rx_make_train_step
from rxtpu_torch.models.convert import from_flax
from rxtpu_torch.models.fused import fused_bottleneck
from rxtpu_torch.models.resnet import BottleneckBlock, ResNet
from rxtpu_torch.models.twosites import TwoSitesNN
from rxtpu_torch.ops import fused_block as fb
from rxtpu_torch.train.checkpoint import load_checkpoint
from rxtpu_torch.train.optim import make_schedule
from rxtpu_torch.train.step import TrainState, make_train_step

BF16 = torch.bfloat16
BODIES = ("k1", "k2", "k3", "k4", "b1", "b2", "b3", "b4")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run as fast on one intra-op thread, and the suite runs
    test files in parallel workers that would otherwise each start one
    thread per core and contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------


def _weights(c, f, proj, seed):
    """rxtpu's layouts, randomized as rxtpu's ``_randomized`` does (BN scale
    1 + 0.4 N(0, 1), so bn3's scale is not the zero of a fresh init)."""
    rng = np.random.default_rng(seed)
    p = {"w1": rng.normal(0, 0.4, (c, f)), "w2": rng.normal(0, 0.4, (9, f, f)),
         "w3": rng.normal(0, 0.4, (f, 4 * f))}
    for i, n in (("1", f), ("2", f), ("3", 4 * f)):
        p[f"g{i}"], p[f"b{i}"] = rng.normal(1, 0.4, n), rng.normal(0, 0.4, n)
    if proj:
        p["wp"] = rng.normal(0, 0.4, (c, 4 * f))
        p["gp"], p["bp"] = rng.normal(1, 0.4, 4 * f), rng.normal(0, 0.4, 4 * f)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _bf16(a: np.ndarray) -> np.ndarray:
    """numpy f32 values rounded to bf16 (kept as f32)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


def _operands(v, h, w, c, f, proj, seed=0):
    """Every body's operands, as the forward and backward chain makes them
    (the port's plain versions on the CPU): ``{body: args}`` in the port's
    signatures."""
    rng = np.random.default_rng(seed + 100)
    r = v * h * w
    p = {k: torch.from_numpy(a) for k, a in _weights(c, f, proj, seed).items()}
    wb = {k: p[k].to(BF16) for k in ("w1", "w2", "w3", "wp") if k in p}
    x = torch.from_numpy(np.maximum(rng.normal(0, 1, (r, c)), 0).astype(np.float32)).to(BF16)
    dy = torch.from_numpy(rng.normal(0, 1, (r, 4 * f)).astype(np.float32)).to(BF16)
    cnt = float(r)
    c1, s1, q1, *spq = fb.k1_reference(x, wb["w1"], wb.get("wp"))
    f1 = fb.finalize(s1, q1, p["g1"], p["b1"], cnt, 1e-5)
    fp = fb.finalize(*spq, p["gp"], p["bp"], cnt, 1e-5) if proj else None
    c2, s2, q2 = fb.k2_reference(c1, f1.scale, f1.shift, wb["w2"], h, w)
    f2 = fb.finalize(s2, q2, p["g2"], p["b2"], cnt, 1e-5)
    f3 = fb.finalize(*fb.k3_reference(c2, f2.scale, f2.shift, wb["w3"]), p["g3"], p["b3"], cnt,
                     1e-5)
    pa = (wb["wp"], fp.scale, fp.shift) if proj else ()
    y = fb.k4_reference(c2, x, f2.scale, f2.shift, wb["w3"], f3.scale, f3.shift, *pa)
    pb = (x, wb["wp"], fp.mean, fp.inv) if proj else ()
    s3a, s3b, *spb = fb.b1_reference(dy, y, c2, f2.scale, f2.shift, wb["w3"], f3.mean, f3.inv,
                                     *pb)
    b2a = (dy, y, c2, f2.scale, f2.shift, wb["w3"], f3.mean, f3.inv, f3.scale, s3a / cnt,
           s3b / cnt, f2.mean, f2.inv)
    g2, _, s2a, s2b = fb.b2_reference(*b2a)
    b3a = (g2, c1, c2, f1.scale, f1.shift, f2.scale, s2a / cnt, s2b / cnt, f2.mean, f2.inv,
           wb["w2"], f1.mean, f1.inv, h, w)
    g1, _, s1a, s1b = fb.b3_reference(*b3a)
    pc = (wb["wp"], fp.scale, s3a / cnt, spb[0] / cnt, fp.mean, fp.inv) if proj else ()
    return {
        "k1": (x, wb["w1"], wb.get("wp")), "k2": (c1, f1.scale, f1.shift, wb["w2"], h, w),
        "k3": (c2, f2.scale, f2.shift, wb["w3"]),
        "k4": (c2, x, f2.scale, f2.shift, wb["w3"], f3.scale, f3.shift, *pa),
        "b1": (dy, y, c2, f2.scale, f2.shift, wb["w3"], f3.mean, f3.inv, *pb),
        "b2": b2a, "b3": b3a,
        "b4": (g1, c1, x, dy, y, f1.scale, s1a / cnt, s1b / cnt, f1.mean, f1.inv, wb["w1"], *pc),
    }


def _j(t: torch.Tensor, v: int = 0):
    """A port tensor as rxtpu takes it: slabs ``[V, P, C]`` (with ``v``),
    per-channel vectors ``[1, C]``, weights as they are."""
    a = t.float().numpy()
    dtype = jnp.bfloat16 if t.dtype == BF16 else jnp.float32
    if v and t.ndim == 2:
        a = a.reshape(v, -1, a.shape[1])
    elif t.ndim == 1:
        a = a[None]
    return jnp.asarray(a, dtype)


def _folded(*vecs):
    """rxtpu's ``_Folded`` from (mean, inv, scale, shift) vectors; var unused."""
    mean, inv, scale, shift = (_j(t) for t in vecs)
    return rx_fb._Folded(mean, None, inv, scale, shift)


def _rxtpu_body(name, args, v, h, w, c, f, proj):
    """rxtpu's Pallas body ``name`` in interpret mode on the port's operands."""
    cfg = rx_fb.plan_block(h, w, f, c, proj=proj, interpret=True)
    assert cfg.padded == cfg.pixels  # an 8x8 plane is one unpadded slab
    S = lambda t: _j(t, v)  # noqa: E731
    if name == "k1":
        x, w1, wp = args
        return rx_fb._k1(cfg, S(x), _j(w1), None if wp is None else _j(wp))
    if name == "k2":
        c1, sc1, sh1, w2, _, _ = args
        return rx_fb._k2(cfg, S(c1), _j(sc1), _j(sh1), _j(w2))
    if name == "k3":
        c2, sc2, sh2, w3 = args
        return rx_fb._k3(cfg, S(c2), _j(sc2), _j(sh2), _j(w3))
    if name == "k4":
        c2, x, sc2, sh2, w3, sc3, sh3, *pa = args
        pa = [_j(t) for t in pa] if pa else [None] * 3
        return rx_fb._k4(cfg, S(c2), S(x), _j(sc2), _j(sh2), _j(w3), _j(sc3), _j(sh3), *pa)
    if name == "b1":
        dy, y, c2, sc2, sh2, w3, m3, i3, *pb = args
        f2 = _folded(m3, i3, sc2, sh2)  # only scale/shift are read
        f3 = _folded(m3, i3, sc2, sh2)  # only mean/inv are read
        x, wp, fp = (S(pb[0]), _j(pb[1]), _folded(pb[2], pb[3], pb[2], pb[3])) if pb else (
            None, None, None)
        return rx_fb._b1(cfg, S(dy), S(y), S(c2), f2, _j(w3), f3, x, wp, fp)
    if name == "b2":
        dy, y, c2, sc2, sh2, w3, m3, i3, k3, d3a, d3b, m2, i2 = args
        f2 = _folded(m2, i2, sc2, sh2)
        f3 = _folded(m3, i3, k3, k3)
        return rx_fb._b2(cfg, S(dy), S(y), S(c2), f2, _j(w3), _j(w3.t().contiguous()), f3,
                         _j(d3a), _j(d3b))
    if name == "b3":
        g2, c1, c2, sc1, sh1, k2, d2a, d2b, m2, i2, w2, m1, i1, _, _ = args
        f1 = _folded(m1, i1, sc1, sh1)
        f2 = _folded(m2, i2, k2, k2)
        return rx_fb._b3(cfg, S(g2), S(c1), S(c2), f1, f2, _j(d2a), _j(d2b),
                         _j(w2.transpose(1, 2).contiguous()))
    g1, c1, x, dy, y, k1, d1a, d1b, m1, i1, w1, *pc = args
    f1 = _folded(m1, i1, k1, k1)
    if pc:
        wp, kp, dpa, dpb, mp, ip = pc
        proj_args = (_j(wp), _j(wp.t().contiguous()), _folded(mp, ip, kp, kp), _j(dpa), _j(dpb))
    else:
        proj_args = (None,) * 5
    return rx_fb._b4(cfg, S(g1), S(c1), S(x), S(dy), S(y), f1, _j(d1a), _j(d1b),
                     _j(w1.t().contiguous()), *proj_args)


def _gap(got: np.ndarray, want: np.ndarray):
    """(max |got - want| / max|want|, share of elements that differ)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    top = float(np.abs(want).max())
    assert top > 0  # a degenerate all-zero output would pass trivially
    return float(np.abs(got - want).max()) / top, float((got != want).mean())


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def test_layout_helpers_round_trip_in_rxtpu_tap_order():
    rng = np.random.default_rng(0)
    w3x3 = torch.from_numpy(rng.normal(size=(5, 4, 3, 3)).astype(np.float32))  # [O, I, 3, 3]
    taps = fb.conv3x3_to_taps(w3x3)
    assert taps.shape == (9, 4, 5)
    for k, (dy, dx) in enumerate(fb.OFFSETS):  # rxtpu's _OFFSETS: (ky, kx) row-major
        assert (dy, dx) == rx_fb._OFFSETS[k]
        assert torch.equal(taps[k], w3x3[:, :, dy + 1, dx + 1].t())
    assert torch.equal(fb.taps_to_conv3x3(taps), w3x3)
    w1x1 = torch.from_numpy(rng.normal(size=(6, 4, 1, 1)).astype(np.float32))
    assert torch.equal(fb.conv1x1_to_mat(w1x1), w1x1[:, :, 0, 0].t())
    assert torch.equal(fb.mat_to_conv1x1(fb.conv1x1_to_mat(w1x1)), w1x1)
    # rxtpu's HWIO kernels, carried across by from_flax: the same matrices
    hwio = rng.normal(size=(3, 3, 4, 5)).astype(np.float32)
    port = from_flax({"Conv_1": {"kernel": hwio}})["Conv_1.weight"]
    np.testing.assert_array_equal(fb.conv3x3_to_taps(port).numpy(), hwio.reshape(9, 4, 5))
    hwio = rng.normal(size=(1, 1, 4, 6)).astype(np.float32)
    port = from_flax({"Conv_0": {"kernel": hwio}})["Conv_0.weight"]
    np.testing.assert_array_equal(fb.conv1x1_to_mat(port).numpy(), hwio.reshape(4, 6))


# ---------------------------------------------------------------------------
# the eight bodies and the whole block against rxtpu
# ---------------------------------------------------------------------------

# bf16 outputs: max |port - rxtpu| / max|rxtpu| and the share of differing
# elements; f32 sums and weight gradients: max |port - rxtpu| / max|rxtpu|.
# Readings: the bf16 outputs bit-equal but for one element of k4's y (6.9e-4,
# share 2.4e-4); the f32 ones within 3.1e-7.
BODY_BF16_MAX, BODY_BF16_SHARE, BODY_F32 = 2.0**-6, 2e-3, 1e-4


@pytest.mark.parametrize("proj", [False, True], ids=["identity", "proj"])
@pytest.mark.parametrize("name", BODIES)
def test_body_matches_rxtpu_interpret(name, proj):
    """The port's plain body on the operands the chain makes, against
    rxtpu's Pallas body in interpret mode on the same operands."""
    v, h, w, f = 2, 8, 8, 8
    c = 16 if proj else 4 * f
    args = _operands(v, h, w, c, f, proj)[name]
    got = getattr(fb, f"{name}_reference")(*args)
    want = _rxtpu_body(name, args, v, h, w, c, f, proj)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b.astype(jnp.float32)).reshape(a.shape)
        rel, share = _gap(a.float().numpy(), b)
        if a.dtype == BF16:
            assert rel <= BODY_BF16_MAX and share <= BODY_BF16_SHARE, (name, i, rel, share)
        else:
            assert rel <= BODY_F32, (name, i, rel)


# the whole block, forward and backward: y as above; batch statistics
# max |port - rxtpu| / max|rxtpu|; dx and each parameter gradient relative
# L2. Readings: with the projection and on the 15x15 plane, y within 1.9e-3,
# statistics 2e-7, gradients equal; the identity block, where an a1 rounds
# the other way and bn2's statistics move (3.1e-4), y 4.8e-3, statistics
# 3.6e-4, dx and gradients up to 3.5e-2 (b1's).
BLOCK_Y, BLOCK_STATS, BLOCK_GRAD = 2.0**-6, 2e-3, 0.08


def _both_blocks(v, h, w, c, f, proj, slab_target=rx_fb.DEFAULT_SLAB_TARGET, seed=0):
    """(port, rxtpu) results of one forward and backward: (y, stats, dx,
    grads) as numpy, rxtpu's pad rows stripped."""
    rng = np.random.default_rng(seed + 7)
    params = _weights(c, f, proj, seed)
    x = _bf16(rng.normal(0, 1, (v, h * w, c)))
    wout = rng.normal(0, 1, (v, h * w, 4 * f)).astype(np.float32)

    tp = {k: torch.from_numpy(a).requires_grad_() for k, a in params.items()}
    tx = torch.from_numpy(x).to(BF16).requires_grad_()
    y, stats = fb.bottleneck_fused(tx, tp, h, w)
    (y.float() * torch.from_numpy(wout)).sum().backward()
    port = (y.float().detach().numpy(), {k: [s.numpy() for s in st] for k, st in stats.items()},
            tx.grad.float().numpy(), {k: t.grad.numpy() for k, t in tp.items()})

    cfg = rx_fb.plan_block(h, w, f, c, proj=proj, interpret=True, slab_target=slab_target)
    xp = rx_fb.pad_pixels(jnp.asarray(x, jnp.bfloat16), cfg)
    wp_ = rx_fb.pad_pixels(jnp.asarray(wout), cfg)
    jp = {k: jnp.asarray(a) for k, a in params.items()}

    def loss(prm, xx):
        yy, st = rx_fb.bottleneck_fused(cfg, xx, prm)
        return jnp.sum(yy.astype(jnp.float32) * wp_), (yy, st)

    (_, (ry, rstats)), (rg, rgx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(jp, xp)
    p = h * w
    ref = (np.asarray(ry.astype(jnp.float32))[:, :p], {k: [np.asarray(s) for s in st]
                                                       for k, st in rstats.items()},
           np.asarray(rgx.astype(jnp.float32))[:, :p], {k: np.asarray(g) for k, g in rg.items()})
    return port, ref, cfg


def _assert_blocks_close(port, ref):
    (y, stats, dx, grads), (ry, rstats, rdx, rgrads) = port, ref
    rel, _ = _gap(y, ry)
    assert rel <= BLOCK_Y, ("y", rel)
    assert sorted(stats) == sorted(rstats)
    for k in stats:
        for s, rs in zip(stats[k], rstats[k]):
            assert _gap(s, rs)[0] <= BLOCK_STATS, (k, _gap(s, rs))
    assert _rel_l2(dx, rdx) <= BLOCK_GRAD, ("dx", _rel_l2(dx, rdx))
    assert sorted(grads) == sorted(rgrads)
    for k in grads:
        assert grads[k].dtype == np.float32
        assert _rel_l2(grads[k], rgrads[k]) <= BLOCK_GRAD, (k, _rel_l2(grads[k], rgrads[k]))


@pytest.mark.parametrize("proj", [False, True], ids=["identity", "proj"])
def test_block_forward_backward_matches_rxtpu(proj):
    f = 8
    port, ref, _ = _both_blocks(2, 8, 8, 16 if proj else 4 * f, f, proj)
    _assert_blocks_close(port, ref)


def test_unpadded_block_matches_slab_padded_rxtpu():
    """A 15x15 plane that rxtpu splits into 4 slabs of 64 (225 pixels padded
    to 256, as ``tests/test_fused_block.py::test_multislab_padded_plane_parity``):
    the port, with no pad rows, equals rxtpu with its pad rows stripped."""
    port, ref, cfg = _both_blocks(2, 15, 15, 16, 8, True, slab_target=64)
    assert cfg.nslab == 4 and cfg.padded > cfg.pixels
    _assert_blocks_close(port, ref)


def test_wrappers_raise_off_cpu_and_cuda():
    """No fallback: a tensor on another device than the CPU or a card raises
    (a CUDA tensor launches the kernel or raises; ``gpu`` test below)."""
    x = torch.empty((64, 64), dtype=BF16, device="meta")
    w = torch.empty((64, 64), dtype=BF16, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        fb.k1(x, w)
    with pytest.raises(ValueError, match="bfloat16"):
        fb.k1(torch.zeros(4, 8), torch.zeros(8, 8, dtype=BF16))


# ---------------------------------------------------------------------------
# fused_bottleneck on a port block, and the ResNet flag
# ---------------------------------------------------------------------------


def _random_block(c, f, seed=0):
    """A port BottleneckBlock with rxtpu's randomized parameters (bn3's scale
    not zero) and running statistics away from their init."""
    torch.manual_seed(seed)
    block = BottleneckBlock(c, f).train()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.4, p.shape)))
        for mod in block.modules():
            if hasattr(mod, "running_mean"):
                mod.weight.copy_(torch.from_numpy(rng.normal(1, 0.4, mod.weight.shape)))
                mod.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, mod.weight.shape)))
                mod.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, mod.weight.shape)))
    return block


@pytest.mark.parametrize("proj", [False, True], ids=["identity", "proj"])
def test_fused_bottleneck_matches_unfused_block(proj):
    """rxtpu's fused-vs-standard check on the port: one train-mode forward
    and backward of a block, fused and unfused (under bf16 autocast), from
    the same parameters. The unfused BN subtracts first and the fused one
    applies the folded ``x*scale + shift``, so values differ by bf16
    roundings: rxtpu's limits (y atol 0.1, running statistics atol 5e-3).
    The state dicts have the same keys; bn1's running variance is exactly
    rxtpu's update with Bessel's correction. (The gradients are held against
    rxtpu's fused block above: the unfused block's, from bf16 autocast, are
    bf16 numbers.)"""
    v, h, w, f = 2, 8, 8, 8
    c, n = 16 if proj else 4 * f, v * h * w
    fused, unfused = _random_block(c, f), _random_block(c, f)
    assert list(fused.state_dict()) == list(unfused.state_dict())
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 1, (v, h, w, c)).astype(np.float32)).to(BF16)
    wout = torch.from_numpy(rng.normal(0, 1, (v, h, w, 4 * f)).astype(np.float32))

    xf = x.reshape(v, h * w, c).clone().requires_grad_()
    yf = fused_bottleneck(fused, xf, h, w)
    (yf.float() * wout.reshape(v, h * w, -1)).sum().backward()
    xu = x.permute(0, 3, 1, 2).clone().requires_grad_()
    with torch.autocast("cpu", dtype=BF16):
        yu = unfused(xu)
    (yu.float() * wout.permute(0, 3, 1, 2)).sum().backward()

    assert yf.dtype == BF16 and xf.grad.dtype == BF16
    np.testing.assert_allclose(yf.float().reshape(v, h, w, -1).detach().numpy(),
                               yu.float().permute(0, 2, 3, 1).detach().numpy(), atol=0.1, rtol=0)
    sf, su = fused.state_dict(), unfused.state_dict()
    for k in sf:
        if "running" in k:
            np.testing.assert_allclose(sf[k].numpy(), su[k].numpy(), atol=5e-3, rtol=0,
                                       err_msg=k)
    # the Bessel correction: bn1 stores c1's batch variance unbiased over n = V*H*W
    w1 = fb.conv1x1_to_mat(fused.Conv_0.weight).detach().to(BF16)
    _, s1, q1 = fb.k1_reference(x.reshape(n, c), w1)
    var = fb.finalize(s1, q1, 1.0, 0.0, float(n), 1e-5).var
    want = 0.9 * _random_block(c, f).BatchNorm_0.running_var + 0.1 * (var * (n / (n - 1)))
    torch.testing.assert_close(fused.BatchNorm_0.running_var, want, rtol=0, atol=0)
    for name, p in fused.named_parameters():  # f32 gradients on the f32 parameters
        assert p.grad is not None and p.grad.dtype == torch.float32, name


def test_resnet_fuse_blocks_matches_rxtpu_and_eval_ignores_flag():
    """Train mode: the port's fused net against rxtpu's (stage 1's two
    blocks fused, the first with the projection, f32 around them): output,
    running statistics and every parameter's gradient of a fixed linear
    loss. Readings: the output bit-equal, the gradients within 2.1e-6
    relative L2, the statistics within 1e-6. Eval: the flag changes nothing,
    bit for bit (rxtpu's ``test_resnet_fuse_flag_matches_standard``)."""
    from test_fused_block import _randomized

    rx = RxResNet(stage_sizes=[2], block_cls=RxBottleneckBlock, num_filters=8,
                  fuse_blocks=True, dtype=jnp.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 16, 16, 6), jnp.float32))
    variables = _randomized(rx.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False))
    port = ResNet([2], BottleneckBlock, num_filters=8, fuse_blocks=True)
    port.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    wout = np.random.default_rng(0).normal(size=(2, 32)).astype(np.float32)

    def loss(params):
        y, mutated = rx.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(y * wout), (y, mutated)

    (_, (want, mutated)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    calls = fb.k1.launches
    got = port.train()(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    (got * torch.from_numpy(wout)).sum().backward()
    assert fb.k1.launches == calls  # the CPU runs the plain versions
    rel, _ = _gap(got.detach().numpy(), np.asarray(want))
    assert rel <= 1e-5, rel
    new = from_flax(variables["params"], mutated["batch_stats"])
    for k, t in port.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(t.numpy(), new[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
    ref = from_flax(grads)
    for name, p in port.named_parameters():
        assert _rel_l2(p.grad.numpy(), ref[name].numpy()) <= 2e-5, name
    unfused = ResNet([2], BottleneckBlock, num_filters=8)
    unfused.load_state_dict(port.state_dict())
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    assert torch.equal(port.eval()(xt), unfused.eval()(xt))
    assert list(port.state_dict()) == list(unfused.state_dict())


def test_resnet50_fuses_its_13_stride1_blocks_in_train_mode_only(monkeypatch):
    """``TwoSitesNN("resnet50", fuse_blocks=True)`` runs stage 1's three
    blocks (the first with the projection) and every later stage's blocks
    but the strided first one through ``fused_bottleneck``: 13 per train
    forward, each at its stage's plane; none in eval or with the flag off."""
    import rxtpu_torch.models.resnet as port_resnet

    calls = []

    def counting(block, x, height, width):
        calls.append((block.Conv_0.in_channels, block.conv_proj is not None, height, width))
        return fused_bottleneck(block, x, height, width)

    monkeypatch.setattr(port_resnet, "fused_bottleneck", counting)
    net = TwoSitesNN("resnet50", nb_classes=8, size_features=16, dropout=0.0, fuse_blocks=True)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 3, 6, 64, 64)).astype(
        np.float32))
    assert net.train()(x).shape == (1, 8)
    assert calls == ([(64, True, 16, 16), (256, False, 16, 16), (256, False, 16, 16)]
                     + [(512, False, 8, 8)] * 3 + [(1024, False, 4, 4)] * 5
                     + [(2048, False, 2, 2)] * 2)
    calls.clear()
    net.eval()(x)
    TwoSitesNN("resnet50", nb_classes=8, size_features=16, dropout=0.0).train()(x)
    assert calls == []


# ---------------------------------------------------------------------------
# the slice: a ResNet-50 train step in lockstep, and the CLI
# ---------------------------------------------------------------------------


def test_resnet50_fused_train_step_in_lockstep_with_rxtpu():
    """One f32 train step of ``TwoSitesNN("resnet50", fuse_blocks=True)`` at
    64^2 (B=4, G=3: 12 views) from rxtpu's initial weights on both sides and
    the same views (augment "none"; the shear augment is held in lockstep in
    ``test_torch_port_trainloop.py``); the 13 fused blocks run in bf16 on
    both sides. Compared: the loss, the running statistics and the parameter
    updates.

    The bf16 chain's roundings differ now and then between the two sides
    (see the module docstring), and through 13 blocks, ReLU masks and
    train-mode BNs over 2x2 planes these move the gradients of this tiny
    batch far more than the loss: rxtpu's own fused step differs from its
    unfused one by 27% relative L2 in the updates at this size, the port's
    fused step from rxtpu's by 24.7%. So the updates are held at 0.5 (a
    wrong or missing gradient moves them by 100% or more), and the exact
    wiring of the gradients by ``test_resnet_fuse_blocks_matches_rxtpu_...``
    and the block tests. Readings: loss 1.0e-5 relative, running statistics
    1.9e-3 at most. At 32^2 or B=2 the head's BN over 2 samples makes even
    the loss chaotic. """
    b = 4
    cfg = Config(model=ModelConfig(backbone="resnet50", nb_classes=8, size_features=16,
                                   dropout=0.0, compute_dtype="float32", fuse_blocks=True),
                 train=TrainConfig(bs_per_device=b, lr=0.05, nb_epochs=1), experiment_id="fb")
    flax_model = rx_build_model(cfg)
    state, lr = rx_create_train_state(cfg, flax_model, steps_per_epoch=1)
    rng = np.random.default_rng(0)
    views = rng.normal(size=(b, 3, 6, 64, 64)).astype(np.float32)
    labels = rng.integers(0, 8, b).astype(np.int32)
    rx_step = rx_make_train_step(flax_model, 64, donate=False, augment="none")
    state1, m = rx_step(state, {"images": jnp.asarray(np.transpose(views, (0, 1, 3, 4, 2))),
                                "labels": jnp.asarray(labels), "mean": jnp.zeros((b, 6)),
                                "std": jnp.ones((b, 6))}, jax.random.PRNGKey(0), jnp.asarray(True))

    port = TwoSitesNN("resnet50", nb_classes=8, size_features=16, dropout=0.0, fuse_blocks=True)
    params0 = from_flax(jax.device_get(state.params), jax.device_get(state.batch_stats))
    port.load_state_dict(params0)
    pstate = TrainState.create(port, make_schedule(lr, 1, 1), weight_decay=cfg.train.weight_decay)
    step = make_train_step(port, 64, augment="none", compute_dtype=torch.float32)
    before = {name: fn.launches for name, fn in zip(BODIES, fb.BODIES)}
    pm = step(pstate, {"images": torch.from_numpy(views), "labels": torch.from_numpy(labels),
                       "mean": torch.zeros(b, 6), "std": torch.ones(b, 6)}, 0, True)
    assert {name: fn.launches for name, fn in zip(BODIES, fb.BODIES)} == before  # CPU: plain

    np.testing.assert_allclose(float(pm["loss"]), float(m["loss"]), rtol=LOCKSTEP_LOSS)
    ref = from_flax(jax.device_get(state1.params), jax.device_get(state1.batch_stats))
    got = port.state_dict()
    num = den = 0.0
    for k in ref:
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0,
                                       atol=LOCKSTEP_STATS, err_msg=k)
            continue
        u, u_ref = got[k].numpy() - params0[k].numpy(), ref[k].numpy() - params0[k].numpy()
        num += float(np.linalg.norm(u - u_ref)) ** 2
        den += float(np.linalg.norm(u_ref)) ** 2
    assert den > 0 and (num / den) ** 0.5 < LOCKSTEP_UPDATES, (num / den) ** 0.5


LOCKSTEP_LOSS, LOCKSTEP_STATS, LOCKSTEP_UPDATES = 1e-4, 1e-2, 0.5


def test_port_cli_trains_with_fuse_blocks(tmp_path, monkeypatch):
    """``--backbone resnet50 --fuse-blocks on --device cpu`` on the numpy
    fixture: it trains (the fused bodies' plain versions, one epoch), writes
    a checkpoint that the unfused model loads, and a submission."""
    from rxtpu_torch.data.synthetic import make_train_fixture

    fx = make_train_fixture(str(tmp_path / "fx"), nb_classes=8, n_experiments=3,
                            wells_per_experiment=4, n_test_wells=3, img_size=48)
    monkeypatch.chdir(tmp_path)
    argv = ["--experiment_id", "fb", "--nb-classes", "8", "--backbone", "resnet50",
            "--crop-size", "32", "--epochs", "1", "--batch-size", "2", "--split-by-experiment",
            "--no-plate-leak", "--fuse-blocks", "on", "--device", "cpu", "--pack",
            fx["pack_dir"], "--data-dir", fx["data_dir"], "--stats", fx["stats"]]
    assert port_cli.main(argv) == 0
    unfused = TwoSitesNN("resnet50", nb_classes=8)
    unfused.load_state_dict(load_checkpoint("models/last_fb.ckpt"))
    sub = pd.read_csv("submission_fb.csv")
    assert list(sub.id_code) == [r["id_code"] for r in fx["test_rows"]]
    assert sub.sirna.between(0, 7).all()
    assert os.path.exists("models/best_model_fb.ckpt")


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pipe_sums_loop(v, bm):
    """The pipelined mainloop's sums epilogue and ``reduce_kernel``, one f32
    add at a time: per BM-row tile and warp row each lane g sums its rows
    (``mt*16 + g + 8*h``, those inside the slab), the lanes meet by shuffles
    across ``xor 4, 8, 16`` (lane bits 1, 2, 4 of g), warp row 0 plus warp
    row 1; then, above 64 tiles, groups of 64 first, and in a group lane y
    sums partials y, y + 8, ... before the eight lanes are added in order."""
    f32 = np.float32
    rows, n = v.shape
    tiles = -(-rows // bm)
    part = np.zeros((tiles, n), f32)
    for t in range(tiles):
        for c in range(n):
            halves = []
            for wm in range(2):
                lanes = []
                for g in range(8):
                    s = f32(0)
                    for mt in range(bm // 32):
                        for h in range(2):
                            r = t * bm + wm * (bm // 2) + mt * 16 + g + 8 * h
                            if r < rows:
                                s = f32(s + v[r, c])
                    lanes.append(s)
                for m in (1, 2, 4):
                    lanes = [f32(lanes[g] + lanes[g ^ m]) for g in range(8)]
                halves.append(lanes[0])
            part[t, c] = f32(halves[0] + halves[1])

    def reduce(p):
        out = np.zeros(n, f32)
        for i in range(n):
            lanes = []
            for y in range(8):
                s = f32(0)
                for k in range(y, p.shape[0], 8):
                    s = f32(s + p[k, i])
                lanes.append(s)
            total = f32(0)
            for s in lanes:
                total = f32(total + s)
            out[i] = total
        return out

    if tiles > 64:
        part = np.stack([reduce(part[g:g + 64]) for g in range(0, tiles, 64)])
    return reduce(part)


@pytest.mark.parametrize("rows,n,bm", [(200, 64, 64), (4500, 8, 64), (200, 16, 128)])
def test_chip_smoke_pipe_sums_order(rows, n, bm):
    """``chip_smoke.fb_pipe_sums``, which phase 2's ties on the card use to
    hold K6.3's and K6.1's sums bit for bit to K6.4's c3 and cp, against a
    direct loop over the same order on a ragged slab (a partial last tile;
    4500 rows make 71 tiles, so the grouped first pass runs), and equal to
    ``torch.sum`` on integer values, where every order is exact."""
    cs = _chip_smoke()
    rng = np.random.default_rng(rows + n + bm)
    v = (rng.standard_normal((rows, n)) * rng.uniform(0.1, 10.0, n)).astype(np.float32)
    got = cs.fb_pipe_sums(torch.from_numpy(v), bm).numpy()
    np.testing.assert_array_equal(got.view(np.int32), _pipe_sums_loop(v, bm).view(np.int32))
    ints = torch.from_numpy(rng.integers(-100, 101, (rows, n)).astype(np.float32))
    assert torch.equal(cs.fb_pipe_sums(ints, bm), ints.sum(0))


@pytest.mark.gpu
def test_fused_block_kernels_match_plain_on_card():
    """Each body's CUDA kernels against its plain version on the card, at
    small planes with edge tiles, row counts that are not a multiple of the
    128-row tile (3 views of 5x7, less than one tile, with the projection,
    C=128, and without it, C=256; 3 views of 9x11 without it), and whole
    tiles at F=128 (2 views of 8x8, C=512: K6.2's 128-wide column tiles):
    bf16 outputs within two bf16 ulps of max|plain|, f32 sums and weight
    gradients within 3e-3 of max|plain| (only the order of f32 sums
    differs), one launch counted per body, and each body's outputs equal
    over two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused_block kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    for v, h, w, c, f, proj in ((3, 5, 7, 128, 64, True), (3, 5, 7, 256, 64, False),
                                (3, 9, 11, 256, 64, False), (2, 8, 8, 512, 128, False)):
        ops = _operands(v, h, w, c, f, proj, seed=3)
        for name, kernel in zip(BODIES, fb.BODIES):
            args = [a.cuda() if isinstance(a, torch.Tensor) else a for a in ops[name]]
            before = kernel.launches
            got = kernel(*args)
            want = getattr(fb, f"{name}_reference")(*args)
            torch.cuda.synchronize()
            assert kernel.launches == before + 1
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                top = float(b.float().abs().max())
                gap = float((a.float() - b.float()).abs().max())
                if a.dtype == BF16:
                    assert gap <= 2 * 2.0 ** (np.floor(np.log2(top)) - 7), (name, h, w, gap, top)
                else:
                    assert gap <= 3e-3 * top, (name, h, w, gap, top)
            again = kernel(*args)
            again = again if isinstance(again, tuple) else (again,)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), (name, h, w)
