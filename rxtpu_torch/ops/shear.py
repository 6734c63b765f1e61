"""The shear augmentation (counterpart of ``rxtpu/ops/shear.py``).

A rotation by phi in [-pi/4, pi/4] is three one-axis shears (Paeth:
R(phi) = Sx(a) . Sy(b) . Sx(a), a = tan(phi/2), b = -sin(phi)); each is a
per-line fractional shift with reflect-101 borders. The random crop offsets
fold into the shifts of passes 2 and 3 and the per-plane normalize into
pass 3, so uint8 planes go in and normalized, cropped views come out of
three passes:

- K2 ``shear_pass``: per-row shift along W (pass 1; all passes of the v1
  pipeline ``rotate_crop_normalize``);
- K3 ``shear_pass_rows``: per-column shift along H (pass 2);
- K4 ``shear_pass_finish``: per-row shift along W, normalize, and the
  output row / column reversal of the dihedral bits (pass 3).

Each wrapper computes the integer shift ``k`` and the fraction ``f`` once
(as ``rxtpu/ops/shear.py:119-124``), then launches its hand-written CUDA
kernel (``rxtpu_torch/csrc/shear.cu``) on a CUDA tensor, or runs its plain
PyTorch version (``*_reference``, a ``torch.cat`` reflect pad and a
``torch.gather``) on a CPU tensor. Both round every product and sum on its
own, so they agree bit for bit. A clamped line keeps its ``f`` unchanged,
as in rxtpu.

``augment_batch_shear`` splits rxtpu's function in two: the draws
(``rxtpu_torch.ops.warp.sample_affine_params`` on a ``torch.Generator``) and
``apply_affine_shear``, which takes the drawn ``(angle, vflip, hflip,
crop)``. It returns NCHW views ``[B, G, C, crop, crop]``; rxtpu returns NHWC.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from rxtpu_torch.ops.crop_norm import normalize_params
from rxtpu_torch.ops.warp import sample_view_params, to_device

_OUT_KINDS = {torch.bfloat16: 0, torch.float32: 2}
_IN_KINDS = {torch.uint8: 0, torch.float32: 2}


# ---------------------------------------------------------------------------
# shift parameters, pads, dihedral bits
# ---------------------------------------------------------------------------

def _pads(max_shear: float, max_pos_offset: float, w_in: int, w_out: int,
          lane_align: bool = True):
    """(pad_left, pad_right) covering shift in [-max_shear, max_shear + off].

    A copy of ``rxtpu/ops/shear.py:_pads``: pads are multiples of 8 and kept
    < w_in - 1 (the single-mirror invariant of the reflect-101 fold); with
    ``lane_align`` the padded width is rounded up to a multiple of 128 by
    growing pad_right, as the TPU kernels need. The kernels here do not need
    the rounding, but the pads set ``kmax`` and so the clamp, which must
    match rxtpu's.
    """
    up8 = lambda v: int(np.ceil(max(v, 1) / 8.0)) * 8  # noqa: E731
    pad_left = up8(max_shear + 2)
    t_max = max_shear + max_pos_offset
    # need: floor(t_max) + pad_left + w_out + 1 <= w_in + pad_left + pad_right
    pad_right = up8(t_max + w_out + 2 - w_in)
    if lane_align:
        wp = w_in + pad_left + pad_right
        extra = (-wp) % 128
        if pad_right + extra < w_in - 1:  # keep the single-mirror invariant
            pad_right += extra            # (tiny test planes skip alignment)
    assert pad_left < w_in - 1 and pad_right < w_in - 1, (
        pad_left, pad_right, w_in)
    return pad_left, pad_right


def shift_params(shift: torch.Tensor, n_in: int, n_out: int, pad_lo: int,
                 pad_hi: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k, f) of a shift: k = clip(floor(shift) + pad_lo, 0, kmax) as int32,
    f = shift - floor(shift) in f32, with kmax = n_in + pads - n_out - 1."""
    if not (0 <= pad_lo < n_in - 1 and 0 <= pad_hi < n_in - 1):
        raise ValueError(f"pads ({pad_lo}, {pad_hi}) break the single-mirror "
                         f"invariant pad < {n_in - 1}")
    kmax = n_in + pad_lo + pad_hi - n_out - 1
    if kmax < 0:
        raise ValueError(f"padded length {n_in + pad_lo + pad_hi} is too short "
                         f"for {n_out} outputs")
    shift = shift.to(torch.float32)
    kf = torch.floor(shift)
    k = (kf.to(torch.int32) + pad_lo).clamp(0, kmax).contiguous()
    f = (shift - kf).contiguous()
    return k, f


def decompose_angle(angle: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """angle -> (k90 in 0..3, phi in [-pi/4, pi/4]) with angle = k*90 + phi."""
    half_pi = math.pi / 2
    k = torch.round(angle / half_pi)  # half to even, as jnp.round
    phi = angle - k * half_pi
    return k.to(torch.int32) % 4, phi


def dihedral_bits(vflip: torch.Tensor, hflip: torch.Tensor, k90: torch.Tensor):
    """(swap, rev_rows, rev_cols) bits of D = rot90^k . flips.

    Every dihedral element acts as out[i,j] = in[u,v] with (u~,v~) = (j,i)
    if swap else (i,j), u = S-1-u~ if rev_rows, v = S-1-v~ if rev_cols.
    rot90^k gives k=0:(0,0,0) k=1:(1,1,0) k=2:(0,1,1) k=3:(1,0,1); the flips
    XOR into the reversal bits.
    """
    k90 = k90 % 4
    swap = k90 % 2 == 1
    r_rot = (k90 == 1) | (k90 == 2)
    c_rot = (k90 == 2) | (k90 == 3)
    return swap, r_rot ^ vflip, c_rot ^ hflip


def _per_plane(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, *([1] * 2))


def dihedral(planes: torch.Tensor, vflip, hflip, k90) -> torch.Tensor:
    """Flips then rot90^k on [P, H, W] planes (per-plane parameters).

    vflip reverses the rows of the source, hflip its columns, and rot90^1
    is the theta = 90 case of the rotation (out[y, x] = src[H-1-x, y]).
    """
    x = torch.where(_per_plane(vflip), planes.flip(1), planes)
    x = torch.where(_per_plane(hflip), x.flip(2), x)
    k = _per_plane(k90 % 4)
    base = torch.where(k % 2 == 1, x.transpose(1, 2), x)
    # k=1: out = x.T[:, ::-1]; k=2: out = x[::-1, ::-1]; k=3: out = x.T[::-1, :]
    base = torch.where((k == 2) | (k == 3), base.flip(1), base)
    return torch.where((k == 1) | (k == 2), base.flip(2), base)


def apply_dihedral_bits(planes: torch.Tensor, swap, rrev, crev) -> torch.Tensor:
    """Source-form (swap, ri, rj) bits on [P, S, S] planes: the output axes
    are reversed after the transpose, where output-row reversal toggles the
    second source axis when swapped (hence the role swap)."""
    rho = torch.where(swap, crev, rrev)    # output-row reversal
    gamma = torch.where(swap, rrev, crev)  # output-col reversal
    x = torch.where(_per_plane(swap), planes.transpose(1, 2), planes)
    x = torch.where(_per_plane(rho), x.flip(1), x)
    return torch.where(_per_plane(gamma), x.flip(2), x)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _reflect_pad(x: torch.Tensor, lo: int, hi: int, dim: int) -> torch.Tensor:
    """Reflect-101 pad along ``dim`` with a single mirror (pads < n - 1)."""
    n = x.shape[dim]
    left = x.narrow(dim, 1, lo).flip(dim)
    right = x.narrow(dim, n - hi - 1, hi).flip(dim)
    return torch.cat([left, x, right], dim)


def _lerp(x0: torch.Tensor, x1: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return x0 * (1.0 - f) + x1 * f


def shear_pass_reference(x, k, f, w_out, pad_left, pad_right, scale, bias,
                         out_dtype=torch.float32) -> torch.Tensor:
    """Plain K2: [P, H, W] -> out_dtype [P, H, w_out]."""
    xp = _reflect_pad(x.to(torch.float32), pad_left, pad_right, 2)
    idx = k.long()[:, :, None] + torch.arange(w_out, device=x.device)
    y = _lerp(torch.gather(xp, 2, idx), torch.gather(xp, 2, idx + 1), f[:, :, None])
    y = y * scale[:, None, None] + bias[:, None, None]
    return y.to(out_dtype)


def shear_pass_rows_reference(x, k, f, h_out, pad_top, pad_bot,
                              out_dtype=torch.float32) -> torch.Tensor:
    """Plain K3: [P, H, W] -> out_dtype [P, h_out, W]."""
    xp = _reflect_pad(x.to(torch.float32), pad_top, pad_bot, 1)
    idx = k.long()[:, None, :] + torch.arange(h_out, device=x.device)[:, None]
    y = _lerp(torch.gather(xp, 1, idx), torch.gather(xp, 1, idx + 1), f[:, None, :])
    return y.to(out_dtype)


def shear_pass_finish_reference(x, k, f, w_out, pad_left, pad_right, scale, bias,
                                rrev, crev, out_dtype=torch.float32) -> torch.Tensor:
    """Plain K4: plain K2 in f32, then the reversals, then the cast."""
    y = shear_pass_reference(x, k, f, w_out, pad_left, pad_right, scale, bias)
    y = torch.where(_per_plane(rrev), y.flip(1), y)
    y = torch.where(_per_plane(crev), y.flip(2), y)
    return y.to(out_dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _library():
    from rxtpu_torch.ops._build import load_library

    lib = load_library("shear")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in (
            ("rxtpu_shear_pass", [ptr, i32, ptr, ptr, ptr, ptr, ptr] + [i32] * 6 + [ptr]),
            ("rxtpu_shear_pass_rows", [ptr] * 4 + [i32] * 6 + [ptr]),
            ("rxtpu_shear_pass_finish", [ptr] * 8 + [i32] * 6 + [ptr])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_planes(x: torch.Tensor, dtypes, name: str):
    if x.ndim != 3 or x.dtype not in dtypes:
        raise ValueError(f"{name}: x must be [P, H, W] of {sorted(map(str, dtypes))}, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, got {x.device}")


def _check_vec(t: torch.Tensor, shape, dtype, device, name: str) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the planes on {device}")
    return t.contiguous()


def _check_out(out_dtype):
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"out_dtype must be one of {list(_OUT_KINDS)}, got {out_dtype}")


def _launch(fn_name: str, args, device: torch.device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_library(), fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {err}")


def _scale_bias(scale, bias, p, device):
    if scale is None:
        scale = torch.ones(p, dtype=torch.float32, device=device)
    if bias is None:
        bias = torch.zeros(p, dtype=torch.float32, device=device)
    return (_check_vec(scale, (p,), torch.float32, device, "scale"),
            _check_vec(bias, (p,), torch.float32, device, "bias"))


def _pass_args(x, shift, w_out, pad_left, pad_right, scale, bias, out_dtype, dtypes, name):
    _check_planes(x, dtypes, name)
    _check_out(out_dtype)
    p, h, w = x.shape
    shift = _check_vec(shift, (p, h), torch.float32, x.device, "shift")
    scale, bias = _scale_bias(scale, bias, p, x.device)
    k, f = shift_params(shift, w, w_out, pad_left, pad_right)
    return k, f, scale, bias


def _flags(rrev, crev, p, device):
    return (_check_vec(rrev, (p,), torch.bool, device, "rrev"),
            _check_vec(crev, (p,), torch.bool, device, "crev"))


def shear_pass(x: torch.Tensor, shift: torch.Tensor, w_out: int, pad_left: int,
               pad_right: int, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K2: fractional per-row shift with reflect-101 borders.

    x uint8 or f32 [P, H, W]; shift f32 [P, H] (out[p, r, j] samples
    x[p, r, j + shift]); optional per-plane ``*scale + bias`` -> out_dtype
    [P, H, w_out]. ``shear_pass.launches`` counts kernel launches.
    """
    k, f, scale, bias = _pass_args(x, shift, w_out, pad_left, pad_right, scale, bias,
                                   out_dtype, _IN_KINDS, "shear_pass")
    if x.device.type == "cpu":
        return shear_pass_reference(x, k, f, w_out, pad_left, pad_right, scale, bias,
                                    out_dtype)
    p, h, w = x.shape
    x = x.contiguous()
    out = torch.empty((p, h, w_out), dtype=out_dtype, device=x.device)
    _launch("rxtpu_shear_pass",
            (x.data_ptr(), _IN_KINDS[x.dtype], k.data_ptr(), f.data_ptr(),
             scale.data_ptr(), bias.data_ptr(), out.data_ptr(), _OUT_KINDS[out_dtype],
             p, h, w, w_out, pad_left), x.device)
    shear_pass.launches += 1
    return out


shear_pass.launches = 0


def shear_pass_rows(x: torch.Tensor, shift: torch.Tensor, h_out: int, pad_top: int,
                    pad_bot: int, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K3: fractional per-column row shift with reflect-101 borders.

    x f32 [P, H, W]; shift f32 [P, W] (out[p, r, c] samples x[p, r + shift, c])
    -> out_dtype [P, h_out, W]. ``shear_pass_rows.launches`` counts launches.
    """
    _check_planes(x, {torch.float32}, "shear_pass_rows")
    _check_out(out_dtype)
    p, h, w = x.shape
    shift = _check_vec(shift, (p, w), torch.float32, x.device, "shift")
    k, f = shift_params(shift, h, h_out, pad_top, pad_bot)
    if x.device.type == "cpu":
        return shear_pass_rows_reference(x, k, f, h_out, pad_top, pad_bot, out_dtype)
    x = x.contiguous()
    out = torch.empty((p, h_out, w), dtype=out_dtype, device=x.device)
    _launch("rxtpu_shear_pass_rows",
            (x.data_ptr(), k.data_ptr(), f.data_ptr(), out.data_ptr(),
             _OUT_KINDS[out_dtype], p, h, w, h_out, pad_top), x.device)
    shear_pass_rows.launches += 1
    return out


shear_pass_rows.launches = 0


def shear_pass_finish(x: torch.Tensor, shift: torch.Tensor, w_out: int, pad_left: int,
                      pad_right: int, scale: torch.Tensor, bias: torch.Tensor,
                      rrev: torch.Tensor, crev: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K4: K2's shift on f32 planes, ``*scale + bias``, then the output rows
    reversed where ``rrev`` and the columns where ``crev`` (bool [P]).
    ``shear_pass_finish.launches`` counts kernel launches."""
    k, f, scale, bias = _pass_args(x, shift, w_out, pad_left, pad_right, scale, bias,
                                   out_dtype, {torch.float32}, "shear_pass_finish")
    p, h, w = x.shape
    rrev, crev = _flags(rrev, crev, p, x.device)
    if x.device.type == "cpu":
        return shear_pass_finish_reference(x, k, f, w_out, pad_left, pad_right, scale,
                                           bias, rrev, crev, out_dtype)
    x = x.contiguous()
    flags = torch.stack([rrev, crev]).to(torch.uint8)
    out = torch.empty((p, h, w_out), dtype=out_dtype, device=x.device)
    _launch("rxtpu_shear_pass_finish",
            (x.data_ptr(), k.data_ptr(), f.data_ptr(), scale.data_ptr(), bias.data_ptr(),
             flags[0].data_ptr(), flags[1].data_ptr(), out.data_ptr(),
             _OUT_KINDS[out_dtype], p, h, w, w_out, pad_left), x.device)
    shear_pass_finish.launches += 1
    return out


shear_pass_finish.launches = 0

KERNEL_PASSES = (shear_pass, shear_pass_rows, shear_pass_finish)


# ---------------------------------------------------------------------------
# the composed passes
# ---------------------------------------------------------------------------

def _shear_geometry(shape, dev, phi, crop_yx, crop_size):
    """Shear factors, crop offsets and per-pass bounds of planes [P, H, W] on
    ``dev``, shared by both pipelines."""
    p, h, w = shape
    a = torch.tan(phi / 2.0)            # x-shear factor (Paeth)
    b = -torch.sin(phi)                 # y-shear factor
    oy = crop_yx[:, 0].to(torch.float32)
    ox = crop_yx[:, 1].to(torch.float32)
    rows = dict(y=torch.arange(h, dtype=torch.float32, device=dev),
                x=torch.arange(w, dtype=torch.float32, device=dev),
                c=torch.arange(crop_size, dtype=torch.float32, device=dev))
    # per-pass shift bounds (|a| <= tan(22.5deg), |b| <= sin(45deg));
    # crop offsets lie in [0, src - crop]
    bounds = (0.41422 * max(h, w) / 2.0, 0.70712 * max(h, w) / 2.0, max(h, w) - crop_size)
    return a, b, oy, ox, rows, bounds


def rotate_crop_normalize(planes, phi, crop_yx, crop_size, scale, bias) -> torch.Tensor:
    """The v1 pipeline: three K2 passes (x, y via transpose, x) with the crop
    offsets folded into passes 2 and 3 and the normalize into pass 3.

    planes uint8 [P, H, W] (dihedral already applied) -> f32 [P, crop, crop].
    """
    p, h, w = planes.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    a, b, oy, ox, rows, (shear_a, shear_b, slack) = _shear_geometry(
        planes.shape, planes.device, phi, crop_yx, crop_size)
    # pass 1: x-shear over all rows y: t1(y) = a * (y - cy)
    t1 = a[:, None] * (rows["y"][None, :] - cy)
    s1 = shear_pass(planes, t1, w, *_pads(shear_a, 0, w, w))
    # pass 2 on transposed planes (rows = x, lanes = y): t2(x) = b*(x - cx) + oy
    t2 = b[:, None] * (rows["x"][None, :] - cx) + oy[:, None]
    s2 = shear_pass(s1.transpose(1, 2).contiguous(), t2, crop_size,
                    *_pads(shear_b, slack, h, crop_size))
    # pass 3 transposed back (rows = y' = y - oy): t3(y') = a*(y' + oy - cy) + ox
    t3 = a[:, None] * (rows["c"][None, :] + oy[:, None] - cy) + ox[:, None]
    return shear_pass(s2.transpose(1, 2).contiguous(), t3, crop_size,
                      *_pads(shear_a, slack, w, crop_size), scale=scale, bias=bias)


def fused_pass_shifts(planes_shape, phi, crop_yx, crop_size):
    """The shifts and pads of the three fused passes for planes of shape
    [P, H, W]: ((t1 [P, H], pads), (t2 [P, W], pads), (t3 [P, crop], pads))."""
    p, h, w = planes_shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    a, b, oy, ox, rows, (shear_a, shear_b, slack) = _shear_geometry(
        planes_shape, phi.device, phi, crop_yx, crop_size)
    # pass 1: x-shear, full height: t1(y) = a * (y - cy)
    t1 = a[:, None] * (rows["y"][None, :] - cy)
    # pass 2: y-shear along rows: t2(x) = b * (x - cx) + oy
    t2 = b[:, None] * (rows["x"][None, :] - cx) + oy[:, None]
    # pass 3: x-shear (+ normalize + reversal bits): t3(y') = a*(y' + oy - cy) + ox
    t3 = a[:, None] * (rows["c"][None, :] + oy[:, None] - cy) + ox[:, None]
    return ((t1, _pads(shear_a, 0, w, w)),
            (t2, _pads(shear_b, slack, h, crop_size, lane_align=False)),
            (t3, _pads(shear_a, slack, w, crop_size)))


def rotate_crop_normalize_fused(planes, phi, crop_yx, crop_size, scale, bias, rrev, crev,
                                out_dtype=torch.float32, passes=KERNEL_PASSES) -> torch.Tensor:
    """K2 -> K3 -> K4: rotation about the center + crop + normalize + the
    reversal bits, with no transpose between passes.

    planes uint8 [P, H, W]; phi f32 [P]; crop_yx int [P, 2]; scale, bias f32
    [P]; rrev, crev bool [P] -> out_dtype [P, crop, crop]. ``passes`` is the
    (K2, K3, K4) triple, called with the wrappers' signatures.
    """
    pass1, pass2, pass3 = passes
    w = planes.shape[2]
    (t1, pads1), (t2, pads2), (t3, pads3) = fused_pass_shifts(planes.shape, phi, crop_yx,
                                                              crop_size)
    s1 = pass1(planes, t1, w, *pads1)
    s2 = pass2(s1, t2, crop_size, *pads2)
    return pass3(s2, t3, crop_size, *pads3, scale, bias, rrev, crev, out_dtype=out_dtype)


def apply_affine_shear(images: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                       angle: torch.Tensor, vflip: torch.Tensor, hflip: torch.Tensor,
                       crop: torch.Tensor, crop_size: int = 364,
                       out_dtype: torch.dtype = torch.bfloat16,
                       passes=KERNEL_PASSES) -> torch.Tensor:
    """The apply half of rxtpu's ``augment_batch_shear`` (``shear.py:550-602``).

    images uint8 [B, G, C, H, W]; mean/std f32 [B, C]; per-view angle [B*G],
    vflip / hflip bool [B*G], crop int [B*G, 2] -> NCHW views out_dtype
    [B, G, C, crop, crop].

    The dihedral part of the angle never runs as a tensor op of its own: via
    R(phi) D = D R(det(D) phi) the shears see a sign-adjusted residual angle
    and a crop window mapped through D^-1; the transpose bit is applied to
    the uint8 input planes, and the two reversal bits ride K4. ``passes`` goes
    to ``rotate_crop_normalize_fused``.
    """
    b, g, c, h, w = images.shape
    if h != w:
        raise ValueError(f"augment paths assume square sources, got {h}x{w}")
    dev = images.device
    angle, vflip, hflip, crop = (to_device(t, dev) for t in (angle, vflip, hflip, crop))
    k90, phi = decompose_angle(angle)
    swap, rrev, crev = dihedral_bits(vflip, hflip, k90)

    # conjugation: R(phi) D = D R(s*phi), s = det(D)
    s = torch.where(swap, -1.0, 1.0) * torch.where(rrev ^ crev, -1.0, 1.0)
    phi_inner = s * phi
    # crop window transformed through D^-1 (axis-aligned again)
    oy, ox = crop[:, 0], crop[:, 1]
    slack = h - crop_size
    o_sel1 = torch.where(swap, ox, oy)
    o_sel2 = torch.where(swap, oy, ox)
    oy_in = torch.where(rrev, slack - o_sel1, o_sel1)
    ox_in = torch.where(crev, slack - o_sel2, o_sel2)
    crop_inner = torch.stack([oy_in, ox_in], dim=-1)

    scale_p, bias_p = normalize_params(mean, std, g)
    rep = lambda v: v.repeat_interleave(c, dim=0)  # noqa: E731  per view -> per plane

    # the swap bit moves to the input side, on the uint8 planes
    # (T(S_{phi,(oy,ox)}(x)) = S_{-phi,(ox,oy)}(T(x)) and T . Rev_{r,c} =
    # Rev_{c,r} . T), so only the reversal bits remain for K4
    planes = images.reshape(b * g * c, h, w)
    planes = torch.where(_per_plane(rep(swap)), planes.transpose(1, 2), planes)
    phi_eff = torch.where(swap, -phi_inner, phi_inner)
    crop_eff = torch.where(swap[:, None], crop_inner.flip(-1), crop_inner)
    rrev_eff = torch.where(swap, crev, rrev)
    crev_eff = torch.where(swap, rrev, crev)
    out = rotate_crop_normalize_fused(
        planes, rep(phi_eff), rep(crop_eff), crop_size, scale_p, bias_p,
        rep(rrev_eff), rep(crev_eff), out_dtype=out_dtype, passes=passes)
    return out.reshape(b, g, c, crop_size, crop_size)


def augment_batch_shear(images: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                        generator: Optional[torch.Generator] = None, crop_size: int = 364,
                        train: bool = True, out_dtype: torch.dtype = torch.bfloat16,
                        rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Draw the per-view parameters from ``generator`` (``rows``: see
    ``rxtpu_torch.ops.warp.sample_view_params``), then apply them through
    K2 -> K3 -> K4. Returns NCHW views [B, G, C, crop, crop]."""
    b, g, _, h, _ = images.shape
    params = sample_view_params(generator, b, g, h, crop_size, train, rows)
    return apply_affine_shear(images, mean, std, *params, crop_size=crop_size,
                              out_dtype=out_dtype)
