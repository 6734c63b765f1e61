"""Plain PyTorch reference of the train augment, in float32.

rxtpu's shear augment (``rxtpu/ops/shear.py``): per view a rotation by a
random angle in [-pi, pi), random flips and a random 364 crop of the 512
source, then ``(x/255 - mean)/std``. The angle splits into quarter turns
and a residual phi in [-pi/4, pi/4]; the quarter turns and flips act as a
dihedral element whose transpose bit is applied to the uint8 planes and
whose two reversal bits flip the output; phi is three one-axis shears
(Paeth: Sx(tan(phi/2)) Sy(-sin(phi)) Sx(tan(phi/2))), each a per-line
fractional shift with linear interpolation and reflect-101 borders, the
crop offsets folded into the second and third. Written out here on its
own, from that description: nothing of the program is imported.

The draws follow the program's documented keying: the step's CPU generator
is seeded by ``step_seed(seed, step, 0)`` and draws the angle's uniform,
the two flips and the integer crop offsets, in that order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

MAX_SHEAR_A = 0.41422  # tan(pi/8), bounds |tan(phi/2)|
MAX_SHEAR_B = 0.70712  # sin(pi/4), bounds |sin(phi)|
PLANE_CHUNK = 96


def step_seed(seed: int, step: int, stream: int) -> int:
    """The 64-bit seed of one (run seed, global step, stream): stream 0 keys
    the augment's draws, stream 1 the dropout's."""
    return int(np.random.SeedSequence([seed, step, stream]).generate_state(1, np.uint64)[0])


def draws(seed: int, step: int, n: int, src: int, crop: int):
    """(angle f32 [n], vflip bool [n], hflip bool [n], crop offsets int32 [n, 2])."""
    gen = torch.Generator().manual_seed(step_seed(seed, step, 0))
    angle = torch.rand(n, generator=gen) * (2 * math.pi) - math.pi
    vflip = torch.rand(n, generator=gen) < 0.5
    hflip = torch.rand(n, generator=gen) < 0.5
    offsets = torch.randint(0, src - crop + 1, (n, 2), generator=gen, dtype=torch.int32)
    return angle, vflip, hflip, offsets


def pads(max_shift: float, max_offset: float, n_in: int, n_out: int,
         lane_align: bool = True) -> Tuple[int, int]:
    """Reflect pads of one shear pass, multiples of 8 covering shifts in
    [-max_shift, max_shift + max_offset], each under ``n_in - 1`` (one
    mirror); with ``lane_align`` the padded length grows to a multiple of
    128 where that keeps the bound. They set the clamp of the shift."""
    up8 = lambda v: int(math.ceil(max(v, 1) / 8.0)) * 8  # noqa: E731
    lo = up8(max_shift + 2)
    hi = up8(max_shift + max_offset + n_out + 2 - n_in)
    if lane_align:
        extra = (-(n_in + lo + hi)) % 128
        if hi + extra < n_in - 1:
            hi += extra
    return lo, hi


def geometry(angle, vflip, hflip, offsets, src: int, crop: int, channels: int, device):
    """Per plane (views x channels): the transpose bit, the three passes'
    shifts with their pads, and the two reversal bits."""
    angle, vflip, hflip, offsets = (t.to(device) for t in (angle, vflip, hflip, offsets))
    half_pi = math.pi / 2
    k90 = torch.round(angle / half_pi)
    phi = angle - k90 * half_pi
    k90 = k90.to(torch.int32) % 4
    swap = k90 % 2 == 1
    rrev = ((k90 == 1) | (k90 == 2)) ^ vflip
    crev = ((k90 == 2) | (k90 == 3)) ^ hflip
    sign = torch.where(swap, -1.0, 1.0) * torch.where(rrev ^ crev, -1.0, 1.0)
    phi = sign * phi
    slack = src - crop
    o1 = torch.where(swap, offsets[:, 1], offsets[:, 0])
    o2 = torch.where(swap, offsets[:, 0], offsets[:, 1])
    oy = torch.where(rrev, slack - o1, o1)
    ox = torch.where(crev, slack - o2, o2)
    # the transpose moves onto the uint8 input
    phi = torch.where(swap, -phi, phi)
    oy, ox = torch.where(swap, ox, oy), torch.where(swap, oy, ox)
    rrev, crev = torch.where(swap, crev, rrev), torch.where(swap, rrev, crev)
    rep = lambda v: v.repeat_interleave(channels, dim=0)  # noqa: E731
    phi, oy, ox, swap, rrev, crev = map(rep, (phi, oy, ox, swap, rrev, crev))
    a, b = torch.tan(phi / 2.0), -torch.sin(phi)
    oy, ox = oy.to(torch.float32), ox.to(torch.float32)
    c = (src - 1) / 2.0
    y = torch.arange(src, dtype=torch.float32, device=device)
    yc = torch.arange(crop, dtype=torch.float32, device=device)
    sa, sb = MAX_SHEAR_A * src / 2.0, MAX_SHEAR_B * src / 2.0
    passes = [
        (a[:, None] * (y[None, :] - c), pads(sa, 0, src, src)),
        (b[:, None] * (y[None, :] - c) + oy[:, None], pads(sb, slack, src, crop, False)),
        (a[:, None] * (yc[None, :] + oy[:, None] - c) + ox[:, None], pads(sa, slack, src, crop)),
    ]
    return swap, passes, rrev, crev


def shift_index(t: torch.Tensor, n_in: int, n_out: int, lo: int, hi: int):
    """(k, f): the first padded sample of each line, clamped to the padded
    length, and the fraction."""
    kf = torch.floor(t)
    k = (kf.to(torch.int64) + lo).clamp(0, n_in + lo + hi - n_out - 1)
    return k, t - kf


def _reflect(x: torch.Tensor, lo: int, hi: int, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 1, lo).flip(dim), x,
                      x.narrow(dim, n - hi - 1, hi).flip(dim)], dim)


def _shift(x: torch.Tensor, t: torch.Tensor, n_out: int, lo: int, hi: int, dim: int):
    """One pass along ``dim`` (2: each row shifts along W by t[p, row]; 1:
    each column along H by t[p, col])."""
    n_in = x.shape[dim]
    k, f = shift_index(t, n_in, n_out, lo, hi)
    xp = _reflect(x, lo, hi, dim)
    j = torch.arange(n_out, device=x.device)
    if dim == 2:
        idx, f = k[:, :, None] + j, f[:, :, None]
    else:
        idx, f = k[:, None, :] + j[:, None], f[:, None, :]
    return torch.gather(xp, dim, idx) * (1.0 - f) + torch.gather(xp, dim, idx + 1) * f


def augment(images: torch.Tensor, mean: torch.Tensor, std: torch.Tensor, params,
            crop: int) -> torch.Tensor:
    """uint8 [B, G, C, H, W], mean/std [B, C], ``draws``'s params -> float32
    views [B, G, C, crop, crop]."""
    b, g, ch, h, w = images.shape
    dev = images.device
    swap, passes, rrev, crev = geometry(*params, h, crop, ch, dev)
    scale = (1.0 / (255.0 * std.float()))[:, None, :].expand(b, g, ch).reshape(-1)
    bias = (-mean.float() / std.float())[:, None, :].expand(b, g, ch).reshape(-1)
    planes = images.reshape(b * g * ch, h, w)
    out = []
    for s in range(0, planes.shape[0], PLANE_CHUNK):
        sl = slice(s, s + PLANE_CHUNK)
        x = planes[sl].to(torch.float32)
        x = torch.where(swap[sl, None, None], x.transpose(1, 2), x)
        (t1, p1), (t2, p2), (t3, p3) = passes
        x = _shift(x, t1[sl], w, *p1, dim=2)
        x = _shift(x, t2[sl], crop, *p2, dim=1)
        x = _shift(x, t3[sl], crop, *p3, dim=2)
        x = x * scale[sl, None, None] + bias[sl, None, None]
        x = torch.where(rrev[sl, None, None], x.flip(1), x)
        out.append(torch.where(crev[sl, None, None], x.flip(2), x))
    return torch.cat(out).reshape(b, g, ch, crop, crop)


def pass_shifts(params, src: int, crop: int, channels: int, device) -> List[Dict]:
    """Each pass's clamped first index per line and its pads, for the
    augment's byte count (``rxbench.work.bounds.shear_bounds``)."""
    _, passes, _, _ = geometry(*params, src, crop, channels, device)
    outs = (src, crop, crop)
    return [{"k": shift_index(t, src, n_out, *p)[0], "pads": p}
            for (t, p), n_out in zip(passes, outs)]
