"""Exact-warp augmentation and the augmentation draws (counterpart of
``rxtpu/ops/warp.py``).

Flip -> rotate -> crop compose into one inverse affine map per view; each
output pixel is a bilinear sample of the uint8 source with reflect-101
borders, then ``(x/255 - mean)/std``. Written as plain torch indexing that
follows rxtpu's ``_warp_one`` step by step (``F.grid_sample`` rounds its
coordinates differently). Outputs are NCHW views ``[B, G, C, crop, crop]``;
rxtpu's are NHWC.

The draws come from a ``torch.Generator``: they cannot match
``jax.random``'s, so the apply half (``apply_affine_warp``) takes them as
arguments, and the tests feed it the parameters rxtpu drew.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from rxtpu_torch.ops.crop_norm import normalize_params


def reflect101(idx: torch.Tensor, size: int) -> torch.Tensor:
    """OpenCV BORDER_REFLECT_101 index fold (...2 1 | 0 1 2 ... n-1 | n-2...),
    period 2(size-1), for any integer index."""
    period = 2 * (size - 1)
    idx = idx.abs() % period
    return torch.where(idx >= size, period - idx, idx)


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; a CPU -> card copy goes from pinned memory without
    blocking the host (the per-step draws are made on the CPU)."""
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def sample_affine_params(generator: Optional[torch.Generator], n: int, src_size: int,
                         crop_size: int, train: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-view parameters (angle [n] f32 rad, vflip [n], hflip [n], crop_yx
    [n, 2] int32), on the generator's device.

    Train: angle uniform in [-pi, pi), Bernoulli(0.5) flips, integer crop
    offsets uniform in [0, src - crop]. Eval: identity and the center crop.
    """
    dev = generator.device if generator is not None else torch.device("cpu")
    if not train:
        c = (src_size - crop_size) // 2
        return (torch.zeros(n, device=dev), torch.zeros(n, dtype=torch.bool, device=dev),
                torch.zeros(n, dtype=torch.bool, device=dev),
                torch.full((n, 2), c, dtype=torch.int32, device=dev))
    u = torch.rand(n, generator=generator, device=dev)
    angle = u * (2 * math.pi) - math.pi
    vflip = torch.rand(n, generator=generator, device=dev) < 0.5
    hflip = torch.rand(n, generator=generator, device=dev) < 0.5
    crop = torch.randint(0, src_size - crop_size + 1, (n, 2), generator=generator,
                         device=dev, dtype=torch.int32)
    return angle, vflip, hflip, crop


def apply_affine_warp(images: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                      angle: torch.Tensor, vflip: torch.Tensor, hflip: torch.Tensor,
                      crop: torch.Tensor, crop_size: int = 364,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The apply half of rxtpu's ``augment_batch`` (``warp.py:70-160``).

    images uint8 [B, G, C, H, W]; mean/std f32 [B, C]; per-view parameters
    as ``sample_affine_params`` returns them -> NCHW out_dtype views.
    """
    b, g, c, h, w = images.shape
    if h != w:
        raise ValueError(f"augment paths assume square sources, got {h}x{w}")
    n = b * g
    dev = images.device
    angle, vflip, hflip, crop = (to_device(t, dev) for t in (angle, vflip, hflip, crop))
    view = lambda t: t.reshape(n, 1, 1)  # noqa: E731  per view, broadcast over pixels
    yy = torch.arange(crop_size, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(crop_size, dtype=torch.float32, device=dev)[None, :]
    # uncrop into rotated-image coordinates
    y = yy + view(crop[:, 0].to(torch.float32))
    x = xx + view(crop[:, 1].to(torch.float32))
    # rotate about the center (inverse = rotate by -angle)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos, sin = view(torch.cos(angle)), view(torch.sin(angle))
    yc, xc = y - cy, x - cx
    ys = cos * yc - sin * xc + cy
    xs = sin * yc + cos * xc + cx
    # unflip (flips are involutions)
    ys = torch.where(view(vflip), (h - 1) - ys, ys)
    xs = torch.where(view(hflip), (w - 1) - xs, xs)

    # bilinear sample with reflect-101 borders
    y0 = torch.floor(ys).to(torch.int32)
    x0 = torch.floor(xs).to(torch.int32)
    wy = (ys - y0.to(torch.float32))[:, None]
    wx = (xs - x0.to(torch.float32))[:, None]
    y0r, y1r = reflect101(y0, h), reflect101(y0 + 1, h)
    x0r, x1r = reflect101(x0, w), reflect101(x0 + 1, w)

    f = images.reshape(n, c, h * w).to(torch.float32)

    def gather(yi, xi):  # [n, crop, crop] indices -> [n, C, crop, crop]
        idx = (yi.long() * w + xi.long()).reshape(n, 1, -1).expand(n, c, -1)
        return torch.gather(f, 2, idx).reshape(n, c, crop_size, crop_size)

    v00, v01 = gather(y0r, x0r), gather(y0r, x1r)
    v10, v11 = gather(y1r, x0r), gather(y1r, x1r)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    out = top * (1 - wy) + bot * wy            # [n, C, crop, crop]
    scale, bias = (t.reshape(n, c, 1, 1) for t in normalize_params(mean, std, g))
    out = out * scale + bias
    return out.to(out_dtype).reshape(b, g, c, crop_size, crop_size)


def augment_batch(images: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                  generator: Optional[torch.Generator] = None, crop_size: int = 364,
                  train: bool = True, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Draw per-view parameters from ``generator`` (each (b, g) view its
    own), then warp. Returns NCHW views [B, G, C, crop, crop]."""
    b, g, _, h, _ = images.shape
    params = sample_affine_params(generator, b * g, h, crop_size, train)
    return apply_affine_warp(images, mean, std, *params, crop_size=crop_size,
                             out_dtype=out_dtype)


def center_crop_normalize_reference(images: torch.Tensor, mean: torch.Tensor,
                                    std: torch.Tensor, crop_size: int,
                                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain eval path: center crop + normalize, uint8 [B, G, C, H, W] ->
    NCHW views [B, G, C, crop, crop]."""
    h = images.shape[3]
    o = (h - crop_size) // 2
    x = images[:, :, :, o:o + crop_size, o:o + crop_size].to(torch.float32)
    scale = (1.0 / (255.0 * std)).to(torch.float32)[:, None, :, None, None]
    bias = (-mean / std).to(torch.float32)[:, None, :, None, None]
    return (x * scale + bias).to(out_dtype)
