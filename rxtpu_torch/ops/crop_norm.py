"""K1: fused center-crop + normalize + cast (counterpart of
``rxtpu/ops/pallas_norm.py``).

``crop_normalize`` launches the hand-written CUDA kernel
``rxtpu_torch/csrc/crop_norm.cu`` (which replaces the Pallas kernel
``pallas_norm.py:_crop_norm_kernel``) on a CUDA tensor, and uses the plain
PyTorch version ``crop_normalize_reference`` only for a tensor on the CPU.
Both round the product and the sum separately, so they agree bit for bit.

``eval_batch_normalize`` is the eval/test batch path. Unlike rxtpu, which
returns NHWC views, it returns NCHW views ``[B, G, C, crop, crop]``, the
layout the port's model consumes.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_OUT_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}


def crop_normalize_reference(planes: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, crop_size: int = 364,
                             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch K1: uint8 [N, H, W] -> out_dtype [N, crop, crop]."""
    h = planes.shape[1]
    off = (h - crop_size) // 2
    block = planes[:, off:off + crop_size, off:off + crop_size]
    x = block.to(torch.float32) * scale[:, None, None]
    x = x + bias[:, None, None]
    if out_dtype == torch.int8:
        # half-to-even like jnp.round, then the symmetric int8 clip
        x = torch.clamp(torch.round(x), -127.0, 127.0)
    return x.to(out_dtype)


def _check(planes, scale, bias, crop_size, out_dtype):
    if planes.dtype != torch.uint8 or planes.ndim != 3:
        raise ValueError(f"planes must be uint8 [N, H, W], got {planes.dtype} {tuple(planes.shape)}")
    n, h, w = planes.shape
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be float32 [{n}], got {t.dtype} {tuple(t.shape)}")
        if t.device != planes.device:
            raise ValueError(f"{name} is on {t.device}, planes on {planes.device}")
    offset = (h - crop_size) // 2
    if not 0 < crop_size <= h or offset + crop_size > w:
        raise ValueError(f"crop {crop_size} does not fit planes of {h}x{w}")
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"out_dtype must be one of {list(_OUT_KINDS)}, got {out_dtype}")
    return n, h, w, offset


def _kernel():
    from rxtpu_torch.ops._build import load_library

    fn = load_library("crop_norm").rxtpu_crop_norm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def crop_normalize(planes: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   crop_size: int = 364,
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Center crop at ``(H - crop) // 2``, then ``x*scale[n] + bias[n]`` in f32,
    then cast (int8: round half to even, clip to +-127).

    planes uint8 [N, H, W], scale/bias f32 [N] -> out_dtype [N, crop, crop].
    A CUDA tensor goes through the kernel, or this raises; a CPU tensor goes
    through ``crop_normalize_reference``. ``crop_normalize.launches`` counts
    kernel launches.
    """
    n, h, w, offset = _check(planes, scale, bias, crop_size, out_dtype)
    if planes.device.type == "cpu":
        return crop_normalize_reference(planes, scale, bias, crop_size, out_dtype)
    if planes.device.type != "cuda":
        raise ValueError(f"crop_normalize runs on cuda or cpu, got {planes.device}")
    planes, scale, bias = planes.contiguous(), scale.contiguous(), bias.contiguous()
    out = torch.empty((n, crop_size, crop_size), dtype=out_dtype, device=planes.device)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = _kernel()(planes.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                        out.data_ptr(), n, h, w, offset, crop_size,
                        _OUT_KINDS[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"crop_norm kernel launch failed: CUDA error {err}")
    crop_normalize.launches += 1
    return out


crop_normalize.launches = 0


def eval_batch_normalize(images: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                         crop_size: Optional[int] = 364,
                         out_dtype: torch.dtype = torch.bfloat16,
                         quant_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 [B, G, C, H, W] + per-sample f32 mean/std [B, C] -> normalized
    NCHW views [B, G, C, crop, crop].

    ``crop_size=None`` skips the crop (the test transform). ``quant_scale``
    (a scalar) emits int8 views quantized at that scale in the same pass.
    """
    b, g, c, h, w = images.shape
    if h != w:
        raise ValueError(f"square sources expected, got {h}x{w}")
    if crop_size is None:
        crop_size = h
    planes = images.reshape(b * g * c, h, w)
    scale = (1.0 / (255.0 * std)).to(torch.float32)
    bias = (-mean / std).to(torch.float32)
    if quant_scale is not None:
        inv = 1.0 / torch.as_tensor(quant_scale, dtype=torch.float32, device=scale.device)
        scale = scale * inv
        bias = bias * inv
        out_dtype = torch.int8
    # per plane, in the planes' (b, g, c) order
    scale = scale[:, None, :].expand(b, g, c).reshape(-1)
    bias = bias[:, None, :].expand(b, g, c).reshape(-1)
    out = crop_normalize(planes, scale, bias, crop_size, out_dtype)
    return out.reshape(b, g, c, crop_size, crop_size)
