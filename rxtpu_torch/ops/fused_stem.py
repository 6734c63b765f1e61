"""K5: the fused eval stem (counterpart of ``rxtpu/ops/fused_stem.py``).

Per view: center crop, ``x*scale[n, c] + bias[n, c]`` in f32, zero pad 3
(after the normalize), conv 7x7/2 with the BN-folded kernel on bf16-rounded
operands with f32 sums, the f32 folded bias, ReLU, max pool 3x3/2 padded 1,
written as ``[N, M, Po, Po]`` NCHW in ``out_dtype``.

``fused_stem`` launches the hand-written CUDA kernel
``rxtpu_torch/csrc/fused_stem.cu`` (which replaces the Pallas kernel
``fused_stem.py:_stem_kernel``: an implicit GEMM on the tensor cores in
persistent blocks) on a CUDA tensor, and uses the plain PyTorch
version ``fused_stem_reference`` only for a tensor on the CPU. Both round
the normalize's product and sum separately and then to bf16, so the conv
operands are bit-equal and only the order of the f32 sums differs; the
kernel sums again, in the plain version's order, the conv outputs whose bf16
rounding that order could change, so its bf16 output equals the plain
version's on the card.

``eval_batch_stem`` is the eval/test batch path, the counterpart of the
stem half of rxtpu's ``_make_fused_stem_apply``: raw ``[B, G, C, H, W]`` and
per-sample mean/std in, stem maps ``[B, G, M, Po, Po]`` out.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from rxtpu_torch.ops.crop_norm import normalize_params

_PAD = 3  # the conv's zero padding
_OUT_KINDS = {torch.bfloat16: 0, torch.float32: 2}
KERNEL_CHANNELS = (6, 64)  # the (input, output) channels the CUDA kernel takes


def stem_out_size(crop: int) -> int:
    conv = (crop + 2 * _PAD - 7) // 2 + 1
    return (conv + 2 * 1 - 3) // 2 + 1


def fused_stem_reference(images: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         weight: torch.Tensor, conv_bias: torch.Tensor,
                         crop_size: Optional[int] = 364,
                         out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch K5, op by op (``rxtpu/ops/fused_stem.py:reference_stem``).

    The operands are rounded to bf16 and the conv runs in f32: the kernel's
    rounding model. On a card, call it with ``torch.backends.cudnn.allow_tf32``
    False, or cuDNN rounds the f32 conv's inputs to TF32.
    """
    h = images.shape[2]
    crop = crop_size or h
    off = (h - crop) // 2
    x = images[:, :, off:off + crop, off:off + crop].to(torch.float32)
    x = x * scale[:, :, None, None]
    x = x + bias[:, :, None, None]
    x = x.to(torch.bfloat16).to(torch.float32)
    w = weight.to(torch.bfloat16).to(torch.float32)
    y = F.conv2d(x, w, stride=2, padding=_PAD)
    y = torch.relu(y + conv_bias[None, :, None, None])
    return F.max_pool2d(y, 3, 2, 1).to(out_dtype)


def _check(images, scale, bias, weight, conv_bias, crop_size, out_dtype):
    if images.dtype != torch.uint8 or images.ndim != 4:
        raise ValueError(f"images must be uint8 [N, C, H, W], got {images.dtype} "
                         f"{tuple(images.shape)}")
    n, c, h, w = images.shape
    if weight.ndim != 4 or tuple(weight.shape[1:]) != (c, 7, 7):
        raise ValueError(f"weight must be [M, {c}, 7, 7], got {tuple(weight.shape)}")
    m = weight.shape[0]
    for name, t, shape in (("scale", scale, (n, c)), ("bias", bias, (n, c)),
                           ("conv_bias", conv_bias, (m,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {list(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("scale", scale), ("bias", bias), ("weight", weight),
                    ("conv_bias", conv_bias)):
        if t.device != images.device:
            raise ValueError(f"{name} is on {t.device}, images on {images.device}")
    crop = crop_size or h
    offset = (h - crop) // 2
    if not 0 < crop <= h or offset + crop > w:
        raise ValueError(f"crop {crop} does not fit images of {h}x{w}")
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"out_dtype must be one of {list(_OUT_KINDS)}, got {out_dtype}")
    return n, c, h, w, m, crop, offset


def _kernel():
    from rxtpu_torch.ops._build import load_library

    fn = load_library("fused_stem").rxtpu_fused_stem
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_stem(images: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               weight: torch.Tensor, conv_bias: torch.Tensor,
               crop_size: Optional[int] = 364,
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """images uint8 [N, C, H, W], scale/bias f32 [N, C] (``1/(255 std)``,
    ``-mean/std``), weight [M, C, 7, 7] (the folded stem conv, in bf16 as the
    kernel reads it; another dtype is rounded to bf16 on every call),
    conv_bias f32 [M] -> [N, M, Po, Po] in ``out_dtype`` (bf16 or f32),
    ``Po = stem_out_size(crop)``. ``crop_size=None`` takes the whole image.

    A CUDA tensor goes through the kernel (6 input and 64 output channels),
    or this raises; a CPU tensor goes through ``fused_stem_reference``.
    ``fused_stem.launches`` counts kernel launches.
    """
    n, c, h, w, m, crop, offset = _check(images, scale, bias, weight, conv_bias,
                                         crop_size, out_dtype)
    if images.device.type == "cpu":
        return fused_stem_reference(images, scale, bias, weight, conv_bias, crop, out_dtype)
    if images.device.type != "cuda":
        raise ValueError(f"fused_stem runs on cuda or cpu, got {images.device}")
    if (c, m) != KERNEL_CHANNELS:
        raise ValueError(f"the fused_stem kernel takes {KERNEL_CHANNELS[0]} input and "
                         f"{KERNEL_CHANNELS[1]} output channels, got {c} and {m}")
    images, scale, bias = images.contiguous(), scale.contiguous(), bias.contiguous()
    w_bf16 = weight.to(torch.bfloat16).reshape(m, c * 49).contiguous()
    conv_bias = conv_bias.contiguous()
    po = stem_out_size(crop)
    out = torch.empty((n, m, po, po), dtype=out_dtype, device=images.device)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = _kernel()(images.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                        w_bf16.data_ptr(), conv_bias.data_ptr(), out.data_ptr(), n, h, w,
                        offset, crop, _OUT_KINDS[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused_stem kernel launch failed: CUDA error {err}")
    fused_stem.launches += 1
    return out


fused_stem.launches = 0


def eval_batch_stem(images: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                    weight: torch.Tensor, conv_bias: torch.Tensor,
                    crop_size: Optional[int] = 364,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 [B, G, C, H, W] + per-sample f32 mean/std [B, C] -> stem maps
    [B, G, M, Po, Po]: the G views fold into K5's batch, and each view takes
    its sample's ``1/(255 std)`` and ``-mean/std``."""
    b, g, c, h, w = images.shape
    scale, bias = (t.reshape(b * g, c) for t in normalize_params(mean, std, g))
    maps = fused_stem(images.reshape(b * g, c, h, w), scale, bias, weight, conv_bias,
                      crop_size, out_dtype)
    return maps.reshape((b, g) + tuple(maps.shape[1:]))
