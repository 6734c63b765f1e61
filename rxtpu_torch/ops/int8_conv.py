"""K8: int8 convolution with the W8A8 epilogue fused (counterpart of the
conv and epilogue of ``rxtpu/models/quant.py:QuantConv``).

NHWC int8 activations ``[N, H, W, Cin]`` and int8 weights packed K-major
``[Cout, kh*kw*Cin]`` ((ky, kx, ci) order) give int32 sums, exact; then, in
f32 op by op, ``acc*scale[c] + bias[c]`` (``scale = w_scale * in_scale``,
formed once by the caller), plus an optional residual (an int8 tensor with
its scale, ``+ rq*rs``, or a float tensor), an optional ReLU, and either a
requantize ``clip(round(o * inv_out), -127, 127)`` to int8 (``inv_out =
1/out_scale``, half to even) or a bf16/f32 output.

``int8_conv`` launches the hand-written CUDA kernel
``rxtpu_torch/csrc/int8_conv.cu`` (an implicit GEMM on ``mma.sync`` s8,
which stands in for XLA's int8 conv: torch has none on CUDA) on a CUDA
tensor, and uses the plain PyTorch version ``int8_conv_reference`` only for
a tensor on the CPU. The plain version convolves in float64, exact for
these sums (at most 127^2 * K < 2^53), so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

_OUT_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}

Pair = Union[int, Tuple[int, int]]


def _pair(v: Pair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def conv_out_size(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def pack_weight(kernel_oihw: torch.Tensor) -> torch.Tensor:
    """OIHW ``[Cout, Cin, kh, kw]`` -> K-major ``[Cout, kh*kw*Cin]``."""
    o = kernel_oihw.shape[0]
    return kernel_oihw.permute(0, 2, 3, 1).reshape(o, -1).contiguous()


def epilogue(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             residual: Optional[torch.Tensor] = None,
             residual_scale: Optional[torch.Tensor] = None, relu: bool = False,
             inv_out_scale: Optional[torch.Tensor] = None,
             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int32 sums ``[..., Cout]`` -> the output, each op rounded on its own."""
    o = acc.to(torch.float32) * scale
    o = o + bias
    if residual is not None:
        if residual.dtype == torch.int8:
            o = o + residual.to(torch.float32) * residual_scale
        else:
            o = o + residual.to(torch.float32)
    if relu:
        o = torch.relu(o)
    if inv_out_scale is not None:
        return torch.clamp(torch.round(o * inv_out_scale), -127.0, 127.0).to(torch.int8)
    return o.to(out_dtype)


def int8_conv_sums(x: torch.Tensor, weight: torch.Tensor, kernel_size: Pair,
                   stride: int = 1, padding: int = 0) -> torch.Tensor:
    """The exact int32 sums ``[N, Ho, Wo, Cout]``: F.conv2d in float64 (on a
    card with cuDNN off, whose FFT and Winograd algorithms would round)."""
    kh, kw = _pair(kernel_size)
    cout, cin = weight.shape[0], x.shape[-1]
    w = weight.reshape(cout, kh, kw, cin).permute(0, 3, 1, 2).to(torch.float64)
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float64), w, stride=stride,
                     padding=padding)
    return y.permute(0, 2, 3, 1).to(torch.int32)


def int8_conv_reference(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, kernel_size: Pair, stride: int = 1,
                        padding: int = 0, residual: Optional[torch.Tensor] = None,
                        residual_scale: Optional[torch.Tensor] = None, relu: bool = False,
                        inv_out_scale: Optional[torch.Tensor] = None,
                        out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch K8: the float64 conv's exact sums, then ``epilogue``."""
    acc = int8_conv_sums(x, weight, kernel_size, stride, padding)
    return epilogue(acc, scale, bias, residual, residual_scale, relu, inv_out_scale,
                    out_dtype)


def _check(x, weight, scale, bias, kh, kw, stride, padding, residual, residual_scale,
           inv_out_scale, out_dtype):
    if x.dtype != torch.int8 or x.ndim != 4:
        raise ValueError(f"x must be int8 [N, H, W, Cin], got {x.dtype} {tuple(x.shape)}")
    n, h, w, cin = x.shape
    if weight.dtype != torch.int8 or weight.ndim != 2 or weight.shape[1] != kh * kw * cin:
        raise ValueError(f"weight must be int8 [Cout, {kh * kw * cin}], got {weight.dtype} "
                         f"{tuple(weight.shape)}")
    cout = weight.shape[0]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (cout,):
            raise ValueError(f"{name} must be float32 [{cout}], got {t.dtype} {tuple(t.shape)}")
    ho, wo = conv_out_size(h, kh, stride, padding), conv_out_size(w, kw, stride, padding)
    if stride < 1 or padding < 0 or ho < 1 or wo < 1:
        raise ValueError(f"stride {stride} / padding {padding} do not fit {h}x{w} "
                         f"and a {kh}x{kw} kernel")
    scalars = [("inv_out_scale", inv_out_scale)]
    if residual is not None:
        if tuple(residual.shape) != (n, ho, wo, cout):
            raise ValueError(f"residual must be [{n}, {ho}, {wo}, {cout}], got "
                             f"{tuple(residual.shape)}")
        if residual.dtype == torch.int8:
            if residual_scale is None:
                raise ValueError("an int8 residual needs its residual_scale")
            scalars.append(("residual_scale", residual_scale))
        elif not residual.is_floating_point():
            raise ValueError(f"residual must be int8 or float, got {residual.dtype}")
    for name, t in scalars:
        if t is not None and (t.dtype != torch.float32 or t.numel() != 1):
            raise ValueError(f"{name} must be a float32 scalar, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if inv_out_scale is None and out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    tensors = [weight, scale, bias, residual, residual_scale, inv_out_scale]
    for t in tensors:
        if t is not None and t.device != x.device:
            raise ValueError(f"an operand is on {t.device}, x on {x.device}")
    return n, h, w, cin, cout, ho, wo


def _kernel():
    from rxtpu_torch.ops._build import load_library

    fn = load_library("int8_conv").rxtpu_int8_conv
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, at a 16-byte aligned address (the kernel's cp.async copies)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def int8_conv(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              kernel_size: Pair, stride: int = 1, padding: int = 0,
              residual: Optional[torch.Tensor] = None,
              residual_scale: Optional[torch.Tensor] = None, relu: bool = False,
              inv_out_scale: Optional[torch.Tensor] = None,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x int8 [N, H, W, Cin], weight int8 [Cout, kh*kw*Cin], scale/bias f32
    [Cout] -> [N, Ho, Wo, Cout]: int8 when ``inv_out_scale`` (a f32 scalar
    tensor) is given, else ``out_dtype`` (bf16 or f32). ``residual``: int8
    with ``residual_scale`` (a f32 scalar tensor), or float, of the output's
    shape. Square stride and padding, as ResNet's convs.

    A CUDA tensor goes through the kernel, or this raises; a CPU tensor goes
    through ``int8_conv_reference``. ``int8_conv.launches`` counts kernel
    launches.
    """
    kh, kw = _pair(kernel_size)
    n, h, w, cin, cout, ho, wo = _check(x, weight, scale, bias, kh, kw, stride, padding,
                                        residual, residual_scale, inv_out_scale, out_dtype)
    if x.device.type == "cpu":
        return int8_conv_reference(x, weight, scale, bias, (kh, kw), stride, padding, residual,
                                   residual_scale, relu, inv_out_scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv runs on cuda or cpu, got {x.device}")
    x, weight = _aligned(x), _aligned(weight)
    scale, bias = scale.contiguous(), bias.contiguous()
    res_kind, res_ptr, rs_ptr = 0, None, None
    if residual is not None:
        if residual.dtype == torch.int8:
            residual, res_kind = residual.contiguous(), 1
            residual_scale = residual_scale.reshape(()).contiguous()
            rs_ptr = residual_scale.data_ptr()
        else:
            residual, res_kind = residual.to(torch.float32).contiguous(), 2
        res_ptr = residual.data_ptr()
    inv_ptr = None
    if inv_out_scale is not None:
        out_dtype = torch.int8
        inv_out_scale = inv_out_scale.reshape(()).contiguous()
        inv_ptr = inv_out_scale.data_ptr()
    out = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(x.data_ptr(), weight.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                        res_ptr, rs_ptr, inv_ptr, out.data_ptr(), n, h, w, cin, cout, kh, kw,
                        stride, padding, res_kind, _OUT_KINDS[out_dtype], int(relu), stream)
    if err != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: CUDA error {err}")
    _counter.launches += 1
    return out


int8_conv.launches = 0
_counter = int8_conv  # the wrapper counts here, whatever ``int8_conv`` is rebound to
