"""K8: int8 convolution with the W8A8 epilogue fused (counterpart of the
conv and epilogue of ``rxtpu/models/quant.py:QuantConv``).

NHWC int8 activations ``[N, H, W, Cin]`` and int8 weights packed K-major
``[Cout, kh*kw*Cin]`` ((ky, kx, ci) order) give int32 sums, exact; then, in
f32 op by op, ``acc*scale[c] + bias[c]`` (``scale = w_scale * in_scale``,
formed once by the caller), plus an optional residual (an int8 tensor with
its scale, ``+ rq*rs``, or a float tensor), an optional ReLU, and either a
requantize ``clip(round(o * inv_out), -127, 127)`` to int8 (``inv_out =
1/out_scale``, half to even; a scalar, or one per output channel, as
DenseNet's per-channel activation scales need) or a bf16/f32 output.

``int8_conv`` launches the hand-written CUDA kernel
``rxtpu_torch/csrc/int8_conv.cu`` (an implicit GEMM on ``mma.sync`` s8,
which stands in for XLA's int8 conv: torch has none on CUDA) on a CUDA
tensor, and uses the plain PyTorch version ``int8_conv_reference`` only for
a tensor on the CPU. Its epilogue is staged: the residual tile is
prefetched into shared memory during the mainloop, and the output tile
leaves in 16-byte rows. The kernel takes Cin in multiples of 16; the
wrapper pads other channel counts with zeros (exact: zero products).

``int8_stem_conv`` is K8's stem entry (7x7/2, pad 3, Cin <= 8): it reads
the NCHW views themselves, float views quantized at ``in_scale`` inside the
kernel (bit-equal to ``quantize``) or int8 views at ``in_scale``, through a
shared-memory patch, with the weights packed once by ``pack_stem_weight``
(``[Cout, 7, 8, 8]``: ky, then 8 taps of 8 channels, tap 7 and channels
past Cin zero). Its plain version is ``quantize`` + permute +
``int8_conv_reference``. Its launches count in ``int8_conv.launches``.

The plain version convolves in float64, exact for these sums (at most
127^2 * K < 2^53), so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}  # the kernel's dtype codes

Pair = Union[int, Tuple[int, int]]

# the stem conv that int8_stem_conv computes: 7x7, stride 2, pad 3, at most 8
# channels; its packed weights hold 8 taps of 8 channels per kernel row
STEM_KERNEL, STEM_STRIDE, STEM_PAD, STEM_TAPS = 7, 2, 3, 8


def _pair(v: Pair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def conv_out_size(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def pack_weight(kernel_oihw: torch.Tensor) -> torch.Tensor:
    """OIHW ``[Cout, Cin, kh, kw]`` -> K-major ``[Cout, kh*kw*Cin]``."""
    o = kernel_oihw.shape[0]
    return kernel_oihw.permute(0, 2, 3, 1).reshape(o, -1).contiguous()


def pack_stem_weight(kernel_q: torch.Tensor) -> torch.Tensor:
    """The stem's K-major ``[Cout, 7*7*Cin]`` (Cin <= 8) -> ``[Cout, 7, 8, 8]``:
    per kernel row ky, taps kx 0..7 of channels 0..7 (K = 448), tap 7 and the
    channels past Cin zero."""
    taps = STEM_KERNEL * STEM_KERNEL
    cout, k = kernel_q.shape
    if k % taps or not 0 < k // taps <= STEM_TAPS:
        raise ValueError(f"a stem kernel_q is [Cout, 49*Cin] with Cin <= 8, got {tuple(kernel_q.shape)}")
    packed = kernel_q.new_zeros(cout, STEM_KERNEL, STEM_TAPS, STEM_TAPS)
    packed[:, :, :STEM_KERNEL, :k // taps] = kernel_q.reshape(cout, STEM_KERNEL, STEM_KERNEL, -1)
    return packed


def unpack_stem_weight(packed: torch.Tensor, cin: int) -> torch.Tensor:
    """``pack_stem_weight``'s inverse: ``[Cout, 7, 8, 8]`` -> ``[Cout, 49*cin]``."""
    return packed[:, :, :STEM_KERNEL, :cin].reshape(packed.shape[0], -1).contiguous()


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """A float tensor -> int8 at a calibrated scale: multiply by ``1/scale``
    (f32), round half to even, clip to +-127."""
    inv = (1.0 / scale).to(torch.float32)
    return torch.clamp(torch.round(x.to(torch.float32) * inv), -127.0, 127.0).to(torch.int8)


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


def int8_stem_conv_reference(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, in_scale: Optional[torch.Tensor] = None,
                             relu: bool = False, inv_out_scale: Optional[torch.Tensor] = None,
                             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch K8 stem: ``quantize`` (float views), permute to NHWC,
    then ``int8_conv_reference`` on the unpacked weights."""
    xq = x if x.dtype == torch.int8 else quantize(x, in_scale)
    return int8_conv_reference(xq.permute(0, 2, 3, 1), unpack_stem_weight(weight, x.shape[1]),
                               scale, bias, STEM_KERNEL, STEM_STRIDE, STEM_PAD, relu=relu,
                               inv_out_scale=inv_out_scale, out_dtype=out_dtype)


def _check_epilogue(device, out_shape, scale, bias, residual, residual_scale,
                    inv_out_scale, out_dtype, *operands):
    cout = out_shape[-1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (cout,):
            raise ValueError(f"{name} must be float32 [{cout}], got {t.dtype} {tuple(t.shape)}")
    if inv_out_scale is not None and (inv_out_scale.dtype != torch.float32 or (
            inv_out_scale.numel() != 1 and tuple(inv_out_scale.shape) != (cout,))):
        raise ValueError(f"inv_out_scale must be a float32 scalar or [{cout}], got "
                         f"{inv_out_scale.dtype} {tuple(inv_out_scale.shape)}")
    scalars = []
    if residual is not None:
        if tuple(residual.shape) != tuple(out_shape):
            raise ValueError(f"residual must be {list(out_shape)}, got {tuple(residual.shape)}")
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
    for t in (scale, bias, residual, residual_scale, inv_out_scale, *operands):
        if t is not None and t.device != device:
            raise ValueError(f"an operand is on {t.device}, x on {device}")


def _check(x, weight, scale, bias, kh, kw, stride, padding, residual, residual_scale,
           inv_out_scale, out_dtype):
    if x.dtype != torch.int8 or x.ndim != 4:
        raise ValueError(f"x must be int8 [N, H, W, Cin], got {x.dtype} {tuple(x.shape)}")
    n, h, w, cin = x.shape
    if weight.dtype != torch.int8 or weight.ndim != 2 or weight.shape[1] != kh * kw * cin:
        raise ValueError(f"weight must be int8 [Cout, {kh * kw * cin}], got {weight.dtype} "
                         f"{tuple(weight.shape)}")
    cout = weight.shape[0]
    ho, wo = conv_out_size(h, kh, stride, padding), conv_out_size(w, kw, stride, padding)
    if stride < 1 or padding < 0 or ho < 1 or wo < 1:
        raise ValueError(f"stride {stride} / padding {padding} do not fit {h}x{w} "
                         f"and a {kh}x{kw} kernel")
    _check_epilogue(x.device, (n, ho, wo, cout), scale, bias, residual, residual_scale,
                    inv_out_scale, out_dtype, weight)
    return n, h, w, cin, cout, ho, wo


# the C entry points: (pointers, ints), then the stream
_SIGNATURES = {"rxtpu_int8_conv": (8, 13), "rxtpu_int8_stem_conv": (9, 10)}


def _kernel(name):
    from rxtpu_torch.ops._build import load_library

    fn = getattr(load_library("int8_conv"), name)
    n_ptrs, n_ints = _SIGNATURES[name]
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, at a 16-byte aligned address (the kernel's cp.async copies)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name, x, out_shape, pointers, sizes, scale, bias, residual, residual_scale, relu,
            inv_out_scale, out_dtype):
    """The epilogue's operands made contiguous, the output allocated, and the
    kernel ``name`` launched on the current stream; returns the output."""
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
    inv_ptr, inv_vec = None, 0
    if inv_out_scale is not None:
        out_dtype = torch.int8
        inv_vec = int(inv_out_scale.numel() != 1)  # one scale per output channel
        inv_out_scale = inv_out_scale.reshape(-1 if inv_vec else ()).contiguous()
        inv_ptr = inv_out_scale.data_ptr()
    out = torch.empty(out_shape, dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel(name)(*pointers, scale.data_ptr(), bias.data_ptr(), res_ptr, rs_ptr,
                            inv_ptr, out.data_ptr(), *sizes, res_kind, _KINDS[out_dtype],
                            int(relu), inv_vec, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    _counter.launches += 1
    return out


def int8_conv(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              kernel_size: Pair, stride: int = 1, padding: int = 0,
              residual: Optional[torch.Tensor] = None,
              residual_scale: Optional[torch.Tensor] = None, relu: bool = False,
              inv_out_scale: Optional[torch.Tensor] = None,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x int8 [N, H, W, Cin], weight int8 [Cout, kh*kw*Cin], scale/bias f32
    [Cout] -> [N, Ho, Wo, Cout]: int8 when ``inv_out_scale`` (a f32 scalar
    tensor, or f32 [Cout]: one requantize scale per output channel) is
    given, else ``out_dtype`` (bf16 or f32). ``residual``: int8
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
    if cin % 16:  # zero channels to a multiple of 16: the kernel's 16-byte chunks
        extra = -cin % 16
        x = F.pad(x, (0, extra))
        weight = F.pad(weight.reshape(cout, kh * kw, cin), (0, extra)).reshape(cout, -1)
        cin += extra
    x, weight = _aligned(x), _aligned(weight)
    return _launch("rxtpu_int8_conv", x, (n, ho, wo, cout), (x.data_ptr(), weight.data_ptr()),
                   (n, h, w, cin, cout, kh, kw, stride, padding), scale, bias, residual,
                   residual_scale, relu, inv_out_scale, out_dtype)


def int8_stem_conv(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, in_scale: Optional[torch.Tensor] = None,
                   relu: bool = False, inv_out_scale: Optional[torch.Tensor] = None,
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """K8's stem entry: NCHW views ``x`` [N, Cin, H, W] (Cin <= 8), bf16 or
    f32 quantized at ``in_scale`` (a f32 scalar tensor) as ``quantize`` does,
    or int8 already at it; ``weight`` from ``pack_stem_weight`` [Cout, 7, 8,
    8]; the 7x7/2 conv padded 3 -> NHWC [N, Ho, Wo, Cout], with
    ``int8_conv``'s epilogue arguments but the residual (the stem has none).

    A CUDA tensor goes through the kernel, or this raises; a CPU tensor goes
    through ``int8_stem_conv_reference``. Launches count in
    ``int8_conv.launches``.
    """
    if x.ndim != 4 or x.dtype not in _KINDS or not 0 < x.shape[1] <= STEM_TAPS:
        raise ValueError(f"x must be int8, bf16 or f32 [N, Cin <= {STEM_TAPS}, H, W], got "
                         f"{x.dtype} {tuple(x.shape)}")
    n, cin, h, w = x.shape
    packed = (weight.shape[0], STEM_KERNEL, STEM_TAPS, STEM_TAPS)
    if weight.dtype != torch.int8 or weight.ndim != 4 or tuple(weight.shape) != packed:
        raise ValueError(f"weight must be int8 {list(packed)} (pack_stem_weight), got "
                         f"{weight.dtype} {tuple(weight.shape)}")
    if x.dtype != torch.int8 and in_scale is None:
        raise ValueError("float views need their in_scale")
    if in_scale is not None and (in_scale.dtype != torch.float32 or in_scale.numel() != 1):
        raise ValueError(f"in_scale must be a float32 scalar, got {in_scale.dtype} "
                         f"{tuple(in_scale.shape)}")
    ho, wo = (conv_out_size(s, STEM_KERNEL, STEM_STRIDE, STEM_PAD) for s in (h, w))
    if ho < 1 or wo < 1:
        raise ValueError(f"{h}x{w} views are too small for the 7x7/2 stem")
    cout = weight.shape[0]
    _check_epilogue(x.device, (n, ho, wo, cout), scale, bias, None, None, inv_out_scale,
                    out_dtype, weight, in_scale)
    if x.device.type == "cpu":
        return int8_stem_conv_reference(x, weight, scale, bias, in_scale, relu, inv_out_scale,
                                        out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_stem_conv runs on cuda or cpu, got {x.device}")
    x, weight = _aligned(x), _aligned(weight)
    inv_in = None if x.dtype == torch.int8 else (1.0 / in_scale).to(torch.float32).reshape(())
    return _launch("rxtpu_int8_stem_conv", x, (n, ho, wo, cout),
                   (x.data_ptr(), weight.data_ptr(), None if inv_in is None else inv_in.data_ptr()),
                   (n, cin, h, w, cout, _KINDS[x.dtype]), scale, bias, None, None, relu,
                   inv_out_scale, out_dtype)


int8_conv.launches = 0
_counter = int8_conv  # the wrappers count here, whatever ``int8_conv`` is rebound to
