"""W8A8 int8 modules of the inference path (counterpart of
``rxtpu/models/quant.py``).

Symmetric, zero-point-free quantization (conv zero padding stays exact):

  xq  = clip(round(x / in_scale), -127, 127)  int8   [per-tensor scale]
  y   = conv(xq, kernel_q)                    int32
  out = y * (w_scale * in_scale) + bias       f32    [w_scale per out-channel]

Activations stay int8 between convs, NHWC: each conv's epilogue (dequant,
bias, residual, ReLU, requantize to the next conv's scale) runs inside the
conv's kernel K8 (``rxtpu_torch.ops.int8_conv``), and a residual branch reads
the int8 tensor with its scale. The stem (``QuantStemConv``) reads the NCHW
views and quantizes them inside K8. Calibration (``rxtpu_torch.infer.quant``)
observes the BN-folded twin's convs (DenseNet's unfolded model, with its
segment observation points) with ``ConvObserver``.

DenseNet quantizes activations per channel: its convs carry an
``in_scale_vec`` (baked into ``kernel_q`` as ``W * s_in[i]``, so their
runtime ``in_scale`` is 1) and a ``[Cout]`` ``out_scale``, and its
pre-activation BNs are ``QuantPreNorm``s, in plain torch (rxtpu runs them as
an XLA elementwise fusion, not a Pallas kernel).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from rxtpu_torch.ops import int8_conv as k8

Quantized = Tuple[torch.Tensor, torch.Tensor]  # (int8 NHWC tensor, its f32 scale)


def quantize_to(x: torch.Tensor, scale: torch.Tensor) -> Quantized:
    """A float tensor -> ``(int8, scale)`` at a calibrated scale: multiply by
    ``1/scale`` (f32), round half to even, clip to +-127."""
    return k8.quantize(x, scale), scale


def quant_max_pool(x: Quantized) -> Quantized:
    """Max pool 3x3/2, pad 1, on an ``(int8 NHWC, scale)`` pair. Quantization is
    monotone, so pooling the int8 tensor is quantizing the pooled one. The
    pool runs in bf16, which holds every int8 value exactly; its -inf pad
    acts as rxtpu's -128 (every window holds a real value)."""
    q, s = x
    y = F.max_pool2d(q.permute(0, 3, 1, 2).to(torch.bfloat16), 3, 2, 1)
    return y.to(torch.int8).permute(0, 2, 3, 1).contiguous(), s


class QuantConv(nn.Module):
    """int8 conv on weights from ``rxtpu_torch.infer.quant.prepare_quantized``.

    Buffers (rxtpu's parameter names): ``kernel_q`` int8 ``[Cout, kh*kw*Cin]``
    (K-major, (ky, kx, ci) order), ``w_scale`` and ``bias`` f32 ``[Cout]``,
    ``in_scale`` and ``out_scale`` f32 scalars (the conv's calibrated input
    and output ranges over 127; the projections requantize at their
    ``out_scale``). ``per_channel=True`` (DenseNet's convs) adds
    ``in_scale_vec`` f32 ``[Cin]`` and makes ``out_scale`` f32 ``[Cout]``.

    ``x``: NHWC, a float tensor (quantized here at ``in_scale``), a bare int8
    tensor already at ``in_scale`` (quantize-at-source), or an ``(int8,
    scale)`` pair a producer quantized; a vector scale there is per input
    channel, baked into ``kernel_q``, so the dequant takes ``w_scale`` alone
    (``rxtpu/models/quant.py:144-150``). ``out_scale`` requantizes the output
    and returns an ``(int8, out_scale)`` pair; without it the output is
    ``out_dtype``. ``relu_out`` and ``residual`` (a pair or a float tensor,
    added before the ReLU) fold into the epilogue.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, per_channel: bool = False):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        k = kernel_size * kernel_size * in_channels
        self.register_buffer("kernel_q", torch.zeros(out_channels, k, dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(out_channels))
        self.register_buffer("bias", torch.zeros(out_channels))
        self.register_buffer("in_scale", torch.ones(()))
        if per_channel:
            self.register_buffer("in_scale_vec", torch.ones(in_channels))
        self.register_buffer("out_scale",
                             torch.ones(out_channels) if per_channel else torch.ones(()))

    def forward(self, x: Union[torch.Tensor, Quantized],
                out_scale: Optional[torch.Tensor] = None, relu_out: bool = False,
                residual: Union[None, torch.Tensor, Quantized] = None,
                out_dtype: torch.dtype = torch.bfloat16):
        if isinstance(x, tuple):
            xq, in_scale = x
        elif x.dtype == torch.int8:
            xq, in_scale = x, self.in_scale
        else:
            xq, in_scale = quantize_to(x, self.in_scale)
        res, res_scale = residual if isinstance(residual, tuple) else (residual, None)
        inv_out = None if out_scale is None else (1.0 / out_scale).to(torch.float32)
        # a vector scale is per input channel, inside kernel_q
        scale = self.w_scale if in_scale.ndim == 1 else self.w_scale * in_scale
        y = k8.int8_conv(xq, self.kernel_q, scale, self.bias,
                         self.kernel_size, self.stride, self.padding, residual=res,
                         residual_scale=res_scale, relu=relu_out, inv_out_scale=inv_out,
                         out_dtype=out_dtype)
        return y if out_scale is None else (y, out_scale)


class QuantStemConv(QuantConv):
    """The stem's ``QuantConv`` (7x7/2, pad 3, Cin <= 8) on the NCHW views
    (``out_channel_scale=True``: DenseNet's ``[Cout]`` ``out_scale``):
    K8's stem entry (``int8_stem_conv``) quantizes float views at
    ``in_scale`` inside the kernel, or takes int8 views already at it, so no
    quantize or NHWC copy runs before it. ``kernel_stem`` (``kernel_q``
    packed by ``pack_stem_weight``, ``[Cout, 7, 8, 8]``) is not in the state
    dict: it is packed anew whenever one is loaded."""

    def __init__(self, in_channels: int, out_channels: int, out_channel_scale: bool = False):
        super().__init__(in_channels, out_channels, k8.STEM_KERNEL, k8.STEM_STRIDE, k8.STEM_PAD)
        if out_channel_scale:
            self.out_scale = torch.ones(out_channels)
        self.register_buffer("kernel_stem", k8.pack_stem_weight(self.kernel_q), persistent=False)
        self.register_load_state_dict_post_hook(QuantStemConv._pack)

    @staticmethod
    @torch.no_grad()
    def _pack(module: "QuantStemConv", _incompatible) -> None:
        module.kernel_stem.copy_(k8.pack_stem_weight(module.kernel_q))

    def forward(self, x: torch.Tensor, out_scale: Optional[torch.Tensor] = None,
                relu_out: bool = False, out_dtype: torch.dtype = torch.bfloat16):
        """``x``: NCHW views, float (quantized at ``in_scale``) or int8 at
        ``in_scale``; the output as ``QuantConv``'s, NHWC."""
        inv_out = None if out_scale is None else (1.0 / out_scale).to(torch.float32)
        y = k8.int8_stem_conv(x, self.kernel_stem, self.w_scale * self.in_scale, self.bias,
                              self.in_scale, relu=relu_out, inv_out_scale=inv_out,
                              out_dtype=out_dtype)
        return y if out_scale is None else (y, out_scale)


class QuantPreNorm(nn.Module):
    """DenseNet's pre-activation BN and ReLU on an int8 state, with an optional
    requantize (``rxtpu/models/quant.py:198-236``): ``(q, svec)`` (int8 NHWC
    and its per-channel scale vector) -> ``z = relu(q * (svec * mul) + add)``
    in f32, the product ``svec * mul`` formed first, as rxtpu does; then
    ``(quantize(z, out_scale), out_scale)`` or, without ``out_scale`` (the
    last norm before the head), ``z``. Buffers ``mul`` and ``add`` (f32
    ``[C]``) are the eval BN's affine, from
    ``rxtpu_torch.infer.quant.quantize_densenet_backbone``."""

    def __init__(self, num_features: int):
        super().__init__()
        self.register_buffer("mul", torch.ones(num_features))
        self.register_buffer("add", torch.zeros(num_features))

    def forward(self, x: Quantized, out_scale: Optional[torch.Tensor] = None):
        q, svec = x
        z = torch.relu(q.to(torch.float32) * (svec * self.mul) + self.add)
        return z if out_scale is None else quantize_to(z, out_scale)


class Observe(nn.Identity):
    """A named observation point of a forward (DenseNet's stored segments):
    the identity, which ``ConvObserver`` hooks to record ``tag`` (the absmax)
    and ``tag + "_ch"`` (per channel, axis 1)."""

    def __init__(self, tag: str):
        super().__init__()
        self.tag = tag


def _absmax(t: torch.Tensor):
    """(absmax, absmax per channel of axis 1), f32."""
    a = t.detach().abs().to(torch.float32)
    return a.amax(), a.amax(dim=[d for d in range(a.ndim) if d != 1])


class ConvObserver:
    """The observed forward of calibration (rxtpu's ``ObservedConv`` and
    DenseNet's segment sows): forward hooks on every ``nn.Conv2d`` of
    ``module`` record the absmax of the conv's input and output, as f32
    scalars and per channel, on the tensors the module computes, and every
    ``Observe`` point its input's; all max-reduced across calls. ``stats``
    maps each conv's name in ``module`` (``conv_init``,
    ``stage1_block1.Conv_0``, ...) to ``{"in_absmax", "in_absmax_ch",
    "out_absmax", "out_absmax_ch"}``, and each point's tag (``stem_absmax``,
    ...) and tag ``_ch`` to a tensor. Use as a context manager; leaving it
    removes the hooks."""

    def __init__(self, module: nn.Module):
        self.stats: Dict[str, Union[torch.Tensor, Dict[str, torch.Tensor]]] = {}
        self._handles = []
        for name, mod in module.named_modules():
            if isinstance(mod, nn.Conv2d):
                self._handles.append(mod.register_forward_hook(
                    functools.partial(self._record_conv, name)))
            elif isinstance(mod, Observe):
                self._handles.append(mod.register_forward_hook(self._record_point))

    def _record_conv(self, name, _conv, inputs, output):
        (a, a_ch), (b, b_ch) = _absmax(inputs[0]), _absmax(output)
        seen = {"in_absmax": a, "in_absmax_ch": a_ch, "out_absmax": b, "out_absmax_ch": b_ch}
        old = self.stats.get(name)
        self.stats[name] = seen if old is None else {
            k: torch.maximum(old[k], v) for k, v in seen.items()}

    def _record_point(self, point, inputs, _output):
        for tag, v in zip((point.tag, point.tag + "_ch"), _absmax(inputs[0])):
            old = self.stats.get(tag)
            self.stats[tag] = v if old is None else torch.maximum(old, v)

    def close(self) -> None:
        for handle in self._handles:
            handle.remove()
        self._handles = []

    def __enter__(self) -> "ConvObserver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
