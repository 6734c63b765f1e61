"""K6 and K7: the fused train-mode bottleneck and its backward (counterpart
of ``rxtpu/ops/fused_block.py``).

The block, on views flattened to an unpadded channels-last slab ``[R, C]``
(``R = V*H*W`` rows, the pixels of V views of H x W, row major):

    c1 = x w1;             a1 = relu(bn1(c1))
    c2 = conv3x3(a1, w2);  a2 = relu(bn2(c2))
    c3 = a2 w3;            y  = relu(bn3(c3) + residual)

with train-mode BatchNorm statistics over all R rows, the residual ``x`` or
``bnp(x wp)`` (the projection of stage 1's first block), and only
``x, c1, c2, y`` kept for a four-pass backward that recomputes the rest.
Eight bodies, one per Pallas kernel of rxtpu:

- forward: ``k1`` (c1 and its sums, the projection's sums), ``k2`` (the
  3x3 conv over a1 and its sums), ``k3`` (the sums of c3), ``k4`` (y);
- backward: ``b1`` (the BN3 sums), ``b2`` (dc3, dw3, g2, the BN2 sums),
  ``b3`` (dc2, dw2, the adjoint 3x3 conv to g1, the BN1 sums), ``b4`` (dc1,
  dw1, dx, and dwp with the projection).

Each body has a plain PyTorch version (``k1_reference`` ...) that mirrors the
rxtpu kernel op by op: matmuls in f32 on bf16 operands (a bf16 x bf16
product is exact in f32, so only the order of the f32 sums can differ from a
kernel), values rounded to bf16 where rxtpu rounds them (c1, c2, c3, a1, a2,
bn3, res, y, dc3, g2, dc2, g1, dc1, dcp, dx), every ``v*scale + shift``
rounded after the product and after the sum, comparisons on bf16 values, and
the BN sums taken on the bf16-rounded values. The 3x3 conv reads the
neighbour ``(y+dy, x+dx)`` of each pixel for the taps in ``(ky, kx)``
row-major order (rxtpu's ``_OFFSETS``) and 0 outside the plane (SAME
padding). rxtpu's slab decomposition, pad rows and their re-masking exist
only because a whole plane exceeds a TPU core's VMEM: none of it is here.

The wrappers ``k1`` ... ``b4`` launch the hand-written CUDA kernels of
``rxtpu_torch/csrc/fused_block.cu`` on CUDA tensors (channels a multiple of
64), or raise, and use the plain version only for CPU tensors. Each counts
its calls that launch kernels in ``<wrapper>.launches``: one per body, however
many kernel launches the body takes. Per-channel vectors are 1-D f32 ``[C]``
(rxtpu's ``[1, C]``, which broadcasts the same).

``BottleneckFused`` is the ``torch.autograd.Function`` (rxtpu's
``custom_vjp``) and ``bottleneck_fused`` its entry point; the layout
helpers convert ``nn.Conv2d`` weights to the kernels' layouts and back.
Given a process group (the data ranks), it is SyncBN: each BN's per-channel
sums, forward and backward, are summed over the group in one all-reduce
before they are used, and the count is the group's rows, so every rank's
rows are normalized with the global batch's statistics (rxtpu's fused
block under GSPMD sees the whole batch); the parameters' gradients keep the
rank's own sums, for the train step's gradient all-reduce.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

BF16 = torch.bfloat16
F32 = torch.float32
OFFSETS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))  # rxtpu's _OFFSETS
KERNEL_CHANNELS = 64  # every channel count the CUDA kernels take is a multiple of this


# ---------------------------------------------------------------------------
# Layouts: nn.Conv2d weights <-> the kernels' matrices (views, so autograd
# carries each gradient back to the conv weight's layout)
# ---------------------------------------------------------------------------


def conv1x1_to_mat(weight: torch.Tensor) -> torch.Tensor:
    """``[O, I, 1, 1]`` -> ``[I, O]`` (w1, w3, wp)."""
    return weight[:, :, 0, 0].t()


def mat_to_conv1x1(mat: torch.Tensor) -> torch.Tensor:
    """``[I, O]`` -> ``[O, I, 1, 1]``."""
    return mat.t()[:, :, None, None]


def conv3x3_to_taps(weight: torch.Tensor) -> torch.Tensor:
    """``[O, I, 3, 3]`` -> ``[9, I, O]``, tap ``3*ky + kx`` (w2)."""
    o, i = weight.shape[:2]
    return weight.permute(2, 3, 1, 0).reshape(9, i, o)


def taps_to_conv3x3(taps: torch.Tensor) -> torch.Tensor:
    """``[9, I, O]`` -> ``[O, I, 3, 3]``."""
    _, i, o = taps.shape
    return taps.reshape(3, 3, i, o).permute(3, 2, 0, 1)


# ---------------------------------------------------------------------------
# Plain versions, one per Pallas body
# ---------------------------------------------------------------------------


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.float() @ b.float()


def _sum_sq(v_bf16: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    v = v_bf16.float()
    return v.sum(0), (v * v).sum(0)


def _affine(v: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``v*scale + shift`` in f32, the product rounded before the sum."""
    return v.float() * scale + shift


def _bn_relu(c: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(_affine(c, scale, shift), 0.0).to(BF16)


def _xhat(c: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    return (c.float() - mean) * inv


def _bn_backward(g: torch.Tensor, xhat: torch.Tensor, k: torch.Tensor, da: torch.Tensor,
                 db: torch.Tensor) -> torch.Tensor:
    return (k * (g.float() - da - xhat * db)).to(BF16)


def _g3(dy: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``dy * [y > 0]`` in bf16 (dy, or a zero of dy's sign), as f32."""
    return (dy * (y.float() > 0).to(BF16)).float()


def _shifted(v: torch.Tensor, height: int, width: int, dy: int, dx: int) -> torch.Tensor:
    """``[R, F]`` rows -> each pixel's neighbour ``(y+dy, x+dx)`` in its own
    view, 0 where that lies outside the plane."""
    f = v.shape[1]
    planes = torch.nn.functional.pad(v.reshape(-1, height, width, f), (0, 0, 1, 1, 1, 1))
    return planes[:, 1 + dy:1 + dy + height, 1 + dx:1 + dx + width].reshape(-1, f)


def _conv_taps(v, w2, height, width, adjoint=False):
    """``sum_k shift_k(v) w2[k]`` in f32, taps in order; the adjoint reads
    across the negated offsets (``w2`` then holds ``w2[k]^T``)."""
    acc = None
    for k, (dy, dx) in enumerate(OFFSETS):
        src = _shifted(v, height, width, -dy, -dx) if adjoint else _shifted(v, height, width,
                                                                            dy, dx)
        term = _mm(src, w2[k])
        acc = term if acc is None else acc + term
    return acc


def k1_reference(x, w1, wp=None):
    """``_k1_kernel``: ``c1 = bf16(x w1)``, sum and sum of squares of c1 per
    channel; with ``wp`` also those of ``cp = bf16(x wp)`` (not stored).
    Returns ``(c1, s1, q1[, sp, qp])``."""
    c1 = _mm(x, w1).to(BF16)
    out = (c1, *_sum_sq(c1))
    if wp is not None:
        out += _sum_sq(_mm(x, wp).to(BF16))
    return out


def k2_reference(c1, sc1, sh1, w2, height, width):
    """``_k2_kernel``: ``a1 = bn_relu(c1)``, ``c2 = bf16(conv3x3(a1, w2))``
    (SAME), and c2's sums. Returns ``(c2, s2, q2)``."""
    a1 = _bn_relu(c1, sc1, sh1)
    c2 = _conv_taps(a1, w2, height, width).to(BF16)
    return (c2, *_sum_sq(c2))


def k3_reference(c2, sc2, sh2, w3):
    """``_k3_kernel``: the sums of ``c3 = bf16(bn_relu(c2) w3)``."""
    return _sum_sq(_mm(_bn_relu(c2, sc2, sh2), w3).to(BF16))


def k4_reference(c2, x, sc2, sh2, w3, sc3, sh3, wp=None, scp=None, shp=None):
    """``_k4_kernel``: ``y = bf16(max(bn3 + res, 0))`` with ``bn3 =
    bf16(c3*sc3 + sh3)`` and ``res = x`` or ``bf16(cp*scp + shp)``."""
    c3 = _mm(_bn_relu(c2, sc2, sh2), w3).to(BF16)
    bn3 = _affine(c3, sc3, sh3).to(BF16)
    res = x if wp is None else _affine(_mm(x, wp).to(BF16), scp, shp).to(BF16)
    return torch.clamp_min(bn3.float() + res.float(), 0.0).to(BF16)


def b1_reference(dy, y, c2, sc2, sh2, w3, m3, i3, x=None, wp=None, mp=None, ip=None):
    """``_b1_kernel``: with ``g3 = dy*[y > 0]``, the sums of g3 and of
    ``g3*xhat3`` (c3 recomputed), and with ``wp`` of ``g3*xhatp``.
    Returns ``(s3a, s3b[, spb])``."""
    g3 = _g3(dy, y)
    c3 = _mm(_bn_relu(c2, sc2, sh2), w3).to(BF16)
    out = (g3.sum(0), (g3 * _xhat(c3, m3, i3)).sum(0))
    if wp is not None:
        cp = _mm(x, wp).to(BF16)
        out += ((g3 * _xhat(cp, mp, ip)).sum(0),)
    return out


def b2_reference(dy, y, c2, sc2, sh2, w3, m3, i3, k3, d3a, d3b, m2, i2):
    """``_b2_kernel``: ``dc3`` (BN3 backward), ``dw3 = a2^T dc3``, ``g2 =
    bf16((dc3 w3^T)*[a2 > 0])`` and the sums of g2 and ``g2*xhat2``.
    Returns ``(g2, dw3, s2a, s2b)``."""
    g3 = _g3(dy, y)
    a2 = _bn_relu(c2, sc2, sh2)
    c3 = _mm(a2, w3).to(BF16)
    dc3 = _bn_backward(g3, _xhat(c3, m3, i3), k3, d3a, d3b)
    dw3 = _mm(a2.t(), dc3)
    g2 = (_mm(dc3, w3.t()) * (a2.float() > 0)).to(BF16)
    g2f = g2.float()
    return g2, dw3, g2f.sum(0), (g2f * _xhat(c2, m2, i2)).sum(0)


def b3_reference(g2, c1, c2, sc1, sh1, k2, d2a, d2b, m2, i2, w2, m1, i1, height, width):
    """``_b3_kernel``: ``dc2`` (BN2 backward), ``dw2[k] = shift_k(a1)^T dc2``
    per tap, the adjoint conv ``da1 = sum_k dc2[q - off_k] w2[k]^T``, ``g1 =
    bf16(da1*[a1 > 0])`` and the sums of g1 and ``g1*xhat1``.
    Returns ``(g1, dw2, s1a, s1b)``."""
    dc2 = _bn_backward(g2, _xhat(c2, m2, i2), k2, d2a, d2b)
    a1 = _bn_relu(c1, sc1, sh1)
    dw2 = torch.stack([_mm(_shifted(a1, height, width, dy, dx).t(), dc2) for dy, dx in OFFSETS])
    da1 = _conv_taps(dc2, w2.transpose(1, 2), height, width, adjoint=True)
    g1 = (da1 * (a1.float() > 0)).to(BF16)
    g1f = g1.float()
    return g1, dw2, g1f.sum(0), (g1f * _xhat(c1, m1, i1)).sum(0)


def b4_reference(g1, c1, x, dy, y, k1, d1a, d1b, m1, i1, w1, wp=None, kp=None, dpa=None,
                 dpb=None, mp=None, ip=None):
    """``_b4_kernel``: ``dc1`` (BN1 backward), ``dw1 = x^T dc1``, ``dx =
    bf16(dc1 w1^T + g3)``, or with ``wp`` ``dcp`` (the projection's BN
    backward), ``dwp = x^T dcp`` and ``dx = bf16(dc1 w1^T + dcp wp^T)``.
    Returns ``(dx, dw1[, dwp])``."""
    dc1 = _bn_backward(g1, _xhat(c1, m1, i1), k1, d1a, d1b)
    dw1 = _mm(x.t(), dc1)
    dx = _mm(dc1, w1.t())
    g3 = _g3(dy, y)
    if wp is None:
        return (dx + g3).to(BF16), dw1
    cp = _mm(x, wp).to(BF16)
    dcp = _bn_backward(g3, _xhat(cp, mp, ip), kp, dpa, dpb)
    dx = dx + _mm(dcp, wp.t())
    return dx.to(BF16), dw1, _mm(x.t(), dcp)


# ---------------------------------------------------------------------------
# The CUDA kernels (csrc/fused_block.cu): arguments and launches
# ---------------------------------------------------------------------------

# the A operand's modes and the epilogues of the GEMM kernels
_STORED, _BN_RELU, _TAP_BN_RELU, _TAP_ADJOINT = range(4)
(_STORE_STATS, _STATS, _RESIDUAL, _OUTPUT, _BN_SUMS, _BN_BACKWARD, _RELU_GRAD,
 _INPUT_GRAD) = range(8)
_SUM_EPIS = (_STORE_STATS, _STATS, _BN_SUMS, _RELU_GRAD)
# the (mode, epilogue) pairs of the eight bodies and the pipelined
# mainloop's rows per block for each: one pair of partial sums per tile;
# g2, g1 and dx read their weights transposed, as stored ([n, k]: w3 for
# g2, w2[tap] for g1, w1 and wp for dx)
_ROW_TILES = {(_STORED, _STORE_STATS): 128, (_STORED, _STATS): 64, (_BN_RELU, _STATS): 64,
              (_TAP_BN_RELU, _STORE_STATS): 128, (_STORED, _RESIDUAL): 64, (_BN_RELU, _OUTPUT): 64,
              (_BN_RELU, _BN_SUMS): 64, (_STORED, _BN_SUMS): 64,
              (_BN_RELU, _BN_BACKWARD): 64, (_STORED, _BN_BACKWARD): 64,
              (_STORED, _RELU_GRAD): 128, (_TAP_ADJOINT, _RELU_GRAD): 128,
              (_STORED, _INPUT_GRAD): 64}
_WT_PAIRS = ((_STORED, _RELU_GRAD), (_TAP_ADJOINT, _RELU_GRAD), (_STORED, _INPUT_GRAD))
_PIPE_ROWS = 32       # the pipelined weight gradient's chunks are multiples of this many rows
_vp, _ll, _int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


class _ASrc(ctypes.Structure):
    _fields_ = [("ptr", _vp), ("ld", _ll), ("col", _int), ("kc", _int), ("scale", _vp),
                ("shift", _vp), ("height", _int), ("width", _int)]


class _GemmArgs(ctypes.Structure):
    _fields_ = [("a", _ASrc), ("w", _vp), ("rows", _ll), ("k", _int), ("n", _int),
                ("mode", _int), ("epi", _int), ("out", _vp), ("ldo", _ll), ("out_col", _int),
                ("add_g3", _int), ("aux0", _vp), ("aux1", _vp), ("ldaux", _ll),
                ("e_scale", _vp), ("e_shift", _vp), ("e_mean", _vp), ("e_inv", _vp),
                ("e_k", _vp), ("e_da", _vp), ("e_db", _vp), ("part0", _vp), ("w2", _vp),
                ("k_split", _int)]


class _WgradArgs(ctypes.Structure):
    _fields_ = [("a", _ASrc), ("mode", _int), ("taps", _int), ("d", _vp), ("ldd", _ll),
                ("rows", _ll), ("k", _int), ("n", _int), ("d_col", _int),
                ("chunk_rows", _int), ("part", _vp)]


class _BnBwdArgs(ctypes.Structure):
    _fields_ = [("g", _vp), ("c", _vp), ("ld", _ll), ("k", _vp), ("da", _vp), ("db", _vp),
                ("mean", _vp), ("inv", _vp), ("out", _vp), ("ldo", _ll), ("rows", _ll),
                ("n", _int), ("out_col", _int)]


@functools.lru_cache(maxsize=None)
def _lib():
    from rxtpu_torch.ops._build import load_library

    lib = load_library("fused_block")
    for name, args in (("rxtpu_fb_pipe_gemm", _GemmArgs), ("rxtpu_fb_pipe_wgrad", _WgradArgs),
                       ("rxtpu_fb_bn_backward", _BnBwdArgs)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(args), _vp]
        fn.restype = _int
    lib.rxtpu_fb_reduce.argtypes = [_vp, _vp, _vp, _int, _ll, _vp]
    lib.rxtpu_fb_reduce.restype = _int
    return lib


def _p(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(what: str, t: torch.Tensor, fn, *args) -> None:
    """``fn(*args, stream)`` with ``t``'s device current (the launches and
    their shared-memory limits use the current device) on its current stream."""
    with torch.cuda.device(t.device):
        err = fn(*args, torch._C._cuda_getCurrentRawStream(t.device.index))
    if err != 0:
        raise RuntimeError(f"fused_block {what} launch failed: CUDA error {err}")


def _a(src, *, col=0, kc=0, scale=None, shift=None, height=0, width=0) -> _ASrc:
    return _ASrc(_p(src), src.shape[1], col, kc, _p(scale), _p(shift), height, width)


def _reduce(part: torch.Tensor) -> torch.Tensor:
    """``[chunks, *shape]`` f32 partials -> their sum ``shape``, summed in a
    fixed order."""
    chunks, size = part.shape[0], part[0].numel()
    out = torch.empty(part.shape[1:], dtype=F32, device=part.device)
    # above 64 partials a first pass sums groups of 64 into tmp
    tmp = torch.empty((-(-chunks // 64), size), dtype=F32, device=part.device) if chunks > 64 \
        else out
    _launch("reduce", part, _lib().rxtpu_fb_reduce, _p(part), _p(tmp), _p(out), chunks, size)
    return out


def _gemm(mode, epi, a: _ASrc, w, rows, device, *, w2=None, out=None, out_col=0, aux0=None,
          aux1=None, add_g3=False, e_scale=None, e_shift=None, e_mean=None, e_inv=None, e_k=None,
          e_da=None, e_db=None):
    """``out[r, n] = sum_k A(r, k) W[k, n]`` with epilogue ``epi``, ``W = w``
    ``[k, n]``, or for the pairs in ``_WT_PAIRS`` ``W^T = [w | w2]`` ``[n,
    k]``, or for the adjoint 3x3 conv ``W^T = [w[0] | ... | w[8]]`` with ``w``
    ``[9, n, k / 9]`` (w2 as stored); returns the per-channel sums (two
    ``[n]`` vectors) for the epilogues that take them."""
    wt = (mode, epi) in _WT_PAIRS
    if mode == _TAP_ADJOINT:
        k, n, k_split = 9 * w.shape[2], w.shape[1], 0
    elif wt:
        k, n = w.shape[1] + (0 if w2 is None else w2.shape[1]), w.shape[0]
        k_split = w.shape[1]
    else:
        (k, n), k_split = w.shape, 0
    row_tile = _ROW_TILES[(mode, epi)]
    tiles = -(-rows // row_tile)
    if tiles > 65535:  # one grid row per tile of rows
        raise ValueError(f"the fused_block kernels take at most {65535 * row_tile} rows, got "
                         f"{rows}")
    # both sums of a tile side by side: one reduction
    part = torch.empty((tiles, 2, n), dtype=F32, device=device) if epi in _SUM_EPIS else None
    args = _GemmArgs(
        a=a, w=_p(w), rows=rows, k=k, n=n, mode=mode, epi=epi, out=_p(out),
        ldo=0 if out is None else out.shape[1], out_col=out_col, add_g3=int(add_g3),
        aux0=_p(aux0), aux1=_p(aux1), ldaux=0 if aux0 is None else aux0.shape[1],
        e_scale=_p(e_scale), e_shift=_p(e_shift), e_mean=_p(e_mean), e_inv=_p(e_inv),
        e_k=_p(e_k), e_da=_p(e_da), e_db=_p(e_db),
        part0=_p(part), w2=_p(w2), k_split=k_split)
    _launch("gemm", w, _lib().rxtpu_fb_pipe_gemm, ctypes.byref(args))
    return None if part is None else tuple(_reduce(part))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _wgrad_chunk_rows(rows: int, k: int, n: int, device: torch.device) -> int:
    """Rows per partial of the pipelined 1x1 weight gradient: enough chunks
    that chunks x output tiles fill two waves of two blocks per SM."""
    tiles = (k // (128 if k % 128 == 0 else 64)) * (n // (128 if n % 128 == 0 else 64))
    chunks = max(1, -(-4 * _sm_count(device) // tiles))
    return -(-rows // (chunks * _PIPE_ROWS)) * _PIPE_ROWS or _PIPE_ROWS


def _tap_chunk_rows(rows: int, k: int, n: int, device: torch.device) -> int:
    """Rows per partial of the 9-tap weight gradient (dw2). The blocks
    (chunks x 9 taps x output tiles) run in waves of two per SM, so the
    rows take ``waves / chunks`` of the products' time; each chunk's f32
    partials [9, k, n], written and read back at 3.35 TB/s, add about
    ``120 / rows`` of it (against 18 rows k n operations at some 100
    TFLOP/s). The chunk count, up to four waves' worth, that costs least:
    a last wave nearly full, without a third of the bytes in partials."""
    units = 9 * (k // (128 if k % 128 == 0 else 64)) * (n // (128 if n % 128 == 0 else 64))
    slots = 2 * _sm_count(device)
    chunks = min(range(1, max(1, 4 * slots // units) + 1),
                 key=lambda c: -(-c * units // slots) / c + c * 120 / rows)
    return -(-rows // (chunks * _PIPE_ROWS)) * _PIPE_ROWS or _PIPE_ROWS


def _wgrad(mode, a: _ASrc, k, d, n, rows, *, d_col=0, taps=1) -> torch.Tensor:
    """``dW[k, n] = sum_r A(r, k) d[r, d_col + n]``, or per 3x3 tap with
    ``taps=9`` (``_TAP_BN_RELU``): ``[9, k, n]``."""
    chunk_rows = (_tap_chunk_rows(rows, k, n, d.device) if taps > 1
                  else _wgrad_chunk_rows(rows, k, n, d.device))
    chunks = -(-rows // chunk_rows)
    part = torch.empty((chunks, taps, k, n), dtype=F32, device=d.device)
    args = _WgradArgs(a=a, mode=mode, taps=taps, d=_p(d), ldd=d.shape[1], rows=rows, k=k, n=n,
                      d_col=d_col, chunk_rows=chunk_rows, part=_p(part))
    _launch("wgrad", d, _lib().rxtpu_fb_pipe_wgrad, ctypes.byref(args))
    out = _reduce(part)
    return out if taps > 1 else out[0]


def _bn_bwd(g, c, k, da, db, mean, inv, out, out_col=0) -> None:
    """``out[:, out_col:out_col + n] = bf16(k*(g - da - ((c - mean)*inv)*db))``."""
    rows, n = g.shape
    args = _BnBwdArgs(g=_p(g), c=_p(c), ld=n, k=_p(k), da=_p(da), db=_p(db), mean=_p(mean),
                      inv=_p(inv), out=_p(out), ldo=out.shape[1], rows=rows, n=n,
                      out_col=out_col)
    _launch("bn_backward", g, _lib().rxtpu_fb_bn_backward, ctypes.byref(args))


# ---------------------------------------------------------------------------
# The wrappers: the kernels for CUDA tensors, the plain versions for CPU ones
# ---------------------------------------------------------------------------


def _on_card(name: str, slabs, mats, vecs) -> bool:
    """Check the operands; True for CUDA tensors (launch the kernels), False
    for CPU tensors (use the plain version); raise for any other device."""
    device = slabs[0].device
    for t in (*slabs, *mats, *vecs):
        if t is not None and t.device != device:
            raise ValueError(f"{name}: operands on {t.device} and {device}")
    for t in (*slabs, *mats):
        if t is not None and t.dtype != BF16:
            raise ValueError(f"{name}: slabs and weights must be bfloat16, got {t.dtype}")
    for t in vecs:
        if t is not None and (t.dtype != F32 or t.ndim != 1):
            raise ValueError(f"{name}: per-channel vectors must be 1-D float32, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {device}")
    present = [t for t in (*slabs, *mats, *vecs) if t is not None]
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in present):
        raise ValueError(f"{name}: the CUDA kernels take contiguous, 16-byte aligned tensors")
    channels = [d for t in slabs if t is not None for d in t.shape[1:]]
    channels += [d for t in mats if t is not None for d in t.shape]
    if any(d % KERNEL_CHANNELS for d in channels):
        raise ValueError(f"{name}: the CUDA kernels take channel counts that are multiples "
                         f"of {KERNEL_CHANNELS}, got {channels}")
    return True


def _check_plane(name, rows, height, width):
    if height * width == 0 or rows % (height * width):
        raise ValueError(f"{name}: {rows} rows are not whole {height}x{width} planes")


def k1(x, w1, wp=None):
    """K6.1 (``_k1_kernel``): ``(c1, s1, q1[, sp, qp])`` of ``x [R, C]``,
    ``w1 [C, F]`` (and ``wp [C, 4F]``), as ``k1_reference``."""
    if not _on_card("k1", [x], [w1, wp], []):
        return k1_reference(x, w1, wp)
    rows = x.shape[0]
    c1 = torch.empty((rows, w1.shape[1]), dtype=BF16, device=x.device)
    out = (c1, *_gemm(_STORED, _STORE_STATS, _a(x), w1, rows, x.device, out=c1))
    if wp is not None:
        out += _gemm(_STORED, _STATS, _a(x), wp, rows, x.device)
    k1.launches += 1
    return out


def k2(c1, sc1, sh1, w2, height, width):
    """K6.2 (``_k2_kernel``): ``(c2, s2, q2)`` of ``c1 [R, F]`` and ``w2 [9,
    F, F]`` over planes of ``height x width``, as ``k2_reference``."""
    _check_plane("k2", c1.shape[0], height, width)
    if not _on_card("k2", [c1], [w2.reshape(-1, w2.shape[-1])], [sc1, sh1]):
        return k2_reference(c1, sc1, sh1, w2, height, width)
    rows, f = c1.shape
    c2 = torch.empty_like(c1)
    a = _a(c1, kc=f, scale=sc1, shift=sh1, height=height, width=width)
    out = (c2, *_gemm(_TAP_BN_RELU, _STORE_STATS, a, w2.reshape(9 * f, f), rows, c1.device,
                      out=c2))
    k2.launches += 1
    return out


def k3(c2, sc2, sh2, w3):
    """K6.3 (``_k3_kernel``): ``(s3, q3)``, as ``k3_reference``."""
    if not _on_card("k3", [c2], [w3], [sc2, sh2]):
        return k3_reference(c2, sc2, sh2, w3)
    out = _gemm(_BN_RELU, _STATS, _a(c2, scale=sc2, shift=sh2), w3, c2.shape[0], c2.device)
    k3.launches += 1
    return out


def k4(c2, x, sc2, sh2, w3, sc3, sh3, wp=None, scp=None, shp=None):
    """K6.4 (``_k4_kernel``): ``y [R, 4F]``, as ``k4_reference``."""
    if not _on_card("k4", [c2, x], [w3, wp], [sc2, sh2, sc3, sh3, scp, shp]):
        return k4_reference(c2, x, sc2, sh2, w3, sc3, sh3, wp, scp, shp)
    rows, n = c2.shape[0], w3.shape[1]
    res = x
    if wp is not None:
        res = torch.empty((rows, n), dtype=BF16, device=x.device)
        _gemm(_STORED, _RESIDUAL, _a(x), wp, rows, x.device, out=res, e_scale=scp, e_shift=shp)
    y = torch.empty((rows, n), dtype=BF16, device=x.device)
    _gemm(_BN_RELU, _OUTPUT, _a(c2, scale=sc2, shift=sh2), w3, rows, x.device, out=y, aux0=res,
          e_scale=sc3, e_shift=sh3)
    k4.launches += 1
    return y


def b1(dy, y, c2, sc2, sh2, w3, m3, i3, x=None, wp=None, mp=None, ip=None):
    """K7.1 (``_b1_kernel``): ``(s3a, s3b[, spb])``, as ``b1_reference``."""
    if not _on_card("b1", [dy, y, c2, x], [w3, wp], [sc2, sh2, m3, i3, mp, ip]):
        return b1_reference(dy, y, c2, sc2, sh2, w3, m3, i3, x, wp, mp, ip)
    rows = c2.shape[0]
    out = _gemm(_BN_RELU, _BN_SUMS, _a(c2, scale=sc2, shift=sh2), w3, rows, c2.device, aux0=dy,
                aux1=y, e_mean=m3, e_inv=i3)
    if wp is not None:
        out += _gemm(_STORED, _BN_SUMS, _a(x), wp, rows, c2.device, aux0=dy, aux1=y, e_mean=mp,
                     e_inv=ip)[1:]
    b1.launches += 1
    return out


def b2(dy, y, c2, sc2, sh2, w3, m3, i3, k3, d3a, d3b, m2, i2):
    """K7.2 (``_b2_kernel``): ``(g2, dw3, s2a, s2b)``, as ``b2_reference``;
    dc3 goes through device memory."""
    if not _on_card("b2", [dy, y, c2], [w3], [sc2, sh2, m3, i3, k3, d3a, d3b, m2, i2]):
        return b2_reference(dy, y, c2, sc2, sh2, w3, m3, i3, k3, d3a, d3b, m2, i2)
    rows, f = c2.shape
    dc3 = torch.empty_like(dy)
    a2 = _a(c2, scale=sc2, shift=sh2)
    _gemm(_BN_RELU, _BN_BACKWARD, a2, w3, rows, c2.device, out=dc3, aux0=dy, aux1=y, e_mean=m3,
          e_inv=i3, e_k=k3, e_da=d3a, e_db=d3b)
    g2 = torch.empty_like(c2)
    s2a, s2b = _gemm(_STORED, _RELU_GRAD, _a(dc3), w3, rows, c2.device, out=g2, aux0=c2,
                     e_scale=sc2, e_shift=sh2, e_mean=m2, e_inv=i2)
    dw3 = _wgrad(_BN_RELU, a2, f, dc3, w3.shape[1], rows)
    b2.launches += 1
    return g2, dw3, s2a, s2b


def b3(g2, c1, c2, sc1, sh1, k2, d2a, d2b, m2, i2, w2, m1, i1, height, width):
    """K7.3 (``_b3_kernel``): ``(g1, dw2, s1a, s1b)``, as ``b3_reference``;
    dc2 goes through device memory."""
    _check_plane("b3", c1.shape[0], height, width)
    if not _on_card("b3", [g2, c1, c2], [w2.reshape(-1, w2.shape[-1])],
                    [sc1, sh1, k2, d2a, d2b, m2, i2, m1, i1]):
        return b3_reference(g2, c1, c2, sc1, sh1, k2, d2a, d2b, m2, i2, w2, m1, i1, height,
                            width)
    rows, f = c1.shape
    dc2 = torch.empty_like(c2)
    _bn_bwd(g2, c2, k2, d2a, d2b, m2, i2, dc2)
    g1 = torch.empty_like(c1)
    s1a, s1b = _gemm(_TAP_ADJOINT, _RELU_GRAD, _a(dc2, kc=f, height=height, width=width), w2,
                     rows, c1.device, out=g1, aux0=c1, e_scale=sc1, e_shift=sh1, e_mean=m1,
                     e_inv=i1)
    a1 = _a(c1, kc=f, scale=sc1, shift=sh1, height=height, width=width)
    dw2 = _wgrad(_TAP_BN_RELU, a1, f, dc2, f, rows, taps=9)
    b3.launches += 1
    return g1, dw2, s1a, s1b


def b4(g1, c1, x, dy, y, k1, d1a, d1b, m1, i1, w1, wp=None, kp=None, dpa=None, dpb=None,
       mp=None, ip=None):
    """K7.4 (``_b4_kernel``): ``(dx, dw1[, dwp])``, as ``b4_reference``; dc1
    and dcp go through device memory side by side, so dx is one GEMM over
    ``[dc1 | dcp] [w1 | wp]^T``."""
    if not _on_card("b4", [g1, c1, x, dy, y], [w1, wp],
                    [k1, d1a, d1b, m1, i1, kp, dpa, dpb, mp, ip]):
        return b4_reference(g1, c1, x, dy, y, k1, d1a, d1b, m1, i1, w1, wp, kp, dpa, dpb, mp, ip)
    rows, c = x.shape
    f = c1.shape[1]
    n4 = 0 if wp is None else wp.shape[1]
    dc = torch.empty((rows, f + n4), dtype=BF16, device=x.device)  # [dc1 | dcp]
    _bn_bwd(g1, c1, k1, d1a, d1b, m1, i1, dc)
    if wp is not None:
        _gemm(_STORED, _BN_BACKWARD, _a(x), wp, rows, x.device, out=dc, out_col=f, aux0=dy,
              aux1=y, e_mean=mp, e_inv=ip, e_k=kp, e_da=dpa, e_db=dpb)
    dx = torch.empty_like(x)
    _gemm(_STORED, _INPUT_GRAD, _a(dc), w1, rows, x.device, w2=wp, out=dx, aux0=dy, aux1=y,
          add_g3=wp is None)
    out = (dx, _wgrad(_STORED, _a(x), c, dc, f, rows))
    if wp is not None:
        out += (_wgrad(_STORED, _a(x), c, dc, n4, rows, d_col=f),)
    b4.launches += 1
    return out


BODIES = (k1, k2, k3, k4, b1, b2, b3, b4)
for _body in BODIES:
    _body.launches = 0


# ---------------------------------------------------------------------------
# The autograd Function
# ---------------------------------------------------------------------------


class Folded(NamedTuple):
    """One BN's batch statistics and folded affine, 1-D f32 per channel."""

    mean: torch.Tensor
    var: torch.Tensor
    inv: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor


def _group_sums(group, *sums: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Per-channel sums -> their sums over ``group``, in one all-reduce
    (unchanged without a group)."""
    if group is None:
        return sums
    flat = torch.cat(sums)
    dist.all_reduce(flat, group=group)
    return flat.split([t.numel() for t in sums])


def finalize(s, q, gamma, beta, count: float, eps: float) -> Folded:
    """rxtpu's ``_finalize``: batch statistics and the folded ``scale``,
    ``shift`` from the sums (one-pass variance, clamped at 0)."""
    mean = s / count
    var = torch.clamp_min(q / count - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    scale = gamma * inv
    return Folded(mean, var, inv, scale, beta - mean * scale)


_PARAMS = ("w1", "w2", "w3", "g1", "b1", "g2", "b2", "g3", "b3", "wp", "gp", "bp")


class BottleneckFused(torch.autograd.Function):
    """``forward(ctx, x, height, width, eps, group, w1, w2, w3, g1, b1, g2,
    b2, g3, b3, wp, gp, bp)`` -> ``y`` and the batch ``(mean, var)`` of bn1,
    bn2, bn3 (and bnp), the statistics without a gradient; over the rows of
    every rank of ``group`` (None: this rank's).

    ``x`` is a bf16 ``[R, C]`` slab; the weights are in the kernels' layouts
    (``w1 [C, F]``, ``w2 [9, F, F]``, ``w3 [F, 4F]``, ``wp [C, 4F]``; ``wp``,
    ``gp``, ``bp`` None without the projection) in any float dtype. Inside,
    autocast is off and every cast is explicit: bf16 activations and weight
    copies, f32 statistics. The backward returns ``dx`` in bf16 and each
    parameter's gradient in its own dtype.
    """

    @staticmethod
    def forward(ctx, x, height, width, eps, group, w1, w2, w3, g1, b1, g2, b2, g3, b3, wp=None,
                gp=None, bp=None):
        with torch.autocast(x.device.type, enabled=False):
            count = float(x.shape[0] * (1 if group is None else dist.get_world_size(group)))
            w1b, w2b, w3b = (w.to(BF16).contiguous() for w in (w1, w2, w3))
            wpb = None if wp is None else wp.to(BF16).contiguous()

            def fold(s, q, gamma, beta):
                return finalize(s, q, gamma.to(F32), beta.to(F32), count, eps)

            c1, *s1 = k1(x, w1b, wpb)
            s1 = _group_sums(group, *s1)
            f1 = fold(s1[0], s1[1], g1, b1)
            fp = None if wp is None else fold(s1[2], s1[3], gp, bp)
            c2, s2, q2 = k2(c1, f1.scale, f1.shift, w2b, height, width)
            f2 = fold(*_group_sums(group, s2, q2), g2, b2)
            f3 = fold(*_group_sums(group, *k3(c2, f2.scale, f2.shift, w3b)), g3, b3)
            y = k4(c2, x, f2.scale, f2.shift, w3b, f3.scale, f3.shift, wpb,
                   *((None, None) if fp is None else (fp.scale, fp.shift)))
        folded = [f1, f2, f3] + ([] if fp is None else [fp])
        ctx.height, ctx.width, ctx.group = height, width, group
        ctx.dtypes = [None if t is None else t.dtype for t in (w1, w2, w3, g1, b1, g2, b2, g3, b3,
                                                               wp, gp, bp)]
        ctx.save_for_backward(x, c1, c2, y, w1b, w2b, w3b, wpb,
                              *(t for f in folded for t in (f.mean, f.inv, f.scale, f.shift)))
        stats = [t for f in folded for t in (f.mean, f.var)]
        ctx.mark_non_differentiable(*stats)
        return (y, *stats)

    @staticmethod
    def backward(ctx, dy, *_stats_grads):
        x, c1, c2, y, w1b, w2b, w3b, wpb, *flat = ctx.saved_tensors
        f1, f2, f3, fp = (flat[i:i + 4] for i in range(0, 16, 4))  # (mean, inv, scale, shift)
        proj = wpb is not None
        group = ctx.group
        with torch.autocast(x.device.type, enabled=False):
            count = float(x.shape[0] * (1 if group is None else dist.get_world_size(group)))
            dy = dy.to(BF16).contiguous()
            r1 = b1(dy, y, c2, f2[2], f2[3], w3b, f3[0], f3[1],
                    *((x, wpb, fp[0], fp[1]) if proj else ()))
            s3a, s3b = r1[:2]
            m3 = [t / count for t in _group_sums(group, *r1)]  # (s3a, s3b[, spb]) over the group
            g2, dw3, s2a, s2b = b2(dy, y, c2, f2[2], f2[3], w3b, f3[0], f3[1], f3[2], m3[0],
                                   m3[1], f2[0], f2[1])
            m2 = [t / count for t in _group_sums(group, s2a, s2b)]
            g1, dw2, s1a, s1b = b3(g2, c1, c2, f1[2], f1[3], f2[2], m2[0], m2[1],
                                   f2[0], f2[1], w2b, f1[0], f1[1], ctx.height, ctx.width)
            m1 = [t / count for t in _group_sums(group, s1a, s1b)]
            proj_args = (wpb, fp[2], m3[0], m3[2], fp[0], fp[1]) if proj else ()
            dx, dw1, *dwp = b4(g1, c1, x, dy, y, f1[2], m1[0], m1[1], f1[0], f1[1],
                               w1b, *proj_args)
        # the affine parameters' gradients: this rank's sums
        grads = [dw1, dw2, dw3, s1b, s1a, s2b, s2a, s3b, s3a]
        # the same upstream g3 feeds both paths: bp's gradient is b3's
        grads += [dwp[0], r1[2], s3a] if proj else [None, None, None]
        grads = [None if g is None else g.to(dt) for g, dt in zip(grads, ctx.dtypes)]
        return (dx, None, None, None, None, *grads)


def bottleneck_fused(x: torch.Tensor, params: Dict[str, torch.Tensor], height: int, width: int,
                     eps: float = 1e-5, group=None):
    """The fused train-mode bottleneck on ``x [V, H*W, C]`` (cast to bf16):
    ``(y [V, H*W, 4F] bf16, stats)`` with ``stats`` mapping bn1, bn2, bn3
    (and bnp) to their batch ``(mean, var)``, as rxtpu's ``bottleneck_fused``
    (without its pad rows). ``params``: w1 ``[C, F]``, w2 ``[9, F, F]``
    (taps in ``(ky, kx)`` row-major order), w3 ``[F, 4F]``, g1/b1, g2/b2,
    g3/b3, and wp ``[C, 4F]``, gp/bp for the projection. ``group``: the
    process group whose ranks' rows make up the batch (SyncBN)."""
    v, p, c = x.shape
    if p != height * width:
        raise ValueError(f"x has {p} pixels per view, not {height}x{width}")
    out = BottleneckFused.apply(x.reshape(v * p, c).to(BF16), height, width, eps, group,
                                *(params.get(k) for k in _PARAMS))
    y, stats = out[0], out[1:]
    keys = ("bn1", "bn2", "bn3", "bnp")
    return y.reshape(v, p, -1), {k: stats[2 * i:2 * i + 2] for i, k in
                                 enumerate(keys[:len(stats) // 2])}
