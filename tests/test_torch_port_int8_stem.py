"""K8's stem entry (``rxtpu_torch.ops.int8_conv.int8_stem_conv``) on the CPU.

- ``pack_stem_weight``: ``[Cout, 7*7*Cin]`` -> ``[Cout, 7, 8, 8]`` with tap 7
  and the channels past Cin zero, and back;
- an emulation of the CUDA kernel's patch and K order: per tile of 128
  output pixels of one output row, the patch ``[7][262][8]`` built from the
  views' 8-column groups as the kernel builds it (input column
  ``2*ox0 - 8 + 8*grp + i`` to patch column ``8*grp + i - 5``, zero outside
  the image and past Cin), output pixel j's row of A at kernel row ky read
  at byte ``(ky*262 + 2*j)*8`` of the patch (the kernel's ldmatrix
  address), times the packed weights in int64: equal to the exact sums
  ``int8_conv_sums`` on a plain shape, an odd 513 x 511 and an image
  narrower than one tile;
- the plain version from bf16 and from int8 NCHW views against rxtpu's
  ``QuantConv`` on the stem, bit for bit, over the forward's epilogues;
- the argument checks and ``QuantStemConv``'s packed buffer.

The kernel runs only on a card: the ``gpu`` test in
``test_torch_port_quant.py`` holds it against the plain version there.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxtpu.models.quant import QuantConv as RxQuantConv
from rxtpu_torch.models.quant import QuantStemConv
from rxtpu_torch.ops.int8_conv import (
    int8_conv_sums, int8_stem_conv, int8_stem_conv_reference, pack_stem_weight, quantize,
    unpack_stem_weight,
)

TILE, PATCH_COLS, GROUPS = 128, 262, 34  # the kernel's tile, patch width, 8-column groups


def _views(rng, n, cin, h, w):
    """bf16 NCHW views spread so that quantizing at 1/32 clips some and
    lands many on .5 ties."""
    x = torch.from_numpy(rng.normal(0.0, 2.0, (n, cin, h, w)).astype(np.float32))
    return x.to(torch.bfloat16)


def _weights(rng, cout, cin):
    return torch.from_numpy(rng.integers(-127, 128, (cout, 49 * cin), dtype=np.int8))


def _kernel_patch(x8: np.ndarray, img: int, oy: int, ox0: int) -> np.ndarray:
    """The tile's patch [7][262][8] as the kernel builds it from int8 views
    x8 [N, Cin, H, W]."""
    _, cin, h, w = x8.shape
    patch = np.full((7, PATCH_COLS, 8), 99, np.int8)  # every byte must be written
    for ky in range(7):
        iy = 2 * oy - 3 + ky
        for grp in range(GROUPS):
            for i in range(8):
                pc = 8 * grp + i - 5
                if not 0 <= pc < PATCH_COLS:
                    continue
                ix = 2 * ox0 - 8 + 8 * grp + i
                col = np.zeros(8, np.int8)
                if 0 <= iy < h and 0 <= ix < w:
                    col[:cin] = x8[img, :, iy, ix]
                patch[ky, pc] = col
    return patch


def _kernel_sums(x8: np.ndarray, packed: np.ndarray) -> np.ndarray:
    """The kernel's sums [N, Ho, Wo, Cout] in int64: the A rows read from
    each tile's patch at the ldmatrix addresses, times the packed weights.
    The patch of the tile at (oy, ox0) is the view of one padded image row
    band starting at input column 2*ox0 - 3, so one padded array serves
    every tile (the test holds tiles built as the kernel builds them to it)."""
    n, cin, h, w = x8.shape
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    wp = 2 * TILE * ((wo + TILE - 1) // TILE) + 6
    padded = np.zeros((n, h + 6, wp, 8), np.int8)  # input (y, x) at (y + 3, x + 3)
    padded[:, 3:3 + h, 3:3 + w, :cin] = x8.transpose(0, 2, 3, 1)
    out = np.zeros((n, ho, wo, packed.shape[0]), np.int64)
    wk = packed.reshape(packed.shape[0], -1).astype(np.int64).T  # [448, Cout]
    for img in range(n):
        for oy in range(ho):
            for ox0 in range(0, wo, TILE):
                band = padded[img, 2 * oy:2 * oy + 7, 2 * ox0:2 * ox0 + PATCH_COLS]
                flat = band.reshape(-1)
                rows = min(TILE, wo - ox0)
                a = np.stack([np.concatenate([flat[(ky * PATCH_COLS + 2 * j) * 8:][:64]
                                              for ky in range(7)]) for j in range(rows)])
                out[img, oy, ox0:ox0 + rows] = a.astype(np.int64) @ wk
    return out


STEM_SHAPES = [(2, 6, 64, 64), (1, 6, 513, 511), (2, 6, 37, 21)]


@pytest.mark.parametrize("shape", STEM_SHAPES, ids=["64x64", "513x511", "37x21"])
def test_kernel_patch_and_k_order_give_the_exact_sums(shape):
    """The kernel's patch, its A addresses and the packed weights' K order
    give int8_conv_sums, exactly; the first and last tiles' patches built
    group by group as the kernel does equal the padded band the emulation
    reads."""
    rng = np.random.default_rng(sum(shape))
    n, cin, h, w = shape
    x8 = rng.integers(-127, 128, shape, dtype=np.int8)
    kq = _weights(rng, 16, cin)
    packed = pack_stem_weight(kq).numpy()
    want = int8_conv_sums(torch.from_numpy(x8).permute(0, 2, 3, 1), kq, 7, 2, 3)
    got = _kernel_sums(x8, packed)
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))
    ho, wo = want.shape[1:3]
    wp = 2 * TILE * ((wo + TILE - 1) // TILE) + 6
    padded = np.zeros((h + 6, wp, 8), np.int8)
    padded[3:3 + h, 3:3 + w, :cin] = x8[n - 1].transpose(1, 2, 0)
    last_x0 = (wo - 1) // TILE * TILE
    for oy, ox0 in ((0, 0), (ho - 1, last_x0), (ho // 2, last_x0)):
        band = padded[2 * oy:2 * oy + 7, 2 * ox0:2 * ox0 + PATCH_COLS]
        np.testing.assert_array_equal(_kernel_patch(x8, n - 1, oy, ox0), band)


def test_pack_stem_weight_layout():
    rng = np.random.default_rng(0)
    for cin in (6, 3, 8):
        kq = _weights(rng, 64, cin)
        packed = pack_stem_weight(kq)
        assert packed.shape == (64, 7, 8, 8) and packed.dtype == torch.int8
        assert not packed[:, :, 7].any() and not packed[:, :, :, cin:].any()
        ref = kq.reshape(64, 7, 7, cin)  # (ky, kx, ci), rxtpu's K order
        assert torch.equal(packed[:, :, :7, :cin], ref)
        assert torch.equal(unpack_stem_weight(packed, cin), kq)
    for bad in ((64, 49 * 9), (64, 50), (64, 49 * 6 + 1)):
        with pytest.raises(ValueError, match="stem kernel_q"):
            pack_stem_weight(torch.zeros(bad, dtype=torch.int8))


# (requantize, relu): the stem's epilogue in the forward, and the others
STEM_EPILOGUES = [(True, True), (True, False), (False, True), (False, False)]


def _rx_stem(x_nhwc, kq, w_scale, bias, in_scale, requant, relu, out_scale):
    cout = kq.shape[0]
    mod = RxQuantConv(features=cout, kernel_size=(7, 7), strides=(2, 2),
                      padding=[(3, 3), (3, 3)], dtype=jnp.float32)
    params = {"params": {
        "kernel_q": jnp.asarray(kq.numpy().reshape(cout, 7, 7, -1).transpose(1, 2, 3, 0)),
        "w_scale": jnp.asarray(w_scale.numpy()), "bias": jnp.asarray(bias.numpy()),
        "in_scale": jnp.asarray(in_scale.numpy())}}
    out = mod.apply(params, x_nhwc, out_scale=jnp.asarray(out_scale.numpy()) if requant else None,
                    relu_out=relu)
    return np.asarray(out[0] if requant else out)


@pytest.mark.parametrize("views", ["bf16", "int8"])
def test_stem_reference_matches_rxtpu_quantconv(views):
    """The stem entry (its plain version on the CPU) from NCHW views against
    rxtpu's QuantConv on the NHWC views: bf16 views quantized at in_scale
    (rxtpu quantizes them inside its QuantConv), or int8 views at in_scale
    (quantize-at-source). Every epilogue bit-equal."""
    rng = np.random.default_rng(7)
    x = _views(rng, 2, 6, 23, 30)
    kq = _weights(rng, 16, 6)
    w_scale = torch.from_numpy(rng.uniform(0.5, 1.5, 16).astype(np.float32) / 127.0)
    bias = torch.from_numpy(rng.normal(0.0, 1.0, 16).astype(np.float32))
    in_scale = torch.tensor(1.0 / 32.0)
    out_scale = torch.tensor(0.15)
    packed = pack_stem_weight(kq)
    if views == "int8":
        x = quantize(x, in_scale)
        rx_x = (jnp.asarray(x.permute(0, 2, 3, 1).numpy()), jnp.asarray(in_scale.numpy()))
    else:
        rx_x = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy()).astype(jnp.bfloat16)
        assert int((x.float() * 32).abs().gt(127).sum()) > 0  # some clip
        assert int((x.float() * 32 % 1 == 0.5).sum()) > 100  # and many are ties
    for requant, relu in STEM_EPILOGUES:
        got = int8_stem_conv(x, packed, w_scale * in_scale, bias, in_scale, relu=relu,
                             inv_out_scale=(1.0 / out_scale) if requant else None,
                             out_dtype=torch.float32)
        want = _rx_stem(rx_x, kq, w_scale, bias, in_scale, requant, relu, out_scale)
        assert got.shape == want.shape == (2, 12, 15, 16)
        np.testing.assert_array_equal(got.numpy(), want)
        if requant:
            assert np.abs(want).max() == 127 and (want == 0).any()


def test_stem_reference_is_quantize_permute_conv():
    """The plain version is quantize + permute + int8_conv_reference, and
    bf16 views give what their int8 quantization gives."""
    rng = np.random.default_rng(3)
    x = _views(rng, 1, 6, 19, 17)
    kq = _weights(rng, 8, 6)
    scale = torch.full((8,), 1e-3)
    bias = torch.linspace(-1.0, 1.0, 8)
    in_scale = torch.tensor(0.05)
    packed = pack_stem_weight(kq)
    got = int8_stem_conv_reference(x, packed, scale, bias, in_scale, relu=True)
    acc = int8_conv_sums(quantize(x, in_scale).permute(0, 2, 3, 1), kq, 7, 2, 3)
    want = torch.relu(acc.float() * scale + bias).to(torch.bfloat16)
    assert torch.equal(got, want)
    assert torch.equal(got, int8_stem_conv(quantize(x, in_scale), packed, scale, bias,
                                           relu=True))


def test_int8_stem_conv_argument_checks():
    x = torch.zeros(1, 6, 16, 16, dtype=torch.bfloat16)
    packed = torch.zeros(4, 7, 8, 8, dtype=torch.int8)
    one = torch.ones(4)
    s = torch.tensor(0.1)
    with pytest.raises(ValueError, match="Cin <= 8"):
        int8_stem_conv(torch.zeros(1, 9, 16, 16), packed, one, one, s)
    with pytest.raises(ValueError, match="x must be"):
        int8_stem_conv(x.to(torch.float16), packed, one, one, s)
    with pytest.raises(ValueError, match="pack_stem_weight"):
        int8_stem_conv(x, torch.zeros(4, 294, dtype=torch.int8), one, one, s)
    with pytest.raises(ValueError, match="in_scale"):
        int8_stem_conv(x, packed, one, one)
    with pytest.raises(ValueError, match="out_dtype"):
        int8_stem_conv(x, packed, one, one, s, out_dtype=torch.float16)
    out = int8_stem_conv(x, packed, one, one, s, inv_out_scale=torch.tensor(2.0))
    assert out.dtype == torch.int8 and tuple(out.shape) == (1, 8, 8, 4)
    assert tuple(int8_stem_conv(x[..., :15, :9], packed, one, one, s).shape) == (1, 8, 5, 4)


def test_quant_stem_conv_packs_its_kernel_on_load():
    """``kernel_stem`` is kernel_q packed, is not in the state dict, and is
    packed anew by load_state_dict (also inside a parent module)."""
    stem = QuantStemConv(6, 16)
    sd = stem.state_dict()
    assert "kernel_stem" not in sd and sd["kernel_q"].shape == (16, 294)
    kq = _weights(np.random.default_rng(1), 16, 6)
    parent = torch.nn.Sequential(stem)
    parent.load_state_dict({f"0.{k}": (kq if k == "kernel_q" else v) for k, v in sd.items()})
    assert torch.equal(stem.kernel_stem, pack_stem_weight(kq))
    x = _views(np.random.default_rng(2), 1, 6, 12, 12)
    y, scale = stem(x, out_scale=torch.tensor(0.5), relu_out=True)
    want = int8_stem_conv_reference(x, pack_stem_weight(kq), stem.w_scale * stem.in_scale,
                                    stem.bias, stem.in_scale, relu=True,
                                    inv_out_scale=torch.tensor(2.0))
    assert float(scale) == 0.5 and torch.equal(y, want)
