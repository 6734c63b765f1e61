"""Least times of the port's hand-written kernels, frozen from the
``chip_smoke.py`` functions of the same names: bytes each kernel must move
against the memory rate, operations against the compute rate."""

from __future__ import annotations

import torch

from rxbench.peaks import BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S


def bound_ms(moved_bytes, f32_ops):
    """Least time for a function: its bytes over the memory rate against its
    f32 operations over the f32 rate; both bound a byte-bound kernel."""
    return max(moved_bytes / HBM_BYTES_PER_S, f32_ops / F32_FLOPS) * 1e3


def k1_bound_ms(n, crop, out_bytes):
    """K1: the cropped uint8 pixels and the per-plane scale/bias read once,
    the output written once; two f32 operations per pixel."""
    return bound_ms(n * crop * crop * (1 + out_bytes) + 2 * 4 * n, 2 * n * crop * crop)


def source_reads(k, n_out, n_in, pad_lo):
    """Distinct source elements that a shear pass must read, summed over its
    lines: the outputs of line i read the padded window [k_i, k_i + n_out],
    which reflect-101 folds back onto the n_in source elements of the line."""
    k = k.reshape(-1).long()
    window = torch.arange(n_out + 1, device=k.device) - pad_lo
    total = 0
    for chunk in k.split(16384):
        src = (chunk[:, None] + window).abs()  # the left mirror: -q -> q
        src = torch.where(src > n_in - 1, 2 * (n_in - 1) - src, src)
        seen = torch.zeros(len(chunk), n_in, dtype=torch.bool, device=k.device)
        total += int(seen.scatter_(1, src, True).sum())
    return total


def shear_bounds(kf, pads, p, h, w, crop):
    """Bytes and f32 operations of K2, K3, K4 on this run's (k, f): the
    source elements each pass's lines read (``source_reads``), each output
    written once, the k and f arrays (4 bytes each per line), scale/bias
    (and K4's flags) per plane. The lerp is 4 operations per output, the
    normalize 2 more."""
    r2 = source_reads(kf["shear_pass"][0], w, w, pads[0][0])
    r3 = source_reads(kf["shear_pass_rows"][0], crop, h, pads[1][0])
    r4 = source_reads(kf["shear_pass_finish"][0], crop, w, pads[2][0])
    k2 = (r2 * 1 + p * h * w * 4 + p * h * 8 + p * 8, 6 * p * h * w)
    k3 = (r3 * 4 + p * crop * w * 4 + p * w * 8, 4 * p * crop * w)
    k4 = (r4 * 4 + p * crop * crop * 2 + p * crop * 8 + p * 10, 6 * p * crop * crop)
    return {"shear_pass": k2, "shear_pass_rows": k3, "shear_pass_finish": k4}


# ResNet-50's stride-1 bottlenecks that K6/K7 fuse in a train step, at a
# 364 crop: (plane side, C, F, projection, blocks); 13 blocks in all
FUSED_BLOCKS = ((91, 64, 64, True, 1), (91, 256, 64, False, 2), (46, 512, 128, False, 3),
                (23, 1024, 256, False, 5), (12, 2048, 512, False, 2))
FUSED_BODIES = ("k1", "k2", "k3", "k4", "b1", "b2", "b3", "b4")


def fb_work(name, r, c, f, proj):
    """(bytes, operations) one body must move and do for a block of ``r``
    rows: each input (slabs, bf16 weights, f32 vectors) read once, each
    output written once; 2 operations per multiply-add of every product the
    body computes, its recomputed c3 and cp included."""
    n4 = 4 * f
    vec = 4  # bytes of one f32 per-channel value
    if name == "k1":
        moved, ops = r * c * 2 + c * f * 2 + r * f * 2 + 2 * f * vec, 2 * r * c * f
    elif name == "k2":
        moved = 2 * r * f * 2 + 9 * f * f * 2 + 4 * f * vec
        ops = 2 * r * 9 * f * f
    elif name == "k3":
        moved, ops = r * f * 2 + f * n4 * 2 + 2 * f * vec + 2 * n4 * vec, 2 * r * f * n4
    elif name == "k4":
        moved = r * f * 2 + r * c * 2 + f * n4 * 2 + 2 * f * vec + 2 * n4 * vec + r * n4 * 2
        ops = 2 * r * f * n4
    elif name == "b1":
        moved = 2 * r * n4 * 2 + r * f * 2 + f * n4 * 2 + 2 * f * vec + 4 * n4 * vec
        ops = 2 * r * f * n4
    elif name == "b2":
        moved = (2 * r * n4 * 2 + r * f * 2 + f * n4 * 2 + (4 * f + 5 * n4) * vec + r * f * 2
                 + f * n4 * 4)
        ops = 3 * 2 * r * f * n4  # c3, g2 = dc3 w3^T, dw3
    elif name == "b3":
        moved = 3 * r * f * 2 + 9 * f * f * 2 + 11 * f * vec + r * f * 2 + 9 * f * f * 4
        ops = 2 * 2 * r * 9 * f * f  # the adjoint conv and dw2
    else:
        moved = 2 * r * f * 2 + r * c * 2 + 2 * r * n4 * 2 + c * f * 2 + 5 * f * vec + r * c * 2
        moved += c * f * 4
        ops = 2 * 2 * r * c * f  # dx and dw1
    if proj and name in ("k1", "k4", "b1", "b4"):
        moved += c * n4 * 2 + 2 * n4 * vec
        ops += 2 * r * c * n4  # cp
        if name == "b4":
            moved += 4 * n4 * vec + c * n4 * 4
            ops += 2 * 2 * r * c * n4  # dcp wp^T and dwp
        if name == "b1":
            moved += r * c * 2 + n4 * vec
    return moved, ops


def fused_step_bound_ms(views: int) -> float:
    """The sum over the 13 fused blocks of a train step of ``views`` views
    of each body's least time, bytes against bf16 operations."""
    total = 0.0
    for side, c, f, proj, blocks in FUSED_BLOCKS:
        r = views * side * side
        for name in FUSED_BODIES:
            moved, ops = fb_work(name, r, c, f, proj)
            total += blocks * max(moved / HBM_BYTES_PER_S, ops / BF16_FLOPS) * 1e3
    return total
