#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rxtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending the run with a non-zero exit when it fails:

1. the card (nvidia-smi name and power limit) and the kernel build from
   ``rxtpu_torch/csrc`` (one compiler per source, all at once; ``jpeg_nv.cu``,
   the nvJPEG decoder, and ``inflate_host.cpp``, the PNG reader and the
   packs' codecs, with g++, among them), the host's JPEG libraries
   (libjpeg's header and library, nvJPEG's version) and its codec libraries
   (zlib's and zstd's headers and sonames, the codecs the port binds);
2. every kernel against its plain PyTorch version on the card, bit for bit:
   K1 (crop_norm) in bf16, int8 (with exact .5 ties) and f32 at the test
   shape and the 364 crop; K2-K4 (the shear passes) at the train shapes
   (288 planes of 512^2, crop 364 and an odd 363, shifts past both clamps,
   uint8 and f32 input, every reversal pair, f32 and bf16 out); then the
   composed shear augment of one [16, 3, 6, 512, 512] batch against the
   composed plain path, and K4's events and device time; K5 (fused_stem)
   in bf16 and f32 at the validation shape [48, 6, 512^2] cropped to 364,
   the test shape [96, 6, 512^2] uncropped, an odd 363 crop, one view at
   crop 48 and three at crop 47 of 64^2 sources (a tile wider than the maps,
   the persistent loop's tail), TF32 off for the plain version: bf16 within
   one ulp, f32 within 1e-5 of max|out|, every output bit-equal over two
   launches, and the events and device time of the validation and test
   launches; K6/K7 (fused_block, the
   eight bodies of the fused bottleneck) at ResNet-50's five block shapes
   (48 views) and two ragged ones (3 views of 5x7, less than one row
   tile): bf16 outputs within two ulps of max|plain| with at most 1e-3 of
   their elements more than one ulp of their own value apart (f32 sum order
   alone differs), f32 sums and weight gradients within 3e-3 of max|plain|,
   every body's outputs bit-equal over repeated launches, K7.2's dc3
   bit-equal to the BN3 backward of c3 as K6.4 computes it, K6.3's sums
   bit-equal to those of K6.4's c3 and K6.1's projection sums to those of
   cp as K6.4's residual launch computes it, both taken in the order of the
   pipelined mainloop's sums epilogue; K8 (int8_conv) at ResNet-50's conv
   kinds (the stem 7x7/2 from 6 channels at 512^2, 1x1/1, 3x3/1, 3x3/2, the
   1x1/2 projection, 2-4 views; 128-column tiles at Cout 256, 512, 2048) and
   five ragged shapes (Cout 40, 72, 320 and 200, and a 513 x 511 stem), with
   and without ReLU and an int8 or float residual, int8, bf16 and f32
   outputs: bit-equal to the plain version (the exact float64 sums on the
   card, cuDNN off), two launches bit-equal, and inputs on exact .5 ties of
   the requantize; K8's stem entry (int8_stem_conv) from NCHW views at
   [2, 6, 512, 512] and 513 x 511, bf16 and f32 (quantized in the kernel,
   many on .5 ties, some clipped) and int8, every epilogue without a
   residual bit-equal to its plain version over two launches, int8 views
   giving the bf16 ones' output; K8 with DenseNet-121's per-channel
   requantize (``inv_out_scale`` one per output channel) at its conv kinds
   (1x1 ``Conv_0`` from Cin 64, 480 and 992 to 128 with ReLU, 3x3
   ``Conv_1`` to Cout 32 at 128^2 and 16^2, the transitions' 1x1 convs with
   bf16 output, 2-4 views) and in the stem entry (64 channels, bf16 and
   int8 views): bit-equal to the plain version and over two launches, and
   inputs on exact .5 ties of a vector requantize;
3. training end to end through ``rxtpu_torch.cli.main`` at full width
   (ResNet-50 + MLP head, 1108 classes, G=3 views of 6x512^2, batch 16, bf16,
   crop 364) on a synthetic fixture: 2 epochs of 4 steps with validation,
   then the test phase; the kernel launch counts of this run are read, the
   logged losses and the checkpoints checked, and ``--resume`` on the
   finished run must train nothing and still write the submission;
3b. training again with ``--fuse-blocks on`` (1 epoch of 4 steps, the same
   fixture): each of K6/K7's eight bodies launched 13 times per train step
   and never in validation or test, finite losses, a last checkpoint that
   the unfused model loads, the submission;
3c. ``rxtpu_torch.cli.main --backbone densenet121 --head arcface
   --calibrate`` (BASELINE configs 2 and 4) at full width on phase 3's
   fixture, 1 epoch of 4 steps with validation: K2-K4 once per step, K1 once
   per validation and test batch, finite losses, a checkpoint; then its test
   phase with ``--tta flips`` and plate leak on phase 4's fixture (run after
   4f): K1 once per test batch, a valid submission;
3d. resuming phase 3's run (after phase 4, in directories of its own): (a)
   its last checkpoint written in rxtpu's pickle layout (numpy trees in
   flax's layout, optax's state classes stood in under optax's module and
   class names, ``save_rxtpu_pickle``) and resumed with one more epoch: the
   momentum buffers on the card, right after loading, bit-equal to the
   pickle's trace after ``from_flax``, the step, one epoch of 4 steps with
   K2-K4 once per step; (b) the same state at the next epoch's batch 2 in
   rxtpu's layout and in the port's format, each resumed under
   ``--profile`` (the port's twice), cuDNN deterministic: 2 steps each, K2-K4
   twice each in the trace under ``board/{id}/profile``, losses and final
   weights bit-equal (within twice the spread of the two port-format runs
   if those differ); (c) ``greedy_jax`` on the card on a seeded [1108, 1108]
   f32 probability matrix, with no host sync in its loop (sync debug mode
   "error"), equal to its CPU run and to the host greedy (the smallest
   top-two gap printed), then the test phase through the CLI with
   ``--assign-method greedy_jax`` on phase 4's fixture: a valid submission;
3e. multi-GPU on the one card (after 3d): (a) phase 3's run for one epoch
   and its test phase through ``python -m torch.distributed.run --standalone
   --nproc-per-node 1`` with ``--distributed`` (NCCL, world 1) and without,
   each in a process of its own, cuDNN deterministic: losses, checkpoints
   (weights, BN statistics, momentum) and submission bit-equal; (b) one f32
   ResNet-50 train step at full width, global batch 16, TF32 off, in two
   processes over gloo on the card (``initialize_distributed(backend=
   "gloo")``), at world 2 (data 2) and with the head split over 2 model
   ranks: the loss within rtol 1e-5 and the weights within atol 2e-5 of
   the world-1 step, K2-K4 once per rank; then the same step with the fused
   blocks at data 2, K6/K7's BN sums all-reduced over the ranks, against
   the fused world-1 step (loss, running statistics, momentum buffers),
   each K6/K7 body 13 times per rank; its wall time is a path check, not a speed figure;
   (c) the bf16 train step at world 1 with and without the NCCL gradient
   all-reduce, by CUDA events, alternated;
3f. ``--checkpoint-backend orbax`` (after 3e, on phase 3's fixture): (o)
   rxtpu's OCDBT checkpoint in ``tests/data/orbax_ocdbt`` (orbax wrote it)
   read on this host without orbax, bit-equal to the arrays beside it; (a)
   one epoch of 4 steps under the flag (K2-K4 once per step, K1 once per
   validation and test batch), its best and last checkpoints orbax
   directories read back at their steps; the last one also written in the
   port's format, and ``--resume`` for one more epoch from each (the port's
   twice), cuDNN deterministic: the momentum on the card right after
   loading bit-equal to the orbax trace, losses and final weights bit-equal
   (within twice the spread of the two port-format runs if those differ);
   (b) the test phase from the orbax best directory and from its port-format
   copy on phase 4's fixture: the same submission bytes; (c) the last
   directory renamed to ``<path>.old`` (a crash in the middle of the save's
   swap): ``--resume`` finds it and ends as (a)'s orbax resume; (d) the save
   and the load of the ResNet-50 rolling payload by the host's clock, with
   the directory's bytes and files, beside the port format's;
4. the test phase end to end (plate-leak assignment) on the checkpoint
   phase 3 trained, then again with ``--predict-scan-window 2`` (rxtpu's
   scanned predict window: one CUDA graph replay per window of 2 batches):
   the same submission, byte for byte, K1 once per test batch; and the
   experiment drained by ``predict_dataset`` per batch and in windows of 2:
   the probabilities bit-equal;
4b. the K5 path at full width on phase 3's last checkpoint: K5 against its
   plain version on the folded stem (bf16 within one ulp, f32 within 1e-5
   of max|out|, and the f32 gaps against the bound the exact path assumes);
   ``EvalStep`` and
   ``Predictor`` with ``fused_stem=True`` against the unfused steps on one
   validation batch (G=3, crop 364) and one test batch (G=6, 512), K5
   launched once per call and K1 not at all, and ``predict_dataset`` over
   phase 4's test pipeline with both (plate-leak assignments compared);
4c. JPEG input at full width: nvJPEG's planes against rxtpu's libjpeg ones
   (``tests/data/jpeg_ref``, within one level); (a) phase 3's fixture written
   as a JPEG tree (6x512^2 planes per view, quality 95, nvJPEG's encoder) and
   a raw pack of the planes nvJPEG decodes from it: the pipeline's batches
   from the tree, preloaded and streaming, equal the pack's bit for bit in
   train, val and test modes over two epochs; (b) ``rxtpu_torch.cli.main``
   with rxtpu's default input (no ``--pack``) and the stats artifact absent:
   the stats it computes within 1e-12 of ``compute_stats_numpy`` on the
   decoded planes, 1 epoch of 4 steps with K2-K4 once per step, finite
   losses, nvJPEG on the path, the submission; (c) the test phase on (b)'s
   checkpoint from ``--pack`` of the decoded planes writes the same bytes;
4d. PNG input and compressed packs at full width: (a) phase 3's fixture
   written as a PNG tree (``write_png_tree``): the port's PNG reader gives
   the raw pack's planes bit for bit, and the pipeline's batches from the
   tree, preloaded and streaming, equal the raw pack's in train, val and
   test modes; (b) ``python -m rxtpu_torch.tools pack`` from the tree as
   zlib, zlib+png and, where the host has ``libzstd.so.1``, zstd (level 3):
   every ``PackStore`` batch equal to the raw pack's; (c)
   ``rxtpu_torch.cli.main --image-ext png`` with no ``--pack`` and the stats
   artifact absent: the stats within 1e-12 of the fixture's, 1 epoch of 4
   steps with K2-K4 once per step and K1 in eval, finite losses, the
   submission; the test phase from the zlib+png pack and from the raw pack
   writes the same bytes; (d) ``png2jpeg`` on a copy of the tree: one JPEG
   per PNG, each decoded by nvJPEG;
4e. ``--quantize int8`` through ``rxtpu_torch.cli.main`` on phase 4's fixture
   and checkpoint: K1 once per test and calibration batch (bf16 views; K8's
   stem entry quantizes them), K8 53 times per test batch, a valid
   plate-leak submission;
4f. the int8 predict step on one full-width batch, calibrated on it: on
   the kernels (K1, K8) against the plain versions on the card, the
   backbone's bf16 features and the probabilities bit-equal; against the
   bf16 ``Predictor``, top-1 agreement and the largest probability gap
   (under 0.08); once without transforms, K1 writing int8 views;
4g. ``densenet121 --quantize int8`` through the CLI on phase 4's fixture (a
   seeded DenseNet-121 + MLP whose BN statistics are fitted to a batch like
   the fixture's): K1 once per test and calibration batch, K8 120 times per
   test batch, a valid submission; then the int8 step on one full-width
   batch calibrated on itself, as 4f: on the kernels against the plain
   versions bit-equal, top-1 agreement with the bf16 ``Predictor`` at least
   0.75 (rxtpu's bar) on the seeded weights, and the agreement and largest
   probability gap with the BN statistics fitted to the batch, reported
   beside 4f's; once without transforms;
4h. windows of 4 predict batches as one CUDA graph replay each
   (``WindowStep``): (b) phase 4's experiment as 4 batches of 8 (G=6,
   512^2), for ResNet-50 bf16 (phase 3's last checkpoint), its int8 without
   transforms (K1's int8 views, K8), DenseNet-121 bf16 (unfolded, under
   autocast) and int8 with ``[identity]`` (4g's model), DenseNet-121 +
   ArcFace under ``--tta flips`` (3c's checkpoint) and the fused stem (K5):
   the window bit-equal to the per-batch step on each batch, two replays
   bit-equal, a tail window of 3 batches and 1 pad giving the 3 real slices
   unchanged, and a replay's launch counts those of the 4 per-batch calls;
   (c) ms per batch at window 1 and 4, alternated (1, 4, 4, 1), by CUDA
   events and host clock, and each mode's peak memory, for the ResNet-50
   and DenseNet-121 bf16 and int8 steps at B=16; (d) ``entry()``'s forward
   on the card (finite [2, 1108], bit-equal over two calls) and
   ``dryrun_multichip(2)`` in a subprocess;
5. the card against the CPU: f32 predict logits on one full-width batch
   (ResNet-50 folded, and DenseNet-121 unfolded), and
   one f32 train step (loss, updated parameters and BN statistics, momentum
   buffers) against the same step in f64, with the CPU's f32 step beside it;
5b. one f32 train step (B=16) with the fused bottleneck on the card, on
   its kernels against the same step on the bodies' plain versions and
   against the unfused step;
6. learning: the loss falls over train steps on one fixed full-width batch,
   unfused and fused;
7. timings by CUDA events after warm-up: K2-K4 next to their bounds,
   device times and plain versions, the whole augment next to one
   ``F.grid_sample`` warp,
   the train step (ms, views/s, peak memory, device time by kernel with the
   augment's share), and K1 and the predict step as before; K5 at the
   validation and test shapes, with its device time, next to its bounds, its
   plain version, cuDNN's bf16 conv 7x7/2 with bias alone (its library call,
   the faster of NCHW and channels-last) and the unfused stem (K1, that
   conv, ReLU, max pool); the eval and
   predict steps fused and unfused (ms, views/s, memory) and a profile of
   the fused predict step; the train step with ``--fuse-blocks on`` beside
   the unfused one (ms, views/s, memory, device time by kernel; each
   profile also lists the host's calls by their own time), each K6/K7
   body at the 13 blocks' shapes of a step beside its bound, its plain
   version and ``torch.matmul`` of its largest product, each launch of
   every body timed alone, each body's device time (the host enqueueing
   ahead of the card) and its host's time to enqueue it, and the blocks fused against the unfused
   composition, forward and backward; the JPEG decode of one train batch
   (288 planes) and one test batch (576) at 1, 4 and nproc threads, and the
   train loop's ``perf/step_time_s`` and ``perf/input_stall_pct`` from the
   JPEG tree and from the decoded pack (2 epochs of 4 steps each, 4 decode
   threads); for uniform and microscopy-like content, a 288-plane batch of
   PNGs decoded onto the card and each codec's inflate of 48 views at 1, 4
   and nproc threads, and the train loop's step time and input stall from
   the PNG tree, from zlib+png and zstd+png packs and from the raw pack; the
   int8 predict step (both views) beside the bf16 one (ms, views/s, memory,
   a profile), K8 at each of the forward's shapes beside its bound, its
   plain version, ``torch._int_mm`` (1x1 stride 1) and cuDNN's bf16 conv,
   summed per conv kind beside the times of K8's first design (the stem's
   with the quantize and permute that design ran before it), and the stem
   entry from int8 views; for DenseNet-121: the train step of config 4
   (ArcFace, calibration; ms, views/s, peak memory, device time by kernel),
   the bf16 and int8 predict steps, K8 per DenseNet conv kind beside its
   bound and its library call, and the ``QuantPreNorm`` chain's share of
   the int8 step; ``greedy_jax`` per [1108, 1108] experiment (ms by the
   host's clock and by events, and its kernel launches).

``python3 chip_smoke.py --fused-block`` builds the kernels and runs only
phase 2's K6/K7 checks and the timing of every body's launches, device
time and host time, per block shape and per train step.
``python3 chip_smoke.py --int8`` builds the kernels and runs only K8's
checks, phase 4f on a seeded random ResNet-50 and the int8 timings.
``python3 chip_smoke.py --densenet`` builds the kernels and runs only K8's
DenseNet checks of phase 2, 3c, 4g and DenseNet's timings of phase 7.
``python3 chip_smoke.py --resume`` builds the kernels and runs phase 3 for
one epoch, phase 4's test phase, phases 3d and 3f and greedy_jax's timing.
``python3 chip_smoke.py --distributed`` builds the kernels and runs phase
3e on phase 3's fixture.
``python3 chip_smoke.py --scan`` builds the kernels and runs only phase 4h,
on seeded weights (ResNet-50 randomized, DenseNet-121's BN statistics
fitted to a batch, its ArcFace model initialized).
``python3 chip_smoke.py --step-timing`` builds the kernels and times only
the bf16 train step, unfused and with the fused blocks, alternated: run from
the roots of two checkouts in one call, it holds their steps against each
other.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import copy
import csv
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import types

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense
STEM_F32_REL = 1e-5         # K5 against its plain version, f32 output: bound / max|out|
ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
P, SRC, CROP, B, G = 16 * 3 * 6, 512, 364, 16, 3  # the train step's planes and shapes


def phase(name):
    print(f"=== {name}", flush=True)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of ``fn()`` in ms over ``iters`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, spin_cycles=50_000_000):
    """Mean device time of ``fn()`` in ms over ``iters`` calls run back to
    back: the card first spins (``torch.cuda._sleep``) while the host
    enqueues every call, so CUDA events around the calls time the card
    alone, where a loop the host cannot keep ahead of times the host. If
    the card reached the calls before the host had enqueued them all, the
    spin is lengthened and the reading taken again."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()  # the card still spinning: every call was enqueued first
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        spin_cycles *= 4
    fail("the host did not get ahead of the card, so fn's device time was not measured")


def host_ms(fn, iters):
    """Mean host time in ms to enqueue ``fn()``, over ``iters`` calls
    started on a drained card: above its device time, a loop of ``fn()``
    runs at the host's pace."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / iters


def bitwise_diff(a, b):
    """(mismatching elements, max |a - b|) of two tensors of one dtype."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        fail(f"kernel output {a.dtype} {tuple(a.shape)} vs plain {b.dtype} {tuple(b.shape)}")
    int_view = {torch.bfloat16: torch.int16, torch.float32: torch.int32, torch.int8: torch.int8}
    mismatches = int((a.view(int_view[a.dtype]) != b.view(int_view[b.dtype])).sum())
    return mismatches, float((a.float() - b.float()).abs().max())


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
    import torch

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


def bf16_gap(out, ref):
    """(share of elements that differ, elements more than one bf16 ulp apart,
    max |out - ref|) of two bf16 tensors."""
    import torch

    a, b = out.float(), ref.float()
    d = (a - b).abs()
    m = torch.maximum(a.abs(), b.abs())
    ulp = torch.where(m > 0, torch.exp2(torch.floor(torch.log2(m)) - 7), torch.zeros_like(m))
    return float((d > 0).float().mean()), int((d > ulp).sum()), float(d.max())


def k5_f32_gaps(out, ref):
    """K5's f32 output (the tensor cores' sums) against its plain version:
    the largest gap where |plain| < 2^-8, and the largest share of the
    bound that the kernel's bf16 exact path assumes, 2^-17 + 2^-18 |plain|
    (its margin is the inverse)."""
    d, r = (out - ref).abs(), ref.abs()
    small = r < 2.0 ** -8
    share = d / (2.0 ** -17 + 2.0 ** -18 * r)
    return float(d[small].max()) if bool(small.any()) else 0.0, float(share.max())


def k5_work(n, crop):
    """K5's bytes (the cropped uint8 pixels, scale/bias, bf16 weights and f32
    bias read once, the bf16 maps written once) and operations (294
    multiply-adds per conv output)."""
    conv = (crop - 1) // 2 + 1
    pool = (conv - 1) // 2 + 1
    moved = n * 6 * crop * crop + 2 * 4 * n * 6 + 64 * 294 * 2 + 64 * 4 + n * 64 * pool * pool * 2
    return moved, 2 * n * 64 * conv * conv * 294


def device_profile(fn, steps, label, ref_ms):
    """Device time per step of ``fn`` by kernel (torch.profiler), its share of
    ``ref_ms``, and the host's calls by their own time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    # device-side events only: an aten op's own device total repeats its kernels'
    averages = prof.key_averages()
    kernels = [e for e in averages
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not kernels:
        fail("the profiler recorded no device time")
    device_us = sum(e.self_device_time_total for e in kernels)
    print(f"profile of {steps} {label}: {device_us / 1e3 / steps:.3f} ms device time "
          f"per step, {100 * device_us / 1e3 / steps / ref_ms:.1f}% of the step's "
          f"{ref_ms:.3f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:14]:
        print(f"  {100 * e.self_device_time_total / device_us:5.1f}%  "
              f"{e.self_device_time_total / 1e3 / steps:8.3f} ms/step  "
              f"x{e.count // steps:<4d} {e.key[:110]}")
    # where the host's time goes (under the profiler, which slows the host)
    host = sorted((e for e in averages if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    print("  host, by self time per step: " + ", ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3 / steps:.3f} ms x{e.count // steps}"
        for e in host))
    return kernels, device_us


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# K6/K7, the fused bottleneck's eight bodies, and the Pallas bodies they replace
FB_NAMES = ("k1", "k2", "k3", "k4", "b1", "b2", "b3", "b4")
FB_LINES = {"k1": 257, "k2": 327, "k3": 365, "k4": 395, "b1": 518, "b2": 567, "b3": 624, "b4": 713}
# ResNet-50's fused blocks in a train step (V = 48 views cropped to 364):
# (label, plane, C, F, projection, blocks per step); 13 blocks in all
FB_SHAPES = (("stage1 proj", 91, 64, 64, True, 1), ("stage1", 91, 256, 64, False, 2),
             ("stage2", 46, 512, 128, False, 3), ("stage3", 23, 1024, 256, False, 5),
             ("stage4", 12, 2048, 512, False, 2))
# ragged blocks (3 views of 5x7: 105 rows, less than one 128-row tile):
# (label, height, width, C, F, projection)
FB_RAGGED = (("ragged proj", 5, 7, 128, 64, True), ("ragged", 5, 7, 256, 64, False))
FB_BF16_TOP_ULPS = 2  # bf16 outputs: max|kernel - plain| <= this many ulps of max|plain|,
FB_BF16_SHARE = 1e-3  # and at most this share more than one ulp of their own value apart
FB_F32_REL = 3e-3     # f32 sums and weight gradients: max|kernel - plain| / max|plain|


def fb_operands(v, plane, c, f, proj, seed, dev, width=None):
    """Every body's operands for one block of ``v`` views of ``plane`` x
    ``width`` (default square), as the forward and backward chain makes them
    (the plain versions, on the card): ReLU'd bf16 input, He-scaled weights,
    BN affines 1 + 0.4 N(0,1) / 0.4 N(0,1)."""
    import torch
    from rxtpu_torch.ops import fused_block as fb

    bf = torch.bfloat16
    width = width or plane
    g = torch.Generator(device=dev).manual_seed(seed)
    r, cnt = v * plane * width, float(v * plane * width)

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    x = rnd(r, c).relu().to(bf)
    w1 = rnd(c, f, std=math.sqrt(2 / f)).to(bf)
    w2 = rnd(9, f, f, std=math.sqrt(2 / (9 * f))).to(bf)
    w3 = rnd(f, 4 * f, std=math.sqrt(2 / (4 * f))).to(bf)
    wp = rnd(c, 4 * f, std=math.sqrt(2 / (4 * f))).to(bf) if proj else None
    gb = {k: (1 + 0.4 * rnd(n), 0.4 * rnd(n)) for k, n in (("1", f), ("2", f), ("3", 4 * f),
                                                            ("p", 4 * f))}
    c1, s1, q1, *spq = fb.k1_reference(x, w1, wp)
    f1 = fb.finalize(s1, q1, *gb["1"], cnt, 1e-5)
    fp = fb.finalize(*spq, *gb["p"], cnt, 1e-5) if proj else None
    c2, s2, q2 = fb.k2_reference(c1, f1.scale, f1.shift, w2, plane, width)
    f2 = fb.finalize(s2, q2, *gb["2"], cnt, 1e-5)
    f3 = fb.finalize(*fb.k3_reference(c2, f2.scale, f2.shift, w3), *gb["3"], cnt, 1e-5)
    pa = (wp, fp.scale, fp.shift) if proj else ()
    y = fb.k4_reference(c2, x, f2.scale, f2.shift, w3, f3.scale, f3.shift, *pa)
    dy = (rnd(r, 4 * f) * 0.01).to(bf)
    pb = (x, wp, fp.mean, fp.inv) if proj else ()
    s3a, s3b, *spb = fb.b1_reference(dy, y, c2, f2.scale, f2.shift, w3, f3.mean, f3.inv, *pb)
    b2a = (dy, y, c2, f2.scale, f2.shift, w3, f3.mean, f3.inv, f3.scale, s3a / cnt, s3b / cnt,
           f2.mean, f2.inv)
    g2, _, s2a, s2b = fb.b2_reference(*b2a)
    b3a = (g2, c1, c2, f1.scale, f1.shift, f2.scale, s2a / cnt, s2b / cnt, f2.mean, f2.inv, w2,
           f1.mean, f1.inv, plane, width)
    g1, _, s1a, s1b = fb.b3_reference(*b3a)
    pc = (wp, fp.scale, s3a / cnt, spb[0] / cnt, fp.mean, fp.inv) if proj else ()
    return {"k1": (x, w1, wp), "k2": (c1, f1.scale, f1.shift, w2, plane, width),
            "k3": (c2, f2.scale, f2.shift, w3),
            "k4": (c2, x, f2.scale, f2.shift, w3, f3.scale, f3.shift, *pa),
            "b1": (dy, y, c2, f2.scale, f2.shift, w3, f3.mean, f3.inv, *pb),
            "b2": b2a, "b3": b3a,
            "b4": (g1, c1, x, dy, y, f1.scale, s1a / cnt, s1b / cnt, f1.mean, f1.inv, w1, *pc)}


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


def fb_largest_gemm(name, r, c, f, proj):
    """(m, k, n) of the largest product a body computes: the yardstick
    ``torch.matmul`` is timed on."""
    n4 = 4 * f
    if name in ("k2", "b3"):
        return r, 9 * f, f
    if name == "k1":
        return (r, c, n4) if proj else (r, c, f)
    if name == "b4":
        return (r, n4, c) if proj else (r, f, c)
    return r, f, n4


def fb_gap(out, ref):
    """(max|out - ref|, check text, ok) of one body output against its plain
    version: bf16 within FB_BF16_TOP_ULPS ulps of max|ref| with at most
    FB_BF16_SHARE of the elements more than one ulp of their own value
    apart; f32 within FB_F32_REL of max|ref|."""
    import torch

    if out.dtype != ref.dtype or out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        return math.inf, f"{out.dtype} {tuple(out.shape)} against {ref.dtype} {tuple(ref.shape)}", \
            False
    top = float(ref.float().abs().max())
    err = float((out.float() - ref.float()).abs().max())
    if out.dtype == torch.bfloat16:
        share, over, _ = bf16_gap(out, ref)
        top_ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
        n_over = over / out.numel()
        return err, (f"bf16 {100 * share:.4f}% differ, {n_over:.2e} more than one ulp, max "
                     f"{err:.4g} = {err / top_ulp if top_ulp else 0:.2f} ulp of max|plain| "
                     f"{top:.4g}"), top > 0 and err <= FB_BF16_TOP_ULPS * top_ulp and \
            n_over <= FB_BF16_SHARE
    rel = err / top if top > 0 else math.inf
    return err, f"f32 max {err:.4g} = {rel:.3g} of max|plain| {top:.4g}", rel <= FB_F32_REL


def fb_k4_c3(fb, c2, sc2, sh2, w3):
    """c3 as K6.4 computes it, ``k4(scale 1) - k4(scale -1)`` with shift 0
    and a zero residual (exact in bf16), as f32."""
    import torch

    n = w3.shape[1]
    one, zero = torch.ones(n, device=w3.device), torch.zeros(n, device=w3.device)
    res = torch.zeros((c2.shape[0], n), dtype=torch.bfloat16, device=c2.device)
    return (fb.k4(c2, res, sc2, sh2, w3, one, zero).float()
            - fb.k4(c2, res, sc2, sh2, w3, -one, zero).float())


def fb_c3_check(fb, args):
    """K7.2's recomputed c3 bit-equal to K6.4's: dc3 from K7.2's dc3 launch
    alone against the BN3 backward (plain, f32 on the card) of c3 as K6.4
    computes it."""
    import torch

    dy, y, c2, sc2, sh2, w3, m3, i3, k3, d3a, d3b, m2, i2 = args
    dc3 = torch.empty_like(dy)
    fb._gemm(fb._BN_RELU, fb._BN_BACKWARD, fb._a(c2, scale=sc2, shift=sh2), w3, c2.shape[0],
             c2.device, out=dc3, aux0=dy, aux1=y, e_mean=m3, e_inv=i3, e_k=k3, e_da=d3a,
             e_db=d3b)
    want = fb._bn_backward(fb._g3(dy, y), fb._xhat(fb_k4_c3(fb, c2, sc2, sh2, w3), m3, i3), k3,
                           d3a, d3b)
    return torch.equal(dc3, want)


def fb_fixed_reduce(part):
    """``[chunks, n]`` f32 partials summed in ``reduce_kernel``'s order (f32
    adds on the card, each rounded as the kernel's ``__fadd_rn``): above
    64 partials, groups of 64 first; in a group, lane y sums partials y, y +
    8, ... from 0, then the eight lanes are added in order. Zero padding adds
    +0.0 to sums that are never -0.0, so it changes no bit."""
    import torch

    def lanes(p):  # [g, c, n] -> [g, n]
        g, c, n = p.shape
        p = torch.cat([p, p.new_zeros(g, -(-c // 8) * 8 - c, n)], 1).view(g, -1, 8, n)
        acc = p.new_zeros(g, 8, n)
        for j in range(p.shape[1]):
            acc = acc + p[:, j]
        t = p.new_zeros(g, n)
        for lane in range(8):
            t = t + acc[:, lane]
        return t

    chunks, n = part.shape
    if chunks > 64:
        groups = -(-chunks // 64)
        part = lanes(torch.cat([part, part.new_zeros(groups * 64 - chunks, n)]).view(groups, 64, n))
    return lanes(part[None])[0]


def fb_pipe_sums(v, bm=64):
    """Per-channel sums of a ``[rows, n]`` f32 slab in the order of
    ``pipe_gemm_kernel``'s sums epilogues, each add an f32 add as the
    kernel's ``__fadd_rn``: per BM-row tile and warp row (BM / 2 rows), the
    lane g (of the 8 that share a column) sums rows ``mt*16 + g`` and ``mt*16
    + g + 8`` for mt = 0, 1, ... in that order from 0; the ``xor 4, 8, 16``
    butterfly adds the lanes as ((0+1) + (2+3)) + ((4+5) + (6+7)); warp row
    0 plus warp row 1 gives the tile's partial; then ``fb_fixed_reduce``
    over the tiles. Rows past the slab, which the kernel skips, add +0.0
    here: that changes no bit of a sum that is never -0.0."""
    import torch

    rows, n = v.shape
    tiles = -(-rows // bm)
    # [tile, warp row, mt, h, g, n]: row wm*(bm/2) + mt*16 + 8*h + g of its tile
    v = torch.cat([v, v.new_zeros(tiles * bm - rows, n)]).view(tiles, 2, bm // 32, 2, 8, n)
    lane = v.new_zeros(tiles, 2, 8, n)
    for mt in range(bm // 32):
        for h in range(2):
            lane = lane + v[:, :, mt, h]
    for _ in range(3):  # xor 4, 8, 16: lanes g and g ^ 1, then pairs of pairs
        lane = lane[:, :, 0::2] + lane[:, :, 1::2]
    return fb_fixed_reduce(lane[:, 0, 0] + lane[:, 1, 0])


def fb_sums_tie(got, v, bm):
    """The sums ``got`` of v and v*v bit-equal to ``fb_pipe_sums``'."""
    import torch

    want = (fb_pipe_sums(v, bm), fb_pipe_sums(v * v, bm))
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, want))


def fb_k3_tie(fb, args):
    """K6.3's ``(s3, q3)`` bit-equal to the sums of K6.4's c3 in the pipe
    epilogue's order: one c3 from the two launches."""
    c2, sc2, sh2, w3 = args
    return fb_sums_tie(fb.k3(*args), fb_k4_c3(fb, c2, sc2, sh2, w3),
                       fb._ROW_TILES[(fb._BN_RELU, fb._STATS)])


def fb_cp_tie(fb, args):
    """K6.1's projection sums ``(sp, qp)`` bit-equal to the sums, in the pipe
    epilogue's order, of cp as K6.4's residual launch computes it with scale
    1 and shift 0 (its output then bf16(acc) exactly): one cp in K6.1, K6.4,
    K7.1 and K7.4."""
    import torch

    x, _, wp = args
    rows, n = x.shape[0], wp.shape[1]
    cp = torch.empty((rows, n), dtype=torch.bfloat16, device=x.device)
    one, zero = torch.ones(n, device=x.device), torch.zeros(n, device=x.device)
    fb._gemm(fb._STORED, fb._RESIDUAL, fb._a(x), wp, rows, x.device, out=cp, e_scale=one,
             e_shift=zero)
    return fb_sums_tie(fb.k1(*args)[3:], cp.float(), fb._ROW_TILES[(fb._STORED, fb._STATS)])


def fb_launch_parts(fb, name, args):
    """The launches of body ``name`` on ``args``, as its wrapper makes them,
    each as (label, fn): a GEMM or weight gradient with the reductions of
    its sums, or the BN backward."""
    import torch

    if name == "k1":
        x, w1, wp = args
        rows = x.shape[0]
        c1 = torch.empty((rows, w1.shape[1]), dtype=torch.bfloat16, device=x.device)
        parts = [("c1 gemm+sums", lambda: fb._gemm(fb._STORED, fb._STORE_STATS, fb._a(x), w1, rows,
                                                   x.device, out=c1))]
        if wp is not None:
            parts.append(("cp sums", lambda: fb._gemm(fb._STORED, fb._STATS, fb._a(x), wp, rows,
                                                      x.device)))
        return parts
    if name == "k3":
        c2, sc2, sh2, w3 = args
        a2 = fb._a(c2, scale=sc2, shift=sh2)
        return [("c3 sums", lambda: fb._gemm(fb._BN_RELU, fb._STATS, a2, w3, c2.shape[0],
                                             c2.device))]
    if name == "k2":
        c1, sc1, sh1, w2, height, width = args
        rows, f = c1.shape
        c2 = torch.empty_like(c1)
        a1 = fb._a(c1, kc=f, scale=sc1, shift=sh1, height=height, width=width)
        return [("c2 gemm+sums", lambda: fb._gemm(fb._TAP_BN_RELU, fb._STORE_STATS, a1,
                                                  w2.reshape(9 * f, f), rows, c1.device,
                                                  out=c2))]
    if name == "k4":
        c2, x, sc2, sh2, w3, sc3, sh3, *proj = args
        rows, n = c2.shape[0], w3.shape[1]
        y = torch.empty((rows, n), dtype=torch.bfloat16, device=x.device)
        res = torch.empty_like(y) if proj else x
        parts = []
        if proj:
            wp, scp, shp = proj
            parts.append(("res gemm", lambda: fb._gemm(fb._STORED, fb._RESIDUAL, fb._a(x), wp, rows,
                                                       x.device, out=res, e_scale=scp,
                                                       e_shift=shp)))
        parts.append(("y gemm", lambda: fb._gemm(fb._BN_RELU, fb._OUTPUT,
                                                 fb._a(c2, scale=sc2, shift=sh2), w3, rows,
                                                 x.device, out=y, aux0=res, e_scale=sc3,
                                                 e_shift=sh3)))
        return parts
    if name == "b1":
        dy, y, c2, sc2, sh2, w3, m3, i3, *proj = args
        rows = c2.shape[0]
        parts = [("s3 gemm+sums", lambda: fb._gemm(fb._BN_RELU, fb._BN_SUMS,
                                                   fb._a(c2, scale=sc2, shift=sh2), w3, rows,
                                                   c2.device, aux0=dy, aux1=y, e_mean=m3,
                                                   e_inv=i3))]
        if proj:
            x, wp, mp, ip = proj
            parts.append(("sp gemm+sums", lambda: fb._gemm(fb._STORED, fb._BN_SUMS, fb._a(x), wp,
                                                           rows, c2.device, aux0=dy, aux1=y,
                                                           e_mean=mp, e_inv=ip)))
        return parts
    if name == "b3":
        g2, c1, c2, sc1, sh1, k2, d2a, d2b, m2, i2, w2, m1, i1, height, width = args
        rows, f = c1.shape
        dc2, g1 = torch.empty_like(c2), torch.empty_like(c1)
        a1 = fb._a(c1, kc=f, scale=sc1, shift=sh1, height=height, width=width)
        return [("dc2 bn_backward", lambda: fb._bn_bwd(g2, c2, k2, d2a, d2b, m2, i2, dc2)),
                ("g1 gemm+sums", lambda: fb._gemm(
                    fb._TAP_ADJOINT, fb._RELU_GRAD, fb._a(dc2, kc=f, height=height, width=width),
                    w2, rows, c1.device, out=g1, aux0=c1, e_scale=sc1, e_shift=sh1, e_mean=m1,
                    e_inv=i1)),
                ("dw2 wgrad", lambda: fb._wgrad(fb._TAP_BN_RELU, a1, f, dc2, f, rows, taps=9))]
    if name == "b2":
        dy, y, c2, sc2, sh2, w3, m3, i3, k3, d3a, d3b, m2, i2 = args
        rows, f = c2.shape
        dc3, g2 = torch.empty_like(dy), torch.empty_like(c2)
        a2 = fb._a(c2, scale=sc2, shift=sh2)
        return [("dc3 gemm", lambda: fb._gemm(fb._BN_RELU, fb._BN_BACKWARD, a2, w3, rows,
                                              c2.device, out=dc3, aux0=dy, aux1=y, e_mean=m3,
                                              e_inv=i3, e_k=k3, e_da=d3a, e_db=d3b)),
                ("g2 gemm+sums", lambda: fb._gemm(fb._STORED, fb._RELU_GRAD, fb._a(dc3), w3, rows,
                                                  c2.device, out=g2, aux0=c2, e_scale=sc2,
                                                  e_shift=sh2, e_mean=m2, e_inv=i2)),
                ("dw3 wgrad", lambda: fb._wgrad(fb._BN_RELU, a2, f, dc3, w3.shape[1], rows))]
    g1, c1, x, dy, y, k1, d1a, d1b, m1, i1, w1, *proj = args
    rows, c = x.shape
    f = c1.shape[1]
    wp = proj[0] if proj else None
    n4 = wp.shape[1] if proj else 0
    dc = torch.empty((rows, f + n4), dtype=torch.bfloat16, device=x.device)
    dx = torch.empty_like(x)
    parts = [("dc1 bn_backward", lambda: fb._bn_bwd(g1, c1, k1, d1a, d1b, m1, i1, dc))]
    if proj:
        _, kp, dpa, dpb, mp, ip = proj
        parts.append(("dcp gemm", lambda: fb._gemm(
            fb._STORED, fb._BN_BACKWARD, fb._a(x), wp, rows, x.device, out=dc, out_col=f,
            aux0=dy, aux1=y, e_mean=mp, e_inv=ip, e_k=kp, e_da=dpa, e_db=dpb)))
    parts.append(("dx gemm", lambda: fb._gemm(fb._STORED, fb._INPUT_GRAD, fb._a(dc), w1, rows,
                                              x.device, w2=wp, out=dx, aux0=dy, aux1=y,
                                              add_g3=not proj)))
    parts.append(("dw1 wgrad", lambda: fb._wgrad(fb._STORED, fb._a(x), c, dc, f, rows)))
    if proj:
        parts.append(("dwp wgrad", lambda: fb._wgrad(fb._STORED, fb._a(x), c, dc, n4, rows,
                                                     d_col=f)))
    return parts


def fb_phase2(dev):
    """Phase 2's K6/K7 checks: every body against its plain version at the
    five block shapes and the ragged ones, the repeated launches, K7.2's c3;
    returns max|kernel - plain| per body."""
    import torch
    from rxtpu_torch.ops import fused_block as fb

    phase(f"2 K6/K7 fused_block bodies against their plain versions (bf16 within "
          f"{FB_BF16_TOP_ULPS} ulps of max|plain|, at most {FB_BF16_SHARE:g} of them more than "
          f"one ulp off; f32 within {FB_F32_REL:g} of max|plain|)")
    fb_bodies = dict(zip(FB_NAMES, fb.BODIES))
    fb_err = dict.fromkeys(FB_NAMES, 0.0)
    shapes = [(label, B * G, plane, plane, c, f, proj) for label, plane, c, f, proj, _ in FB_SHAPES]
    shapes += [(label, 3, fh, fw, c, f, proj) for label, fh, fw, c, f, proj in FB_RAGGED]
    for label, fv, fh, fw, c, f, proj in shapes:
        ops = fb_operands(fv, fh, c, f, proj, 7, dev, width=fw)
        size = f"{fh}^2" if fh == fw else f"{fh}x{fw}"
        for name in FB_NAMES:
            out = fb_bodies[name](*ops[name])
            ref = getattr(fb, f"{name}_reference")(*ops[name])
            torch.cuda.synchronize()
            out = out if isinstance(out, tuple) else (out,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            for i, (o, r) in enumerate(zip(out, ref)):
                err, text, ok = fb_gap(o, r)
                fb_err[name] = max(fb_err[name], err)
                print(f"{name} {label:11s} V={fv} {size} C={c} F={f} out[{i}] "
                      f"{tuple(o.shape)}: {text}")
                if not ok:
                    fail(f"fused_block {name} differs from its plain version ({label}, out {i})")
        for name in FB_NAMES:
            first, second = fb_bodies[name](*ops[name]), fb_bodies[name](*ops[name])
            first = first if isinstance(first, tuple) else (first,)
            second = second if isinstance(second, tuple) else (second,)
            if not all(torch.equal(a, b) for a, b in zip(first, second)):
                fail(f"fused_block {name} differs between two launches ({label})")
        if not fb_c3_check(fb, ops["b2"]):
            fail(f"K7.2's dc3 is not the BN3 backward of K6.4's c3, bit for bit ({label})")
        if not fb_k3_tie(fb, ops["k3"]):
            fail(f"K6.3's sums are not those of K6.4's c3 in the pipe epilogue's order, bit for "
                 f"bit ({label})")
        if proj and not fb_cp_tie(fb, ops["k1"]):
            fail(f"K6.1's projection sums are not those of K6.4's cp in the pipe epilogue's "
                 f"order, bit for bit ({label})")
        del ops, out, ref, first, second
    print("every body's outputs bit-equal over repeated launches at each shape (deterministic "
          "reductions); K7.2's dc3 bit-equal to the BN3 backward of K6.4's c3; K6.3's sums "
          "bit-equal to those of K6.4's c3, and K6.1's projection sums to those of K6.4's cp, "
          "in the pipe epilogue's order")
    return fb_err


def fb_launch_breakdown(dev):
    """Each launch of every K6/K7 body by CUDA events at the five block
    shapes, the body by events, by its device time with the host ahead and
    by the host's time to enqueue it (events read about the larger of the
    two), beside the body's bound, and per train step (each shape times its
    blocks per step); returns ``{body: {label: ms per step}}``."""
    from rxtpu_torch.ops import fused_block as fb

    per_step = {name: {} for name in FB_NAMES}
    for label, plane, c, f, proj, mult in FB_SHAPES:
        ops = fb_operands(B * G, plane, c, f, proj, 8, dev)
        r = B * G * plane * plane
        for name in per_step:
            parts = fb_launch_parts(fb, name, ops[name])
            for part, fn in parts:
                fn()  # dc3 / dc / res before the launches that read them
            times = [(part, cuda_ms(fn, 10)) for part, fn in parts]
            whole = cuda_ms(lambda: getattr(fb, name)(*ops[name]), 10)
            dev_ms = device_ms(lambda: getattr(fb, name)(*ops[name]), 10)
            enq_ms = host_ms(lambda: getattr(fb, name)(*ops[name]), 10)
            moved, n_ops = fb_work(name, r, c, f, proj)
            bnd = max(moved / HBM_BYTES_PER_S, n_ops / BF16_FLOPS) * 1e3
            print(f"{name} launches {label:11s} R={r}: " + ", ".join(
                f"{part} {ms:.4f}" for part, ms in times) + f"; sum {sum(t for _, t in times):.4f}"
                f" ms, the body {whole:.4f} ms (bound {bnd:.4f} ms, {100 * bnd / whole:.1f}%), "
                f"its device time {dev_ms:.4f} ms, the host's {enq_ms:.4f} ms")
            for part, ms in times + [("body", whole), ("device", dev_ms), ("host", enq_ms),
                                     ("bound", bnd)]:
                per_step[name][part] = per_step[name].get(part, 0.0) + mult * ms
        del ops
    for name, parts in per_step.items():
        print(f"{name} launches per train step: " + ", ".join(
            f"{part} {ms:.4f}" for part, ms in parts.items()) + " ms")
    return per_step


def shear_phase2(dev):
    """K2-K4 against their plain versions, bit for bit, at the train shapes;
    K4's events and device time at crop 364. Returns (max error per pass,
    the crop-364 inputs, the per-plane scale and bias)."""
    import torch
    from rxtpu_torch.ops import shear as ps

    shear_names = ("shear_pass", "shear_pass_rows", "shear_pass_finish")
    phase("2 K2-K4 shear passes against their plain versions (bit equality)")
    sgen = torch.Generator(device=dev).manual_seed(1)
    x8 = torch.randint(0, 256, (P, SRC, SRC), dtype=torch.uint8, device=dev, generator=sgen)
    sc = torch.rand(P, device=dev, generator=sgen) * 0.05 + 0.01
    bi = -torch.rand(P, device=dev, generator=sgen) * 3.0
    shear_err = dict.fromkeys(shear_names, 0.0)
    timing_inputs = {}

    def check(name, out, ref, label):
        torch.cuda.synchronize()
        bad, err = bitwise_diff(out, ref)
        shear_err[name] = max(shear_err[name], err)
        print(f"{name:18s} {label:42s} mismatches {bad} max_abs_diff {err}")
        if bad:
            fail(f"{name} differs from its plain version ({label})")

    def shifts(rows, lo, hi):
        # past both ends: k reaches 0 and kmax (the clamps)
        return torch.rand(P, rows, device=dev, generator=sgen) * (lo + hi + 16) - lo - 8

    for crop in (CROP, CROP - 1):
        pl, pr = ps._pads(0.41422 * SRC / 2, 0, SRC, SRC)
        t1 = shifts(SRC, pl, pr)
        k, f = ps.shift_params(t1, SRC, SRC, pl, pr)
        clamps = (int((k == 0).sum()), int((k == SRC + pl + pr - SRC - 1).sum()))
        for xin in (x8, x8.float()):
            s1 = ps.shear_pass(xin, t1, SRC, pl, pr)
            check("shear_pass", s1, ps.shear_pass_reference(xin, k, f, SRC, pl, pr,
                                                            torch.ones_like(sc),
                                                            torch.zeros_like(bi)),
                  f"{str(xin.dtype)} pads {pl}/{pr} clamps {clamps}")
        pt, pb = ps._pads(0.70712 * SRC / 2, SRC - crop, SRC, crop, lane_align=False)
        t2 = shifts(SRC, pt, pb + SRC - crop)
        k, f = ps.shift_params(t2, SRC, crop, pt, pb)
        s2 = ps.shear_pass_rows(s1, t2, crop, pt, pb)
        check("shear_pass_rows", s2, ps.shear_pass_rows_reference(s1, k, f, crop, pt, pb),
              f"crop {crop} pads {pt}/{pb}")
        pl3, pr3 = ps._pads(0.41422 * SRC / 2, SRC - crop, SRC, crop)
        t3 = shifts(crop, pl3, pr3 + SRC - crop)
        k, f = ps.shift_params(t3, SRC, crop, pl3, pr3)
        for rr in (False, True):
            for cr in (False, True):
                rrev = torch.full((P,), rr, device=dev)
                crev = torch.full((P,), cr, device=dev)
                for dt in (torch.bfloat16, torch.float32):
                    out = ps.shear_pass_finish(s2, t3, crop, pl3, pr3, sc, bi, rrev, crev, dt)
                    ref = ps.shear_pass_finish_reference(s2, k, f, crop, pl3, pr3, sc, bi,
                                                         rrev, crev, dt)
                    check("shear_pass_finish", out, ref,
                          f"crop {crop} rrev {rr:d} crev {cr:d} {str(dt)}")
        if crop == CROP:
            timing_inputs = dict(t1=t1, pads1=(pl, pr), s1=s1, t2=t2, pads2=(pt, pb), s2=s2,
                                 t3=t3, pads3=(pl3, pr3))

    ti = timing_inputs
    rrev, crev = (torch.arange(P, device=dev) % m == 0 for m in (2, 3))
    def k4():
        return ps.shear_pass_finish(ti["s2"], ti["t3"], CROP, *ti["pads3"], sc, bi, rrev, crev,
                                    torch.bfloat16)
    print(f"shear_pass_finish crop {CROP} bf16, both reversals mixed: {cuda_ms(k4, 20):.4f} ms "
          f"by events, {device_ms(k4, 20):.4f} ms device time")
    del x8
    return shear_err, timing_inputs, sc, bi


def k5_phase2(dev):
    """K5 against its plain version (TF32 off for the plain conv): bf16
    within one ulp, f32 within STEM_F32_REL of max|out|, at the validation,
    test and odd-crop shapes, one view at crop 48 (a tile wider than the
    maps) and three at crop 47 on 64^2 sources (the persistent loop's
    tail); every output bit-equal over two launches; the events and device
    time of the validation and test launches. Returns (max error, the
    inputs as ``stem``: a dict of the tensors and ``args(label)``)."""
    import torch
    from rxtpu_torch.ops._build import load_library
    from rxtpu_torch.ops.fused_stem import fused_stem, fused_stem_reference

    phase("2 K5 fused_stem against its plain version (bf16 within one ulp, f32 within "
          f"{STEM_F32_REL:g} of max|out|)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"plain version's f32 conv: cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}")
    lib = load_library("fused_stem")
    if hasattr(lib, "rxtpu_fused_stem_blocks_per_sm"):  # absent from one-block-per-tile builds
        per_sm = lib.rxtpu_fused_stem_blocks_per_sm
        print(f"K5 persistent blocks per SM: bf16 {per_sm(0)}, f32 {per_sm(2)}; "
              f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    fgen = torch.Generator(device=dev).manual_seed(5)
    imgs = torch.randint(0, 256, (96, 6, SRC, SRC), dtype=torch.uint8, device=dev,
                         generator=fgen)
    std = torch.rand(96, 6, device=dev, generator=fgen) * 0.25 + 0.05
    mean = torch.rand(96, 6, device=dev, generator=fgen) * 0.5 + 0.1
    small = torch.randint(0, 256, (3, 6, 64, 64), dtype=torch.uint8, device=dev,
                          generator=fgen)
    stem = {"imgs": imgs, "scale": (1.0 / (255.0 * std)).float(),
            "bias": (-mean / std).float(),
            "w": torch.randn(64, 6, 7, 7, device=dev, generator=fgen) * math.sqrt(2.0 / (64 * 49)),
            "cb": torch.randn(64, device=dev, generator=fgen) * 0.5,
            "cases": {"val": (48, CROP, SRC), "test": (96, None, SRC),
                      "odd crop": (48, CROP - 1, SRC), "1v 64^2/48": (1, 48, 64),
                      "3v 64^2/47": (3, 47, 64)}}

    def args(label):
        nv, crop, size = stem["cases"][label]
        src = imgs if size == SRC else small
        return (src[:nv], stem["scale"][:nv], stem["bias"][:nv], stem["w"], stem["cb"], crop)

    stem["args"] = args
    k5_err = 0.0
    for label in stem["cases"]:
        for dt in (torch.bfloat16, torch.float32):
            out = fused_stem(*args(label), dt)
            again = fused_stem(*args(label), dt)
            ref = fused_stem_reference(*args(label), dt)
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != ref.dtype or not bool(
                    torch.isfinite(out).all()):
                fail(f"K5 gave {out.dtype} {tuple(out.shape)} against {ref.dtype} "
                     f"{tuple(ref.shape)}, or non-finite values")
            if bitwise_diff(out, again)[0]:
                fail(f"K5's repeated launches differ ({label}, {dt})")
            top = float(ref.float().abs().max())
            if dt == torch.bfloat16:
                share, over, err = bf16_gap(out, ref)
                k5_err = max(k5_err, err)
                print(f"K5 {label:10s} {tuple(out.shape)} bf16: {100 * share:.4f}% of elements "
                      f"differ, {over} by more than one ulp, max_abs_diff {err} (max|out| {top}); "
                      f"a second launch bit-equal")
                if over:
                    a, b = out.float(), ref.float()
                    m = torch.maximum(a.abs(), b.abs())
                    ulp = torch.where(m > 0, torch.exp2(torch.floor(torch.log2(m)) - 7), m)
                    for i in ((a - b).abs() > ulp).nonzero()[:8].tolist():
                        print(f"  at {i}: kernel {float(a[tuple(i)])!r}, plain "
                              f"{float(b[tuple(i)])!r}")
                    fail(f"K5 differs from its plain version by more than one bf16 ulp ({label})")
            else:
                err = float((out - ref).abs().max())
                k5_err = max(k5_err, err)
                near, rel = k5_f32_gaps(out, ref)
                print(f"K5 {label:10s} {tuple(out.shape)} f32: max_abs_diff {err:.6g} = "
                      f"{err / top:.3g} of max|out| {top:.6g} (bound {STEM_F32_REL:g}); a second "
                      f"launch bit-equal; gap {near:.3g} below 2^-8, {rel:.3g} of the exact "
                      f"path's bound")
                if err > STEM_F32_REL * top:
                    fail(f"K5 f32 output differs from its plain version ({label})")
            if top < 1.0 or float((ref == 0).float().mean()) > 0.5:
                fail(f"K5 check on a degenerate output ({label})")
    torch.backends.cudnn.allow_tf32 = True
    for label in ("val", "test"):
        k5 = lambda: fused_stem(*args(label), torch.bfloat16)  # noqa: E731
        print(f"K5 {label} bf16: {cuda_ms(k5, 10):.4f} ms by events, {device_ms(k5, 10):.4f} ms "
              f"device time")
    return k5_err, stem


def k5_timings(dev, stem):
    """Phase 7's K5: at the validation and test shapes, by events and device
    time, beside its bound, its plain version (TF32 off), cuDNN's bf16 conv
    7x7/2 with bias alone (the faster of NCHW and channels-last: the library
    yardstick) and the unfused stem as the folded predictor runs it (K1, that
    conv, ReLU, pool). Returns {label: (ms, plain, bound, device, library)}."""
    import torch
    import torch.nn.functional as F
    from rxtpu_torch.ops.crop_norm import crop_normalize
    from rxtpu_torch.ops.fused_stem import fused_stem, fused_stem_reference, stem_out_size

    k5_times = {}
    for label in ("val", "test"):
        nv, crop, _ = stem["cases"][label]
        size = crop or SRC
        args = stem["args"](label)
        ms = cuda_ms(lambda: fused_stem(*args, torch.bfloat16), 20)
        dev_ms = device_ms(lambda: fused_stem(*args, torch.bfloat16), 20)
        torch.backends.cudnn.allow_tf32 = False
        plain_ms = cuda_ms(lambda: fused_stem_reference(*args, torch.bfloat16), 5)
        torch.backends.cudnn.allow_tf32 = True
        conv = torch.nn.Conv2d(6, 64, 7, 2, 3).to(dev, torch.bfloat16)
        with torch.no_grad():
            conv.weight.copy_(stem["w"])
            conv.bias.copy_(stem["cb"])
        planes_v = stem["imgs"][:nv].reshape(nv * 6, SRC, SRC)
        scale_v, bias_v = stem["scale"][:nv].reshape(-1), stem["bias"][:nv].reshape(-1)
        views = crop_normalize(planes_v, scale_v, bias_v, size).reshape(nv, 6, size, size)

        @torch.inference_mode()
        def unfused():
            v = crop_normalize(planes_v, scale_v, bias_v, size).reshape(nv, 6, size, size)
            return F.max_pool2d(F.relu(conv(v)), 3, 2, 1)

        unfused_ms = cuda_ms(unfused, 20)
        lib = {}
        with torch.inference_mode():
            for layout in ("NCHW", "channels-last"):
                fmt = torch.channels_last if layout == "channels-last" else torch.contiguous_format
                conv_l = conv.to(memory_format=fmt)
                views_l = views.contiguous(memory_format=fmt)
                lib[layout] = cuda_ms(lambda: conv_l(views_l), 20)
        lib_layout = min(lib, key=lib.get)
        moved, ops = k5_work(nv, size)
        bnd = max(moved / HBM_BYTES_PER_S, ops / BF16_FLOPS) * 1e3
        k5_times[label] = (ms, plain_ms, bnd, dev_ms, lib[lib_layout])
        print(f"K5 {label} [{nv},6,{SRC}^2] -> {size}^2 -> [{nv},64,{stem_out_size(size)}^2] bf16: "
              f"{ms:.4f} ms by events, {dev_ms:.4f} ms device time; bound {bnd:.4f} ms by "
              f"operations ({ops / 1e9:.1f} GFLOP at bf16 tensor-core rate; bytes "
              f"{moved / 1e6:.1f} MB = {moved / HBM_BYTES_PER_S * 1e3:.4f} ms), "
              f"{100 * bnd / ms:.2f}% of it ({100 * bnd / dev_ms:.2f}% by device time), "
              f"{ops / ms / 1e9:.1f} TFLOP/s; plain {plain_ms:.4f} ms; cuDNN bf16 conv 7x7/2 with "
              f"bias alone {lib['NCHW']:.4f} ms NCHW, {lib['channels-last']:.4f} ms channels-last "
              f"(library_ms: {lib_layout}); unfused stem (K1 + cuDNN bf16 conv + ReLU + max pool) "
              f"{unfused_ms:.4f} ms")
        del conv, planes_v, views
    return k5_times


def shear_main_timings(dev, images, draws, sc, bi):
    """Phase 7's K2-K4 on the main path's own shifts (the draws' residual
    angles and crops through the fused pipeline's geometry), by events and
    device time, beside their bounds and plain versions. Returns
    ({name: (ms, plain, bound, device)}, the k of each pass)."""
    import torch
    from rxtpu_torch.ops import shear as ps
    from rxtpu_torch.ops.shear import decompose_angle, fused_pass_shifts

    _, phi = decompose_angle(draws[0].to(dev))
    (t1, p1), (t2, p2), (t3, p3) = fused_pass_shifts(
        (P, SRC, SRC), phi.repeat_interleave(6), draws[3].to(dev).repeat_interleave(6, 0), CROP)
    x_main = images.reshape(P, SRC, SRC)
    s1m = ps.shear_pass(x_main, t1, SRC, *p1)
    s2m = ps.shear_pass_rows(s1m, t2, CROP, *p2)
    rrev = torch.arange(P, device=dev) % 2 == 0
    crev = torch.arange(P, device=dev) % 4 < 2
    kf = {"shear_pass": ps.shift_params(t1, SRC, SRC, *p1),
          "shear_pass_rows": ps.shift_params(t2, SRC, CROP, *p2),
          "shear_pass_finish": ps.shift_params(t3, SRC, CROP, *p3)}
    ones, zeros = torch.ones_like(sc), torch.zeros_like(bi)
    calls = {
        "shear_pass": (lambda: ps.shear_pass(x_main, t1, SRC, *p1),
                       lambda: ps.shear_pass_reference(x_main, *kf["shear_pass"], SRC, *p1,
                                                       ones, zeros)),
        "shear_pass_rows": (lambda: ps.shear_pass_rows(s1m, t2, CROP, *p2),
                            lambda: ps.shear_pass_rows_reference(
                                s1m, *kf["shear_pass_rows"], CROP, *p2)),
        "shear_pass_finish": (lambda: ps.shear_pass_finish(s2m, t3, CROP, *p3, sc, bi, rrev,
                                                           crev, torch.bfloat16),
                              lambda: ps.shear_pass_finish_reference(
                                  s2m, *kf["shear_pass_finish"], CROP, *p3, sc, bi, rrev,
                                  crev, torch.bfloat16)),
    }
    bounds = shear_bounds(kf, (p1, p2, p3), P, SRC, SRC, CROP)
    shear_times = {}
    for name, (kernel_fn, plain_fn) in calls.items():
        ms = cuda_ms(kernel_fn, 50)
        dev_ms = device_ms(kernel_fn, 50)
        plain_ms = cuda_ms(plain_fn, 10)
        moved, ops = bounds[name]
        bnd = bound_ms(moved, ops)
        shear_times[name] = (ms, plain_ms, bnd, dev_ms)
        print(f"{name:18s} {ms:.4f} ms by events, {dev_ms:.4f} ms device time (bound "
              f"{bnd:.4f} ms: {moved / 1e6:.1f} MB, {100 * bnd / ms:.1f}% of it, "
              f"{100 * bnd / dev_ms:.1f}% by device time), plain {plain_ms:.4f} ms")
    return shear_times


# ---------------------------------------------------------------------------
# JPEG input (phase 4c and its timings in phase 7): rxtpu's default run reads
# a JPEG tree; on the card the port decodes it with nvJPEG (csrc/jpeg_nv.cu)
# ---------------------------------------------------------------------------
JPEG_REF_MAX_LEVELS = 1  # nvJPEG's planes against rxtpu's libjpeg ones (tests/data/jpeg_ref)
STATS_REL = 1e-12        # the CLI's computed stats against compute_stats_numpy


def jpeg_host_probe():
    """Phase 1's probe of the host's JPEG libraries: libjpeg's header and
    library (the CPU route) and nvJPEG's version (the card's route)."""
    import ctypes.util

    from rxtpu_torch.data.decode import nvjpeg_version

    header = [p for p in ("/usr/include/jpeglib.h",) if os.path.exists(p)]
    lib = ctypes.util.find_library("jpeg")
    print(f"JPEG route on this host: libjpeg header {header or 'absent'}, library "
          f"{lib or 'absent'}; nvJPEG {'.'.join(map(str, nvjpeg_version()))} from the CUDA "
          f"toolkit (csrc/jpeg_nv.cu decodes on the card)")


def jpeg_phase(dev, cli, train_dir, shear_kernels, crop_normalize, card):
    """Phase 4c: (a) phase 3's fixture as a JPEG tree and a raw pack of the
    planes nvJPEG decodes from it, the pipeline's batches from the tree
    (preloaded and streaming) equal to the pack's in train, val and test
    modes over two epochs; (b) the CLI on the tree with no --pack and no
    stats artifact; (c) the test phase from the tree and from the pack of
    its planes, the same submission bytes. Returns what phase 7 reuses."""
    import numpy as np
    import torch

    from rxtpu_torch.data import decode as jd
    from rxtpu_torch.data.pack import PackStore, write_raw_pack
    from rxtpu_torch.data.pipeline import ByteStore, Pipeline
    from rxtpu_torch.data.records import image_path, load_metadata, read_metadata_csvs
    from rxtpu_torch.data.stats import compute_stats_numpy, load_stats
    from rxtpu_torch.data.synthetic import write_jpeg_tree

    ref_dir = os.path.join(ROOT, "tests", "data", "jpeg_ref")
    ref_paths = sorted(os.path.join(ref_dir, n) for n in os.listdir(ref_dir)
                       if n.endswith(".jpeg"))
    ref = np.load(os.path.join(ref_dir, "planes.npz"))["planes"].astype(np.int64)
    def host(x):  # decoded planes: a tensor on the card, numpy on the CPU
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

    side = ref.shape[-1]
    got = jd.decode_files(ref_paths, side, side, nthreads=4, strict=True, device=dev)
    gap = np.abs(host(got).astype(np.int64) - ref)
    print(f"nvJPEG against rxtpu's libjpeg planes (tests/data/jpeg_ref, {len(ref_paths)} JPEGs "
          f"of {side}^2, quality 95): max |difference| {int(gap.max())} levels (limit "
          f"{JPEG_REF_MAX_LEVELS}), {100 * float((gap > 0).mean()):.3f}% of pixels differ")
    if gap.max() > JPEG_REF_MAX_LEVELS:
        fail("nvJPEG's planes differ from rxtpu's by more than the limit")

    jpeg_dir = os.path.join(WORK, "jpeg")
    data = os.path.join(jpeg_dir, "data")
    shutil.copytree(os.path.join(train_dir, "data", "metadata"), os.path.join(data, "metadata"))
    t0 = time.perf_counter()
    jd.encode_batch_jpeg.launches = 0
    n_files = write_jpeg_tree(os.path.join(train_dir, "packs"), data, 95, dev)
    sizes = [os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(data) for f in fs
             if f.endswith(".jpeg")]
    print(f"(a) JPEG tree of phase 3's fixture: {n_files} files of {SRC}^2 at quality 95 "
          f"(nvJPEG, {jd.encode_batch_jpeg.launches} encode calls) in "
          f"{time.perf_counter() - t0:.2f} s, mean {np.mean(sizes) / 1e3:.1f} KB per file")
    dec = os.path.join(jpeg_dir, "packs_dec")
    decoded = {}  # (experiment, channel) -> planes, for the stats check
    for split in ("train", "test"):
        with open(os.path.join(train_dir, "packs", f"{split}.rxpack.json")) as f:
            entries = json.load(f)["entries"]  # "experiment|plate|well|site" -> ordinal
        keys = [(e, int(p), w, int(s)) for (e, p, w, s) in
                (k.split("|") for k, _ in sorted(entries.items(), key=lambda kv: kv[1]))]

        def views():
            for i in range(0, len(keys), 48):
                chunk = keys[i:i + 48]
                paths = [image_path(data, split, e, p, w, s, ch) for e, p, w, s in chunk
                         for ch in range(1, 7)]
                planes = jd.decode_files(paths, SRC, SRC, nthreads=4, strict=True, device=dev)
                planes = host(planes).reshape(len(chunk), 6, SRC, SRC)
                for key, view in zip(chunk, planes):
                    for ch in range(6):
                        decoded.setdefault((key[0], ch + 1), []).append(view[ch])
                    yield key, view

        write_raw_pack(dec, split, views())
    stats = load_stats(os.path.join(train_dir, "stats_experiments.json"))
    n_checked = 0
    for split, modes in (("train", ("train", "val")), ("test", ("test",))):
        rows, ctrl = read_metadata_csvs(os.path.join(data, "metadata"), split)
        index = load_metadata(rows, ctrl, split)
        pack = PackStore(os.path.join(dec, f"{split}.rxpack"))
        for mode in modes:
            kw = dict(seed=1, shuffle=mode == "train", drop_last=mode == "train")
            want_pipe = Pipeline(index, pack, stats, B, mode, **kw)
            for preload in (True, False):
                pipe = Pipeline(index, ByteStore(index, data, preload=preload), stats, B, mode,
                                src_size=SRC, decoder_threads=4, device=dev, **kw)
                for epoch in (0, 1):
                    got_b, want_b = list(pipe.epoch(epoch)), list(want_pipe.epoch(epoch))
                    if len(got_b) != len(want_b) or not got_b:
                        fail(f"{mode} pipeline from the tree gave {len(got_b)} batches, the "
                             f"pack {len(want_b)}")
                    for g_, w_ in zip(got_b, want_b):
                        on_card = isinstance(g_["images"], torch.Tensor)
                        if on_card != (dev.type == "cuda") or not np.array_equal(
                                host(g_["images"]), w_["images"]):
                            fail(f"{mode} batch from the tree (preload {preload}) differs "
                                 "from the pack's")
                        if g_["id_codes"] != w_["id_codes"] or any(
                                not np.array_equal(g_[k], w_[k])
                                for k in ("labels", "mean", "std", "valid")):
                            fail(f"{mode} batch metadata from the tree differs from the pack's")
                        n_checked += 1
    print(f"(a) pipeline batches from the tree (preloaded and streaming, nvJPEG on the card) "
          f"equal the decoded pack's bit for bit: {n_checked} batches of train, val and test "
          f"modes over two epochs")

    # (b) rxtpu's default run: no --pack, the stats artifact absent
    run = os.path.join(jpeg_dir, "run")
    os.makedirs(run)
    stats_path = os.path.join(run, "stats_experiments.json")
    argv = ["--experiment_id", "jpeg", "--data-dir", data, "--stats", stats_path,
            "--out-dir", run, "--split-by-experiment", "--epochs", "1", "--no-plate-leak",
            "--device", "cuda"]
    resolve = cli.resolve_config

    def log_every_step(args):
        cfg = resolve(args)
        cfg.train.log_every_steps = 1
        return cfg

    cwd = os.getcwd()
    cli.resolve_config = log_every_step
    os.chdir(run)
    for kernel in shear_kernels:
        kernel.launches = 0
    crop_normalize.launches = 0
    jd.decode_batch.launches = jd.decode_files.launches = 0
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        cli.resolve_config = resolve
    n_steps = 64 // B
    launches = [k.launches for k in shear_kernels]
    print(f"(b) cli (no --pack, stats absent) rc {rc} in {time.perf_counter() - t0:.2f} s; "
          f"K2-K4 launches {launches} for {n_steps} train steps; K1 {crop_normalize.launches}; "
          f"nvJPEG decode_batch calls {jd.decode_batch.launches}, decode_files calls "
          f"{jd.decode_files.launches} (the stats pass)")
    if rc != 0:
        fail(f"the JPEG cli run exited {rc}")
    if launches != [n_steps] * 3 or crop_normalize.launches == 0:
        fail("the JPEG run did not launch K2-K4 once per train step and K1 in eval")
    if jd.decode_batch.launches == 0 or jd.decode_files.launches == 0:
        fail("the JPEG run did not decode with nvJPEG")
    written = load_stats(stats_path)
    want = compute_stats_numpy((e, ch, p) for (e, ch), ps in decoded.items() for p in ps)
    worst = max(float(np.max(np.abs(written[e][k] / want[e][k] - 1)))
                for e in want for k in ("mean", "std"))
    print(f"(b) stats written by the run ({len(written)} experiments) against "
          f"compute_stats_numpy on the decoded planes: max relative difference {worst:.3g} "
          f"(limit {STATS_REL})")
    if sorted(written) != sorted(want) or not worst <= STATS_REL:
        fail("the computed stats artifact differs from compute_stats_numpy")
    logged = read_jsonl(os.path.join(run, "board", "jpeg", "metrics.jsonl"))
    losses = [r["training/loss"] for r in logged if "training/loss" in r]
    val_losses = [r["validation/loss"] for r in logged if "validation/loss" in r]
    print(f"(b) train losses {[round(v, 4) for v in losses]}; val losses "
          f"{[round(v, 4) for v in val_losses]}")
    if len(losses) != n_steps or len(val_losses) != 2 or not all(
            math.isfinite(v) for v in losses + val_losses):
        fail("a logged loss of the JPEG run is missing or not finite")
    with open(os.path.join(run, "submission_jpeg.csv"), "rb") as f:
        sub_jpeg = f.read()
    rows, _ = read_metadata_csvs(os.path.join(data, "metadata"), "test")
    if [line.split(",")[0] for line in sub_jpeg.decode().splitlines()[1:]] != [
            r["id_code"] for r in rows]:
        fail("the JPEG run's submission rows do not match the test ids")

    # (c) the test phase on (b)'s checkpoint from the pack of the decoded planes
    out = os.path.join(run, "from_pack")
    os.makedirs(out)
    os.chdir(run)
    try:
        rc = cli.main([out if a == run else a for a in argv] + ["--pack", dec])
    finally:
        os.chdir(cwd)
    with open(os.path.join(out, "submission_jpeg.csv"), "rb") as f:
        same = f.read() == sub_jpeg
    print(f"(c) test phase from --pack of the decoded planes: rc {rc}; submission "
          f"{'byte-equal to' if same else 'DIFFERENT from'} the JPEG tree's "
          f"({len(sub_jpeg.splitlines()) - 1} rows)")
    if rc != 0 or not same:
        fail("the test phase from the pack wrote another submission than from the tree")
    return {"data": data, "dec": dec, "argv": argv}


def jpeg_timings(dev, cli, jp, card):
    """Phase 7's JPEG numbers, at two contents: the fixture's uniform random
    planes (the worst case for the Huffman decode) and microscopy-like ones
    (``tests/data/jpeg_ref``'s two cell images, copied into every path of a
    second tree). One train batch (288 planes) and one test batch (576)
    decoded from memory at 1, 4 and nproc threads; the train loop's step time
    and input stall from each tree and from the decoded pack, at rxtpu's 4
    threads, over the same steps."""
    import torch

    from rxtpu_torch.data import decode as jd

    def tree_files(root):
        return sorted(os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
                      if f.endswith(".jpeg"))

    ref_dir = os.path.join(ROOT, "tests", "data", "jpeg_ref")
    cells = []
    for name in ("0.jpeg", "1.jpeg"):
        with open(os.path.join(ref_dir, name), "rb") as f:
            cells.append(f.read())
    cells_data = os.path.join(WORK, "jpeg", "cells_data")
    shutil.copytree(os.path.join(jp["data"], "metadata"), os.path.join(cells_data, "metadata"))
    for i, p in enumerate(tree_files(jp["data"])):
        out = os.path.join(cells_data, os.path.relpath(p, jp["data"]))
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "wb") as f:
            f.write(cells[i % 2])
    contents = {"uniform": ([], SRC), "cells": ([cells[i % 2] for i in range(576)],
                                               jd.jpeg_size(os.path.join(ref_dir, "0.jpeg"),
                                                            dev)[0])}
    for p in tree_files(os.path.join(jp["data"], "train"))[:576]:
        with open(p, "rb") as f:
            contents["uniform"][0].append(f.read())
    nproc = os.cpu_count()
    for content, (bufs, side) in contents.items():
        for n in (288, 576):
            for threads in (1, 4, nproc):
                jd.decode_batch(bufs[:n], side, side, nthreads=threads, strict=True, device=dev)
                torch.cuda.synchronize()
                reps = 3
                t0 = time.perf_counter()
                for _ in range(reps):
                    jd.decode_batch(bufs[:n], side, side, nthreads=threads, strict=True,
                                    device=dev)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / reps
                print(f"JPEG decode (nvJPEG, from memory), {content} content, {n} planes of "
                      f"{side}^2 ({sum(map(len, bufs[:n])) / n / 1e3:.1f} KB each) at {threads} "
                      f"threads: {ms:.2f} ms, {n * 1e3 / ms:.0f} planes/s; {card}")
    runs = (("JPEG tree, uniform content (nvJPEG, 4 threads)", []),
            ("JPEG tree, cells content (nvJPEG, 4 threads)", ["--data-dir", cells_data]),
            ("decoded pack", ["--pack", jp["dec"]]))
    for i, (source, extra) in enumerate(runs):
        run = os.path.join(WORK, "jpeg", f"loop_{i}")
        os.makedirs(run)
        argv = list(jp["argv"])  # --stats: the artifact phase 4c's run wrote
        argv[argv.index("--out-dir") + 1] = run
        argv[argv.index("--epochs") + 1] = "2"
        cwd = os.getcwd()
        os.chdir(run)
        try:
            rc = cli.main(argv + extra)
        finally:
            os.chdir(cwd)
        if rc != 0:
            fail(f"the timing run from the {source} exited {rc}")
        perf = [r for r in read_jsonl(os.path.join(run, "board", "jpeg", "metrics.jsonl"))
                if "perf/step_time_s" in r]
        for e, r in enumerate(perf, 1):
            print(f"train loop from the {source}, epoch {e} of 4 steps: perf/step_time_s "
                  f"{r['perf/step_time_s']:.4f}, perf/input_stall_pct "
                  f"{r['perf/input_stall_pct']:.2f}; {card}")


# ---------------------------------------------------------------------------
# PNG input and compressed packs (phase 4d and its timings in phase 7): the
# Kaggle release's PNG tree read by the port's PNG reader, and packs written
# by the port's pack tool (csrc/inflate_host.cpp on the host)
# ---------------------------------------------------------------------------
PACK_MODES = {  # phase 4d (b)'s packs: tool flags (zstd at a low level, for time)
    "zlib": ["--compress", "zlib"],
    "zlib+png": ["--compress", "zlib", "--filter", "png"],
    "zstd": ["--compress", "zstd", "--compress-level", "3"],
}


def codec_host_probe():
    """Phase 1's probe of the host's codec libraries: zlib's and zstd's
    headers and sonames, Python's zlib, and the codecs the port binds by
    dlopen. Returns the codecs this host has."""
    import zlib

    from rxtpu_torch.data.decode import CODEC_LIBRARIES, load_codec

    headers = [h for h in ("/usr/include/zlib.h", "/usr/include/zstd.h") if os.path.exists(h)]
    ldc = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True, timeout=60).stdout
    sonames = sorted({ln.split()[0] for ln in ldc.splitlines()
                      if re.search(r"libz\.so|libzstd", ln)})
    codecs = []
    for codec in CODEC_LIBRARIES:
        try:
            load_codec(codec)
            codecs.append(codec)
        except RuntimeError as e:
            print(f"codec {codec} not available: {e}")
    print(f"codec route on this host: headers {headers or 'absent'}, ldconfig {sonames}, "
          f"Python zlib {zlib.ZLIB_RUNTIME_VERSION}; the port binds by dlopen "
          f"{[CODEC_LIBRARIES[c] for c in codecs]} (csrc/inflate_host.cpp)")
    return codecs


def tree_files(root, ext):
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(f".{ext}"))


def run_cli(cli, run, argv):
    """``cli.main(argv)`` from ``run``; returns its exit code."""
    cwd = os.getcwd()
    os.chdir(run)
    try:
        return cli.main(argv)
    finally:
        os.chdir(cwd)


def pack_keys(index):
    from rxtpu_torch.data.records import all_records

    return [(r, s) for r in all_records(index) for s in (1, 2)]


def png_phase(dev, cli, train_dir, shear_kernels, crop_normalize, codecs):
    """Phase 4d: (a) phase 3's fixture as a PNG tree: the port's reader gives
    the raw pack's planes bit for bit, and the pipeline's batches from the
    tree (preloaded and streaming) equal the pack's in train, val and test
    modes; (b) ``python -m rxtpu_torch.tools pack`` from the tree as zlib,
    zlib+png and, where the host has libzstd.so.1, zstd: every PackStore
    batch equal to the raw pack's; (c) the CLI with ``--image-ext png``, no
    --pack and no stats artifact, then the test phase from the zlib+png and
    the raw pack, the same submission bytes; (d) ``png2jpeg`` on a copy of
    the tree. Returns what phase 7 reuses."""
    import numpy as np
    import torch

    from rxtpu_torch import tools
    from rxtpu_torch.data import decode as jd
    from rxtpu_torch.data.pack import PackStore
    from rxtpu_torch.data.pipeline import ByteStore, Pipeline
    from rxtpu_torch.data.records import load_metadata, read_metadata_csvs
    from rxtpu_torch.data.stats import load_stats
    from rxtpu_torch.data.synthetic import write_png_tree

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

    png_dir = os.path.join(WORK, "png")
    data = os.path.join(png_dir, "data")
    raw_dir = os.path.join(train_dir, "packs")
    shutil.copytree(os.path.join(train_dir, "data", "metadata"), os.path.join(data, "metadata"))
    t0 = time.perf_counter()
    n_files = write_png_tree(raw_dir, data)
    sizes = [os.path.getsize(p) for p in tree_files(data, "png")]
    print(f"(a) PNG tree of phase 3's fixture: {n_files} files of {SRC}^2 (zlib level 6, the "
          f"row filter) in {time.perf_counter() - t0:.2f} s, mean {np.mean(sizes) / 1e3:.1f} KB "
          "per file")
    indexes, raws = {}, {}
    for split in ("train", "test"):
        rows, ctrl = read_metadata_csvs(os.path.join(data, "metadata"), split)
        indexes[split] = load_metadata(rows, ctrl, split)
        raws[split] = PackStore(os.path.join(raw_dir, f"{split}.rxpack"))
    t0, n_planes = time.perf_counter(), 0
    for split, index in indexes.items():
        keys, tree = pack_keys(index), ByteStore(index, data, "png", preload=False)
        for i in range(0, len(keys), 48):
            chunk = keys[i:i + 48]
            paths = [p for r, s in chunk for p in tree.paths(r, s)]
            got = jd.decode_files(paths, SRC, SRC, nthreads=0, strict=True, device=dev)
            if isinstance(got, torch.Tensor) != (dev.type == "cuda") or not np.array_equal(
                    host(got).reshape(len(chunk), 6, SRC, SRC),
                    raws[split].get_decoded_batch(chunk)):
                fail(f"the PNG reader's planes of {split} differ from the raw pack's")
            n_planes += len(paths)
    print(f"(a) the PNG reader's planes of all {n_planes} files (on the card by a pinned copy) "
          f"equal the raw pack's bit for bit ({time.perf_counter() - t0:.2f} s)")
    stats = load_stats(os.path.join(train_dir, "stats_experiments.json"))
    n_checked = 0
    for split, modes in (("train", ("train", "val")), ("test", ("test",))):
        index = indexes[split]
        for mode in modes:
            kw = dict(seed=1, shuffle=mode == "train", drop_last=mode == "train")
            want_pipe = Pipeline(index, raws[split], stats, B, mode, **kw)
            for preload in (True, False):
                pipe = Pipeline(index, ByteStore(index, data, "png", preload=preload), stats,
                                B, mode, src_size=SRC, decoder_threads=4, device=dev, **kw)
                got_b, want_b = list(pipe.epoch(0)), list(want_pipe.epoch(0))
                if len(got_b) != len(want_b) or not got_b:
                    fail(f"{mode} pipeline from the PNG tree gave {len(got_b)} batches, the "
                         f"pack {len(want_b)}")
                for g_, w_ in zip(got_b, want_b):
                    if not np.array_equal(host(g_["images"]), w_["images"]) or \
                            g_["id_codes"] != w_["id_codes"] or any(
                                not np.array_equal(g_[k], w_[k])
                                for k in ("labels", "mean", "std", "valid")):
                        fail(f"{mode} batch from the PNG tree (preload {preload}) differs "
                             "from the raw pack's")
                    n_checked += 1
    print(f"(a) pipeline batches from the PNG tree (preloaded and streaming) equal the raw "
          f"pack's bit for bit: {n_checked} batches of train, val and test modes")

    # (b) the pack tool from the tree, every codec this host has
    packs = {}
    raw_bytes = sum(os.path.getsize(os.path.join(raw_dir, f"{s}.rxpack")) for s in indexes)
    for name, flags in PACK_MODES.items():
        if name.split("+")[0] not in codecs:
            print(f"(b) {name} pack skipped: this host cannot load "
                  f"{jd.CODEC_LIBRARIES[name.split('+')[0]]}")
            continue
        out = os.path.join(png_dir, "packs_" + name.replace("+", "_"))
        t0 = time.perf_counter()
        tools.main(["pack", "--data", data, "--out", out, "--ext", "png", "--device", "cuda"]
                   + flags)
        wrote = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(out, f"{s}.rxpack")) for s in indexes)
        t0, n_views = time.perf_counter(), 0
        for split, index in indexes.items():
            store, keys = PackStore(os.path.join(out, f"{split}.rxpack")), pack_keys(index)
            for i in range(0, len(keys), 48):
                if not np.array_equal(store.get_decoded_batch(keys[i:i + 48], nthreads=4),
                                      raws[split].get_decoded_batch(keys[i:i + 48])):
                    fail(f"{name} pack's {split} batch differs from the raw pack's")
                n_views += len(keys[i:i + 48])
        packs[name] = out
        print(f"(b) tools pack {' '.join(flags)}: {size / 1e6:.1f} MB (raw {raw_bytes / 1e6:.1f}"
              f" MB) in {wrote:.2f} s; its PackStore batches of all {n_views} views equal the "
              f"raw pack's bit for bit ({time.perf_counter() - t0:.2f} s at 4 threads)")
    print(f"(b) codecs run: {sorted(packs)}")
    if "zlib+png" not in packs:
        fail("the zlib+png pack was not written")

    # (c) the CLI from the PNG tree: no --pack, the stats artifact absent
    run = os.path.join(png_dir, "run")
    os.makedirs(run)
    stats_path = os.path.join(run, "stats_experiments.json")
    argv = ["--experiment_id", "png", "--data-dir", data, "--image-ext", "png", "--stats",
            stats_path, "--out-dir", run, "--split-by-experiment", "--epochs", "1",
            "--no-plate-leak", "--device", "cuda"]
    resolve = cli.resolve_config

    def log_every_step(args):
        cfg = resolve(args)
        cfg.train.log_every_steps = 1
        return cfg

    cli.resolve_config = log_every_step
    for kernel in shear_kernels:
        kernel.launches = 0
    crop_normalize.launches = 0
    t0 = time.perf_counter()
    try:
        rc = run_cli(cli, run, argv)
        torch.cuda.synchronize()
    finally:
        cli.resolve_config = resolve
    n_steps = 64 // B
    launches = [k.launches for k in shear_kernels]
    print(f"(c) cli --image-ext png (no --pack, stats absent) rc {rc} in "
          f"{time.perf_counter() - t0:.2f} s; K2-K4 launches {launches} for {n_steps} train "
          f"steps; K1 {crop_normalize.launches}")
    if rc != 0:
        fail(f"the PNG cli run exited {rc}")
    if launches != [n_steps] * 3 or crop_normalize.launches == 0:
        fail("the PNG run did not launch K2-K4 once per train step and K1 in eval")
    written, want = load_stats(stats_path), stats
    worst = max(float(np.max(np.abs(written[e][k] / want[e][k] - 1)))
                for e in want for k in ("mean", "std"))
    print(f"(c) stats written by the run ({len(written)} experiments) against the fixture's: "
          f"max relative difference {worst:.3g} (limit {STATS_REL})")
    if sorted(written) != sorted(want) or not worst <= STATS_REL:
        fail("the stats computed from the PNG tree differ from the fixture's")
    logged = read_jsonl(os.path.join(run, "board", "png", "metrics.jsonl"))
    losses = [r["training/loss"] for r in logged if "training/loss" in r]
    val_losses = [r["validation/loss"] for r in logged if "validation/loss" in r]
    print(f"(c) train losses {[round(v, 4) for v in losses]}; val losses "
          f"{[round(v, 4) for v in val_losses]}")
    if len(losses) != n_steps or len(val_losses) != 2 or not all(
            math.isfinite(v) for v in losses + val_losses):
        fail("a logged loss of the PNG run is missing or not finite")
    with open(os.path.join(run, "submission_png.csv"), "rb") as f:
        sub_png = f.read()
    rows, _ = read_metadata_csvs(os.path.join(data, "metadata"), "test")
    if [line.split(",")[0] for line in sub_png.decode().splitlines()[1:]] != [
            r["id_code"] for r in rows]:
        fail("the PNG run's submission rows do not match the test ids")
    for name, pack in (("zlib+png", packs["zlib+png"]), ("raw", raw_dir)):
        out = os.path.join(run, "from_" + name.replace("+", "_"))
        os.makedirs(out)
        rc = run_cli(cli, run, [out if a == run else a for a in argv] + ["--pack", pack])
        with open(os.path.join(out, "submission_png.csv"), "rb") as f:
            same = f.read() == sub_png
        print(f"(c) test phase from the {name} pack: rc {rc}; submission "
              f"{'byte-equal to' if same else 'DIFFERENT from'} the PNG tree's "
              f"({len(sub_png.splitlines()) - 1} rows)")
        if rc != 0 or not same:
            fail(f"the test phase from the {name} pack wrote another submission")

    # (d) png2jpeg on a copy of the tree; nvJPEG decodes every JPEG it wrote
    copy = os.path.join(png_dir, "data_jpeg")
    shutil.copytree(data, copy)
    t0 = time.perf_counter()
    jd.encode_batch_jpeg.launches = 0
    n = tools.run_png2jpeg(copy, device=dev)
    wrote = time.perf_counter() - t0
    pngs, jpegs = tree_files(copy, "png"), tree_files(copy, "jpeg")
    if n != len(pngs) or [p[:-4] for p in pngs] != [p[:-5] for p in jpegs]:
        fail(f"png2jpeg wrote {len(jpegs)} JPEGs for {len(pngs)} PNGs")
    gap = 0
    for i in range(0, len(jpegs), 288):
        planes = host(jd.decode_files(jpegs[i:i + 288], SRC, SRC, strict=True, device=dev))
        ref = host(jd.decode_files(pngs[i:i + 288], SRC, SRC, strict=True))
        gap = max(gap, int(np.abs(planes.astype(np.int16) - ref).max()))
    print(f"(d) png2jpeg (nvJPEG, {jd.encode_batch_jpeg.launches} encode calls): {n} JPEGs "
          f"for {len(pngs)} PNGs in {wrote:.2f} s; nvJPEG decodes all of them, at most {gap} "
          "levels from the PNG planes (uniform random content at quality 95)")
    shutil.rmtree(copy)
    return {"data": data, "raw": raw_dir, "packs": packs, "argv": argv}


def png_timings(dev, cli, pp, card, codecs):
    """Phase 7's PNG and pack numbers, at two contents: the fixture's uniform
    random planes and microscopy-like ones (``tests/data/jpeg_ref``'s two
    cell images, decoded and written as PNGs). A 288-plane batch (48 views)
    of PNGs decoded from memory onto the card, and each codec's inflate of
    48 views, at 1, 4 and nproc threads; the train loop's step time and
    input stall from each PNG tree, from the zlib+png packs of both
    contents, from the cells tree's zstd+png pack (where the host has
    libzstd.so.1) and from the raw pack, at rxtpu's 4 threads, over the same
    steps."""
    import numpy as np
    import torch

    from rxtpu_torch import tools
    from rxtpu_torch.data import decode as jd
    from rxtpu_torch.data.synthetic import png_bytes

    ref_dir = os.path.join(ROOT, "tests", "data", "jpeg_ref")
    cell_paths = [os.path.join(ref_dir, n) for n in ("0.jpeg", "1.jpeg")]
    side = jd.jpeg_size(cell_paths[0], dev)[0]
    cell_planes = jd.decode_files(cell_paths, side, side, strict=True, device=dev)
    cell_planes = np.ascontiguousarray(torch.as_tensor(cell_planes).cpu().numpy()[:, :SRC, :SRC])
    cell_pngs = [png_bytes(s, SRC, SRC) for s in jd.deflate_filtered_batch(
        cell_planes[:, None], level=6, use_filter=True, codec="zlib")]
    uniform = []
    for p in tree_files(os.path.join(pp["data"], "train"), "png")[:288]:
        with open(p, "rb") as f:
            uniform.append(f.read())
    raw_views = np.memmap(os.path.join(pp["raw"], "train.rxpack"), dtype=np.uint8,
                          mode="r").reshape(-1, 6, SRC, SRC)[:48]
    contents = {"uniform": (uniform, np.ascontiguousarray(raw_views)),
                "cells": ([cell_pngs[i % 2] for i in range(288)],
                          np.stack([cell_planes[i % 2] for i in range(288)]).reshape(
                              48, 6, SRC, SRC))}
    nproc = os.cpu_count()

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    view_mb = 48 * 6 * SRC * SRC / 1e6
    for content, (bufs, views) in contents.items():
        kb = sum(map(len, bufs)) / len(bufs) / 1e3
        for threads in (1, 4, nproc):
            ms = timed(lambda: jd.decode_batch(bufs, SRC, SRC, nthreads=threads, strict=True,
                                               device=dev))
            print(f"PNG decode (host, from memory, then one pinned copy to the card), {content} "
                  f"content, 288 planes of {SRC}^2 ({kb:.1f} KB each) at {threads} threads: "
                  f"{ms:.2f} ms, {288e3 / ms:.0f} planes/s; {card}")
        for codec, use_filter, level in (("zlib", False, 6), ("zlib", True, 6),
                                         ("zstd", False, 3), ("zstd", True, 3)):
            if codec not in codecs:
                continue
            name = codec + ("+png" if use_filter else "")
            t0 = time.perf_counter()
            streams = jd.deflate_filtered_batch(views, level, use_filter, 0, codec)
            comp_ms = (time.perf_counter() - t0) * 1e3
            lengths = np.array([len(s) for s in streams], np.int64)
            offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
            data = np.frombuffer(b"".join(streams), np.uint8)
            for threads in (1, 4, nproc):
                if use_filter:
                    ms = timed(lambda: jd.inflate_unfilter_batch(
                        data, offsets, lengths, 6, SRC, SRC, threads, True, codec))
                else:
                    ms = timed(lambda: jd.inflate_batch(data, offsets, lengths,
                                                        6 * SRC * SRC, threads, True, codec))
                print(f"inflate {name} (level {level}), {content} content, 48 views of "
                      f"6x{SRC}^2 (ratio {data.size / (view_mb * 1e6):.3f}, compressed in "
                      f"{comp_ms:.0f} ms at {nproc} threads) at {threads} threads: {ms:.2f} "
                      f"ms, {view_mb * 1e3 / ms:.0f} MB/s of planes; {card}")

    # the cells tree: the two cell PNGs in every path, and its zlib+png pack
    cells_data = os.path.join(WORK, "png", "cells_data")
    shutil.copytree(os.path.join(pp["data"], "metadata"), os.path.join(cells_data, "metadata"))
    for i, p in enumerate(tree_files(pp["data"], "png")):
        out = os.path.join(cells_data, os.path.relpath(p, pp["data"]))
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "wb") as f:
            f.write(cell_pngs[i % 2])
    runs = [("PNG tree, uniform content (4 threads)", []),
            ("PNG tree, cells content (4 threads)", ["--data-dir", cells_data]),
            ("zlib+png pack, uniform content (4 threads)", ["--pack", pp["packs"]["zlib+png"]])]
    for codec in ("zlib", "zstd"):  # the cells tree's packs, row-filtered
        if codec not in codecs:
            continue
        out = os.path.join(WORK, "png", f"packs_cells_{codec}_png")
        flags = ["--compress", codec, "--filter", "png"] + (
            ["--compress-level", "3"] if codec == "zstd" else [])
        tools.main(["pack", "--data", cells_data, "--out", out, "--ext", "png",
                    "--device", "cuda"] + flags)
        runs.append((f"{codec}+png pack, cells content (4 threads)", ["--pack", out]))
    runs.append(("raw pack", ["--pack", pp["raw"]]))
    for i, (source, extra) in enumerate(runs):
        run = os.path.join(WORK, "png", f"loop_{i}")
        os.makedirs(run)
        argv = list(pp["argv"])  # --stats: the artifact phase 4d's run wrote
        argv[argv.index("--out-dir") + 1] = run
        argv[argv.index("--epochs") + 1] = "2"
        rc = run_cli(cli, run, argv + extra)
        if rc != 0:
            fail(f"the timing run from the {source} exited {rc}")
        perf = [r for r in read_jsonl(os.path.join(run, "board", "png", "metrics.jsonl"))
                if "perf/step_time_s" in r]
        for e, r in enumerate(perf, 1):
            print(f"train loop from the {source}, epoch {e} of 4 steps: perf/step_time_s "
                  f"{r['perf/step_time_s']:.4f}, perf/input_stall_pct "
                  f"{r['perf/input_stall_pct']:.2f}; {card}")


# ---------------------------------------------------------------------------
# K8, the int8 conv, and the --quantize int8 test phase (phases 2, 4e, 4f and
# their timings in phase 7)
# ---------------------------------------------------------------------------
INT8_OPS = 1979e12  # H100 SXM int8 tensor cores, dense (a multiply-add is two operations)
K8_REPLACES = "rxtpu/models/quant.py:167"  # the XLA int8 conv (lax.conv_general_dilated)
K8_LAUNCHES = 53  # per ResNet-50 forward: the stem, 16 blocks x 3 convs, 4 projections
# (label, N, H, W, Cin, Cout, kernel, stride, padding): ResNet-50's conv kinds at
# their widths and the test size's planes, few views (the plain version's conv
# runs in float64), then ragged shapes: odd H and W, M off the 128-row tile,
# Cout off the 64- and 128-column tiles (40, 72; 320 leaves half a 128 tile;
# 200 int8 bytes a row are no whole 16-byte chunks, so its int8 residual and
# output go element by element), K = 294 off the 64-byte stage. Cout >= 128
# takes 128-column tiles (256, 512, 2048, 320, 200 among these).
K8_CHECKS = (
    ("stem 7x7/2", 2, 512, 512, 6, 64, 7, 2, 3),
    ("1x1/1 stage1 Conv_2", 2, 128, 128, 64, 256, 1, 1, 0),
    ("3x3/1 stage1", 2, 128, 128, 64, 64, 3, 1, 1),
    ("3x3/2 stage2", 2, 128, 128, 128, 128, 3, 2, 1),
    ("1x1/2 stage2 proj", 2, 128, 128, 256, 512, 1, 2, 0),
    ("1x1/1 stage4 Conv_2", 4, 16, 16, 512, 2048, 1, 1, 0),
    ("ragged 3x3/1", 3, 7, 5, 96, 40, 3, 1, 1),
    ("ragged 1x1/1", 1, 9, 11, 32, 72, 1, 1, 0),
    ("ragged 1x1/1 Cout 320", 2, 24, 19, 128, 320, 1, 1, 0),
    ("ragged 3x3/1 Cout 200", 2, 9, 13, 64, 200, 3, 1, 1),
    ("ragged stem", 1, 513, 511, 6, 64, 7, 2, 3),
)
# (label, N, H, W): the stem entry's NCHW views, 6 channels: the test shape and
# a ragged one (odd rows, a row width not a multiple of 8, so the patch's
# columns load element by element, and 257 output columns: a 1-pixel tile)
K8_STEM_CHECKS = (("stem 7x7/2 NCHW", 2, 512, 512), ("ragged stem NCHW", 1, 513, 511))
# (label, requantize, relu, residual): the forward's epilogues and the rest
K8_EPILOGUES = (("int8 relu", True, True, None), ("int8 relu + int8 res", True, True, "int8"),
                ("int8", True, False, None), ("bf16 relu + int8 res", False, True, "int8"),
                ("bf16", False, False, None), ("f32 relu + f32 res", False, True, "float"))
K8_STEM_EPILOGUES = [e for e in K8_EPILOGUES if e[3] is None]  # the stem has no residual


def k8_operands(case, seed, dev):
    """int8 input and weights over the whole range, scales that put the
    outputs at O(1) (so requantize clips some and rounds the rest), N(0,1)
    biases, an int8 and a float residual."""
    import torch

    _, n, h, w, cin, cout, k, s, p = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1

    def i8(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=gen)

    in_scale = torch.tensor(1.0 / (127.0 * math.sqrt(k * k * cin)), device=dev)
    w_scale = (torch.rand(cout, device=dev, generator=gen) + 0.5) / 127.0
    return dict(x=i8(n, h, w, cin), w=i8(cout, k * k * cin), scale=w_scale * in_scale,
                bias=torch.randn(cout, device=dev, generator=gen),
                rq=i8(n, ho, wo, cout), rs=torch.tensor(0.9 / 127.0, device=dev),
                rf=torch.randn(n, ho, wo, cout, device=dev, generator=gen),
                inv=torch.tensor(127.0 / 1.3, device=dev))


def k8_kwargs(ops, requant, relu, res):
    import torch

    return dict(residual={None: None, "int8": ops["rq"], "float": ops["rf"]}[res],
                residual_scale=ops["rs"] if res == "int8" else None, relu=relu,
                inv_out_scale=ops["inv"] if requant else None,
                out_dtype=torch.float32 if res == "float" else torch.bfloat16)


def k8_phase2(dev):
    """Phase 2's K8: every shape and epilogue bit-equal to the plain version
    (the exact float64 sums and the same epilogue in torch ops), two launches
    bit-equal, and inputs built on exact .5 ties of the requantize. Returns
    max |kernel - plain|."""
    import torch
    from rxtpu_torch.ops import int8_conv as k8

    phase("2 K8 int8_conv against its plain version (bit equality; the plain conv in float64 "
          "on the card)")
    worst = 0.0
    for seed, case in enumerate(K8_CHECKS):
        label, n, h, w, cin, cout, k, s, p = case
        ops = k8_operands(case, seed, dev)
        acc = k8.int8_conv_sums(ops["x"], ops["w"], k, s, p)  # the plain version's sums
        results = []
        for ep_label, requant, relu, res in K8_EPILOGUES:
            kw = k8_kwargs(ops, requant, relu, res)
            out = k8.int8_conv(ops["x"], ops["w"], ops["scale"], ops["bias"], k, s, p, **kw)
            again = k8.int8_conv(ops["x"], ops["w"], ops["scale"], ops["bias"], k, s, p, **kw)
            ref = k8.epilogue(acc, ops["scale"], ops["bias"], kw["residual"],
                              kw["residual_scale"], relu, kw["inv_out_scale"], kw["out_dtype"])
            torch.cuda.synchronize()
            bad, err = bitwise_diff(out, ref)
            rep, _ = bitwise_diff(out, again)
            worst = max(worst, err)
            results.append(f"{ep_label} {bad}/{rep}")
            if bad or rep:
                fail(f"K8 {label} [{n},{h},{w},{cin}] -> {cout} {k}x{k}/{s}, {ep_label}: "
                     f"{bad} outputs differ from the plain version (max {err}), {rep} between "
                     f"two launches")
        print(f"{label} [{n},{h},{w},{cin}] -> [{n},{acc.shape[1]},{acc.shape[2]},{cout}] "
              f"{k}x{k}/{s} pad {p}: mismatches (plain/repeat) {', '.join(results)}; "
              f"max|sum| {int(acc.abs().max())}")
        del ops, acc
    worst = max(worst, k8_stem_phase2(dev))
    # .5 ties: small operands, scale 1, bias +-0.5 and out scale 1, so every
    # output o = sum +- 0.5 is exact and rounds half to even
    case = ("ties 3x3/1", 2, 64, 64, 64, 64, 3, 1, 1)
    gen = torch.Generator(device=dev).manual_seed(99)
    x = torch.randint(-2, 3, (2, 64, 64, 64), dtype=torch.int8, device=dev, generator=gen)
    wt = torch.randint(-1, 2, (64, 9 * 64), dtype=torch.int8, device=dev, generator=gen)
    one = torch.ones(64, device=dev)
    half = torch.where(torch.arange(64, device=dev) % 2 == 0, 0.5, -0.5)
    inv = torch.tensor(1.0, device=dev)
    out = k8.int8_conv(x, wt, one, half, 3, 1, 1, inv_out_scale=inv)
    acc = k8.int8_conv_sums(x, wt, 3, 1, 1)
    ref = k8.epilogue(acc, one, half, inv_out_scale=inv)
    torch.cuda.synchronize()
    bad, err = bitwise_diff(out, ref)
    v = acc.double() + half.double()
    ties = int((v.abs() < 127).sum())
    even = bool((ref[v.abs() < 127].double() % 2 == 0).all())
    print(f"{case[0]}: {ties} of {v.numel()} outputs on exact .5 ties inside the clip, every "
          f"plain result even: {even}; mismatches {bad}")
    if bad or ties < v.numel() // 2 or not even:
        fail("K8 rounds .5 ties otherwise than its plain version")
    return max(worst, err)


def k8_stem_phase2(dev):
    """Phase 2's K8 stem entry: NCHW views in bf16, f32 (quantized in the
    kernel at in_scale 1/32, so many land on .5 ties and some clip) and int8
    (``quantize`` of the same views), every epilogue bit-equal to the plain
    version and over two launches, and the three inputs' outputs equal.
    Returns max |kernel - plain|."""
    import torch
    from rxtpu_torch.ops import int8_conv as k8

    worst = 0.0
    for seed, (label, n, h, w) in enumerate(K8_STEM_CHECKS, start=len(K8_CHECKS)):
        ops = k8_operands((label, n, h, w, 6, 64, 7, 2, 3), seed, dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        in_scale = torch.tensor(1.0 / 32.0, device=dev)
        xf = torch.randn(n, 6, h, w, device=dev, generator=gen) * 2.0
        views = {"bf16": xf.to(torch.bfloat16), "f32": xf}
        views["int8"] = k8.quantize(views["bf16"], in_scale)
        weight = ops["w"]
        packed = k8.pack_stem_weight(weight)
        outs, results = {}, []
        for kind, x in views.items():
            bad_sum = rep_sum = 0
            xq = x if x.dtype == torch.int8 else k8.quantize(x, in_scale)
            acc = k8.int8_conv_sums(xq.permute(0, 2, 3, 1), weight, 7, 2, 3)  # the plain sums
            for ep_label, requant, relu, res in K8_STEM_EPILOGUES:
                kw = k8_kwargs(ops, requant, relu, res)
                del kw["residual"], kw["residual_scale"]
                before = k8.int8_conv.launches
                out = k8.int8_stem_conv(x, packed, ops["scale"], ops["bias"], in_scale, **kw)
                again = k8.int8_stem_conv(x, packed, ops["scale"], ops["bias"], in_scale, **kw)
                ref = k8.epilogue(acc, ops["scale"], ops["bias"], None, None, relu,
                                  kw["inv_out_scale"], kw["out_dtype"])
                torch.cuda.synchronize()
                bad, err = bitwise_diff(out, ref)
                rep, _ = bitwise_diff(out, again)
                worst = max(worst, err)
                if k8.int8_conv.launches != before + 2:
                    fail(f"K8 stem entry: int8_conv.launches moved by "
                         f"{k8.int8_conv.launches - before}, not 2")
                if bad or rep:
                    fail(f"K8 {label} [{n},6,{h},{w}] {kind}, {ep_label}: {bad} outputs differ "
                         f"from the plain version (max {err}), {rep} between two launches")
                if kind == "bf16":
                    outs[ep_label] = out
                elif kind == "int8" and bitwise_diff(out, outs[ep_label])[0]:
                    fail(f"K8 {label}: int8 views give another {ep_label} output than bf16 ones")
                bad_sum, rep_sum = bad_sum + bad, rep_sum + rep
            results.append(f"{kind} {bad_sum}/{rep_sum}")
        ties = int((views["bf16"].float() * 32 % 1 == 0.5).sum())
        clipped = int((views["bf16"].float().abs() * 32 > 127).sum())
        print(f"{label} [{n},6,{h},{w}] -> [{n},{acc.shape[1]},{acc.shape[2]},64], "
              f"{len(K8_STEM_EPILOGUES)} epilogues each: mismatches (plain/repeat) "
              f"{', '.join(results)}; bf16 views on .5 ties {ties}, clipped "
              f"{clipped}; int8 views equal to bf16 ones on every epilogue")
        del ops, views, acc
    return worst


def int8_batch(dev, seed):
    """One full-width test batch [16, 6, 6, 512^2] and its per-sample mean/std."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return {"images": torch.randint(0, 256, (B, 6, 6, SRC, SRC), dtype=torch.uint8,
                                    device=dev, generator=gen),
            "mean": torch.rand(B, 6, device=dev, generator=gen) * 0.4 + 0.1,
            "std": torch.rand(B, 6, device=dev, generator=gen) * 0.2 + 0.05}


def check_submission(path, fx, n_classes=1108):
    """A submission's ids follow the test rows, its sirnas are in range, one
    per well of a plate, each on its well's plate. Returns the sirnas."""
    with open(path, newline="") as f:
        sub = list(csv.DictReader(f))
    if [r["id_code"] for r in sub] != [r["id_code"] for r in fx["test_rows"]]:
        fail(f"{path}: rows do not match the test ids")
    sirnas = [int(r["sirna"]) for r in sub]
    if not all(0 <= s < n_classes for s in sirnas):
        fail(f"{path}: sirna out of [0, {n_classes})")
    by_plate = {}
    for row, s in zip(fx["test_rows"], sirnas):
        if fx["plate_groups"][s, 0] != row["plate"]:
            fail(f"{path}: {row['id_code']}: sirna {s} is not on plate {row['plate']}")
        by_plate.setdefault(row["plate"], []).append(s)
    for plate, ss in by_plate.items():
        if len(set(ss)) != len(ss):
            fail(f"{path}: plate {plate}: assignment is not one-to-one")
    print(f"submission {os.path.basename(path)}: {len(sub)} rows, plates {sorted(by_plate)}, "
          f"one-to-one per plate, plate leak respected")
    return sirnas


def int8_cli_phase(cli, test_dir, argv, fx, n_batches):
    """Phase 4e: ``--quantize int8`` through ``rxtpu_torch.cli.main`` on phase 4's
    fixture and checkpoint: K1 once per test and calibration batch, K8 53
    times per test batch, a valid plate-leak submission. Returns K8's
    launches."""
    from rxtpu_torch.ops import int8_conv as k8
    from rxtpu_torch.ops.crop_norm import crop_normalize

    out_dir = os.path.join(test_dir, "int8")
    os.makedirs(out_dir)
    argv_q = [out_dir if a == test_dir else a for a in argv] + ["--quantize", "int8"]
    calib = min(2, n_batches)  # the CLI's default --calib-batches, within the first experiment
    cwd = os.getcwd()
    os.chdir(test_dir)
    # the path's launches: every count set to 0 just before, read just after
    crop_normalize.launches = k8.int8_conv.launches = 0
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv_q)
        import torch
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    k1, k8_launches = crop_normalize.launches, k8.int8_conv.launches
    print(f"cli --quantize int8 rc {rc} in {time.perf_counter() - t0:.2f} s; crop_norm launches "
          f"{k1} ({n_batches} test + {calib} calibration batches); int8_conv launches "
          f"{k8_launches} ({K8_LAUNCHES} x {n_batches} test batches)")
    if rc != 0:
        fail(f"cli --quantize int8 exited {rc}")
    if k1 != n_batches + calib or k8_launches != K8_LAUNCHES * n_batches:
        fail(f"--quantize int8 launched K1 {k1} and K8 {k8_launches} times")
    got = check_submission(os.path.join(out_dir, "submission_smoke.csv"), fx)
    bf16 = check_submission(os.path.join(test_dir, "submission_smoke.csv"), fx)
    print(f"int8 against bf16 submission: {sum(a != b for a, b in zip(got, bf16))} of "
          f"{len(got)} wells assigned otherwise")
    return k8_launches


def int8_forward_phase(dev, model, batch, launches=K8_LAUNCHES, gap_limit=0.08, min_agree=None):
    """Phase 4f (4g for DenseNet-121): the int8 predict step on one full-width
    batch, calibrated on it. On the kernels (K1, K8) against the plain
    versions on the card: the backbone's bf16 features and the probabilities
    bit-equal; against the bf16 ``Predictor``: top-1 agreement (at least
    ``min_agree``) and the largest probability gap (under ``gap_limit``); and
    once without transforms (K1's int8 mode). Returns the steps for phase 7,
    the gap and the agreement."""
    import torch
    from rxtpu_torch.infer.predict import Predictor, tta_transforms
    from rxtpu_torch.infer.quant import QuantPredictor, calibrate, prepare_quantized
    from rxtpu_torch.ops import crop_norm
    from rxtpu_torch.ops import int8_conv as k8

    t0 = time.perf_counter()
    qstats = calibrate(model, [batch], None, torch.bfloat16)
    qnet = prepare_quantized(model, qstats, torch.bfloat16)
    torch.cuda.synchronize()
    print(f"calibrate (1 batch) + prepare_quantized in {time.perf_counter() - t0:.2f} s; "
          f"stem in_scale {float(qnet.backbone.conv_init.in_scale):.6g}, kernel_q "
          f"{tuple(qnet.backbone.conv_init.kernel_q.shape)} int8")
    qstep = QuantPredictor(qnet, None, tta_transforms("none"))  # the CLI's path
    feats = []
    hook = qnet.backbone.register_forward_hook(lambda mod, i, out: feats.append(out))
    runs = {}
    for label in ("kernels", "plain"):
        saved = crop_norm.crop_normalize, k8.int8_conv, k8.int8_stem_conv
        if label == "plain":  # eval_batch_normalize and QuantConv look them up in the modules
            crop_norm.crop_normalize = crop_norm.crop_normalize_reference
            k8.int8_conv = k8.int8_conv_reference
            k8.int8_stem_conv = k8.int8_stem_conv_reference
        before = (saved[0].launches, saved[1].launches)
        try:
            t0 = time.perf_counter()
            probs = qstep(batch)
            torch.cuda.synchronize()
            runs[label] = (probs, feats[-1], time.perf_counter() - t0,
                           (saved[0].launches - before[0], saved[1].launches - before[1]))
        finally:
            crop_norm.crop_normalize, k8.int8_conv, k8.int8_stem_conv = saved
    hook.remove()
    (pk, fk, tk, lk), (pp, fp, tp, lp) = runs["kernels"], runs["plain"]
    fbad, ferr = bitwise_diff(fk, fp)
    pbad, perr = bitwise_diff(pk, pp)
    print(f"int8 predict B={B} G=6 {SRC}^2 on the kernels ({tk:.2f} s; K1/K8 launches {lk}) "
          f"against the plain versions ({tp:.2f} s; {lp}): features {tuple(fk.shape)} "
          f"{fk.dtype} mismatches {fbad} (max {ferr}), probabilities mismatches {pbad} "
          f"(max {perr})")
    if lk != (1, launches) or lp != (0, 0):
        fail(f"the int8 step launched K1/K8 {lk} times on the kernels, {lp} on the plain versions")
    if fbad or pbad or not bool(torch.isfinite(pk).all()) or tuple(pk.shape) != (B, 1108):
        fail("the int8 forward on the kernels differs from the plain versions")
    pstep = Predictor(model, None, dtype=torch.bfloat16)
    pb = pstep(batch)
    agree = float((pk.argmax(-1) == pb.argmax(-1)).float().mean())
    gap = float((pk - pb).abs().max())
    limit = "no limit" if gap_limit is None else f"limit {gap_limit}, tests/test_quant.py:109"
    print(f"int8 against the bf16 Predictor on the same batch: top-1 agreement {agree:.4f}"
          f"{'' if min_agree is None else f' (at least {min_agree}, tests/test_quant.py:205)'}, "
          f"max |probs int8 - bf16| {gap:.4g} ({limit}; max prob {float(pb.max()):.4g})")
    if not math.isfinite(gap) or (gap_limit is not None and gap >= gap_limit):
        fail(f"the int8 probabilities are {gap_limit} or more from the bf16 Predictor's")
    if min_agree is not None and agree < min_agree:
        fail(f"int8 and bf16 agree on {agree:.4f} of the top-1 classes, under {min_agree}")
    qstep_src = QuantPredictor(qnet, None, None)  # quantize-at-source: K1's int8 mode
    before = (crop_norm.crop_normalize.launches, k8.int8_conv.launches)
    ps = qstep_src(batch)
    torch.cuda.synchronize()
    launched = (crop_norm.crop_normalize.launches - before[0], k8.int8_conv.launches - before[1])
    print(f"QuantPredictor(transforms=None), K1 writing int8 views: K1/K8 launches {launched}; "
          f"max |probs - the bf16-view path's| {float((ps - pk).abs().max()):.4g}, top-1 "
          f"agreement {float((ps.argmax(-1) == pk.argmax(-1)).float().mean()):.4f}")
    if launched != (1, launches) or not bool(torch.isfinite(ps).all()):
        fail(f"the quantize-at-source step did not run K1 once and K8 {launches} times")
    return qstep, qstep_src, pstep, gap, agree


# PERF.md's K8 rows and the times of K8's first design for them (an epilogue
# stored element by element, the stem by a byte gather; its last chip run,
# NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
K8_FIRST_MS = {"stem 7x7/2": 5.2879, "1x1/1": 7.5098, "1x1/1 + residual": 19.9773,
              "3x3/1": 5.7264, "3x3/2": 1.2432, "1x1/2": 1.9911}
K8_FIRST_STEP_MS = 41.736
K8_FIRST_STEM_PREP_MS = 2.4417  # its quantize of the bf16 views and NHWC permute, outside K8


def k8_kind(k, s, res):
    if k == 7:
        return "stem 7x7/2"
    return f"{k}x{k}/{s}" + (" + residual" if res else "")


def int8_work(key):
    """Bytes (the input pixels some tap reads, weights, scale and bias,
    residual, each read once; output written once) and int8 operations (two
    per multiply-add) of one K8 call. A 1x1/2 projection reads one pixel in
    four, and a pixel's channels (256 or more) are one contiguous run, so the
    others are never fetched. The stem reads its views at their own width
    (bf16 views 2 bytes an element: the quantize is part of its work)."""
    n, h, w, cin, cout, k, s, p, res, out_bytes, in_bytes = key
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1

    def touched(size, out):  # input rows (or columns) that some tap reads
        return len({o * s - p + t for o in range(out) for t in range(k)} & set(range(size)))

    m, kk = n * ho * wo, k * k * cin
    moved = (n * touched(h, ho) * touched(w, wo) * cin * in_bytes + cout * kk + 8 * cout
             + m * cout * (res + out_bytes))
    return moved, 2 * m * cout * kk


def int8_bound_ms(key):
    """K8's bound for one call: (ms, bytes ms, operations ms)."""
    moved, ops = int8_work(key)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def int8_timings(dev, qstep, qstep_src, pstep, batch, card, launches=K8_LAUNCHES,
                 kind_of=lambda key: k8_kind(key[5], key[6], key[8]), first=K8_FIRST_MS):
    """Phase 7's int8 path: the predict steps (CLI path, quantize-at-source,
    the bf16 Predictor) by host clock and events, peak memory and a profile;
    K8 at each of the forward's distinct shapes by events beside its bound,
    its plain version, ``torch._int_mm`` (the 1x1 stride-1 shapes: the same
    int32 sums) and cuDNN's bf16 conv of the shape (context); the NHWC
    permute of the stem's input. Returns K8's (ms, plain, bound, bytes ms,
    operations ms, library yardstick ms, cuDNN bf16 conv ms) per predict step,
    and per conv kind (``kind_of`` a call's key) its (count, ms, bound,
    ``torch._int_mm`` ms, cuDNN ms); the yardstick is ``torch._int_mm`` for
    the 1x1 stride-1 shapes and cuDNN's bf16 conv of the shape for the
    others. ``first``: the times of K8's first design per kind, printed
    beside (ResNet-50's)."""
    import torch
    import torch.nn.functional as F
    from rxtpu_torch.ops import int8_conv as k8
    from rxtpu_torch.ops.crop_norm import eval_batch_normalize

    for label, step in (("int8 (CLI path: bf16 views)", qstep),
                        ("int8 quantize-at-source (int8 views)", qstep_src),
                        ("bf16 Predictor", pstep)):
        for _ in range(3):
            step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            step(batch)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / iters
        ev = cuda_ms(lambda: step(batch), iters, warmup=0)
        peak = torch.cuda.max_memory_allocated()
        print(f"predict step {label} B={B} G=6 {SRC}^2: {host:.3f} ms host clock, {ev:.3f} ms "
              f"CUDA events, {B * 6 * 1e3 / host:.1f} views/s, peak memory "
              f"{peak / 2**30:.3f} GiB [{card}]")
        if step is qstep:
            device_profile(lambda: step(batch), 3, "int8 predict steps", ev)

    # the forward's K8 calls, one per distinct shape and epilogue, with counts;
    # the key: (N, H, W, Cin, Cout, kernel, stride, pad, residual bytes, output
    # bytes, input bytes), the stem's from its NCHW views
    calls, real, real_stem = {}, k8.int8_conv, k8.int8_stem_conv

    def note(key, fn, args, kw):
        if key not in calls:
            calls[key] = [0, fn, args, kw]
        calls[key][0] += 1

    def epi_bytes(kw):
        res = kw.get("residual")
        return (0 if res is None else res.element_size(),
                1 if kw.get("inv_out_scale") is not None else 2)

    def record(x, weight, scale, bias, kernel_size, stride=1, padding=0, **kw):
        args = (x.contiguous(), weight, scale, bias, kernel_size, stride, padding)
        note((*x.shape, weight.shape[0], kernel_size, stride, padding, *epi_bytes(kw), 1),
             "conv", args, kw)
        return real(*args, **kw)

    def record_stem(x, weight, scale, bias, in_scale=None, **kw):
        n, cin, h, w = x.shape
        note((n, h, w, cin, weight.shape[0], 7, 2, 3, *epi_bytes(kw), x.element_size()),
             "stem", (x, weight, scale, bias, in_scale), kw)
        return real_stem(x, weight, scale, bias, in_scale, **kw)

    k8.int8_conv, k8.int8_stem_conv = record, record_stem
    try:
        qstep(batch)
    finally:
        k8.int8_conv, k8.int8_stem_conv = real, real_stem
    if sum(c[0] for c in calls.values()) != launches:
        fail(f"one int8 forward made {sum(c[0] for c in calls.values())} K8 calls")
    tot = [0.0] * 7
    rows = {}  # the conv kinds of PERF.md's K8 table: summed (ms, bound, _int_mm, cuDNN)
    for key, (count, entry, args, kw) in calls.items():
        n, h, w, cin, cout, k, s, p, res, out_bytes, in_bytes = key
        kernel, plain = {"conv": (k8.int8_conv, k8.int8_conv_reference),
                         "stem": (k8.int8_stem_conv, k8.int8_stem_conv_reference)}[entry]
        ms = cuda_ms(lambda: kernel(*args, **kw), 10)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), 1, warmup=1)
        moved, ops = int8_work(key)
        bnd, t_bytes, t_ops = int8_bound_ms(key)
        lib, mm_ms = "", None
        if k == 1 and s == 1:
            a = args[0].reshape(-1, cin)
            bt = args[1].t()  # [K, Cout], column-major
            mm_ms = cuda_ms(lambda: torch._int_mm(a, bt), 10)
            lib = f"torch._int_mm [{a.shape[0]},{cin}]x[{cin},{cout}] {mm_ms:.4f} ms; "
        x, weight = args[:2]
        if entry == "stem":  # NCHW views and packed weights
            xb, weight = x.to(torch.bfloat16), k8.unpack_stem_weight(weight, cin)
        else:
            xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)  # channels-last NCHW view
        wb = weight.reshape(cout, k, k, cin).permute(0, 3, 1, 2).to(torch.bfloat16)
        conv_ms = cuda_ms(lambda: F.conv2d(xb, wb, stride=s, padding=p), 10)
        print(f"K8 x{count} {entry} [{n},{h},{w},{cin}] {x.dtype} -> {cout} {k}x{k}/{s} pad {p} "
              f"res {res}B out {out_bytes}B: {ms:.4f} ms (bound {bnd:.4f} ms by "
              f"{'bytes' if t_bytes >= t_ops else 'operations'}: {moved / 1e6:.1f} MB, "
              f"{ops / 1e12:.3f} TOP; {100 * bnd / ms:.1f}% of it, {ops / ms / 1e9:.1f} TOP/s), "
              f"plain {plain_ms:.3f} ms; {lib}cuDNN bf16 conv channels-last {conv_ms:.4f} ms "
              f"[{card}]")
        yard = conv_ms if mm_ms is None else mm_ms
        for i, v in enumerate((ms, plain_ms, bnd, t_bytes, t_ops, yard, conv_ms)):
            tot[i] += count * v
        row = rows.setdefault(kind_of(key), [0, 0.0, 0.0, 0.0, 0.0])
        for i, v in enumerate((1, ms, bnd, mm_ms or 0.0, conv_ms)):
            row[i] += count * v
        del xb, wb
    for kind_label, (count, ms, bnd, mm_ms, conv_ms) in rows.items():
        lib = f", torch._int_mm {mm_ms:.4f} ms (K8 {ms / mm_ms:.2f}x)" if mm_ms else ""
        was = ""
        if first:
            was = first[kind_label]
            if kind_label == "stem 7x7/2":  # with the quantize and permute run before it then
                ratio = ms / (was + K8_FIRST_STEM_PREP_MS)
                was = f"{was} ms + {K8_FIRST_STEM_PREP_MS} ms = {was + K8_FIRST_STEM_PREP_MS:.4f}"
            else:
                ratio = ms / was
            was = f" (first design: {was} ms, {ratio:.3f}x)"
        print(f"K8 row {kind_label} x{count}: {ms:.4f} ms{was}, bound {bnd:.4f} ms "
              f"({100 * bnd / ms:.1f}%){lib}, cuDNN bf16 conv {conv_ms:.4f} ms "
              f"(K8 {ms / conv_ms:.2f}x) [{card}]")
    was = (f" (first design: {K8_FIRST_STEP_MS} ms, {tot[0] / K8_FIRST_STEP_MS:.3f}x)"
           if first else "")
    print(f"K8 per int8 predict step ({launches} launches): {tot[0]:.3f} ms{was}, bound "
          f"{tot[2]:.3f} ms ({100 * tot[2] / tot[0]:.1f}%; bytes {tot[3]:.3f} ms, operations "
          f"{tot[4]:.3f} ms), plain {tot[1]:.3f} ms; library yardstick (torch._int_mm for "
          f"1x1/1, cuDNN bf16 conv for the rest) {tot[5]:.3f} ms; cuDNN bf16 conv of every "
          f"shape {tot[6]:.3f} ms [{card}]")
    # the stem on the quantize-at-source path's int8 views, beside the CLI path's bf16 ones
    (key, (_, _, args, kw)), = [(k, c) for k, c in calls.items() if c[1] == "stem"]
    views = eval_batch_normalize(batch["images"], batch["mean"], batch["std"], None,
                                 quant_scale=args[4]).reshape(args[0].shape)
    int8_ms = cuda_ms(lambda: k8.int8_stem_conv(views, *args[1:], **kw), 10)
    was = (f" (first design: {K8_FIRST_MS['stem 7x7/2']} ms on NHWC int8 and "
           f"{K8_FIRST_STEM_PREP_MS} ms before it to quantize and permute)" if first else "")
    print(f"K8 stem from int8 views (K1's int8 mode) {int8_ms:.4f} ms, bound "
          f"{int8_bound_ms(key[:-1] + (1,))[0]:.4f} ms; from the CLI path's bf16 views: the "
          f"stem row above{was} [{card}]")
    return tot, rows


# ---------------------------------------------------------------------------
# DenseNet-121 and the ArcFace head (BASELINE configs 2 and 4): K8's
# per-channel requantize (phase 2), training and the test phase through the
# CLI (3c), DenseNet's W8A8 int8 (4g), the card against the CPU (5) and
# their timings (7)
# ---------------------------------------------------------------------------
DN_K8_LAUNCHES = 120  # per DenseNet-121 forward: the stem, 58 layers x 2 convs, 3 transitions
DN_K8_REPLACES = "rxtpu/models/quant.py:167"  # the same XLA int8 conv, at DenseNet's shapes
# (label, N, H, W, Cin, Cout, kernel, stride, padding, epilogue): DenseNet-121's
# conv kinds at the test size's planes (96 views of 512^2: maps of 128^2 to
# 16^2), few views: each layer's Conv_0 (1x1 from Cin 64 to 992, per-channel
# requantize and ReLU), Conv_1 (3x3 to Cout 32, per-channel requantize) and
# the transitions' 1x1 convs (bf16 output: the pool comes after)
DN_K8_CHECKS = (
    ("1x1 Conv_0 block1 Cin 64", 2, 128, 128, 64, 128, 1, 1, 0, "int8 relu"),
    ("1x1 Conv_0 block3 Cin 480", 4, 32, 32, 480, 128, 1, 1, 0, "int8 relu"),
    ("1x1 Conv_0 block4 Cin 992", 4, 16, 16, 992, 128, 1, 1, 0, "int8 relu"),
    ("3x3 Conv_1 to 32 at 128^2", 2, 128, 128, 128, 32, 3, 1, 1, "int8"),
    ("3x3 Conv_1 to 32 at 16^2", 4, 16, 16, 128, 32, 3, 1, 1, "int8"),
    ("1x1 transition1 256 to 128", 2, 128, 128, 256, 128, 1, 1, 0, "bf16"),
    ("1x1 transition2 512 to 256", 2, 64, 64, 512, 256, 1, 1, 0, "bf16"),
    ("1x1 transition3 1024 to 512", 2, 32, 32, 1024, 512, 1, 1, 0, "bf16"),
)


def dn_inv_scales(cout, seed, dev):
    """One requantize scale per output channel, 127 / U(0.3, 3)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return 127.0 / (torch.rand(cout, device=dev, generator=gen) * 2.7 + 0.3)


def k8_densenet_phase2(dev):
    """Phase 2's K8 at DenseNet-121's shapes with the per-channel requantize:
    both entries bit-equal to the plain version and over two launches, the
    stem from bf16 and int8 views, and inputs on exact .5 ties of a vector
    requantize. Returns max |kernel - plain|."""
    import torch
    from rxtpu_torch.ops import int8_conv as k8

    phase("2 K8 with DenseNet-121's per-channel requantize against its plain version (bit "
          "equality)")
    worst = 0.0
    for seed, case in enumerate(DN_K8_CHECKS, start=50):
        label, n, h, w, cin, cout, k, s, p, epi = case
        ops = k8_operands(case[:9], seed, dev)
        kw = dict(relu=epi == "int8 relu", out_dtype=torch.bfloat16,
                  inv_out_scale=dn_inv_scales(cout, seed, dev) if epi != "bf16" else None)
        acc = k8.int8_conv_sums(ops["x"], ops["w"], k, s, p)
        out = k8.int8_conv(ops["x"], ops["w"], ops["scale"], ops["bias"], k, s, p, **kw)
        again = k8.int8_conv(ops["x"], ops["w"], ops["scale"], ops["bias"], k, s, p, **kw)
        ref = k8.epilogue(acc, ops["scale"], ops["bias"], None, None, kw["relu"],
                          kw["inv_out_scale"], kw["out_dtype"])
        torch.cuda.synchronize()
        bad, err = bitwise_diff(out, ref)
        rep, _ = bitwise_diff(out, again)
        worst = max(worst, err)
        clipped = int((ref.abs() == 127).sum()) if ref.dtype == torch.int8 else 0
        print(f"{label} [{n},{h},{w},{cin}] -> [{n},{acc.shape[1]},{acc.shape[2]},{cout}] "
              f"{k}x{k}/{s}, {epi}{' per channel' if epi != 'bf16' else ''}: mismatches "
              f"(plain/repeat) {bad}/{rep}; clipped {clipped}")
        if bad or rep:
            fail(f"K8 {label}: {bad} outputs differ from the plain version (max {err}), {rep} "
                 f"between two launches")
        del ops, acc
    # the stem entry with the 64-channel requantize (stem_absmax_ch), bf16 and int8 views
    ops = k8_operands(("stem", 2, SRC, SRC, 6, 64, 7, 2, 3), 60, dev)
    gen = torch.Generator(device=dev).manual_seed(60)
    in_scale = torch.tensor(1.0 / 32.0, device=dev)
    views = (torch.randn(2, 6, SRC, SRC, device=dev, generator=gen) * 2.0).to(torch.bfloat16)
    packed = k8.pack_stem_weight(ops["w"])
    kw = dict(relu=True, inv_out_scale=dn_inv_scales(64, 60, dev))
    acc = k8.int8_conv_sums(k8.quantize(views, in_scale).permute(0, 2, 3, 1), ops["w"], 7, 2, 3)
    ref = k8.epilogue(acc, ops["scale"], ops["bias"], None, None, True, kw["inv_out_scale"])
    for kind, x in (("bf16", views), ("int8", k8.quantize(views, in_scale))):
        out = k8.int8_stem_conv(x, packed, ops["scale"], ops["bias"], in_scale, **kw)
        again = k8.int8_stem_conv(x, packed, ops["scale"], ops["bias"], in_scale, **kw)
        torch.cuda.synchronize()
        bad, err = bitwise_diff(out, ref)
        rep, _ = bitwise_diff(out, again)
        worst = max(worst, err)
        print(f"stem 7x7/2 NCHW [2,6,{SRC},{SRC}] {kind} views -> 64, ReLU, per-channel "
              f"requantize: mismatches (plain/repeat) {bad}/{rep}")
        if bad or rep:
            fail(f"K8 stem entry, {kind} views, per-channel requantize: {bad} outputs differ "
                 f"(max {err}), {rep} between two launches")
    # .5 ties of a vector requantize: scale 1, bias +-0.25, inv_out 2 per channel,
    # so every output o * inv = 2 sum +- 0.5 is exact and rounds half to even
    x = torch.randint(-2, 3, (2, 32, 32, 128), dtype=torch.int8, device=dev, generator=gen)
    wt = torch.randint(-1, 2, (32, 9 * 128), dtype=torch.int8, device=dev, generator=gen)
    one = torch.ones(32, device=dev)
    quarter = torch.where(torch.arange(32, device=dev) % 2 == 0, 0.25, -0.25)
    inv = torch.full((32,), 2.0, device=dev)
    out = k8.int8_conv(x, wt, one, quarter, 3, 1, 1, inv_out_scale=inv)
    acc = k8.int8_conv_sums(x, wt, 3, 1, 1)
    ref = k8.epilogue(acc, one, quarter, inv_out_scale=inv)
    torch.cuda.synchronize()
    bad, err = bitwise_diff(out, ref)
    v = 2 * acc.double() + 2 * quarter.double()
    ties = int((v.abs() < 127).sum())
    even = bool((ref[v.abs() < 127].double() % 2 == 0).all())
    print(f"ties 3x3 128 -> 32, per-channel requantize: {ties} of {v.numel()} outputs on exact "
          f".5 ties inside the clip, every plain result even: {even}; mismatches {bad}")
    if bad or ties < v.numel() // 2 or not even:
        fail("K8's per-channel requantize rounds .5 ties otherwise than its plain version")
    return max(worst, err)


def dn_fixtures():
    """Phase 3's train fixture and phase 4's test fixture, for ``--densenet``."""
    from rxtpu_torch.data.synthetic import make_test_fixture, make_train_fixture

    shutil.rmtree(WORK, ignore_errors=True)
    train_dir, test_dir = os.path.join(WORK, "train"), os.path.join(WORK, "test")
    fx = make_train_fixture(train_dir, nb_classes=1108, n_experiments=3,
                            wells_per_experiment=32, n_test_wells=16, img_size=SRC, seed=0)
    fx_test = make_test_fixture(test_dir, nb_classes=1108, n_test_wells=32, img_size=SRC,
                                seed=0)
    return fx, fx_test


def dn_run(cli, run_dir, argv, log_every_step=False):
    """``cli.main(argv)`` from ``run_dir`` (every train step logged when asked);
    returns (exit code, wall seconds)."""
    import torch

    resolve = cli.resolve_config

    def every_step(args):
        cfg = resolve(args)
        cfg.train.log_every_steps = 1
        return cfg

    if log_every_step:
        cli.resolve_config = every_step
    cwd = os.getcwd()
    os.chdir(run_dir)
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        cli.resolve_config = resolve
    return rc, time.perf_counter() - t0


def densenet_arcface_phase(cli, fx, fx_test, shear_kernels, crop_normalize):
    """Phase 3c: ``rxtpu_torch.cli.main --backbone densenet121 --head arcface
    --calibrate`` at full width on phase 3's fixture, 1 epoch of 4 steps with
    validation: K2-K4 once per train step and K1 once per validation and
    test batch, finite losses, checkpoints; then the test phase with ``--tta
    flips`` and plate leak on phase 4's fixture: K1 once per test batch (the
    TTA flips act on its views), no train step, a valid submission."""
    from rxtpu_torch.train.checkpoint import load_train_state

    run = os.path.join(WORK, "densenet_arcface")
    os.makedirs(run)
    model_flags = ["--backbone", "densenet121", "--head", "arcface", "--calibrate",
                   "--tta", "flips", "--device", "cuda"]
    argv = ["--experiment_id", "dnarc", "--pack", fx["pack_dir"], "--data-dir", fx["data_dir"],
            "--stats", fx["stats"], "--out-dir", run, "--split-by-experiment", "--epochs", "1",
            "--no-plate-leak"] + model_flags
    for kernel in shear_kernels:
        kernel.launches = 0
    crop_normalize.launches = 0
    rc, wall = dn_run(cli, run, argv, log_every_step=True)
    launches = {k.__name__: k.launches for k in shear_kernels}
    launches["crop_norm"] = crop_normalize.launches
    n_steps, val_batches = 64 // B, 2
    print(f"cli densenet121 --head arcface --calibrate rc {rc} in {wall:.2f} s; launches "
          f"{launches}; train steps {n_steps}, val batches {val_batches} x 2 validations, test "
          f"batches 1 (--tta flips)")
    if rc != 0:
        fail(f"cli densenet121 --head arcface exited {rc}")
    if any(k.launches != n_steps for k in shear_kernels):
        fail(f"K2-K4 launched {[k.launches for k in shear_kernels]} times for {n_steps} steps")
    if launches["crop_norm"] != 2 * val_batches + 1:
        fail(f"crop_norm launched {launches['crop_norm']} times, expected {2 * val_batches + 1}")
    logged = read_jsonl(os.path.join(run, "board", "dnarc", "metrics.jsonl"))
    losses = [r["training/loss"] for r in logged if "training/loss" in r]
    val_losses = [r["validation/loss"] for r in logged if "validation/loss" in r]
    print(f"train losses {[round(v, 4) for v in losses]}; val losses "
          f"{[round(v, 4) for v in val_losses]}")
    if len(losses) != n_steps or len(val_losses) != 2 or not all(
            math.isfinite(v) for v in losses + val_losses):
        fail("a logged loss of the DenseNet + ArcFace run is missing or not finite")
    best = os.path.join(run, "models", "best_model_dnarc.ckpt")
    last = load_train_state(os.path.join(run, "models", "last_dnarc.ckpt"))
    if last["step"] != n_steps or "backbone.block4_layer16.Conv_1.weight" not in last[
            "state_dict"] or "head.weight" not in last["state_dict"]:
        fail("the DenseNet + ArcFace run wrote no full checkpoint")
    test_run = os.path.join(WORK, "densenet_arcface_test")
    os.makedirs(os.path.join(test_run, "models"))
    shutil.copy(best, os.path.join(test_run, "models", "best_model_dnarc.ckpt"))
    argv_t = ["--experiment_id", "dnarc", "--pack", fx_test["pack_dir"], "--data-dir",
              fx_test["data_dir"], "--stats", fx_test["stats"], "--out-dir", test_run
              ] + model_flags
    for kernel in shear_kernels:
        kernel.launches = 0
    crop_normalize.launches = 0
    rc, wall = dn_run(cli, test_run, argv_t)
    n_batches = math.ceil(len(fx_test["test_rows"]) / B)
    print(f"test phase (plate leak, --tta flips) rc {rc} in {wall:.2f} s; crop_norm launches "
          f"{crop_normalize.launches} for {n_batches} test batches")
    if rc != 0 or crop_normalize.launches != n_batches or any(k.launches for k in shear_kernels):
        fail("the DenseNet + ArcFace test phase did not run K1 once per batch, or trained")
    check_submission(os.path.join(test_run, "submission_dnarc.csv"), fx_test)


def densenet_int8_cli_phase(dev, cli, fx_test):
    """Phase 4g (a): a seeded DenseNet-121 + MLP (rxtpu's initial
    distributions, ``init_weights``, as rxtpu's own DenseNet int8 test draws
    them) whose BN statistics are fitted to a batch like the fixture's
    (``fit_bn_statistics``: with the initial ones its probabilities are
    one-hot and the plate-leak assignment degenerates), through ``--quantize
    int8`` on phase 4's fixture: K1 once per test and calibration batch (bf16
    views; K8's stem entry quantizes them), K8 120 times per test batch, a
    valid plate-leak submission. Returns (K8's launches, the seeded model)."""
    import torch
    from rxtpu_torch.models.resnet import init_weights
    from rxtpu_torch.models.twosites import TwoSitesNN
    from rxtpu_torch.ops import int8_conv as k8
    from rxtpu_torch.ops.crop_norm import crop_normalize
    from rxtpu_torch.train.checkpoint import save_checkpoint

    run = os.path.join(WORK, "densenet_int8")
    os.makedirs(run)
    model = init_weights(TwoSitesNN("densenet121", nb_classes=1108),
                         torch.Generator().manual_seed(0)).to(dev)
    fitted = fit_bn_statistics(model, int8_batch(dev, 13))
    save_checkpoint(os.path.join(run, "models", "best_model_dn8.ckpt"),
                    {k: v.cpu() for k, v in fitted.state_dict().items()})
    del fitted
    argv = ["--experiment_id", "dn8", "--pack", fx_test["pack_dir"], "--data-dir",
            fx_test["data_dir"], "--stats", fx_test["stats"], "--out-dir", run,
            "--backbone", "densenet121", "--quantize", "int8", "--device", "cuda"]
    n_batches = math.ceil(len(fx_test["test_rows"]) / B)
    calib = min(2, n_batches)
    # the path's launches: every count set to 0 just before, read just after
    crop_normalize.launches = k8.int8_conv.launches = 0
    rc, wall = dn_run(cli, run, argv)
    k1, k8_launches = crop_normalize.launches, k8.int8_conv.launches
    print(f"cli densenet121 --quantize int8 rc {rc} in {wall:.2f} s; crop_norm launches {k1} "
          f"({n_batches} test + {calib} calibration batches); int8_conv launches {k8_launches} "
          f"({DN_K8_LAUNCHES} x {n_batches} test batches)")
    if rc != 0:
        fail(f"cli densenet121 --quantize int8 exited {rc}")
    if k1 != n_batches + calib or k8_launches != DN_K8_LAUNCHES * n_batches:
        fail(f"densenet121 --quantize int8 launched K1 {k1} and K8 {k8_launches} times")
    check_submission(os.path.join(run, "submission_dn8.csv"), fx_test)
    return k8_launches, model.eval()


def fit_bn_statistics(model, batch):
    """A copy of ``model`` whose BN running statistics are one train-mode pass's
    batch statistics over ``batch`` (bf16 views, momentum 0, no gradient):
    seeded weights with the eval-mode activations of a trained net in
    range, where the initial statistics (mean 0, variance 1) let a random
    DenseNet's activations grow layer by layer until its probabilities are
    one-hot."""
    import torch
    from rxtpu_torch.models.norm import BatchNorm
    from rxtpu_torch.ops.crop_norm import eval_batch_normalize

    fitted = copy.deepcopy(model)
    bns = [m for m in fitted.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.momentum = 0.0
    views = eval_batch_normalize(batch["images"], batch["mean"], batch["std"], None)
    with torch.no_grad(), torch.autocast(views.device.type, dtype=torch.bfloat16):
        fitted.train()(views)
    for bn in bns:
        bn.momentum = 0.9
    return fitted.eval()


def densenet_int8_forward(dev, model, batch):
    """Phase 4g (b): ``int8_forward_phase`` on the seeded DenseNet-121 (120 K8
    launches, top-1 agreement with bf16 at least 0.75, rxtpu's bar), then on
    the same weights with BN statistics fitted to the batch, its agreement
    and gap reported without a limit. Returns the fitted model's steps and
    both (gap, agreement) pairs."""
    seeded = int8_forward_phase(dev, model, batch, DN_K8_LAUNCHES, None, 0.75)
    print("the same weights, BN statistics fitted to the batch (reported, no limit):")
    fitted = int8_forward_phase(dev, fit_bn_statistics(model, batch), batch, DN_K8_LAUNCHES,
                                None, None)
    return fitted[:3], seeded[3:], fitted[3:]


def dn_kind(key):
    """DenseNet-121's K8 conv kinds (PERF.md's rows) from an ``int8_timings`` key."""
    k, out_bytes = key[5], key[9]
    if k == 7:
        return "stem 7x7/2"
    if k == 3:
        return "3x3/1 Conv_1 (to 32)"
    return "1x1/1 transition (bf16 out)" if out_bytes == 2 else "1x1/1 Conv_0 (to 128)"


def densenet_card_vs_cpu(dev, h):
    """Phase 5 for DenseNet-121: f32 eval logits of the unfolded model (MLP
    head; rxtpu's initial distributions) on one full-width well, the card
    against the CPU, TF32 off."""
    import torch
    from rxtpu_torch.infer.fold import unfolded_twin
    from rxtpu_torch.models.resnet import init_weights
    from rxtpu_torch.models.twosites import TwoSitesNN
    from rxtpu_torch.ops.crop_norm import eval_batch_normalize

    model = init_weights(TwoSitesNN("densenet121", nb_classes=1108),
                         torch.Generator().manual_seed(3)).eval()
    gen = torch.Generator().manual_seed(5)
    images = torch.randint(0, 256, (1, 6, 6, h, h), dtype=torch.uint8, generator=gen)
    mean = torch.rand(1, 6, generator=gen) * 0.5 + 0.1
    std = torch.rand(1, 6, generator=gen) * 0.25 + 0.05
    net_cpu = unfolded_twin(model, torch.float32)
    net_gpu = unfolded_twin(copy.deepcopy(model).to(dev), torch.float32)
    with torch.inference_mode():
        v_cpu = eval_batch_normalize(images, mean, std, None)
        t0 = time.perf_counter()
        l_cpu = net_cpu(v_cpu)
        t_cpu = time.perf_counter() - t0
        l_gpu = net_gpu(eval_batch_normalize(images.to(dev), mean.to(dev), std.to(dev),
                                             None)).cpu()
    scale = float(l_cpu.abs().max())
    diff = float((l_gpu - l_cpu).abs().max())
    print(f"DenseNet-121 f32 eval logits (unfolded): max|logit| {scale:.6g}; max|card - cpu| "
          f"{diff:.6g} (bound {1e-3 * scale:.6g}: 1e-3 of max|logit|, f32 sums in other "
          f"orders through 120 convs); cpu forward {t_cpu:.2f} s")
    if not math.isfinite(diff) or scale < 1e-6 or diff > 1e-3 * scale:
        fail("card f32 DenseNet-121 logits disagree with the CPU's")


def densenet_timings(dev, int8_steps, batch, card):
    """Phase 7 for DenseNet-121: the train step of config 4 (ArcFace head,
    control calibration; B=16, G=3, 512^2 cropped to 364, bf16, K2-K4) by host
    clock and events, its peak memory and device time by kernel; the bf16
    and int8 predict steps and K8 per DenseNet conv kind beside its bound and
    its library call (``int8_timings``); the QuantPreNorm chain's share of
    the int8 step. Returns ``int8_timings``'s K8 totals."""
    import torch
    from rxtpu_torch.models.quant import QuantPreNorm
    from rxtpu_torch.models.resnet import init_weights
    from rxtpu_torch.models.twosites import TwoSitesNN
    from rxtpu_torch.train.optim import make_schedule
    from rxtpu_torch.train.step import TrainState, make_train_step

    gen = torch.Generator(device=dev).manual_seed(21)
    fixed = {"images": torch.randint(0, 256, (B, G, 6, SRC, SRC), dtype=torch.uint8,
                                     device=dev, generator=gen),
             "labels": torch.arange(B, device=dev) * 67 % 1108,
             "mean": torch.full((B, 6), 0.5, device=dev),
             "std": torch.full((B, 6), 0.2, device=dev)}
    model = init_weights(TwoSitesNN("densenet121", nb_classes=1108, head="arcface",
                                    control_calibration=True),
                         torch.Generator().manual_seed(0)).to(dev)
    state = TrainState.create(model, make_schedule(0.0005 * B, 1, 1, False), weight_decay=3e-5)
    step = make_train_step(model, CROP, augment="shear", compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(state, fixed, 0, True)["loss"]) for _ in range(2)]
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        step(state, fixed, 0, True)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / iters
    step_ev = cuda_ms(lambda: step(state, fixed, 0, True), iters, warmup=0)
    peak = torch.cuda.max_memory_allocated()
    print(f"train step bf16 B={B} G={G} 6x{SRC}^2 -> {CROP}^2 DenseNet-121 + ArcFace + "
          f"calibration: {step_ms:.3f} ms/step host clock, {step_ev:.3f} ms/step CUDA events, "
          f"{B * G * 1e3 / step_ms:.1f} views/s, peak memory {peak / 2**30:.3f} GiB "
          f"(first losses {[round(v, 4) for v in losses]}) [{card}]")
    if not all(math.isfinite(v) for v in losses):
        fail("the DenseNet-121 train step gave a non-finite loss")
    kernels, device_us = device_profile(lambda: step(state, fixed, 0, True), 3,
                                        "DenseNet-121 train steps", step_ev)
    shear_us = sum(e.self_device_time_total for e in kernels if "shear_" in e.key)
    print(f"augment share of the DenseNet-121 train step: K2-K4 "
          f"{100 * shear_us / device_us:.1f}% of device time")
    del state, model, step, fixed

    qstep, qstep_src, pstep = int8_steps
    tot, rows = int8_timings(dev, qstep, qstep_src, pstep, batch, card,
                             launches=DN_K8_LAUNCHES, kind_of=dn_kind, first=None)
    # the QuantPreNorm chain: each call of one int8 forward timed alone, summed
    calls, real = [], QuantPreNorm.forward

    def record(mod, x, out_scale=None):
        calls.append((mod, x, out_scale))
        return real(mod, x, out_scale)

    QuantPreNorm.forward = record
    try:
        qstep(batch)
    finally:
        QuantPreNorm.forward = real
    with torch.inference_mode():
        chain_ms = sum(cuda_ms(lambda: real(m, x, o), 5, warmup=1) for m, x, o in calls)
    step_ms = cuda_ms(lambda: qstep(batch), 10)
    print(f"QuantPreNorm chain ({len(calls)} calls a forward, plain torch: "
          f"relu(q * (svec * mul) + add), requantized): {chain_ms:.3f} ms per int8 predict "
          f"step = {100 * chain_ms / step_ms:.1f}% of its {step_ms:.3f} ms; K8 "
          f"{tot[0]:.3f} ms = {100 * tot[0] / step_ms:.1f}% [{card}]")
    return tot


# ---------------------------------------------------------------------------
# --resume from rxtpu's pickle, --profile and --assign-method greedy_jax
# (phase 3d and greedy_jax's timing in phase 7)
# ---------------------------------------------------------------------------
SHEAR_KERNEL_NAMES = ("shear_x_kernel", "shear_y_kernel", "shear_finish_kernel")  # K2-K4
GREEDY_N, GREEDY_SEED = 1108, 16  # a Kaggle test experiment: four plates of 277 wells


def momentum_by_name(payload, names):
    """A port-format training checkpoint's momentum buffers by parameter name
    (the optimizer's state is keyed by position in ``named_parameters``)."""
    return {names[i]: s["momentum_buffer"] for i, s in payload["optimizer"]["state"].items()}


def rxtpu_layout_copy(payload, names, path, **meta):
    """``payload`` (the port's format) written in rxtpu's pickle layout; the
    loop fields default to the payload's own."""
    from rxtpu_torch.train.checkpoint import save_rxtpu_pickle

    fields = {k: payload[k] for k in ("epoch", "batch_in_epoch", "best_metric",
                                      "epochs_without_improvement") if k in payload}
    fields.update(meta)
    step = fields.pop("step", payload["step"])
    save_rxtpu_pickle(path, payload["state_dict"], momentum_by_name(payload, names), step,
                      **fields)


def trace_kernel_counts(logdir):
    """Launches of K2-K4's kernels in the one ``*.pt.trace.json`` of ``logdir``."""
    import glob

    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    if len(files) != 1:
        fail(f"{logdir}: {len(files)} trace files, expected 1")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    return {k: sum(k in n for n in kernels) for k in SHEAR_KERNEL_NAMES}, len(kernels), \
        os.path.getsize(files[0])


def greedy_gaps(probs):
    """The host greedy loop on ``probs`` (f32, numpy), returning the smallest
    gap over its iterations between the two largest row maxima and between
    the two largest values of the winning row: how near a tie came."""
    import numpy as np

    from rxtpu_torch.infer.plate_leak import rescale

    p = rescale(probs.copy())
    gap_rows = gap_in_row = math.inf
    for _ in range(p.shape[0] - 1):
        best = p.argmax(axis=1)
        vals = p[np.arange(len(p)), best]
        top2 = np.partition(vals, -2)[-2:]
        gap_rows = min(gap_rows, float(top2[1] - top2[0]))
        r = int(vals.argmax())
        row2 = np.partition(p[r], -2)[-2:]
        gap_in_row = min(gap_in_row, float(row2[1] - row2[0]))
        p[:, best[r]] = 0.0
        p[r, :] = 0.0
        p = rescale(p)
    return gap_rows, gap_in_row


def greedy_probs(dev):
    """One seeded [1108, 1108] f32 probability matrix: softmax of N(0, 3^2) logits."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(GREEDY_SEED)
    logits = torch.randn(GREEDY_N, GREEDY_N, device=dev, generator=gen) * 3.0
    return torch.softmax(logits, dim=-1)


def run_gaps(a, b):
    """Two runs' (losses, final state_dict): the losses' max |diff|, the
    weights' relative L2 distance, and whether both are bit-equal."""
    import torch

    (la, sa), (lb, sb) = a, b
    num = sum(float((sa[k].double() - sb[k].double()).norm()) ** 2 for k in sa)
    den = sum(float(sb[k].double().norm()) ** 2 for k in sb)
    same = all(torch.equal(sa[k], sb[k]) for k in sa) and la == lb
    return max(abs(x - y) for x, y in zip(la, lb)), (num / den) ** 0.5, same


def resumed_run(cli, base, label, argv_run, models, train_dir, names, shear_kernels,
                crop_normalize):
    """``cli.main(argv_run)`` (every step logged) from a fresh directory
    ``base/label`` whose ``models/`` holds ``models`` ({file name: a file or
    an orbax directory to copy}), ``train_dir`` in ``argv_run`` standing for
    it; returns the directory, K2-K4's launches, K1's and the state the first
    step saw (its step, and the momentum on the card by parameter name)."""
    from rxtpu_torch.train import loop as port_loop

    run_dir = os.path.join(base, label)
    os.makedirs(os.path.join(run_dir, "models"))
    for name, path in models.items():
        dst = os.path.join(run_dir, "models", name)
        if os.path.isdir(path):
            shutil.copytree(path, dst)
        else:
            shutil.copy(path, dst)
    argv_run = [run_dir if a == train_dir else a for a in argv_run]
    seen = {}
    real = port_loop.make_train_step

    def first_step_snapshot(*a, **k):
        fn = real(*a, **k)

        def step(state, *args):
            if not seen:  # right after loading: the optimizer's state on the card
                slots = [state.optimizer.state.get(p, {}) for p in state.model.parameters()]
                seen.update(step=state.step, momentum={
                    n: s["momentum_buffer"].detach().clone()
                    for n, s in zip(names, slots) if s.get("momentum_buffer") is not None})
            return fn(state, *args)
        return step

    port_loop.make_train_step = first_step_snapshot
    for kernel in shear_kernels:
        kernel.launches = 0
    crop_normalize.launches = 0
    try:
        rc, wall = dn_run(cli, run_dir, argv_run, log_every_step=True)
    finally:
        port_loop.make_train_step = real
    launches = [k.launches for k in shear_kernels]
    print(f"{label}: cli rc {rc} in {wall:.2f} s; K2-K4 launches {launches}, K1 "
          f"{crop_normalize.launches}")
    if rc != 0:
        fail(f"{label}: cli exited {rc}")
    return run_dir, launches, crop_normalize.launches, seen


def resume_profile_phase(dev, cli, train_dir, argv, n_steps, shear_kernels, crop_normalize,
                         test_run=None):
    """Phase 3d on phase 3's fixture and its last checkpoint (epoch E, step
    E * n_steps): (a) written in rxtpu's pickle layout (best and last) and
    resumed with ``--epochs E+1``: the momentum buffers on the card right
    after loading bit-equal to the pickle's trace after ``from_flax``, the
    step, one epoch of ``n_steps`` steps with K2-K4 once per step; (b) the
    same state at epoch E+1, batch 2 (step E * n_steps + 2) in rxtpu's
    layout and in the port's format, each resumed under ``--profile`` (the
    port's twice): 2 steps each, K2-K4 twice each in the trace, losses and
    final weights bit-equal when the two port runs are, else within twice
    their spread; (c) greedy_jax on the card (``test_run``: phase 4's
    fixture, directory and argv, for the CLI's test phase)."""
    import numpy as np
    import torch

    from rxtpu_torch.models.convert import from_flax
    from rxtpu_torch.models.twosites import TwoSitesNN
    from rxtpu_torch.train.checkpoint import (
        is_port_format, load_train_state, read_rxtpu_pickle, save_checkpoint,
    )

    def flag(name, default):
        return argv[argv.index(name) + 1] if name in argv else default

    net = TwoSitesNN(flag("--backbone", "resnet50"), nb_classes=int(flag("--nb-classes", 1108)))
    names = [n for n, _ in net.named_parameters()]
    del net
    last = load_train_state(os.path.join(train_dir, "models", "last_smoke.ckpt"))
    best = load_train_state(os.path.join(train_dir, "models", "best_model_smoke.ckpt"))
    n_epochs = int(last["epoch"])
    t0 = time.perf_counter()

    # the checkpoints the runs start from, written once
    src = os.path.join(WORK, "resume", "src")
    os.makedirs(src)
    mid = dict(epoch=n_epochs + 1, batch_in_epoch=2, step=n_epochs * n_steps + 2)
    ckpts = {name: os.path.join(src, f"{name}.ckpt") for name in
             ("rx_best", "rx_last", "rx_mid", "port_mid")}
    rxtpu_layout_copy(best, names, ckpts["rx_best"])
    rxtpu_layout_copy(last, names, ckpts["rx_last"])
    rxtpu_layout_copy(last, names, ckpts["rx_mid"], **mid)
    save_checkpoint(ckpts["port_mid"], last["state_dict"],
                    optimizer=types.SimpleNamespace(state_dict=lambda: last["optimizer"]),
                    best_metric=last["best_metric"],
                    epochs_without_improvement=last["epochs_without_improvement"], **mid)
    ckpts["port_best"] = os.path.join(train_dir, "models", "best_model_smoke.ckpt")

    def run(label, argv_run, models):
        run_dir, launches, _, seen = resumed_run(
            cli, os.path.join(WORK, "resume"), label, argv_run,
            {f"{name}_smoke.ckpt": path for name, path in models.items()}, train_dir, names,
            shear_kernels, crop_normalize)
        return run_dir, launches, seen

    # (a) an epoch-end resume from rxtpu's layout
    resume = argv[:argv.index("--epochs")] + argv[argv.index("--epochs") + 2:] + [
        "--resume", "--epochs", str(n_epochs + 1)]
    dir_a, launches, seen = run("a_rxtpu_epoch_end", resume,
                                {"best_model": ckpts["rx_best"], "last": ckpts["rx_last"]})
    pickled = read_rxtpu_pickle(ckpts["rx_last"])
    trace = from_flax(pickled["opt_state"][0].trace)
    mom = seen.get("momentum", {})
    off = [n for n in names if not (n in mom and mom[n].device.type == dev.type
                                    and torch.equal(mom[n].cpu(), trace[n]))]
    step0 = int(np.asarray(pickled["step"]))
    print(f"(a) rxtpu-layout pickle at epoch {n_epochs}, step {step0} (schedule count "
          f"{int(np.asarray(pickled['opt_state'][1].count))}): {len(names) - len(off)} of "
          f"{len(names)} momentum buffers on the card bit-equal to its trace after from_flax "
          f"right after loading; the first step ran at step {seen.get('step')}")
    if off or seen.get("step") != step0 or step0 != last["step"]:
        fail(f"(a) the resumed state differs from the pickle's: buffers {off[:3]}, step "
             f"{seen.get('step')} against {step0}")
    if launches != [n_steps] * 3:
        fail(f"(a) K2-K4 launched {launches} times for one epoch of {n_steps} steps")
    after = load_train_state(os.path.join(dir_a, "models", "last_smoke.ckpt"))
    logged = [r["training/loss"] for r in read_jsonl(os.path.join(dir_a, "board", "smoke",
                                                                  "metrics.jsonl"))
              if "training/loss" in r]
    print(f"(a) one epoch: last checkpoint epoch {after['epoch']} step {after['step']}; losses "
          f"{[round(v, 4) for v in logged]}; best checkpoint still rxtpu's: "
          f"{not is_port_format(os.path.join(dir_a, 'models', 'best_model_smoke.ckpt'))}")
    if (after["epoch"], after["step"]) != (n_epochs + 1, step0 + n_steps) or \
            len(logged) != n_steps or not all(math.isfinite(v) for v in logged):
        fail("(a) the resumed run did not train exactly one epoch with finite losses")

    # (b) a mid-epoch resume under --profile, from both formats
    profiled = resume + ["--profile"]
    saved_det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = {}
    try:
        for label, models in (
                ("b_rxtpu_mid_epoch", {"best_model": ckpts["rx_best"], "last": ckpts["rx_mid"]}),
                ("b_port_mid_epoch_1", {"best_model": ckpts["port_best"],
                                        "last": ckpts["port_mid"]}),
                ("b_port_mid_epoch_2", {"best_model": ckpts["port_best"],
                                        "last": ckpts["port_mid"]})):
            run_dir, launches, seen = run(label, profiled, models)
            counts, n_kernels, size = trace_kernel_counts(
                os.path.join(run_dir, "board", "smoke", "profile"))
            losses = [r["training/loss"] for r in read_jsonl(
                os.path.join(run_dir, "board", "smoke", "metrics.jsonl")) if "training/loss" in r]
            final = load_train_state(os.path.join(run_dir, "models", "last_smoke.ckpt"))
            print(f"{label}: first step at step {seen.get('step')}; trace of {n_kernels} kernel "
                  f"launches ({size / 1e6:.1f} MB): {counts}; losses {losses}")
            if launches != [2, 2, 2] or list(counts.values()) != [2, 2, 2]:
                fail(f"{label}: K2-K4 launched {launches} times, traced {counts}; expected 2 "
                     "each (batches 2 and 3 of the epoch)")
            if seen.get("step") != mid["step"] or final["step"] != mid["step"] + 2 or \
                    len(losses) != 2 or not all(math.isfinite(v) for v in losses):
                fail(f"{label}: the mid-epoch resume did not train 2 steps from step "
                     f"{mid['step']}")
            runs[label] = (losses, final["state_dict"])
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_det

    (l_rx, w_rx, same_rx) = run_gaps(runs["b_rxtpu_mid_epoch"], runs["b_port_mid_epoch_1"])
    (l_pp, w_pp, same_pp) = run_gaps(runs["b_port_mid_epoch_2"], runs["b_port_mid_epoch_1"])
    print(f"(b) rxtpu-layout against port-format resume: losses max|diff| {l_rx:.3g}, final "
          f"weights relative L2 {w_rx:.3g}, bit-equal {same_rx}; the two port-format "
          f"resumes: {l_pp:.3g}, {w_pp:.3g}, bit-equal {same_pp} (cuDNN deterministic)")
    if same_pp and not same_rx:
        fail("(b) the step is deterministic, and the rxtpu-layout resume is not bit-equal to "
             "the port-format one")
    if not same_pp and (l_rx > 2 * l_pp or w_rx > 2 * w_pp):
        fail("(b) the rxtpu-layout resume lies outside twice the spread of two port-format "
             "resumes")
    print(f"phase 3d (a)-(b) in {time.perf_counter() - t0:.2f} s")
    if test_run is not None:
        greedy_jax_phase(dev, cli, *test_run)


def greedy_jax_phase(dev, cli, fx_test, test_dir, argv):
    """Phase 3d (c): greedy_jax on the card on one seeded [1108, 1108] f32
    probability matrix, with no host sync inside its loop (CUDA sync debug
    mode "error"), against the host greedy and its own CPU run; then the test
    phase through the CLI with ``--assign-method greedy_jax``."""
    import numpy as np
    import torch

    from rxtpu_torch.infer.plate_leak import greedy_assign, greedy_assign_jax, greedy_assign_loop

    probs = greedy_probs(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        on_card = greedy_assign_loop(probs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = on_card.cpu().numpy()
    host = probs.cpu().numpy()
    cpu = greedy_assign_jax(host, "cpu")
    exact = greedy_assign(host)
    gap_rows, gap_in_row = greedy_gaps(host)
    print(f"(c) greedy_jax on the card [{GREEDY_N},{GREEDY_N}] f32 (no host sync in its loop): "
          f"{len(set(got.tolist()))} distinct classes; equal to its CPU run {np.array_equal(got, cpu)}, "
          f"to the host greedy {np.array_equal(got, exact)}; smallest top-two gap of the row "
          f"maxima {gap_rows:.3g}, within the winning row {gap_in_row:.3g}")
    if got.dtype != np.float32 or not np.array_equal(got, cpu) or not np.array_equal(got, exact):
        fail("(c) greedy_jax on the card differs from its CPU run or the host greedy")
    out_dir = os.path.join(test_dir, "greedy_jax")
    os.makedirs(out_dir)
    argv_g = [out_dir if a == test_dir else a for a in argv] + ["--assign-method", "greedy_jax"]
    rc, wall = dn_run(cli, test_dir, argv_g)
    print(f"(c) test phase with --assign-method greedy_jax: rc {rc} in {wall:.2f} s")
    if rc != 0:
        fail(f"the greedy_jax test phase exited {rc}")
    sirnas = check_submission(os.path.join(out_dir, "submission_smoke.csv"), fx_test)
    with open(os.path.join(test_dir, "submission_smoke.csv"), newline="") as f:
        greedy_sirnas = [int(r["sirna"]) for r in csv.DictReader(f)]
    print(f"(c) greedy_jax's submission against phase 4's greedy one: "
          f"{sum(a != b for a, b in zip(sirnas, greedy_sirnas))} of {len(sirnas)} rows differ")


def greedy_jax_timings(dev, card):
    """Phase 7: greedy_jax per experiment ([1108, 1108]) on the card: the whole
    call from host probabilities to host results by the host's clock, the
    loop by CUDA events, and its kernel launches (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rxtpu_torch.infer.plate_leak import greedy_assign_jax, greedy_assign_loop

    probs = greedy_probs(dev)
    host = probs.cpu().numpy()
    greedy_assign_jax(host, dev)  # warm-up
    ms = host_ms(lambda: greedy_assign_jax(host, dev), 3)
    loop_ms = cuda_ms(lambda: greedy_assign_loop(probs), 3, warmup=1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        greedy_assign_loop(probs)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    print(f"greedy_jax per experiment [{GREEDY_N},{GREEDY_N}] f32 on {card}: {ms:.3f} ms host "
          f"clock (host probabilities to host results), loop {loop_ms:.3f} ms CUDA events, "
          f"{launches} kernel launches ({launches / GREEDY_N:.1f} per iteration)")
    return ms, loop_ms, launches


# ---------------------------------------------------------------------------
# --checkpoint-backend orbax (phase 3f): rxtpu's orbax directories written and
# read without orbax, tensorstore or JAX
# ---------------------------------------------------------------------------
ORBAX_FIXTURE = os.path.join(ROOT, "tests", "data", "orbax_ocdbt")  # written by rxtpu, OCDBT


def dir_files(path):
    """(bytes, files) under a directory."""
    sizes = [os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(path) for n in ns]
    return sum(sizes), len(sizes)


def orbax_fixture_check():
    """Phase 3f (o): rxtpu's OCDBT checkpoint in ``tests/data/orbax_ocdbt``
    (orbax and tensorstore wrote it) read on this host by the port: every
    array bit-equal to ``expected.npz``, the tree (lists, dicts, None, {})
    that ``expected.json`` gives, a chunk read from a data file."""
    import numpy as np

    from rxtpu_torch.train.checkpoint import load_checkpoint_orbax
    from rxtpu_torch.train.ocdbt import read_manifest, read_ocdbt

    path = os.path.join(ORBAX_FIXTURE, "ckpt")
    t0 = time.perf_counter()
    store = read_ocdbt(path)
    got = load_checkpoint_orbax(path)
    wall = time.perf_counter() - t0
    expected = np.load(os.path.join(ORBAX_FIXTURE, "expected.npz"))
    with open(os.path.join(ORBAX_FIXTURE, "expected.json")) as f:
        tree = json.load(f)
    off = []

    def walk(g, w, where):
        if isinstance(w, dict) or isinstance(w, list):
            if type(g) is not type(w) or len(g) != len(w):
                off.append(where)
                return
            for k, v in (w.items() if isinstance(w, dict) else enumerate(w)):
                if isinstance(w, dict) and k not in g:
                    off.append(f"{where}.{k}")
                else:
                    walk(g[k], v, f"{where}.{k}")
        elif w is None:
            if g is not None:
                off.append(where)
        else:
            want = expected[w]
            if not (isinstance(g, np.ndarray) and g.dtype == want.dtype and g.shape == want.shape
                    and g.tobytes() == want.tobytes()):
                off.append(where)

    walk(got, tree, "payload")
    manifest = read_manifest(path)
    print(f"(o) rxtpu's OCDBT checkpoint (tests/data/orbax_ocdbt, {dir_files(path)[0]} bytes, "
          f"{dir_files(path)[1]} files; B+tree of height {manifest['root_height']}, "
          f"{len(store)} keys, chunk of params.dense.kernel "
          f"{len(store[b'params.dense.kernel/0.0'])} bytes in a data file) read in "
          f"{wall * 1e3:.1f} ms: {len(expected.files)} arrays, mismatches {off}")
    if off:
        fail(f"(o) the OCDBT checkpoint reads otherwise than rxtpu restored it: {off[:5]}")


def port_copy(saved, names, path, net):
    """``saved`` (``load_train_state``'s payload of an orbax directory)
    written in the port's own format, the trace as the SGD momentum."""
    from rxtpu_torch.train.checkpoint import save_checkpoint
    from rxtpu_torch.train.optim import make_optimizer, sgd_state_from_trace

    opt = sgd_state_from_trace(make_optimizer(net.parameters()), names, saved["trace"])
    meta = {k: saved[k] for k in ("step", "epoch", "batch_in_epoch", "best_metric",
                                  "epochs_without_improvement") if k in saved}
    save_checkpoint(path, saved["state_dict"], optimizer=opt, **meta)


def orbax_phase(dev, cli, train_dir, argv, n_steps, shear_kernels, crop_normalize, card,
                test_run):
    """Phase 3f on phase 3's fixture at full width: (o) ``orbax_fixture_check``;
    (a) one epoch of ``n_steps`` steps with ``--checkpoint-backend orbax``
    (K2-K4 once per step, K1 once per validation and test batch), its best
    and last checkpoints orbax directories that ``load_checkpoint_orbax``
    reads back at their steps; the last one written again in the port's
    format, and ``--resume`` for one more epoch from each (the port's
    twice), cuDNN deterministic: the momentum on the card right after
    loading bit-equal to the orbax trace, losses and final weights bit-equal
    to the port format's (within twice the spread of the two port-format
    runs if those differ); (b) the test phase (``test_run``: phase 4's
    fixture, directory and argv) from the orbax best directory and from the
    same weights in the port's format: the same submission bytes; (c) the
    last directory renamed to ``<path>.old``, as a crash in the middle of
    the save's swap leaves it: ``--resume`` finds it, trains one epoch, and
    leaves one last directory; (d) the save and the load of the ResNet-50
    rolling payload by the host's clock, with the directory's bytes and
    files, beside the port format's."""
    import numpy as np
    import torch

    from rxtpu_torch.models.twosites import TwoSitesNN
    from rxtpu_torch.train.checkpoint import (
        is_orbax_checkpoint, is_port_format, load_checkpoint, load_checkpoint_orbax,
        load_train_state, save_checkpoint, save_checkpoint_orbax,
    )

    t_start = time.perf_counter()
    base = os.path.join(WORK, "orbax")
    orbax_fixture_check()
    net = TwoSitesNN("resnet50", nb_classes=1108)
    names = [n for n, _ in net.named_parameters()]

    # (a) one epoch under --checkpoint-backend orbax
    argv_a = argv[:argv.index("--epochs")] + argv[argv.index("--epochs") + 2:] + [
        "--epochs", "1", "--checkpoint-backend", "orbax"]
    run_a, launches, k1, _ = resumed_run(cli, base, "a_train", argv_a, {}, train_dir, names,
                                         shear_kernels, crop_normalize)
    val_batches, test_batches = 2, 1
    if launches != [n_steps] * 3 or k1 != 2 * val_batches + test_batches:
        fail(f"(a) K2-K4 launched {launches}, K1 {k1} times for one epoch of {n_steps} steps, "
             f"2 validations of {val_batches} batches and {test_batches} test batch")
    models = os.path.join(run_a, "models")
    best, last = (os.path.join(models, f"{n}_smoke.ckpt") for n in ("best_model", "last"))
    logged = read_jsonl(os.path.join(run_a, "board", "smoke", "metrics.jsonl"))
    vals = [(r["step"], r["validation/accuracy"]) for r in logged if "validation/accuracy" in r]
    best_step = max(vals, key=lambda v: v[1])[0]  # the first of the highest: strict improvement
    trees = {p: load_checkpoint_orbax(p) for p in (best, last)}
    steps = {p: int(t["step"]) for p, t in trees.items()}
    listing = sorted(os.listdir(models))
    print(f"(a) checkpoints {listing}: orbax directories "
          f"{[is_orbax_checkpoint(p) for p in (best, last)]}, steps {[steps[best], steps[last]]} "
          f"(validations at (step, accuracy) {vals}), last: {dir_files(last)[1]} files, "
          f"{dir_files(last)[0] / 1e6:.1f} MB")
    if listing != ["best_model_smoke.ckpt", "last_smoke.ckpt"] or not all(
            os.path.isdir(p) for p in (best, last)):
        fail(f"(a) the orbax run left {listing}, not two orbax directories")
    if steps[last] != n_steps or steps[best] != best_step or \
            int(trees[last]["opt_state"][1]["count"]) != n_steps:
        fail(f"(a) orbax checkpoints at steps {steps}, expected last {n_steps}, best {best_step}")
    with open(os.path.join(last, "_METADATA")) as f:
        if json.load(f)["use_ocdbt"] is not False:
            fail("(a) the port wrote no plain zarr layout")
    saved_last, saved_best = load_train_state(last), load_train_state(best)
    src = os.path.join(base, "src")
    os.makedirs(src)
    port_last, port_best = os.path.join(src, "port_last.ckpt"), os.path.join(src, "port_best.ckpt")
    port_copy(saved_last, names, port_last, net)
    port_copy(saved_best, names, port_best, net)

    resume = argv_a[:argv_a.index("--epochs")] + argv_a[argv_a.index("--epochs") + 2:] + [
        "--resume", "--epochs", "2"]
    as_pickle = [("pickle" if a == "orbax" else a) for a in resume]
    saved_det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = {}
    try:
        for label, argv_run, ckpts in (
                ("a_orbax_resume", resume, {"best_model_smoke.ckpt": best,
                                            "last_smoke.ckpt": last}),
                ("a_port_resume_1", as_pickle, {"best_model_smoke.ckpt": port_best,
                                                "last_smoke.ckpt": port_last}),
                ("a_port_resume_2", as_pickle, {"best_model_smoke.ckpt": port_best,
                                                "last_smoke.ckpt": port_last}),
                ("c_orbax_old", resume, {"best_model_smoke.ckpt": best,
                                         "last_smoke.ckpt.old": last})):
            run_dir, launches, k1, seen = resumed_run(cli, base, label, argv_run, ckpts, train_dir,
                                                      names, shear_kernels, crop_normalize)
            mom = seen.get("momentum", {})
            off = [n for n in names if not (n in mom and mom[n].device.type == dev.type
                                            and torch.equal(mom[n].cpu(), saved_last["trace"][n]))]
            out = os.path.join(run_dir, "models", "last_smoke.ckpt")
            final = load_train_state(out)
            losses = [r["training/loss"] for r in read_jsonl(
                os.path.join(run_dir, "board", "smoke", "metrics.jsonl")) if "training/loss" in r]
            left = sorted(os.listdir(os.path.join(run_dir, "models")))
            print(f"{label}: first step at step {seen.get('step')}; {len(names) - len(off)} of "
                  f"{len(names)} momentum buffers on the card bit-equal to the orbax trace; "
                  f"losses {losses}; last at epoch {final['epoch']} step {final['step']} "
                  f"({'orbax directory' if os.path.isdir(out) else 'port format'}); models/ "
                  f"{left}")
            if off or seen.get("step") != n_steps:
                fail(f"{label}: the resumed state differs from the orbax checkpoint's: buffers "
                     f"{off[:3]}, step {seen.get('step')}")
            if launches != [n_steps] * 3 or k1 != val_batches + test_batches:
                fail(f"{label}: K2-K4 launched {launches}, K1 {k1} times for one epoch")
            if (final["epoch"], final["step"]) != (2, 2 * n_steps) or len(losses) != n_steps \
                    or not all(math.isfinite(v) for v in losses):
                fail(f"{label}: the resumed run did not train one epoch with finite losses")
            if os.path.isdir(out) != (argv_run is resume) or left != [
                    "best_model_smoke.ckpt", "last_smoke.ckpt"]:
                fail(f"{label}: models/ holds {left}, the last checkpoint "
                     f"{'a directory' if os.path.isdir(out) else 'a file'}")
            runs[label] = (losses, final["state_dict"])
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_det
    (l_op, w_op, same_op) = run_gaps(runs["a_orbax_resume"], runs["a_port_resume_1"])
    (l_pp, w_pp, same_pp) = run_gaps(runs["a_port_resume_2"], runs["a_port_resume_1"])
    (l_oc, w_oc, same_oc) = run_gaps(runs["c_orbax_old"], runs["a_orbax_resume"])
    print(f"(a) orbax against port-format resume: losses max|diff| {l_op:.3g}, final weights "
          f"relative L2 {w_op:.3g}, bit-equal {same_op}; the two port-format resumes: "
          f"{l_pp:.3g}, {w_pp:.3g}, bit-equal {same_pp}; (c) from {os.path.basename(last)}.old "
          f"against from the directory: {l_oc:.3g}, {w_oc:.3g}, bit-equal {same_oc} (cuDNN "
          "deterministic)")
    if same_pp and not (same_op and same_oc):
        fail("(a, c) the step is deterministic, and an orbax resume is not bit-equal to the "
             "port-format one")
    if not same_pp and (max(l_op, l_oc) > 2 * l_pp or max(w_op, w_oc) > 2 * w_pp):
        fail("(a, c) an orbax resume lies outside twice the spread of two port-format resumes")

    # (b) the test phase from the orbax best directory and from the port's format
    fx_test, test_dir, argv_test = test_run
    subs = {}
    for label, ckpt in (("b_test_orbax", best), ("b_test_port", port_best)):
        run_dir, _, k1, _ = resumed_run(cli, base, label, argv_test,
                                        {"best_model_smoke.ckpt": ckpt}, test_dir, names,
                                        shear_kernels, crop_normalize)
        n_batches = math.ceil(len(fx_test["test_rows"]) / B)
        if k1 != n_batches:
            fail(f"{label}: K1 launched {k1} times for {n_batches} test batches")
        sub = os.path.join(run_dir, "submission_smoke.csv")
        check_submission(sub, fx_test)
        with open(sub, "rb") as f:
            subs[label] = f.read()
    print(f"(b) test phase from the orbax best directory and from the port's format: "
          f"submissions byte-equal {subs['b_test_orbax'] == subs['b_test_port']}")
    if subs["b_test_orbax"] != subs["b_test_port"] or is_port_format(best):
        fail("(b) the orbax best checkpoint predicts otherwise than its port-format copy")
    weights = load_checkpoint(best)
    differ = [k for k, v in load_checkpoint(port_best).items() if not torch.equal(weights[k], v)]
    if differ:
        fail(f"(b) {differ[:3]} differ between the orbax best and its port-format copy")

    # (d) the save and the load of the full ResNet-50 rolling payload
    from rxtpu_torch.models.convert import from_flax
    from rxtpu_torch.train.checkpoint import rxtpu_payload
    from rxtpu_torch.train.optim import make_optimizer, sgd_state_from_trace

    payload = trees[last]
    n_bytes = sum(a.nbytes for a in _leaves(payload))
    timing = os.path.join(base, "d_timing")
    os.makedirs(timing)
    path, port = os.path.join(timing, "last_smoke.ckpt"), os.path.join(timing, "port.ckpt")
    meta = {k: saved_last[k] for k in ("step", "epoch", "best_metric",
                                       "epochs_without_improvement")}
    opt = sgd_state_from_trace(make_optimizer(net.parameters()), names, saved_last["trace"])
    ops = {  # the loop's calls, then their parts: the layout change and the orbax layer
        "orbax save_checkpoint": lambda: save_checkpoint(
            path, saved_last["state_dict"], backend="orbax", momentum=saved_last["trace"],
            **meta),
        "orbax load_train_state": lambda: load_train_state(path),
        "to_flax (rxtpu_payload)": lambda: rxtpu_payload(
            saved_last["state_dict"], saved_last["trace"], **meta),
        "from_flax": lambda: (from_flax(payload["params"], payload["batch_stats"]),
                              from_flax(payload["opt_state"][0]["trace"])),
        "save_checkpoint_orbax": lambda: save_checkpoint_orbax(path, payload),
        "load_checkpoint_orbax": lambda: load_checkpoint_orbax(path),
        "port save_checkpoint": lambda: save_checkpoint(port, saved_last["state_dict"],
                                                        optimizer=opt, **meta),
        "port load_train_state": lambda: load_train_state(port),
    }
    t = {k: [] for k in ops}
    for _ in range(3):
        for name, op in ops.items():
            t0 = time.perf_counter()
            out = op()
            t[name].append(time.perf_counter() - t0)
            if name == "load_checkpoint_orbax":
                back = out
    size, files = dir_files(path)
    got, want = _leaves(back), _leaves(payload)
    if len(got) != len(want) or any(not np.array_equal(a, b) for a, b in zip(got, want)):
        fail("(d) the timed round trip changed the payload")
    print(f"(d) ResNet-50 rolling payload ({n_bytes / 1e6:.1f} MB of arrays; the orbax "
          f"directory {size / 1e6:.1f} MB in {files} files, the port's file "
          f"{os.path.getsize(port) / 1e6:.1f} MB), host clock, warm file cache, 3 runs (s): "
          + "; ".join(f"{k} {' '.join(f'{v:.3f}' for v in vs)}" for k, vs in t.items())
          + f"; {card}")
    print(f"phase 3f in {time.perf_counter() - t_start:.1f} s")


def _leaves(tree):
    """The arrays of an orbax tree in order (dicts by key order)."""
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _leaves(v)]
    if isinstance(tree, list):
        return [a for v in tree for a in _leaves(v)]
    return [] if tree is None else [tree]


# ---------------------------------------------------------------------------
# Multi-GPU (phase 3e): --distributed at world 1 over NCCL through torchrun,
# the world-2 train step over gloo on the one card (plain and with a
# tensor-parallel head), and the cost of the gradient all-reduce at world 1
# ---------------------------------------------------------------------------

# the CLI as ``-m rxtpu_torch.cli`` runs it, with cuDNN deterministic and every
# train step logged, so that two runs can be compared bit for bit
DET_CLI = """import sys
import torch
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
import rxtpu_torch.cli as cli
resolve = cli.resolve_config
def every_step(args):
    cfg = resolve(args)
    cfg.train.log_every_steps = 1
    return cfg
cli.resolve_config = every_step
sys.exit(cli.main(sys.argv[1:]))
"""


def dist_cli_runs(argv, out_dir):
    """Phase 3e (a): phase 3's run (``argv``, its ``--out-dir`` ``out_dir``)
    for one epoch and its test phase, once as ``python -m
    torch.distributed.run --standalone --nproc-per-node 1 ... --distributed``
    (NCCL at world 1) and once without ``--distributed``, at the same time,
    each in a process and a directory of its own: losses, final weights,
    momentum and the submission bit-equal."""
    import torch

    from rxtpu_torch.train.checkpoint import load_train_state

    base = os.path.join(WORK, "dist_cli")
    os.makedirs(base)
    script = os.path.join(base, "det_cli.py")
    with open(script, "w") as f:
        f.write(DET_CLI)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")])}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    a = [os.curdir if x == out_dir else x for x in argv]
    a[a.index("--epochs") + 1] = "1"
    launch = {"plain": [sys.executable, script],
              "torchrun": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", "1", script, "--distributed"]}
    got, procs = {}, {}
    t0 = time.perf_counter()
    for name, cmd in launch.items():
        run = os.path.join(base, name)
        os.makedirs(run)
        procs[name] = subprocess.Popen(cmd + a, cwd=run, env=env, text=True,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    for name, p in procs.items():
        run = os.path.join(base, name)
        try:
            stdout, stderr = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
                q.communicate()
            fail(f"(a) the {name} run did not end in 600 s")
        wall = time.perf_counter() - t0
        if p.returncode != 0:
            for q in procs.values():
                if q.poll() is None:
                    q.kill()
                    q.communicate()
            print(stdout[-4000:], stderr[-4000:])
            fail(f"(a) the {name} run exited {p.returncode}")
        logged = read_jsonl(os.path.join(run, "board", "smoke", "metrics.jsonl"))
        got[name] = {
            "wall": wall, "out": stdout,
            "train": [r["training/loss"] for r in logged if "training/loss" in r],
            "val": [r["validation/loss"] for r in logged if "validation/loss" in r],
            "ckpt": {k: load_train_state(os.path.join(run, "models", f"{k}_smoke.ckpt"))
                     for k in ("best_model", "last")},
        }
        with open(os.path.join(run, "submission_smoke.csv"), "rb") as f:
            got[name]["submission"] = f.read()
        print(f"(a) {name}: rc 0, done {wall:.2f} s after the start of both; train losses "
              f"{got[name]['train']}; val losses {got[name]['val']}")
    plain, dist = got["plain"], got["torchrun"]
    if "process group: nccl, world 1, rank 0" not in dist["out"]:
        fail("(a) the torchrun run formed no NCCL process group of world 1")
    if "process group" in plain["out"]:
        fail("(a) the run without --distributed formed a process group")
    if len(plain["train"]) != 64 // B or plain["train"] != dist["train"] \
            or plain["val"] != dist["val"]:
        fail("(a) the losses of the --distributed run differ from the plain run's")
    n_tensors = 0
    for kind in ("best_model", "last"):
        x, y = plain["ckpt"][kind], dist["ckpt"][kind]
        if x["step"] != y["step"] or x["state_dict"].keys() != y["state_dict"].keys():
            fail(f"(a) the {kind} checkpoints differ in step or names")
        for k, v in x["state_dict"].items():
            n_tensors += 1
            if not torch.equal(v, y["state_dict"][k]):
                fail(f"(a) {kind} {k}: the --distributed run's weight is not bit-equal")
        for i, slot in x["optimizer"]["state"].items():
            n_tensors += 1
            if not torch.equal(slot["momentum_buffer"],
                               y["optimizer"]["state"][i]["momentum_buffer"]):
                fail(f"(a) {kind}: momentum buffer {i} is not bit-equal")
    if plain["submission"] != dist["submission"]:
        fail("(a) the --distributed run's submission differs")
    print(f"(a) NCCL at world 1 through torchrun: {len(plain['train'])} train losses, "
          f"{len(plain['val'])} val losses, {n_tensors} checkpoint tensors (weights, BN "
          f"statistics, momentum) and the submission ({len(plain['submission'])} bytes) "
          "bit-equal to the run without --distributed (cuDNN deterministic)")


def e3_batch(dev):
    """Phase 3e's full-width train batch [16, 3, 6, 512^2] uint8 from a seed,
    the same in every process."""
    import torch

    g = torch.Generator().manual_seed(31)
    return {"images": torch.randint(0, 256, (B, G, 6, SRC, SRC), generator=g,
                                    dtype=torch.uint8).to(dev),
            "labels": torch.randint(0, 1108, (B,), generator=g).to(dev),
            "mean": (0.3 + 0.2 * torch.rand((B, 6), generator=g)).to(dev),
            "std": (0.1 + 0.1 * torch.rand((B, 6), generator=g)).to(dev)}


def e3_state(dev, mesh, compute_dtype="float32", fuse=False):
    """ResNet-50 + MLP head at full width (``fuse``: its stride-1 blocks on
    K6/K7), initialized from seed 0 on every rank, the tensor-parallel
    shards cut; (state, train step)."""
    import torch

    from rxtpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from rxtpu_torch.parallel import place_state
    from rxtpu_torch.train.setup import build_model, create_train_state
    from rxtpu_torch.train.step import make_train_step

    world = 1 if mesh is None else mesh.world
    cfg = Config(data=DataConfig(crop_size=CROP),
                 model=ModelConfig(backbone="resnet50", nb_classes=1108, pretrained=False,
                                   compute_dtype=compute_dtype, fuse_blocks=fuse),
                 train=TrainConfig(bs_per_device=B // world, seed=0), experiment_id="e3")
    model = build_model(cfg, mesh)
    state, _ = create_train_state(cfg, model, 1, dev, n_devices=world)
    place_state(state, mesh)
    step = make_train_step(model, CROP, augment="shear",
                           compute_dtype=getattr(torch, compute_dtype), mesh=mesh)
    return state, step


def e3_step(dev, mesh, fuse=False):
    """One f32 train step (TF32 off; ``fuse``: the blocks on K6/K7) on this
    rank's rows of ``e3_batch``: the loss, accuracy, the whole updated
    weights on the host (with ``fuse``, the momentum buffers too: the step's
    gradients plus weight decay), K2-K4's and K6/K7's launches by their
    wrappers and the step's wall time."""
    import torch

    from rxtpu_torch.ops import fused_block as fb
    from rxtpu_torch.ops import shear as ps
    from rxtpu_torch.parallel import whole_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state, step = e3_state(dev, mesh, fuse=fuse)
    batch = e3_batch(dev)
    if mesh is not None:
        k = B // mesh.data_size
        batch = {n: v[mesh.data_rank * k:(mesh.data_rank + 1) * k] for n, v in batch.items()}
    kernels = (ps.shear_pass, ps.shear_pass_rows, ps.shear_pass_finish)
    for kernel in kernels + fb.BODIES:
        kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = step(state, batch, 0, True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    momentum = None if not fuse else {
        n: state.optimizer.state[p]["momentum_buffer"].cpu()
        for n, p in state.model.named_parameters()}
    return {"loss": float(m["loss"]), "accuracy": float(m["accuracy"]),
            "grad_norm": float(m["grad_norm"]), "wall_s": wall, "momentum": momentum,
            "launches": [kernel.launches for kernel in kernels],
            "fb_launches": [body.launches for body in fb.BODIES], "rows": batch["labels"].shape[0],
            "state_dict": {k: v.cpu() for k, v in whole_state_dict(state.model, mesh).items()}}


def e3_gloo_rank(rank, world, port, outs):
    """One rank of phase 3e (b): gloo on the one card, as
    ``initialize_distributed(backend="gloo")`` forms it; the step at model
    size 1, then 2, then the fused step at model size 1, written to
    ``outs[key][rank]`` (key 1, 2, "fused")."""
    import torch

    from rxtpu_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo", device="cuda")
    for key, paths in outs.items():
        out = e3_step(torch.device("cuda", torch.cuda.current_device()),
                      make_mesh(1 if key == "fused" else key), fuse=key == "fused")
        out["backend"] = torch.distributed.get_backend()
        torch.save(out, paths[rank])
        del out
        torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()


def e3_nccl_timing(dev):
    """Phase 3e (c): the bf16 train step at world 1 (a one-rank NCCL group
    formed here and destroyed after) with the mesh, so with its gradient
    all-reduce, and without, by CUDA events, alternated three times."""
    import torch

    from rxtpu_torch.parallel import initialize_distributed, make_mesh
    from rxtpu_torch.train.step import make_train_step

    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        backend = torch.distributed.get_backend()
        state, plain = e3_state(dev, None, "bfloat16")
        dist = make_train_step(state.model, CROP, augment="shear",
                               compute_dtype=torch.bfloat16, mesh=make_mesh(1))
        batch = e3_batch(dev)
        times = {"plain": [], "distributed": []}
        for name in ("plain", "distributed") * 3:
            fn = plain if name == "plain" else dist
            times[name].append(cuda_ms(lambda: fn(state, batch, 0, True), 10))
    finally:
        torch.distributed.destroy_process_group()
    return {"times": times, "backend": backend}


def step_timings(dev, card):
    """The bf16 train step (ResNet-50 + MLP head, seeded random weights, B=16
    of phase 3e's batch, the shear augment) unfused and with the fused
    blocks, by the host's clock (10 steps after 2 of warm-up) and by CUDA
    events (10 steps), alternated three times."""
    import torch

    from rxtpu_torch.data.synthetic import randomize_
    from rxtpu_torch.models.twosites import TwoSitesNN
    from rxtpu_torch.train.step import TrainState, make_train_step

    batch = e3_batch(dev)
    steps = {}
    for name, fuse in (("unfused", False), ("fused", True)):
        m = randomize_(TwoSitesNN("resnet50", nb_classes=1108, fuse_blocks=fuse), seed=2).to(dev)
        state = TrainState.create(m, lambda step: 0.008, weight_decay=3e-5)
        steps[name] = (state, make_train_step(m, CROP, augment="shear",
                                              compute_dtype=torch.bfloat16))
    times = {name: {"host": [], "events": []} for name in steps}
    for name in ("unfused", "fused") * 3:
        state, step = steps[name]
        for _ in range(2):
            step(state, batch, 0, True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step(state, batch, 0, True)
        torch.cuda.synchronize()
        times[name]["host"].append((time.perf_counter() - t0) * 1e3 / 10)
        times[name]["events"].append(cuda_ms(lambda: step(state, batch, 0, True), 10, warmup=0))
    for name, t in times.items():
        print(f"{name} bf16 train step B={B} G={G} 6x{SRC}^2 -> {CROP}^2 ResNet-50: host clock "
              f"{' / '.join(f'{v:.3f}' for v in t['host'])} ms/step, CUDA events "
              f"{' / '.join(f'{v:.3f}' for v in t['events'])} ms/step; {card}")
    return times


def free_port():
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_phase(dev, argv, out_dir, card):
    """Phase 3e: (a) ``dist_cli_runs``; (b) one f32 ResNet-50 train step at
    full width, global batch 16, at world 2 (data 2) and at world 2 with the
    head split over 2 model ranks, two processes over gloo on the one card,
    against the world-1 step: the loss within rtol 1e-5, the weights within
    atol 2e-5, K2-K4 once per rank, and the fused step at data 2 against the
    fused world-1 step, K6/K7 13 times per rank; a collective that gloo
    refuses on CUDA tensors fails the phase; (c) ``e3_nccl_timing``."""
    import gc

    import torch
    import torch.multiprocessing as mp

    t_start = time.perf_counter()
    dist_cli_runs(argv, out_dir)

    gc.collect()
    torch.cuda.empty_cache()
    want = e3_step(dev, None)
    if want["launches"] != [1, 1, 1]:
        fail(f"(b) the world-1 step launched K2-K4 {want['launches']} times")
    print(f"(b) world 1: f32 step loss {want['loss']:.7f}, accuracy {want['accuracy']}, "
          f"grad norm {want['grad_norm']:.6f}, {want['wall_s']:.3f} s")
    ref = want.pop("state_dict")
    gc.collect()
    torch.cuda.empty_cache()
    fwant = e3_step(dev, None, fuse=True)
    if fwant["launches"] != [1, 1, 1] or fwant["fb_launches"] != [13] * 8:
        fail(f"(b) the fused world-1 step launched K2-K4 {fwant['launches']}, K6/K7 "
             f"{fwant['fb_launches']} times")
    print(f"(b) world 1, fused blocks: f32 step loss {fwant['loss']:.7f}, grad norm "
          f"{fwant['grad_norm']:.6f}, {fwant['wall_s']:.3f} s")
    fref, fmom = fwant.pop("state_dict"), fwant.pop("momentum")
    gc.collect()
    torch.cuda.empty_cache()
    outs = {m: [os.path.join(WORK, f"e3_gloo_m{m}_r{r}.pt") for r in range(2)]
            for m in (1, 2, "fused")}
    t0 = time.perf_counter()
    try:
        mp.spawn(e3_gloo_rank, args=(2, free_port(), outs), nprocs=2, join=True)
    except Exception as e:  # a rank raised (a collective gloo refused, a mismatch)
        fail(f"(b) world 2 over gloo: a rank failed: {e}")
    print(f"(b) two processes, both meshes, in {time.perf_counter() - t0:.1f} s")
    for model_parallel in (1, 2):
        label = "data 2" if model_parallel == 1 else "data 1 x model 2"
        for r, path in enumerate(outs[model_parallel]):
            got = torch.load(path, weights_only=False)
            if got["backend"] != "gloo" or got["launches"] != [1, 1, 1]:
                fail(f"(b) {label} rank {r}: backend {got['backend']}, K2-K4 launches "
                     f"{got['launches']}")
            rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            worst, name = max((float((got["state_dict"][k].float() - v.float()).abs().max()), k)
                              for k, v in ref.items())
            print(f"(b) world 2 ({label}), rank {r}: {got['rows']} rows, loss "
                  f"{got['loss']:.7f} (rel {rel:.2e} of world 1's), accuracy {got['accuracy']}, "
                  f"weights max |diff| {worst:.3e} ({name}), K2-K4 launches {got['launches']}; "
                  f"step {got['wall_s']:.3f} s over gloo (a path check, not a speed figure)")
            if rel > 1e-5 or worst > 2e-5:
                fail(f"(b) {label} rank {r} is off world 1's step")
            os.remove(path)
    # The fused step at data 2, its BN sums all-reduced over the two ranks,
    # against the fused world-1 step: the kernels' sums add in another order,
    # so a bf16 value now and then rounds the other way, and the step
    # amplifies that. Held: the loss, the running statistics (max |diff|)
    # and the momentum buffers (the step's gradients plus weight decay,
    # relative L2 over all of them). The worst tensor is printed, not held:
    # from the CLI's initialization (the last BN of each residual branch at
    # scale 0) most gradients are exactly 0 on both sides, and stage 4's
    # projection BN scale has a gradient at rounding level (on the CPU at
    # 48^2, norm 0.0022 against 0.41 for its neighbours, 0.89 apart fused
    # and the unfused f32 step's worst tensor too). Readings on the H100:
    # loss 4.5e-6, statistics 8.4e-5, buffers 0.0154. Limits: phase 5b's
    # for the fused kernels against their plain versions on the loss and
    # statistics (5e-3); the buffers 0.1, below what a rank's own sums give
    # (without the backward's all-reduce, 0.42 on the CPU at 48^2, against
    # 0.014 with it).
    f_lim = {"loss": 5e-3, "stats": 5e-3, "overall": 0.1}
    for r, path in enumerate(outs["fused"]):
        got = torch.load(path, weights_only=False)
        if got["backend"] != "gloo" or got["launches"] != [1, 1, 1] \
                or got["fb_launches"] != [13] * 8:
            fail(f"(b) fused data 2 rank {r}: backend {got['backend']}, K2-K4 launches "
                 f"{got['launches']}, K6/K7 {got['fb_launches']}")
        stats = max(float((got["state_dict"][k].double() - v.double()).abs().max())
                    for k, v in fref.items() if "running" in k)
        num = den = 0.0
        rel = {}
        for k, b in fmom.items():
            a, b = got["momentum"][k].double(), b.double()
            num += float((a - b).norm()) ** 2
            den += float(b.norm()) ** 2
            if float(b.norm()) > 0:
                rel[k] = float((a - b).norm() / b.norm())
        worst = max(rel, key=rel.get)
        gap = {"loss": abs(got["loss"] - fwant["loss"]) / abs(fwant["loss"]), "stats": stats,
               "overall": (num / den) ** 0.5}
        print(f"(b) world 2 (data 2), fused blocks, rank {r}: {got['rows']} rows, loss "
              f"{got['loss']:.7f}; against the fused world-1 step: "
              + ", ".join(f"{k} {v:.3g}" for k, v in gap.items())
              + f" (momentum buffers; worst tensor {worst} {rel[worst]:.3g}, its norm "
              f"{float(fmom[worst].norm()):.3g} of {den ** 0.5:.3g}, median tensor "
              f"{sorted(rel.values())[len(rel) // 2]:.3g}); K6/K7 launches "
              f"{got['fb_launches']}; limits {f_lim}")
        if not math.isfinite(got["loss"]) or any(gap[k] > v for k, v in f_lim.items()):
            fail(f"(b) the fused data-2 step, rank {r}, is off the fused world-1 step")
        os.remove(path)
    del fref, fmom

    gc.collect()
    torch.cuda.empty_cache()
    timing = e3_nccl_timing(dev)
    t = timing["times"]
    print(f"(c) bf16 train step B={B} at world 1, CUDA events, 10 steps each, alternated: "
          f"without --distributed {' / '.join(f'{v:.3f}' for v in t['plain'])} ms, with "
          f"({timing['backend']}, one gradient all-reduce) "
          f"{' / '.join(f'{v:.3f}' for v in t['distributed'])} ms; {card}")
    print(f"phase 3e in {time.perf_counter() - t_start:.1f} s")
    return timing



# ---------------------------------------------------------------------------
# --predict-scan-window: one CUDA graph replay per window of K batches
# (phase 4h)
# ---------------------------------------------------------------------------
SCAN_K, SCAN_B = 4, 8  # 4h's windows: phase 4's 32 test wells in 4 batches of 8


def counts():
    """Every kernel wrapper's launch count, in ``launch_counters()`` order."""
    from rxtpu_torch.ops import launch_counters

    return [c.launches for c in launch_counters()]


def count_delta(before):
    """{wrapper name: launches since ``before``} for the wrappers that moved."""
    from rxtpu_torch.ops import launch_counters

    return {c.__name__: n - b for c, n, b in zip(launch_counters(), counts(), before) if n != b}


def scan_window_probs(dev, fx, ckpt, n_batches):
    """Phase 4 (a): the test experiment drained by ``predict_dataset`` with the
    bf16 ``Predictor`` on the checkpoint, per batch and in windows of 2 (one
    graph replay each): the probabilities and ids bit-equal, and K1 counted
    once per test batch in the windowed drain."""
    import numpy as np
    import torch
    from rxtpu_torch.data.pack import PackStore
    from rxtpu_torch.data.pipeline import Pipeline
    from rxtpu_torch.data.records import load_metadata, read_metadata_csvs
    from rxtpu_torch.data.stats import load_stats
    from rxtpu_torch.infer.predict import Predictor, predict_dataset
    from rxtpu_torch.models.twosites import TwoSitesNN
    from rxtpu_torch.ops.crop_norm import crop_normalize
    from rxtpu_torch.train.checkpoint import load_checkpoint

    model = TwoSitesNN("resnet50", nb_classes=1108)
    model.load_state_dict(load_checkpoint(ckpt))
    step = Predictor(model.to(dev).eval(), None, dtype=torch.bfloat16)
    rows, ctrl = read_metadata_csvs(os.path.join(fx["data_dir"], "metadata"), "test")
    pipe = Pipeline(load_metadata(rows, ctrl, "test"), PackStore(fx["pack"]),
                    load_stats(fx["stats"]), B)
    want, want_ids = predict_dataset(step, pipe, dev)
    crop_normalize.launches = 0
    got, got_ids = predict_dataset(step, pipe, dev, scan_window=2)
    torch.cuda.synchronize()
    print(f"predict_dataset over the experiment in windows of 2: probabilities {got.shape} "
          f"bit-equal to the per-batch drain {np.array_equal(got, want)}, ids equal "
          f"{got_ids == want_ids}; crop_norm launches {crop_normalize.launches} for "
          f"{n_batches} batches")
    if not np.array_equal(got, want) or got_ids != want_ids or \
            crop_normalize.launches != n_batches:
        fail("the windowed drain differs from the per-batch one, or K1 ran otherwise")


def scan_fixture_windows(dev, fx):
    """Phase 4's test experiment as 4 batches of 8 (G=6, 512^2) on the card:
    the window of 4 and a tail window of its first 3 and the 3rd again."""
    from rxtpu_torch.data.pack import PackStore
    from rxtpu_torch.data.pipeline import Pipeline, stack_window
    from rxtpu_torch.data.records import load_metadata, read_metadata_csvs
    from rxtpu_torch.data.stats import load_stats

    rows, ctrl = read_metadata_csvs(os.path.join(fx["data_dir"], "metadata"), "test")
    pipe = Pipeline(load_metadata(rows, ctrl, "test"), PackStore(fx["pack"]),
                    load_stats(fx["stats"]), SCAN_B)
    host = [{k: b[k] for k in ("images", "mean", "std")} for b in pipe.epoch(0)]
    if len(host) != SCAN_K:
        fail(f"phase 4's experiment gave {len(host)} batches of {SCAN_B}, not {SCAN_K}")
    return stack_window(host, dev), stack_window(host[:3] + [host[2]], dev)


def scan_phase(dev, fx, steps, timed, card):
    """Phase 4h (b)-(d). (b) each of ``steps`` ((label, per-batch step)) over
    phase 4's experiment in a window of 4 batches, one graph replay: bit-equal
    to the per-batch step on each batch, two replays bit-equal, the tail
    window's 3 real slices bit-equal, and the launch counts of a replay K
    times the per-batch step's. (c) ``timed`` ((label, step, batch)): ms per
    batch at window 1 and 4, alternated, by events and host clock, and each
    mode's peak memory. (d) ``entry()``'s forward on the card and
    ``dryrun_multichip(2)`` in a subprocess."""
    import torch
    from rxtpu_torch.train.step import make_scanned_predict_step

    window, tail = scan_fixture_windows(dev, fx)
    batches = [{k: v[i] for k, v in window.items()} for i in range(SCAN_K)]
    for label, step in steps:
        before = counts()
        per = torch.stack([step(b) for b in batches])
        torch.cuda.synchronize()
        per_window = count_delta(before)  # the K per-batch calls'
        scan = make_scanned_predict_step(step, SCAN_K)
        t0 = time.perf_counter()
        first = scan(window).clone()  # warm-up, capture, then the first replay
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        before = counts()
        second = scan(window).clone()
        torch.cuda.synchronize()
        replay = count_delta(before)
        end = scan(tail).clone()
        torch.cuda.synchronize()
        bad = int((first != per).sum())
        print(f"{label}: window of {SCAN_K} x [{SCAN_B},6,6,{SRC}^2] (first call, warm-up and "
              f"capture included, {t_first:.2f} s): mismatches against the per-batch step "
              f"{bad} of {per.numel()}, two replays equal {torch.equal(first, second)}, tail "
              f"(3 + 1 pad) equal {torch.equal(end[:3], per[:3])}; launches per replay "
              f"{replay}, of {SCAN_K} per-batch calls {per_window}")
        if bad or not torch.equal(first, second) or not torch.equal(end[:3], per[:3]):
            fail(f"{label}: the graph replay differs from the per-batch step")
        if replay != per_window or not bool(torch.isfinite(per).all()):
            fail(f"{label}: a replay launched {replay}, the {SCAN_K} per-batch calls "
                 f"{per_window}")
        del scan, first, second, end, per
        torch.cuda.empty_cache()
    del window, tail, batches

    for label, step, batch in timed:
        # peak memory of each mode alone, above what is allocated before it (the
        # models, the batch): one batch; the window from its capture on
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(batch)
        torch.cuda.synchronize()
        peak = {1: torch.cuda.max_memory_allocated() - base}
        torch.cuda.reset_peak_memory_stats()
        win = {k: torch.stack([v] * SCAN_K) for k, v in batch.items()}
        scan = make_scanned_predict_step(step, SCAN_K)
        scan(win)
        torch.cuda.synchronize()
        peak[SCAN_K] = torch.cuda.max_memory_allocated() - base
        singles = [batch] * SCAN_K
        runs = {1: [], SCAN_K: []}

        def window_1():
            for b in singles:
                step(b)

        def window_k():
            scan(win)

        for k in (1, SCAN_K, SCAN_K, 1):  # alternated
            fn = window_1 if k == 1 else window_k
            ev = cuda_ms(fn, 5, warmup=1) / SCAN_K
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            runs[k].append((ev, (time.perf_counter() - t0) * 1e3 / (5 * SCAN_K)))
        fmt = lambda rs: " / ".join(f"{e:.3f}" for e, _ in rs) + " by events, " + \
            " / ".join(f"{h:.3f}" for _, h in rs) + " host clock"
        print(f"4h (c) {label} B={B} G=6 {SRC}^2, ms per batch: window 1 {fmt(runs[1])}; "
              f"window {SCAN_K} {fmt(runs[SCAN_K])}; peak memory above the "
              f"{base / 2**30:.3f} GiB held before: window 1 {peak[1] / 2**30:.3f} GiB, "
              f"window {SCAN_K} {peak[SCAN_K] / 2**30:.3f} GiB (its input window, static "
              f"copy, warm-up and graph pool) [{card}]")
        del scan, win
        torch.cuda.empty_cache()

    from rxtpu_torch.entry import entry

    fn, (x,) = entry()
    a, b = fn(x), fn(x)
    torch.cuda.synchronize()
    print(f"4h (d) entry(): {tuple(a.shape)} {a.dtype} on {a.device}, finite "
          f"{bool(torch.isfinite(a).all())}, two calls bit-equal {torch.equal(a, b)}")
    if tuple(a.shape) != (2, 1108) or not bool(torch.isfinite(a).all()) or not torch.equal(a, b):
        fail("entry()'s forward on the card is not a finite [2, 1108] repeated bit for bit")
    del fn, x, a, b
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", "from rxtpu_torch.entry import "
                          "dryrun_multichip; dryrun_multichip(2)"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    print(f"4h (d) dryrun_multichip(2) in a subprocess: rc {run.returncode} in "
          f"{time.perf_counter() - t0:.1f} s; {run.stdout.strip().splitlines()[-1:]}")
    if run.returncode != 0:
        print(run.stderr[-4000:])
        fail("dryrun_multichip(2) failed")


def seeded_scan_steps(dev):
    """``--scan``'s steps on seeded weights (no training): ResNet-50 bf16, its
    int8 (calibrated on a full-width batch) without and with transforms,
    DenseNet-121 + MLP with BN statistics fitted to a batch, bf16 and int8,
    DenseNet-121 + ArcFace with calibration under ``--tta flips``, and the
    fused stem. Returns (4h (b)'s steps, 4h (c)'s timed steps)."""
    import torch
    from rxtpu_torch.data.synthetic import randomize_
    from rxtpu_torch.infer.predict import Predictor, tta_transforms
    from rxtpu_torch.infer.quant import QuantPredictor, calibrate, prepare_quantized
    from rxtpu_torch.models.resnet import init_weights
    from rxtpu_torch.models.twosites import TwoSitesNN

    batch = int8_batch(dev, 11)
    net = randomize_(TwoSitesNN("resnet50", nb_classes=1108), seed=0).to(dev).eval()
    qnet = prepare_quantized(net, calibrate(net, [batch], None, torch.bfloat16))
    dn = fit_bn_statistics(init_weights(TwoSitesNN("densenet121", nb_classes=1108),
                                        torch.Generator().manual_seed(0)).to(dev), batch)
    dnq = prepare_quantized(dn, calibrate(dn, [batch], None, torch.bfloat16))
    arc = init_weights(TwoSitesNN("densenet121", nb_classes=1108, head="arcface",
                                  control_calibration=True),
                       torch.Generator().manual_seed(1)).to(dev).eval()
    bf16 = Predictor(net, None, dtype=torch.bfloat16)
    int8 = QuantPredictor(qnet, None, tta_transforms("none"))
    dn_bf16 = Predictor(dn, None, dtype=torch.bfloat16)
    dn_int8 = QuantPredictor(dnq, None, tta_transforms("none"))
    steps = scan_steps(bf16, QuantPredictor(qnet, None, None), dn_bf16, dn_int8,
                       Predictor(arc, None, "flips", dtype=torch.bfloat16),
                       Predictor(net, None, dtype=torch.bfloat16, fused_stem=True))
    return steps, scan_timed(bf16, int8, dn_bf16, dn_int8, batch)


def scan_steps(bf16, int8_src, dn_bf16, dn_int8, arcface, fused):
    """4h (b)'s (label, step) pairs."""
    return [("ResNet-50 bf16 (K1)", bf16),
            ("ResNet-50 int8, no transforms (K1 int8 views, K8)", int8_src),
            ("DenseNet-121 bf16, unfolded under autocast (K1)", dn_bf16),
            ("DenseNet-121 int8, [identity] (K1 bf16 views, K8's stem quantizes)", dn_int8),
            ("DenseNet-121 + ArcFace, --tta flips (K1)", arcface),
            ("ResNet-50 fused_stem=True (K5)", fused)]


def scan_timed(bf16, int8, dn_bf16, dn_int8, batch):
    """4h (c)'s (label, step, batch) triples."""
    return [("ResNet-50 bf16 predict", bf16, batch),
            ("ResNet-50 int8 predict ([identity], the CLI's)", int8, batch),
            ("DenseNet-121 bf16 predict", dn_bf16, batch),
            ("DenseNet-121 int8 predict ([identity], the CLI's)", dn_int8, batch)]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from rxtpu_torch.ops import _build
        from rxtpu_torch.ops import shear as ps
        from rxtpu_torch.ops.crop_norm import (
            crop_normalize, crop_normalize_reference, eval_batch_normalize, normalize_params,
        )
    except ImportError as e:
        print(f"chip_smoke: the rxtpu_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    shear_kernels = (ps.shear_pass, ps.shear_pass_rows, ps.shear_pass_finish)
    shear_names = [k.__name__ for k in shear_kernels]

    # ---- 1. card + build -----------------------------------------------------
    phase("1 card and kernel build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"built {sorted(built)} from rxtpu_torch/csrc in {time.perf_counter() - t0:.2f} s")
    jpeg_host_probe()
    codecs = codec_host_probe()
    for name, (_, log) in built.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:  # the kernel and its template arguments
                m = re.search(r"\d+((?:[a-z][a-z0-9]*_)*kernel)(I(?:L[ib]\d+E)+E)?", line)
                targs = re.findall(r"L[ib](\d+)E", (m and m.group(2)) or "")
                entry = "" if m is None else m.group(1) + (f"<{','.join(targs)}>" if targs else "")
            elif "registers" in line or "spill" in line:
                print(f"  {name} {entry}: {line.strip()}")
    if "--fused-block" in sys.argv[1:]:  # only K6/K7's checks and their launches
        fb_phase2(dev)
        fb_launch_breakdown(dev)
        print(card)
        return 0
    if "--int8" in sys.argv[1:]:  # only K8's checks, the int8 forward and its timings
        from rxtpu_torch.data.synthetic import randomize_
        from rxtpu_torch.models.twosites import TwoSitesNN

        k8_phase2(dev)
        phase(f"4f int8 predict step on one full-width batch [{B},6,6,{SRC}^2], seeded random "
              "ResNet-50")
        net = randomize_(TwoSitesNN("resnet50", nb_classes=1108), seed=0).to(dev).eval()
        batch = int8_batch(dev, 11)
        phase("7 timings of the int8 path")
        int8_timings(dev, *int8_forward_phase(dev, net, batch)[:3], batch, card)
        print(card)
        return 0
    if "--resume" in sys.argv[1:]:  # only a 1-epoch phase 3, 3d, 3f and greedy_jax's timing
        from rxtpu_torch import cli
        from rxtpu_torch.data.synthetic import make_test_fixture, make_train_fixture

        shutil.rmtree(WORK, ignore_errors=True)
        train_dir, test_dir = os.path.join(WORK, "train"), os.path.join(WORK, "test")
        fx = make_train_fixture(train_dir, nb_classes=1108, n_experiments=3,
                                wells_per_experiment=32, n_test_wells=16, img_size=SRC, seed=0)
        argv = ["--experiment_id", "smoke", "--pack", fx["pack_dir"], "--data-dir",
                fx["data_dir"], "--stats", fx["stats"], "--out-dir", train_dir,
                "--split-by-experiment", "--epochs", "1", "--no-plate-leak", "--device", "cuda"]
        phase("3 training end to end, 1 epoch (rxtpu_torch.cli)")
        rc, wall = dn_run(cli, train_dir, argv)
        print(f"cli rc {rc} in {wall:.2f} s")
        fx_test = make_test_fixture(test_dir, nb_classes=1108, n_test_wells=32, img_size=SRC,
                                    seed=0)
        os.makedirs(os.path.join(test_dir, "models"))
        shutil.copy(os.path.join(train_dir, "models", "best_model_smoke.ckpt"),
                    os.path.join(test_dir, "models", "best_model_smoke.ckpt"))
        argv_test = ["--experiment_id", "smoke", "--pack", fx_test["pack_dir"], "--data-dir",
                     fx_test["data_dir"], "--stats", fx_test["stats"], "--out-dir", test_dir,
                     "--device", "cuda"]
        rc_test, _ = dn_run(cli, test_dir, argv_test)
        if rc or rc_test:
            fail(f"phase 3's run exited {rc}, the test phase {rc_test}")
        phase("3d --resume from an rxtpu-layout pickle, --profile, greedy_jax")
        resume_profile_phase(dev, cli, train_dir, argv, 64 // B, shear_kernels,
                             crop_normalize, test_run=(fx_test, test_dir, argv_test))
        phase("3f --checkpoint-backend orbax: rxtpu's OCDBT checkpoint read on this host; "
              "train, resume (also from <path>.old) and test against the port's format; save "
              "and load times")
        orbax_phase(dev, cli, train_dir, argv, 64 // B, shear_kernels, crop_normalize, card,
                    test_run=(fx_test, test_dir, argv_test))
        phase("7 timing of greedy_jax")
        greedy_jax_timings(dev, card)
        shutil.rmtree(WORK, ignore_errors=True)
        print(card)
        return 0
    if "--distributed" in sys.argv[1:]:  # only phase 3e, on phase 3's fixture
        from rxtpu_torch.data.synthetic import make_train_fixture

        shutil.rmtree(WORK, ignore_errors=True)
        train_dir = os.path.join(WORK, "train")
        fx = make_train_fixture(train_dir, nb_classes=1108, n_experiments=3,
                                wells_per_experiment=32, n_test_wells=16, img_size=SRC, seed=0)
        argv = ["--experiment_id", "smoke", "--pack", fx["pack_dir"], "--data-dir",
                fx["data_dir"], "--stats", fx["stats"], "--out-dir", train_dir,
                "--split-by-experiment", "--epochs", "2", "--no-plate-leak", "--device", "cuda"]
        phase("3e --distributed: torchrun at world 1 over NCCL bit-equal to the plain run; "
              "the world-2 f32 step over gloo on the one card, plain, with "
              "--model-parallel 2 and fused; the gradient all-reduce's cost at world 1")
        dist_phase(dev, argv, train_dir, card)
        shutil.rmtree(WORK, ignore_errors=True)
        print(card)
        return 0
    if "--scan" in sys.argv[1:]:  # only phase 4h, on seeded weights
        from rxtpu_torch.data.synthetic import make_test_fixture

        shutil.rmtree(WORK, ignore_errors=True)
        fx = make_test_fixture(os.path.join(WORK, "test"), nb_classes=1108, n_test_wells=32,
                               img_size=SRC, seed=0)
        phase(f"4h windows of {SCAN_K} predict batches as one CUDA graph replay each, seeded "
              "weights; window 1 against 4; entry() and dryrun_multichip(2)")
        scan_phase(dev, fx, *seeded_scan_steps(dev), card)
        shutil.rmtree(WORK, ignore_errors=True)
        print(card)
        return 0
    if "--step-timing" in sys.argv[1:]:  # only the train step's times, unfused and fused
        phase("7 the bf16 train step, unfused and fused, alternated")
        step_timings(dev, card)
        print(card)
        return 0
    if "--densenet" in sys.argv[1:]:  # only DenseNet's K8 checks, 3c, 4g and their timings
        from rxtpu_torch import cli

        k8_densenet_phase2(dev)
        fx, fx_test = dn_fixtures()
        phase("3c training end to end with --backbone densenet121 --head arcface --calibrate, "
              "then its test phase with --tta flips")
        densenet_arcface_phase(cli, fx, fx_test,
                               (ps.shear_pass, ps.shear_pass_rows, ps.shear_pass_finish),
                               crop_normalize)
        phase("4g densenet121 --quantize int8: the CLI, then the int8 step on one full-width "
              "batch against its plain versions and the bf16 Predictor")
        _, dn_model = densenet_int8_cli_phase(dev, cli, fx_test)
        batch = int8_batch(dev, 12)
        dn_steps, _, _ = densenet_int8_forward(dev, dn_model, batch)
        phase("7 timings of DenseNet-121: train step, bf16 and int8 predict steps, K8 per conv "
              "kind")
        densenet_timings(dev, dn_steps, batch, card)
        shutil.rmtree(WORK, ignore_errors=True)
        print(card)
        return 0

    # ---- 2. kernels against their plain versions -----------------------------
    phase("2 K1 crop_norm against its plain version (bit equality)")
    n, h = 16 * 6 * 6, SRC
    gen = torch.Generator(device=dev).manual_seed(0)
    planes = torch.randint(0, 256, (n, h, h), dtype=torch.uint8, device=dev, generator=gen)
    std = torch.rand(n, device=dev, generator=gen) * 0.25 + 0.05
    mean = torch.rand(n, device=dev, generator=gen) * 0.5 + 0.1
    scale = (1.0 / (255.0 * std)).float()
    bias = (-mean / std).float()
    # int8: x*0.5 - 64 lands on .5 ties for every odd x; x*1 - 128 hits the clip
    half = torch.arange(n, device=dev) % 2 == 0
    q_scale = torch.where(half, 0.5, 1.0).float()
    q_bias = torch.where(half, -64.0, -128.0).float()
    cases = [(512, torch.bfloat16, scale, bias), (364, torch.bfloat16, scale, bias),
             (363, torch.bfloat16, scale, bias), (512, torch.int8, q_scale, q_bias),
             (364, torch.int8, q_scale, q_bias), (512, torch.float32, scale, bias),
             (364, torch.float32, scale, bias)]
    k1_err = 0.0
    for crop, dtype, s, b in cases:
        out = crop_normalize(planes, s, b, crop, dtype)
        ref = crop_normalize_reference(planes, s, b, crop, dtype)
        torch.cuda.synchronize()
        bad, err = bitwise_diff(out, ref)
        k1_err = max(k1_err, err)
        print(f"crop {h}->{crop} offset {(h - crop) // 2} {str(dtype):15s} "
              f"mismatches {bad} max_abs_diff {err}")
        if bad:
            fail(f"K1 differs from its plain version at crop {crop} {dtype}")
    print(f"int8 .5-tie inputs checked at 512: {int((planes[half] % 2 == 1).sum())}")
    del planes

    shear_err, timing_inputs, sc, bi = shear_phase2(dev)

    from rxtpu_torch.ops.shear import apply_affine_shear
    from rxtpu_torch.ops.warp import sample_affine_params

    # the plain versions behind the wrappers' signatures: the composed plain path
    def plain_k2(x, shift, w_out, lo, hi):
        ones = torch.ones(x.shape[0], device=x.device)
        return ps.shear_pass_reference(x, *ps.shift_params(shift, x.shape[2], w_out, lo, hi),
                                       w_out, lo, hi, ones, torch.zeros_like(ones))

    def plain_k3(x, shift, h_out, lo, hi):
        return ps.shear_pass_rows_reference(
            x, *ps.shift_params(shift, x.shape[1], h_out, lo, hi), h_out, lo, hi)

    def plain_k4(x, shift, w_out, lo, hi, scale, bias, rrev, crev, out_dtype):
        return ps.shear_pass_finish_reference(
            x, *ps.shift_params(shift, x.shape[2], w_out, lo, hi), w_out, lo, hi, scale, bias,
            rrev, crev, out_dtype)

    agen = torch.Generator(device=dev).manual_seed(2)
    images = torch.randint(0, 256, (B, G, 6, SRC, SRC), dtype=torch.uint8, device=dev,
                           generator=agen)
    img_mean = torch.rand(B, 6, device=dev, generator=agen) * 0.4 + 0.1
    img_std = torch.rand(B, 6, device=dev, generator=agen) * 0.2 + 0.05
    draws = sample_affine_params(torch.Generator().manual_seed(3), B * G, SRC, CROP, True)
    views = apply_affine_shear(images, img_mean, img_std, *draws, crop_size=CROP)
    plain = apply_affine_shear(images, img_mean, img_std, *draws, crop_size=CROP,
                               passes=(plain_k2, plain_k3, plain_k4))
    torch.cuda.synchronize()
    bad, err = bitwise_diff(views, plain)
    print(f"composed shear augment [{B},{G},6,{SRC},{SRC}] -> {tuple(views.shape)} bf16: "
          f"mismatches {bad} max_abs_diff {err}; finite {bool(torch.isfinite(views).all())}")
    if bad or not bool(torch.isfinite(views).all()):
        fail("the composed shear augment differs from the composed plain path")
    del plain

    k5_err, stem = k5_phase2(dev)
    from rxtpu_torch.ops.fused_stem import fused_stem

    from rxtpu_torch.ops import fused_block as fb

    fb_bodies = dict(zip(FB_NAMES, fb.BODIES))
    fb_err = fb_phase2(dev)
    k8_err = k8_phase2(dev)
    dn_k8_err = k8_densenet_phase2(dev)

    # ---- 3. training end to end ---------------------------------------------
    phase("3 training end to end at full width (rxtpu_torch.cli)")
    from rxtpu_torch import cli
    from rxtpu_torch.data.synthetic import make_train_fixture
    from rxtpu_torch.train.checkpoint import load_train_state

    shutil.rmtree(WORK, ignore_errors=True)
    train_dir = os.path.join(WORK, "train")
    t0 = time.perf_counter()
    fx = make_train_fixture(train_dir, nb_classes=1108, n_experiments=3,
                            wells_per_experiment=32, n_test_wells=16, img_size=SRC, seed=0)
    train_fx = fx  # phase 3c trains on it too
    print(f"train fixture in {time.perf_counter() - t0:.2f} s "
          f"({os.path.getsize(os.path.join(fx['pack_dir'], 'train.rxpack')) / 1e6:.1f} MB "
          f"train pack)")
    argv = ["--experiment_id", "smoke", "--pack", fx["pack_dir"], "--data-dir",
            fx["data_dir"], "--stats", fx["stats"], "--out-dir", train_dir,
            "--split-by-experiment", "--epochs", "2", "--no-plate-leak", "--device", "cuda"]
    train_argv = argv  # phase 3d resumes from this run
    resolve = cli.resolve_config

    def log_every_step(args):  # so every train step's loss is logged and checked
        cfg = resolve(args)
        cfg.train.log_every_steps = 1
        return cfg

    cli.resolve_config = log_every_step
    cwd = os.getcwd()
    os.chdir(train_dir)
    for kernel in shear_kernels:
        kernel.launches = 0
    crop_normalize.launches = 0
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in shear_kernels}
    launches["crop_norm"] = crop_normalize.launches
    n_steps, val_batches, test_batches = 2 * (64 // B), 2, 1
    print(f"cli rc {rc} in {wall:.2f} s; launches {launches}; train steps {n_steps}, "
          f"val batches {val_batches} x 3 validations, test batches {test_batches}")
    if rc != 0:
        fail(f"cli exited {rc}")
    for name in shear_names:
        if launches[name] != n_steps:
            fail(f"{name} launched {launches[name]} times for {n_steps} train steps")
    if launches["crop_norm"] != 3 * val_batches + test_batches:
        fail(f"crop_norm launched {launches['crop_norm']} times, expected "
             f"{3 * val_batches + test_batches}")
    logged = read_jsonl(os.path.join(train_dir, "board", "smoke", "metrics.jsonl"))
    losses = [r["training/loss"] for r in logged if "training/loss" in r]
    val_losses = [r["validation/loss"] for r in logged if "validation/loss" in r]
    print(f"train losses {[round(v, 4) for v in losses]}; val losses "
          f"{[round(v, 4) for v in val_losses]}")
    if len(losses) != n_steps or len(val_losses) != 3 or not all(
            math.isfinite(v) for v in losses + val_losses):
        fail("a logged loss is missing or not finite")
    saved = {name: load_train_state(os.path.join(train_dir, "models", f"{name}_smoke.ckpt"))
             for name in ("best_model", "last")}
    for name, payload in saved.items():
        if payload["format"] != "rxtpu_torch" or "optimizer" not in payload:
            fail(f"{name} is not a full training checkpoint in the port's format")
    best, last = saved["best_model"], saved["last"]
    print(f"checkpoints: best (step {best['step']}, val accuracy {best['best_metric']}), "
          f"last (epoch {last['epoch']}, step {last['step']})")
    if last["step"] != n_steps or last["epoch"] != 2:
        fail(f"last checkpoint at epoch {last['epoch']} step {last['step']}")
    sub_path = os.path.join(train_dir, "submission_smoke.csv")
    os.remove(sub_path)
    os.chdir(train_dir)
    for kernel in shear_kernels:
        kernel.launches = 0
    try:
        rc = cli.main(argv + ["--resume"])
    finally:
        os.chdir(cwd)
        cli.resolve_config = resolve
    if rc != 0 or any(k.launches for k in shear_kernels) or not os.path.exists(sub_path):
        fail("--resume on the finished run trained or wrote no submission")
    with open(sub_path, newline="") as f:
        rows = list(csv.DictReader(f))
    if [r["id_code"] for r in rows] != [r["id_code"] for r in fx["test_rows"]]:
        fail("resumed run's submission rows do not match the test ids")
    print(f"--resume: no train step, submission of {len(rows)} rows rewritten")

    # ---- 3b. training with the fused bottleneck (K6/K7) -----------------------
    phase("3b training end to end with --fuse-blocks on (K6/K7), 1 epoch, same fixture")
    from rxtpu_torch.models.twosites import TwoSitesNN
    from rxtpu_torch.train.checkpoint import load_checkpoint

    fused_dir = os.path.join(WORK, "train_fused")
    os.makedirs(fused_dir)
    argv_f = [fused_dir if a == train_dir else a for a in argv]
    argv_f[argv_f.index("--epochs") + 1] = "1"
    cli.resolve_config = log_every_step
    os.chdir(fused_dir)
    # the path's launches: every count set to 0 just before, read just after
    for kernel in shear_kernels + fb.BODIES:
        kernel.launches = 0
    crop_normalize.launches = 0
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv_f + ["--fuse-blocks", "on"])
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        cli.resolve_config = resolve
    wall = time.perf_counter() - t0
    fb_launches = {name: k.launches for name, k in zip(FB_NAMES, fb.BODIES)}
    n_fsteps = 64 // B
    print(f"cli rc {rc} in {wall:.2f} s; fused_block launches {fb_launches}; shear launches "
          f"{[k.launches for k in shear_kernels]}; crop_norm {crop_normalize.launches}; train "
          f"steps {n_fsteps}, 13 fused blocks per step")
    if rc != 0:
        fail(f"cli --fuse-blocks on exited {rc}")
    for name, count in fb_launches.items():
        if count != 13 * n_fsteps:  # never in validation or test: eval runs the standard blocks
            fail(f"fused_block {name} launched {count} times for {n_fsteps} train steps")
    if any(k.launches != n_fsteps for k in shear_kernels) or crop_normalize.launches == 0:
        fail("the fused training run did not launch K1-K4 as the unfused one does")
    logged = read_jsonl(os.path.join(fused_dir, "board", "smoke", "metrics.jsonl"))
    f_losses = [r["training/loss"] for r in logged if "training/loss" in r]
    print(f"fused train losses {[round(v, 4) for v in f_losses]}")
    if len(f_losses) != n_fsteps or not all(math.isfinite(v) for v in f_losses):
        fail("a logged loss of the fused run is missing or not finite")
    unfused_net = TwoSitesNN("resnet50", nb_classes=1108)
    unfused_net.load_state_dict(load_checkpoint(os.path.join(fused_dir, "models",
                                                             "last_smoke.ckpt")))
    with open(os.path.join(fused_dir, "submission_smoke.csv"), newline="") as f:
        f_rows = list(csv.DictReader(f))
    if [r["id_code"] for r in f_rows] != [r["id_code"] for r in fx["test_rows"]]:
        fail("the fused run's submission rows do not match the test ids")
    print(f"the fused run's last checkpoint loads into the unfused model (strict); submission "
          f"of {len(f_rows)} rows")
    del unfused_net

    # ---- 4. the test phase on the trained checkpoint ------------------------
    phase("4 test phase end to end at full width on the trained checkpoint")
    from rxtpu_torch.data.synthetic import make_test_fixture, randomize_

    test_dir = os.path.join(WORK, "test")
    fx = make_test_fixture(test_dir, nb_classes=1108, n_test_wells=32, img_size=SRC, seed=0)
    os.makedirs(os.path.join(test_dir, "models"))
    shutil.copy(os.path.join(train_dir, "models", "best_model_smoke.ckpt"),
                os.path.join(test_dir, "models", "best_model_smoke.ckpt"))
    argv = ["--experiment_id", "smoke", "--pack", fx["pack_dir"], "--data-dir",
            fx["data_dir"], "--stats", fx["stats"], "--out-dir", test_dir, "--device", "cuda"]
    os.chdir(test_dir)
    crop_normalize.launches = 0
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    n_batches = math.ceil(len(fx["test_rows"]) / 16)
    print(f"cli rc {rc} in {time.perf_counter() - t0:.2f} s; crop_norm launches "
          f"{crop_normalize.launches}; test batches {n_batches}")
    if rc != 0:
        fail(f"cli exited {rc}")
    if crop_normalize.launches != n_batches:
        fail(f"crop_norm launched {crop_normalize.launches} times for {n_batches} batches")
    check_submission(os.path.join(test_dir, "submission_smoke.csv"), fx)
    with open(os.path.join(test_dir, "submission_smoke.csv"), "rb") as f:
        sub_bytes = f.read()
    out_dir = os.path.join(test_dir, "scan2")
    os.makedirs(out_dir)
    argv_w = [out_dir if a == test_dir else a for a in argv]
    os.chdir(test_dir)
    crop_normalize.launches = 0
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv_w + ["--predict-scan-window", "2"])
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    print(f"--predict-scan-window 2 (one CUDA graph replay per window): cli rc {rc} in "
          f"{time.perf_counter() - t0:.2f} s; crop_norm launches {crop_normalize.launches} for "
          f"{n_batches} batches")
    if rc != 0 or crop_normalize.launches != n_batches:
        fail(f"--predict-scan-window 2 run failed or launched K1 {crop_normalize.launches} times")
    with open(os.path.join(out_dir, "submission_smoke.csv"), "rb") as f:
        if f.read() != sub_bytes:
            fail("--predict-scan-window 2 wrote another submission")
    print("scan-window submission: byte-equal to window 1")
    scan_window_probs(dev, fx, os.path.join(test_dir, "models", "best_model_smoke.ckpt"),
                      n_batches)

    # ---- 3d. --resume from rxtpu's layout, --profile, greedy_jax ----------------
    phase("3d --resume from an rxtpu-layout pickle (epoch end; mid-epoch under --profile "
          "against the port's format), greedy_jax on the card and through the CLI")
    resume_profile_phase(dev, cli, train_dir, train_argv, 64 // B, shear_kernels,
                         crop_normalize, test_run=(fx, test_dir, argv))

    # ---- 3e. multi-GPU: NCCL at world 1, gloo at world 2 on the one card ------
    phase("3e --distributed: torchrun at world 1 over NCCL bit-equal to the plain run; the "
          "world-2 f32 step over gloo on the one card, plain, with --model-parallel 2 and "
          "fused; the gradient all-reduce's cost at world 1")
    dist_phase(dev, train_argv, train_dir, card)

    # ---- 3f. --checkpoint-backend orbax -----------------------------------------
    phase("3f --checkpoint-backend orbax: rxtpu's OCDBT checkpoint read on this host; train, "
          "resume (also from <path>.old) and test against the port's format; save and load "
          "times")
    orbax_phase(dev, cli, train_dir, train_argv, 64 // B, shear_kernels, crop_normalize, card,
                test_run=(fx, test_dir, argv))

    # ---- 4b. the K5 path at full width ----------------------------------------
    phase("4b K5 path at full width: EvalStep / Predictor(fused_stem=True) on the trained "
          "checkpoint")
    from rxtpu_torch.data.pack import PackStore
    from rxtpu_torch.data.pipeline import Pipeline
    from rxtpu_torch.data.records import load_metadata, read_metadata_csvs
    from rxtpu_torch.data.stats import load_stats
    from rxtpu_torch.infer.plate_leak import constrained_predict
    from rxtpu_torch.infer.predict import Predictor, predict_dataset
    from rxtpu_torch.train.step import EvalStep

    # the last checkpoint: its BN statistics have moved, so the stem's folded
    # bias is not a bf16 number (the best one is the initial state, whose
    # folded stem bias is 0: random labels never improve on it)
    trained = TwoSitesNN("resnet50", nb_classes=1108)
    trained.load_state_dict(load_checkpoint(os.path.join(train_dir, "models", "last_smoke.ckpt")))
    trained = trained.to(dev).eval()
    egen = torch.Generator(device=dev).manual_seed(6)
    val_batch = {
        "images": torch.randint(0, 256, (B, G, 6, SRC, SRC), dtype=torch.uint8, device=dev,
                                generator=egen),
        "labels": torch.randint(0, 1108, (B,), device=dev, generator=egen),
        "mean": torch.rand(B, 6, device=dev, generator=egen) * 0.4 + 0.1,
        "std": torch.rand(B, 6, device=dev, generator=egen) * 0.2 + 0.05,
    }
    test_batch = {
        "images": torch.randint(0, 256, (B, 6, 6, SRC, SRC), dtype=torch.uint8, device=dev,
                                generator=egen),
        "mean": torch.rand(B, 6, device=dev, generator=egen) * 0.4 + 0.1,
        "std": torch.rand(B, 6, device=dev, generator=egen) * 0.2 + 0.05,
    }
    evals = {f: EvalStep(trained, CROP, torch.bfloat16, fused_stem=f) for f in (False, True)}
    # K5 itself on the checkpoint's folded stem and these batches' views, TF32
    # off for the plain version: bf16 within one ulp (the kernel aims at bit
    # equality), f32 within STEM_F32_REL of max|out|
    from rxtpu_torch.infer.fold import fold_state_dict
    from rxtpu_torch.ops.fused_stem import fused_stem_reference

    folded = fold_state_dict(trained.state_dict())
    stem_wt = folded["backbone.conv_init.weight"].to(torch.bfloat16)
    stem_cbt = folded["backbone.conv_init.bias"]
    torch.backends.cudnn.allow_tf32 = False
    for label, batch_, crop, g in (("val", val_batch, CROP, G), ("test", test_batch, None, 6)):
        nv = B * g
        sc_, bi_ = (t.reshape(nv, 6) for t in normalize_params(batch_["mean"], batch_["std"], g))
        args = (batch_["images"].reshape(nv, 6, SRC, SRC), sc_, bi_, stem_wt, stem_cbt, crop)
        out, ref = fused_stem(*args, torch.bfloat16), fused_stem_reference(*args, torch.bfloat16)
        share, over, err = bf16_gap(out, ref)
        out32 = fused_stem(*args, torch.float32)
        ref32 = fused_stem_reference(*args, torch.float32)
        gap32, top32 = float((out32 - ref32).abs().max()), float(ref32.abs().max())
        near, rel = k5_f32_gaps(out32, ref32)
        print(f"K5 on the trained stem, {label} batch: bf16 {100 * share:.4f}% of elements differ, "
              f"{over} by more than one ulp; f32 max_abs_diff {gap32:.3g} of max|out| {top32:.4g}; "
              f"gap {near:.3g} below 2^-8, {rel:.3g} of the exact path's bound")
        if over or gap32 > STEM_F32_REL * top32:
            fail(f"K5 on the trained stem differs from its plain version ({label})")
    torch.backends.cudnn.allow_tf32 = True
    del out, ref, out32, ref32
    preds = {f: Predictor(trained, None, dtype=torch.bfloat16, fused_stem=f)
             for f in (False, True)}

    def counted(fn, fused, label):
        k5, k1 = fused_stem.launches, crop_normalize.launches
        out = fn()
        torch.cuda.synchronize()
        got = (fused_stem.launches - k5, crop_normalize.launches - k1)
        if got != ((1, 0) if fused else (0, 1)):
            fail(f"{label}: K5/K1 launched {got} times in one {'fused' if fused else 'unfused'} "
                 "call")
        return out

    # the path's K5 launches are counted from here to the end of the phase
    fused_stem.launches = crop_normalize.launches = 0
    logits = {f: counted(lambda: evals[f].logits(val_batch), f, "EvalStep.logits")
              for f in (False, True)}
    metrics = {f: counted(lambda: evals[f](val_batch), f, "EvalStep") for f in (False, True)}
    probs = {f: counted(lambda: preds[f](test_batch), f, "Predictor") for f in (False, True)}
    lu, lf = logits[False], logits[True]
    eval_rel = float((lf - lu).abs().max() / lu.abs().max())
    eval_agree = float((lf.argmax(-1) == lu.argmax(-1)).float().mean())
    loss_rel = abs(float(metrics[True]["loss_sum"]) / float(metrics[False]["loss_sum"]) - 1)
    prob_gap = float((probs[True] - probs[False]).abs().max())
    pred_agree = float((probs[True].argmax(-1) == probs[False].argmax(-1)).float().mean())
    print(f"eval B={B} G={G} crop {CROP}: logits max|fused - unfused| / max|logit| {eval_rel:.4g} "
          f"(max|logit| {float(lu.abs().max()):.4g}), argmax agreement {eval_agree:.4f}, "
          f"loss_sum rel {loss_rel:.4g}, correct {float(metrics[True]['correct'])} vs "
          f"{float(metrics[False]['correct'])}")
    print(f"predict B={B} G=6 {SRC}^2: max|probs fused - unfused| {prob_gap:.4g} (max prob "
          f"{float(probs[False].max()):.4g}), argmax agreement {pred_agree:.4f}")
    # The two paths round differently: the unfused stem adds the bf16 bias of
    # the cast twin and rounds the conv to bf16 before the ReLU and the pool,
    # K5 adds the f32 bias and rounds once. Limits, with the H100 readings
    # beside them: eval logits 5.7e-3 of max|logit|, loss_sum 3.6e-5, test
    # probabilities 2.5e-3 (max prob 0.13), predict_dataset probabilities
    # 1.3e-5, argmax agreement 1.0 on both batches.
    limits = {"eval_rel": 0.03, "loss_rel": 2e-4, "prob_gap": 0.01, "ds_gap": 1e-4,
              "min_agree": 0.875}
    print(f"fused against unfused limits: {limits}")
    if any(not math.isfinite(v) or v > limits[k] for k, v in
           (("eval_rel", eval_rel), ("loss_rel", loss_rel), ("prob_gap", prob_gap))) or min(
               eval_agree, pred_agree) < limits["min_agree"]:
        fail("the fused stem path disagrees with the unfused path")

    rows, ctrl = read_metadata_csvs(os.path.join(fx["data_dir"], "metadata"), "test")
    index = load_metadata(rows, ctrl, "test")
    store, stats = PackStore(fx["pack"]), load_stats(fx["stats"])
    plates = np.asarray([r["plate"] for r in rows])
    drained, assigned = {}, {}
    for f in (False, True):
        k5, k1 = fused_stem.launches, crop_normalize.launches
        drained[f] = predict_dataset(preds[f], Pipeline(index, store, stats, B), dev)
        torch.cuda.synchronize()
        want = (n_batches, 0) if f else (0, n_batches)
        if (fused_stem.launches - k5, crop_normalize.launches - k1) != want:
            fail(f"predict_dataset (fused {f}) launched K5/K1 "
                 f"{(fused_stem.launches - k5, crop_normalize.launches - k1)} times")
        assigned[f] = constrained_predict(drained[f][0], plates, fx["plate_groups"], 0)
    k5_launches = fused_stem.launches
    ids = [r["id_code"] for r in rows]
    if drained[True][1] != ids or drained[False][1] != ids:
        fail("predict_dataset rows differ between the fused and unfused paths")
    ds_gap = float(np.abs(drained[True][0] - drained[False][0]).max())
    n_diff = int((assigned[True] != assigned[False]).sum())
    print(f"predict_dataset over {len(rows)} test wells ({n_batches} batches): max|probs fused "
          f"- unfused| {ds_gap:.4g}; plate-leak assignments that differ: {n_diff} of "
          f"{len(rows)}; K5 launches on this path {k5_launches}")
    if not math.isfinite(ds_gap) or ds_gap > limits["ds_gap"]:
        fail("predict_dataset with the fused stem disagrees with the unfused path")

    # ---- 4c. JPEG input at full width ------------------------------------------
    phase(f"4c JPEG input at full width (6x{SRC}^2 planes, quality 95): nvJPEG against rxtpu's "
          "planes, pipelines from the tree, the CLI without --pack or stats")
    jpeg_run = jpeg_phase(dev, cli, train_dir, shear_kernels, crop_normalize, card)

    # ---- 4d. PNG input and compressed packs at full width -----------------------
    phase(f"4d PNG input and compressed packs at full width (6x{SRC}^2 planes): the PNG "
          "reader, pipelines from the tree, the pack tool, the CLI from the tree and packs")
    png_run = png_phase(dev, cli, train_dir, shear_kernels, crop_normalize, codecs)

    # ---- 4e. --quantize int8: the test phase through the CLI --------------------
    phase("4e --quantize int8 test phase end to end at full width on the trained checkpoint "
          "(K1 in bf16, the stem quantizes, K8 for every conv)")
    k8_launches = int8_cli_phase(cli, test_dir, argv, fx, n_batches)

    # ---- 4f. the int8 forward at full width, kernels against plain versions -----
    phase(f"4f int8 predict step on one full-width batch [{B},6,6,{SRC}^2] on phase 3's last "
          "checkpoint: kernels against plain versions, against the bf16 Predictor")
    int8_steps = int8_forward_phase(dev, trained, test_batch)

    # ---- 3c. DenseNet-121 + ArcFace + calibration through the CLI ---------------
    phase("3c training end to end with --backbone densenet121 --head arcface --calibrate "
          "(1 epoch, phase 3's fixture), then its test phase with --tta flips on phase 4's")
    densenet_arcface_phase(cli, train_fx, fx, shear_kernels, crop_normalize)

    # ---- 4g. DenseNet-121's W8A8 int8 -------------------------------------------
    phase(f"4g densenet121 --quantize int8: the CLI on phase 4's fixture, then the int8 step on "
          f"one full-width batch [{B},6,6,{SRC}^2] against its plain versions and the bf16 "
          f"Predictor")
    dn_k8_launches, dn_model = densenet_int8_cli_phase(dev, cli, fx)
    dn_steps, dn_seeded, dn_fitted = densenet_int8_forward(dev, dn_model, test_batch)
    print(f"largest int8 - bf16 probability gap (top-1 agreement): DenseNet-121 seeded "
          f"{dn_seeded[0]:.4g} ({dn_seeded[1]:.4f}), with fitted BN statistics {dn_fitted[0]:.4g} "
          f"({dn_fitted[1]:.4f}); ResNet-50 in 4f {int8_steps[3]:.4g} ({int8_steps[4]:.4f}, "
          f"trained 8 steps)")

    # ---- 4h. --predict-scan-window: one CUDA graph replay per window -----------
    phase(f"4h windows of {SCAN_K} predict batches as one CUDA graph replay each, against the "
          "per-batch steps (ResNet-50 bf16 and int8, DenseNet-121 bf16 and int8, ArcFace, "
          "the fused stem); window 1 against 4; entry() and dryrun_multichip(2)")
    from rxtpu_torch.infer.predict import Predictor as _Predictor
    from rxtpu_torch.train.checkpoint import load_checkpoint as _load_checkpoint

    arc = TwoSitesNN("densenet121", nb_classes=1108, head="arcface", control_calibration=True)
    arc.load_state_dict(_load_checkpoint(os.path.join(WORK, "densenet_arcface", "models",
                                                      "best_model_dnarc.ckpt")))
    arc_step = _Predictor(arc.to(dev).eval(), None, "flips", dtype=torch.bfloat16)
    scan_phase(dev, fx, scan_steps(preds[False], int8_steps[1], dn_steps[2], dn_steps[0],
                                   arc_step, preds[True]),
               scan_timed(preds[False], int8_steps[0], dn_steps[2], dn_steps[0], test_batch),
               card)
    del arc, arc_step

    # ---- 5. the card against the CPU ------------------------------------------
    phase("5 card against CPU: f32 predict logits; f32 train step against f64")
    from rxtpu_torch.infer.fold import fold_for_inference
    from rxtpu_torch.train.step import TrainState, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = randomize_(TwoSitesNN("resnet50", nb_classes=1108), seed=0)
    cpu_gen = torch.Generator().manual_seed(1)
    images6 = torch.randint(0, 256, (1, 6, 6, h, h), dtype=torch.uint8, generator=cpu_gen)
    mean6 = torch.rand(1, 6, generator=cpu_gen) * 0.5 + 0.1
    std6 = torch.rand(1, 6, generator=cpu_gen) * 0.25 + 0.05
    net_cpu = fold_for_inference(model.eval())
    net_gpu = fold_for_inference(copy.deepcopy(model).to(dev).eval())
    with torch.inference_mode():
        v_cpu = eval_batch_normalize(images6, mean6, std6, None)
        v_gpu = eval_batch_normalize(images6.to(dev), mean6.to(dev), std6.to(dev), None)
        bad, _ = bitwise_diff(v_gpu.cpu(), v_cpu)
        t0 = time.perf_counter()
        l_cpu = net_cpu(v_cpu)
        t_cpu = time.perf_counter() - t0
        l_gpu = net_gpu(v_gpu).cpu()
    scale_l = float(l_cpu.abs().max())
    diff = float((l_gpu - l_cpu).abs().max())
    print(f"predict: views mismatches {bad}; max|logit| {scale_l:.6g}; max|card - cpu| "
          f"{diff:.6g} (bound {1e-3 * scale_l:.6g}); cpu forward {t_cpu:.2f} s")
    if bad or not math.isfinite(diff) or scale_l < 1e-6 or diff > 1e-3 * scale_l:
        fail("card f32 logits disagree with CPU f32 logits")
    del net_cpu, net_gpu
    densenet_card_vs_cpu(dev, h)

    # One train step on given views: on the card in f32, on the CPU in f32 and
    # in f64. B=4: with B=1 the head's BN sees a single sample, normalizes it
    # to its bias and passes no gradient to the backbone, which would leave
    # most of the check empty. The f64 step is the reference. The CPU f32 step
    # is printed beside the card's as the yardstick of an f32 step: a head
    # ReLU whose pre-activation lies within f32 rounding of zero may take the
    # other side in one f32 run, and since every backbone gradient flows
    # through the head, that one unit moves all of them by a few percent (on
    # an H100 the CPU f32 step flipped one such unit, |pre-activation| 1.9e-6,
    # and was 2.6% off f64 in the median tensor; the card flipped none).
    tb, wd = 4, 3e-5
    tviews = torch.randn(tb, G, 6, CROP, CROP, generator=cpu_gen)
    tlabels = torch.randint(0, 1108, (tb,), generator=cpu_gen)
    net = randomize_(TwoSitesNN("resnet50", nb_classes=1108, dropout=0.0), seed=2)
    old = {k: v.double() for k, v in net.state_dict().items()}
    runs = {}
    for label, device, dtype in (("f64", torch.device("cpu"), torch.float64),
                                 ("cpu f32", torch.device("cpu"), torch.float32),
                                 ("card f32", dev, torch.float32)):
        m = copy.deepcopy(net).to(device=device, dtype=dtype)
        pre = []  # the head's fc1 pre-activations, ahead of its ReLU
        hook = m.head.fc1.register_forward_hook(
            lambda mod, i, out: pre.append(out.detach().cpu()))
        state = TrainState.create(m, lambda step: 0.008, weight_decay=wd)
        step = make_train_step(m, CROP, augment="none", compute_dtype=torch.float32)
        t0 = time.perf_counter()
        metrics = step(state, {"images": tviews.to(device, dtype), "labels": tlabels.to(device),
                               "mean": torch.zeros(tb, 6, device=device),
                               "std": torch.ones(tb, 6, device=device)}, 0, True)
        runs[label] = dict(
            loss=float(metrics["loss"]), t=time.perf_counter() - t0, pre=pre[0],
            upd={k: v.cpu().double() - old[k] for k, v in m.state_dict().items()},
            mom={n: state.optimizer.state[p]["momentum_buffer"].cpu().double()
                 for n, p in m.named_parameters()})
        hook.remove()
    ref = runs["f64"]

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-300))

    # no tensor's gradient is rounding-level: the f64 gradient (the first
    # momentum buffer less the weight decay) against the weight-decay term
    ratio = {n: float((g - wd * old[n]).norm() / (wd * old[n]).norm().clamp_min(1e-300))
             for n, g in ref["mom"].items()}
    low = min(ratio, key=ratio.get)
    print(f"train step f64 reference: loss {ref['loss']:.9f} in {ref['t']:.2f} s; "
          f"smallest |grad| / |wd p| {ratio[low]:.4g} ({low})")
    # Limits, with the H100 readings of the card against f64 beside them: loss
    # 1.9e-6, all updates and BN statistics together 5.9e-4, the worst tensor
    # 5.9e-3, the worst momentum buffer 5.9e-3 (the CPU f32 step: 5.6e-7,
    # 4.7e-3, 5.6e-2, 5.6e-2).
    limits = {"loss": 1e-5, "overall": 3e-3, "tensor": 2e-2, "momentum": 2e-2}
    def against_f64(label):
        r = runs[label]
        upd = {k: rel(r["upd"][k], ref["upd"][k]) for k in old
               if float(ref["upd"][k].norm()) > 0}
        mom = {n: rel(r["mom"][n], ref["mom"][n]) for n in ref["mom"]}
        num = sum(float((r["upd"][k] - ref["upd"][k]).norm()) ** 2 for k in old)
        den = sum(float(ref["upd"][k].norm()) ** 2 for k in old)
        got = {"loss": abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
               "overall": (num / den) ** 0.5, "tensor": max(upd.values()),
               "momentum": max(mom.values())}
        worst = sorted(upd, key=upd.get)[-3:]
        flips = int(((r["pre"] > 0) != (ref["pre"] > 0)).sum())
        print(f"{label} against f64: " + ", ".join(f"{k} {v:.3g}" for k, v in got.items())
              + f"; median tensor {sorted(upd.values())[len(upd) // 2]:.3g}; worst "
              f"{[(k, round(upd[k], 5)) for k in worst]}; head ReLU flips {flips} of "
              f"{r['pre'].numel()}; step {r['t']:.2f} s")
        return got

    against_f64("cpu f32")
    got = against_f64("card f32")
    print(f"card f32 limits: {limits}")
    if not math.isfinite(runs["card f32"]["loss"]) or any(got[k] > v for k, v in limits.items()):
        fail("card f32 train step disagrees with the f64 train step")
    del runs, ref, net

    phase("5b fused f32 train step on the card: kernels against the plain versions, and "
          "against the unfused step")
    # The same f32 step (B=16, G=3, crop 364, seeded random weights with BN
    # scales away from 0) three ways: the fused blocks on their kernels, on
    # their plain versions (the same bf16 arithmetic, other f32 sum orders),
    # and unfused (f32 convs and the port's BN). TF32 off.
    fgen = torch.Generator(device=dev).manual_seed(10)
    fviews = torch.randn(B, G, 6, CROP, CROP, device=dev, generator=fgen)
    flabels = torch.randint(0, 1108, (B,), device=dev, generator=fgen)
    fnet = randomize_(TwoSitesNN("resnet50", nb_classes=1108, dropout=0.0, fuse_blocks=True),
                      seed=2)
    fold = {k: v.double() for k, v in fnet.state_dict().items()}
    fruns = {}
    for label, fuse, plain in (("kernels", True, False), ("plain", True, True),
                               ("unfused", False, False)):
        m = copy.deepcopy(fnet).to(dev)
        m.backbone.fuse_blocks = fuse
        state = TrainState.create(m, lambda step: 0.008, weight_decay=wd)
        step = make_train_step(m, CROP, augment="none", compute_dtype=torch.float32)
        before = [k.launches for k in fb.BODIES]
        saved = {name: getattr(fb, name) for name in FB_NAMES}
        if plain:  # BottleneckFused looks its bodies up in the module
            for name in FB_NAMES:
                setattr(fb, name, getattr(fb, f"{name}_reference"))
        try:
            t0 = time.perf_counter()
            metrics = step(state, {"images": fviews, "labels": flabels,
                                   "mean": torch.zeros(B, 6, device=dev),
                                   "std": torch.ones(B, 6, device=dev)}, 0, True)
            loss = float(metrics["loss"])
        finally:
            for name, fn in saved.items():
                setattr(fb, name, fn)
        fruns[label] = dict(loss=loss, t=time.perf_counter() - t0,
                            launched=[k.launches - n for k, n in zip(fb.BODIES, before)],
                            sd={k: v.cpu().double() for k, v in m.state_dict().items()})
        del m, state, step
    if fruns["kernels"]["launched"] != [13] * 8 or any(fruns["plain"]["launched"]) or any(
            fruns["unfused"]["launched"]):
        fail(f"fused_block launches in phase 5b: {[r['launched'] for r in fruns.values()]}")

    def step_gap(a, b):
        """loss, all parameter updates together (relative L2), the worst
        tensor's update, running statistics (max |a - b|) of two steps."""
        ra, rb = fruns[a], fruns[b]
        num = den = 0.0
        upd, stats = {}, 0.0
        for k, v0 in fold.items():
            if "running" in k:
                stats = max(stats, float((ra["sd"][k] - rb["sd"][k]).abs().max()))
                continue
            ua, ub = ra["sd"][k] - v0, rb["sd"][k] - v0
            num += float((ua - ub).norm()) ** 2
            den += float(ub.norm()) ** 2
            if float(ub.norm()) > 0:
                upd[k] = rel(ua, ub)
        worst = max(upd, key=upd.get)
        got = {"loss": abs(ra["loss"] / rb["loss"] - 1), "overall": (num / den) ** 0.5,
               "tensor": upd[worst], "stats": stats}
        print(f"{a} against {b}: " + ", ".join(f"{k} {v:.3g}" for k, v in got.items())
              + f"; median tensor {sorted(upd.values())[len(upd) // 2]:.3g} (worst {worst}); losses {ra['loss']:.7f} / {rb['loss']:.7f}; steps "
              f"{ra['t']:.2f} / {rb['t']:.2f} s")
        return got

    # Limits, with the H100 readings beside them. Kernels against plain: loss
    # 7.2e-4, running statistics 9.5e-4, all updates 0.26, the worst tensor
    # 0.33; against unfused: 2.4e-4, 1.4e-3, 0.38, 0.50. The loss and the
    # statistics are held tightly. The updates are not: the step amplifies
    # bf16-level differences (the same step in f32 on the card moves 5.9e-4
    # from f64 for rounding noise 1e-7, phase 5), so two sum orders of the
    # same bf16 arithmetic already differ by a quarter in every tensor's
    # update; their limits only catch a wrong or missing gradient (100% and
    # more). Each body's outputs are held tightly in phase 2.
    f_limits = {"kernels-plain": {"loss": 5e-3, "overall": 0.8, "tensor": 1.0, "stats": 5e-3},
                "kernels-unfused": {"loss": 2e-3, "overall": 1.0, "tensor": 1.5,
                                    "stats": 5e-3}}
    print(f"limits: {f_limits}")
    for (a, b), lim in zip((("kernels", "plain"), ("kernels", "unfused")), f_limits.values()):
        got = step_gap(a, b)
        if not math.isfinite(fruns[a]["loss"]) or any(got[k] > v for k, v in lim.items()):
            fail(f"the fused f32 step on its {a} disagrees with the {b} step")
    torch.backends.cudnn.allow_tf32 = True
    del fruns, fnet, fold, fviews

    # ---- 6. learning ------------------------------------------------------------
    phase("6 learning: train steps on one fixed full-width batch, constant lr")
    from rxtpu_torch.models.resnet import init_weights
    from rxtpu_torch.train.optim import make_schedule

    lgen = torch.Generator(device=dev).manual_seed(4)
    # each sample its own brightness, so the samples are told apart
    base = (torch.arange(B, device=dev) * 12 + 20).view(B, 1, 1, 1, 1)
    fixed = {"images": (base + torch.randint(0, 40, (B, G, 6, SRC, SRC), device=dev,
                                             generator=lgen)).to(torch.uint8),
             "labels": torch.arange(B, device=dev) * 67 % 1108,
             "mean": torch.full((B, 6), 0.5, device=dev),
             "std": torch.full((B, 6), 0.2, device=dev)}
    train_model = init_weights(TwoSitesNN("resnet50", nb_classes=1108),
                               torch.Generator().manual_seed(0)).to(dev)
    state = TrainState.create(train_model, make_schedule(0.0005 * B, 1, 1, False),
                              weight_decay=3e-5)
    step = make_train_step(train_model, CROP, augment="shear", compute_dtype=torch.bfloat16)
    n_learn = 12
    curve = [float(step(state, fixed, 0, True)["loss"]) for _ in range(n_learn)]
    print(f"losses over {n_learn} steps: {[round(v, 4) for v in curve]}")
    margin = 2.0  # the first run on an H100 fell by 7.7 (7.76 -> 0.10)
    if not all(math.isfinite(v) for v in curve) or curve[-1] > curve[0] - margin:
        fail(f"the loss did not fall by {margin} ({curve[0]:.4f} -> {curve[-1]:.4f})")
    # the same from the same weights with the fused bottleneck
    fused_model = init_weights(TwoSitesNN("resnet50", nb_classes=1108, fuse_blocks=True),
                               torch.Generator().manual_seed(0)).to(dev)
    fstate = TrainState.create(fused_model, make_schedule(0.0005 * B, 1, 1, False),
                               weight_decay=3e-5)
    fstep = make_train_step(fused_model, CROP, augment="shear", compute_dtype=torch.bfloat16)
    fcurve = [float(fstep(fstate, fixed, 0, True)["loss"]) for _ in range(n_learn)]
    print(f"fused (--fuse-blocks on) losses over {n_learn} steps: "
          f"{[round(v, 4) for v in fcurve]}")
    if not all(math.isfinite(v) for v in fcurve) or fcurve[-1] > fcurve[0] - margin:
        fail(f"with the fused blocks the loss did not fall by {margin} ({fcurve[0]:.4f} -> "
             f"{fcurve[-1]:.4f})")

    # ---- 7. timings -------------------------------------------------------------
    phase("7 timings")
    import torch.nn.functional as F

    shear_times = shear_main_timings(dev, images, draws, sc, bi)
    ti = timing_inputs  # phase 2's random per-column shifts: K3's direct-read path
    rand_ms = cuda_ms(lambda: ps.shear_pass_rows(ti["s1"], ti["t2"], CROP, *ti["pads2"]), 20)
    print(f"shear_pass_rows on random per-column shifts (rows read directly): {rand_ms:.4f} ms")

    aug_ms = cuda_ms(lambda: apply_affine_shear(images, img_mean, img_std, *draws,
                                                crop_size=CROP), 20)
    # the library yardstick: one bilinear grid_sample of the same views with
    # the same rotations and crops (reflection borders; not bit-equal)
    angle, _, _, crop_yx = (t.to(dev) for t in draws)
    cos, sin = torch.cos(angle), torch.sin(angle)
    theta = torch.zeros(B * G, 2, 3, device=dev)
    theta[:, 0, 0], theta[:, 0, 1], theta[:, 1, 0], theta[:, 1, 1] = cos, -sin, sin, cos
    theta[:, :, :2] *= CROP / SRC
    theta[:, 0, 2] = (crop_yx[:, 1].float() + (CROP - 1) / 2) / ((SRC - 1) / 2) - 1
    theta[:, 1, 2] = (crop_yx[:, 0].float() + (CROP - 1) / 2) / ((SRC - 1) / 2) - 1
    grid = F.affine_grid(theta, (B * G, 6, CROP, CROP), align_corners=True)
    src_f = images.reshape(B * G, 6, SRC, SRC).float()
    grid_ms = cuda_ms(lambda: F.grid_sample(src_f, grid, mode="bilinear",
                                            padding_mode="reflection", align_corners=True), 20)
    print(f"whole shear augment [{B},{G},6,{SRC}^2] -> {CROP}^2 bf16: {aug_ms:.4f} ms "
          f"(K2+K3+K4 bound {sum(v[2] for v in shear_times.values()):.4f} ms); "
          f"F.grid_sample warp of the same views (f32): {grid_ms:.4f} ms")
    del src_f, grid

    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step(state, fixed, 0, True)
    torch.cuda.synchronize()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        step(state, fixed, 0, True)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / iters
    step_ev = cuda_ms(lambda: step(state, fixed, 0, True), iters, warmup=0)
    step_peak = torch.cuda.max_memory_allocated()
    print(f"train step bf16 B={B} G={G} 6x{SRC}^2 -> {CROP}^2 ResNet-50: {step_ms:.3f} ms/step "
          f"host clock, {step_ev:.3f} ms/step CUDA events, {B * G * 1e3 / step_ms:.1f} views/s, "
          f"peak memory {step_peak / 2**30:.3f} GiB")

    kernels, device_us = device_profile(lambda: step(state, fixed, 0, True), 3,
                                        "train steps", step_ev)
    shear_us = sum(e.self_device_time_total for e in kernels if "shear_" in e.key)
    print(f"augment share of the train step: K2-K4 {100 * shear_us / device_us:.1f}% of device "
          f"time; the whole augment by events {aug_ms:.3f} ms = "
          f"{100 * aug_ms / step_ev:.1f}% of the step")

    # the same step with --fuse-blocks on (phase 6's fused model, same batch)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        fstep(fstate, fixed, 0, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fstep(fstate, fixed, 0, True)
    torch.cuda.synchronize()
    fstep_ms = (time.perf_counter() - t0) * 1e3 / iters
    fstep_ev = cuda_ms(lambda: fstep(fstate, fixed, 0, True), iters, warmup=0)
    fstep_peak = torch.cuda.max_memory_allocated()
    print(f"fused train step (--fuse-blocks on) bf16 B={B} G={G}: {fstep_ms:.3f} ms/step host "
          f"clock, {fstep_ev:.3f} ms/step CUDA events, {B * G * 1e3 / fstep_ms:.1f} views/s, "
          f"peak memory {fstep_peak / 2**30:.3f} GiB; unfused {step_ev:.3f} ms, "
          f"{step_peak / 2**30:.3f} GiB")
    fkernels, fdevice_us = device_profile(lambda: fstep(fstate, fixed, 0, True), 3,
                                          "fused train steps", fstep_ev)
    fb_us = sum(e.self_device_time_total for e in fkernels if any(
        k in e.key for k in ("gemm_kernel", "wgrad_kernel", "reduce_kernel",
                             "bn_backward_kernel")))
    print(f"K6/K7 kernels' share of the fused step's device time: "
          f"{100 * fb_us / fdevice_us:.1f}% ({fb_us / 1e3 / 3:.3f} ms/step)")
    del state, train_model, fstate, fused_model, fixed, ti, timing_inputs

    # K6/K7: each body at the 13 blocks' shapes of a train step (5 distinct),
    # next to its bound, its plain version and torch.matmul of its largest
    # product; and the block fused against the unfused composition (cuDNN
    # bf16 convs + the port's BN under autocast), forward and backward.
    # Sums per train step (each shape times its blocks per step).
    from rxtpu_torch.models.fused import fused_bottleneck
    from rxtpu_torch.models.resnet import BottleneckBlock

    fb_times = {name: [0.0] * 6 for name in FB_NAMES}  # ms, plain, bound, bytes, ops, matmul
    blk_times = [0.0] * 4  # unfused fwd, unfused fwd+bwd, fused fwd, fused fwd+bwd
    for label, plane, c, f, proj, mult in FB_SHAPES:
        ops = fb_operands(B * G, plane, c, f, proj, 8, dev)
        r = B * G * plane * plane
        for name in FB_NAMES:
            kern, plain = fb_bodies[name], getattr(fb, f"{name}_reference")
            ms = cuda_ms(lambda: kern(*ops[name]), 10)
            plain_ms = cuda_ms(lambda: plain(*ops[name]), 3, warmup=1)
            moved, n_ops = fb_work(name, r, c, f, proj)
            m_, k_, n_ = fb_largest_gemm(name, r, c, f, proj)
            a_ = torch.randn(m_, k_, device=dev).to(torch.bfloat16)
            b_ = torch.randn(k_, n_, device=dev).to(torch.bfloat16)
            mm_ms = cuda_ms(lambda: torch.matmul(a_, b_), 10)
            t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, n_ops / BF16_FLOPS * 1e3
            bnd = max(t_bytes, t_ops)
            print(f"{name} {label:11s} R={r} C={c} F={f}: {ms:.4f} ms (bound {bnd:.4f} ms by "
                  f"{'bytes' if t_bytes >= t_ops else 'operations'}: {moved / 1e6:.1f} MB, "
                  f"{n_ops / 1e9:.2f} GFLOP; {100 * bnd / ms:.1f}% of it), plain "
                  f"{plain_ms:.4f} ms, torch.matmul [{m_},{k_}]x[{k_},{n_}] {mm_ms:.4f} ms")
            for i, v in enumerate((ms, plain_ms, bnd, t_bytes, t_ops, mm_ms)):
                fb_times[name][i] += mult * v
            del a_, b_
        del ops
        blk = BottleneckBlock(c, f).to(dev).train()
        gen8 = torch.Generator(device=dev).manual_seed(9)
        xin = torch.randn(B * G, c, plane, plane, device=dev, generator=gen8).relu().to(
            torch.bfloat16)
        dyo = torch.randn(B * G, 4 * f, plane, plane, device=dev, generator=gen8).to(
            torch.bfloat16)
        xin_flat = xin.permute(0, 2, 3, 1).reshape(B * G, plane * plane, c).contiguous()
        dyo_flat = dyo.permute(0, 2, 3, 1).reshape(B * G, plane * plane, 4 * f).contiguous()

        def unfused_block(backward):
            x_ = xin.detach().requires_grad_(backward)
            with torch.autocast("cuda", dtype=torch.bfloat16):
                y_ = blk(x_)
            if backward:
                y_.backward(dyo)

        def fused_block(backward):
            x_ = xin_flat.detach().requires_grad_(backward)
            y_ = fused_bottleneck(blk, x_, plane, plane)
            if backward:
                y_.backward(dyo_flat)

        times = [cuda_ms(lambda: fn(bw), 5) for fn in (unfused_block, fused_block)
                 for bw in (False, True)]
        print(f"block {label:11s}: unfused (cuDNN + port BN) forward {times[0]:.4f} ms, "
              f"forward+backward {times[1]:.4f} ms; fused K6 {times[2]:.4f} ms, K6+K7 "
              f"{times[3]:.4f} ms")
        for i, v in enumerate(times):
            blk_times[i] += mult * v
        del blk, xin, dyo, xin_flat, dyo_flat
    k6 = sum(fb_times[n][0] for n in FB_NAMES[:4])
    k7 = sum(fb_times[n][0] for n in FB_NAMES[4:])
    print(f"per train step over the 13 fused blocks: K6 bodies {k6:.3f} ms, K7 bodies "
          f"{k7:.3f} ms (bounds {sum(fb_times[n][2] for n in FB_NAMES[:4]):.3f} / "
          f"{sum(fb_times[n][2] for n in FB_NAMES[4:]):.3f} ms); blocks fused forward "
          f"{blk_times[2]:.3f} ms, forward+backward {blk_times[3]:.3f} ms; unfused forward "
          f"{blk_times[0]:.3f} ms, forward+backward {blk_times[1]:.3f} ms")
    fb_launch_breakdown(dev)
    for name in FB_NAMES:
        ms, plain_ms, bnd, t_bytes, t_ops, mm_ms = fb_times[name]
        print(f"{name} per step: {ms:.4f} ms, bound {bnd:.4f} ms ({100 * bnd / ms:.1f}%; bytes "
              f"{t_bytes:.4f} ms, operations {t_ops:.4f} ms), plain {plain_ms:.4f} ms, "
              f"torch.matmul of its largest product {mm_ms:.4f} ms")

    planes = torch.randint(0, 256, (n, h, h), dtype=torch.uint8, device=dev, generator=gen)
    k1 = {}
    for crop in (512, 364):
        ms = cuda_ms(lambda: crop_normalize(planes, scale, bias, crop), 50)
        plain_ms = cuda_ms(lambda: crop_normalize_reference(planes, scale, bias, crop), 20)
        bnd = k1_bound_ms(n, crop, 2)
        k1[crop] = (ms, plain_ms, bnd)
        print(f"K1 bf16 {n}x{h}^2 -> {crop}^2: {ms:.4f} ms (bound {bnd:.4f} ms, "
              f"{100 * bnd / ms:.1f}% of it), plain {plain_ms:.4f} ms")

    from rxtpu_torch.infer.predict import Predictor

    torch.cuda.reset_peak_memory_stats()
    pstep = Predictor(model.to(dev), None, "none", "probs", dtype=torch.bfloat16)
    batch = {
        "images": torch.randint(0, 256, (16, 6, 6, h, h), dtype=torch.uint8, device=dev),
        "mean": torch.full((16, 6), 0.5, device=dev),
        "std": torch.full((16, 6), 0.2, device=dev),
    }
    for _ in range(3):
        probs = pstep(batch)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(probs).all()) or tuple(probs.shape) != (16, 1108):
        fail(f"predict step gave {tuple(probs.shape)} with non-finite values")
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        pstep(batch)
    torch.cuda.synchronize()
    ms_batch = (time.perf_counter() - t0) * 1e3 / iters
    ev_ms = cuda_ms(lambda: pstep(batch), iters, warmup=0)
    peak = torch.cuda.max_memory_allocated()
    print(f"predict bf16 B=16 G=6 6x512^2: {ms_batch:.3f} ms/batch host clock, "
          f"{ev_ms:.3f} ms/batch CUDA events, {16 * 6 * 1e3 / ms_batch:.1f} views/s, "
          f"peak memory {peak / 2**30:.3f} GiB")
    device_profile(lambda: pstep(batch), 3, "predict steps", ev_ms)
    del pstep

    k5_times = k5_timings(dev, stem)

    # the eval and predict steps, fused and unfused, on the trained checkpoint
    for name, steps, batch_, views in (("eval", evals, val_batch, B * G),
                                       ("predict", preds, test_batch, B * 6)):
        for f in (False, True):
            for _ in range(3):
                steps[f](batch_)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            iters = 20
            t0 = time.perf_counter()
            for _ in range(iters):
                steps[f](batch_)
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3 / iters
            ev = cuda_ms(lambda: steps[f](batch_), iters, warmup=0)
            peak = torch.cuda.max_memory_allocated()
            print(f"{name} step {'fused K5 ' if f else 'unfused  '} bf16 B={B} "
                  f"{views // B} views/well: {host:.3f} ms host clock, {ev:.3f} ms CUDA events, "
                  f"{views * 1e3 / host:.1f} views/s, peak memory {peak / 2**30:.3f} GiB "
                  f"({(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB resident)")
    device_profile(lambda: preds[True](test_batch), 3, "fused predict steps", ev)
    k8_times, _ = int8_timings(dev, *int8_steps[:3], test_batch, card)
    dn_k8_times = densenet_timings(dev, dn_steps, test_batch, card)
    jpeg_timings(dev, cli, jpeg_run, card)
    png_timings(dev, cli, png_run, card, codecs)
    greedy_jax_timings(dev, card)
    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    print(card)

    shutil.rmtree(WORK, ignore_errors=True)
    ms, plain_ms, bnd = k1[512]
    entries = [{
        "name": "crop_norm", "route": "cuda", "source": "rxtpu_torch/csrc/crop_norm.cu",
        "replaces": "rxtpu/ops/pallas_norm.py:26", "launches": launches["crop_norm"],
        "max_abs_err": k1_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
        "bound_by": "bytes", "library_ms": None,
    }]
    replaces = {"shear_pass": "rxtpu/ops/shear.py:47", "shear_pass_rows": "rxtpu/ops/shear.py:154",
                "shear_pass_finish": "rxtpu/ops/shear.py:229"}
    for name in shear_names:
        ms, plain_ms, bnd, _ = shear_times[name]
        entries.append({
            "name": name, "route": "cuda", "source": "rxtpu_torch/csrc/shear.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": shear_err[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": "bytes", "library_ms": None,
        })
    ms, plain_ms, bnd, _, lib_ms = k5_times["test"]
    entries.append({
        "name": "fused_stem", "route": "cuda", "source": "rxtpu_torch/csrc/fused_stem.cu",
        "replaces": "rxtpu/ops/fused_stem.py:65", "launches": k5_launches,
        "max_abs_err": k5_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
        "bound_by": "operations", "library_ms": lib_ms,
    })
    for name in FB_NAMES:
        ms, plain_ms, bnd, t_bytes, t_ops, mm_ms = fb_times[name]
        entries.append({
            "name": f"fused_block_{name}", "route": "cuda",
            "source": "rxtpu_torch/csrc/fused_block.cu",
            "replaces": f"rxtpu/ops/fused_block.py:{FB_LINES[name]}",
            "launches": fb_launches[name], "max_abs_err": fb_err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": mm_ms,
        })
    ms, plain_ms, bnd, t_bytes, t_ops, lib_ms, _ = k8_times
    entries.append({
        "name": "int8_conv", "route": "cuda", "source": "rxtpu_torch/csrc/int8_conv.cu",
        "replaces": K8_REPLACES, "launches": k8_launches, "max_abs_err": k8_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bnd,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": lib_ms,
    })
    ms, plain_ms, bnd, t_bytes, t_ops, lib_ms, _ = dn_k8_times
    entries.append({
        "name": "int8_conv_densenet121", "route": "cuda",
        "source": "rxtpu_torch/csrc/int8_conv.cu", "replaces": DN_K8_REPLACES,
        "launches": dn_k8_launches, "max_abs_err": dn_k8_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bnd, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
    })
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
