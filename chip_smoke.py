#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rxtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending the run with a non-zero exit when it fails:

1. the card (nvidia-smi name and power limit) and the kernel build from
   ``rxtpu_torch/csrc`` (one nvcc per source, all at once);
2. every kernel against its plain PyTorch version on the card, bit for bit:
   K1 (crop_norm) in bf16, int8 (with exact .5 ties) and f32, at the test
   shape (576 planes of 512^2, no crop) and the 364 val crop;
3. the test phase end to end through ``rxtpu_torch.cli.main`` at full width
   (ResNet-50 + MLP head, 1108 classes, G=6 views of 6x512^2, batch 16, bf16)
   on a synthetic fixture and a seeded random checkpoint; the kernel launch
   counts of this run are read, and the submission is checked;
4. card f32 logits against CPU f32 logits on one full-width batch;
5. timings: K1 by CUDA events next to its bound and its plain version, the
   predict step's ms/batch and views/s with the batch already on the card,
   the peak device memory, and the step's device time by kernel
   (torch.profiler).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import csv
import json
import math
import os
import shutil
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")


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


def bitwise_diff(a, b):
    """(mismatching elements, max |a - b|) of two tensors of one dtype."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        fail(f"kernel output {a.dtype} {tuple(a.shape)} vs plain {b.dtype} {tuple(b.shape)}")
    int_view = {torch.bfloat16: torch.int16, torch.float32: torch.int32, torch.int8: torch.int8}
    mismatches = int((a.view(int_view[a.dtype]) != b.view(int_view[b.dtype])).sum())
    return mismatches, float((a.float() - b.float()).abs().max())


def k1_bound_ms(n, crop, out_bytes):
    """Least time for K1: the bytes it must move (the cropped uint8 pixels
    and the per-plane scale/bias read once, the output written once) over
    the memory rate, against two f32 operations per pixel."""
    moved = n * crop * crop * (1 + out_bytes) + 2 * 4 * n
    return max(moved / HBM_BYTES_PER_S, 2 * n * crop * crop / F32_FLOPS) * 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from rxtpu_torch.ops import _build
        from rxtpu_torch.ops.crop_norm import (
            crop_normalize, crop_normalize_reference, eval_batch_normalize,
        )
    except ImportError as e:
        print(f"chip_smoke: the rxtpu_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda")

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
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ---- 2. kernels against their plain versions -----------------------------
    phase("2 K1 crop_norm against its plain version (bit equality)")
    n, h = 16 * 6 * 6, 512
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

    # ---- 3. the slice end to end ----------------------------------------------
    phase("3 test phase end to end at full width (rxtpu_torch.cli)")
    from rxtpu_torch import cli
    from rxtpu_torch.data.synthetic import make_test_fixture, randomize_
    from rxtpu_torch.models.twosites import TwoSitesNN
    from rxtpu_torch.train.checkpoint import save_checkpoint

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t0 = time.perf_counter()
    fx = make_test_fixture(WORK, nb_classes=1108, n_test_wells=32, img_size=512, seed=0)
    model = randomize_(TwoSitesNN("resnet50", nb_classes=1108), seed=0)
    ckpt = os.path.join(WORK, "models", "best_model_smoke.ckpt")
    save_checkpoint(ckpt, model.state_dict())
    print(f"fixture + checkpoint in {time.perf_counter() - t0:.2f} s "
          f"({os.path.getsize(fx['pack']) / 1e6:.1f} MB pack)")
    argv = ["--experiment_id", "smoke", "--pack", fx["pack_dir"], "--data-dir",
            fx["data_dir"], "--stats", fx["stats"], "--out-dir", WORK, "--device", "cuda"]
    cwd = os.getcwd()
    os.chdir(WORK)
    crop_normalize.launches = 0
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    wall = time.perf_counter() - t0
    launches = {"crop_norm": crop_normalize.launches}
    n_batches = math.ceil(len(fx["test_rows"]) / 16)
    print(f"cli rc {rc} in {wall:.2f} s; launches {launches}; test batches {n_batches}")
    if rc != 0:
        fail(f"cli exited {rc}")
    if launches["crop_norm"] != n_batches:
        fail(f"crop_norm launched {launches['crop_norm']} times for {n_batches} batches")
    with open(os.path.join(WORK, "submission_smoke.csv"), newline="") as f:
        sub = list(csv.DictReader(f))
    ids = [r["id_code"] for r in fx["test_rows"]]
    if [r["id_code"] for r in sub] != ids:
        fail("submission rows do not match the test ids")
    sirnas = [int(r["sirna"]) for r in sub]
    if not all(0 <= s < 1108 for s in sirnas):
        fail("sirna out of [0, 1108)")
    by_plate = {}
    for row, s in zip(fx["test_rows"], sirnas):
        if fx["plate_groups"][s, 0] != row["plate"]:
            fail(f"{row['id_code']}: sirna {s} is not on plate {row['plate']}")
        by_plate.setdefault(row["plate"], []).append(s)
    for plate, ss in by_plate.items():
        if len(set(ss)) != len(ss):
            fail(f"plate {plate}: assignment is not one-to-one")
    print(f"submission: {len(sub)} rows, plates {sorted(by_plate)}, one-to-one per plate, "
          f"plate leak respected")

    # ---- 4. card f32 against CPU f32 ------------------------------------------
    phase("4 card f32 logits against CPU f32 logits (B=1, G=6, 512^2)")
    from rxtpu_torch.infer.fold import fold_for_inference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu_gen = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (1, 6, 6, h, h), dtype=torch.uint8, generator=cpu_gen)
    mean6 = torch.rand(1, 6, generator=cpu_gen) * 0.5 + 0.1
    std6 = torch.rand(1, 6, generator=cpu_gen) * 0.25 + 0.05
    net_cpu = fold_for_inference(model.eval())
    net_gpu = fold_for_inference(model.to(dev).eval())
    with torch.inference_mode():
        v_cpu = eval_batch_normalize(images, mean6, std6, None)
        v_gpu = eval_batch_normalize(images.to(dev), mean6.to(dev), std6.to(dev), None)
        bad, _ = bitwise_diff(v_gpu.cpu(), v_cpu)
        t0 = time.perf_counter()
        l_cpu = net_cpu(v_cpu)
        t_cpu = time.perf_counter() - t0
        l_gpu = net_gpu(v_gpu).cpu()
    scale_l = float(l_cpu.abs().max())
    diff = float((l_gpu - l_cpu).abs().max())
    print(f"views mismatches {bad}; max|logit| {scale_l:.6g}; max|card - cpu| {diff:.6g} "
          f"(bound {1e-3 * scale_l:.6g}); cpu forward {t_cpu:.2f} s")
    if bad or not math.isfinite(diff) or scale_l < 1e-6 or diff > 1e-3 * scale_l:
        fail("card f32 logits disagree with CPU f32 logits")
    torch.backends.cudnn.allow_tf32 = True
    del net_cpu, net_gpu

    # ---- 5. timings -------------------------------------------------------------
    phase("5 timings")
    from rxtpu_torch.infer.predict import Predictor

    k1 = {}
    for crop in (512, 364):
        ms = cuda_ms(lambda: crop_normalize(planes, scale, bias, crop), 50)
        plain = cuda_ms(lambda: crop_normalize_reference(planes, scale, bias, crop), 20)
        bound = k1_bound_ms(n, crop, 2)
        k1[crop] = (ms, plain, bound)
        print(f"K1 bf16 {n}x{h}^2 -> {crop}^2: {ms:.4f} ms (bound {bound:.4f} ms, "
              f"{100 * bound / ms:.1f}% of it), plain {plain:.4f} ms")

    torch.cuda.reset_peak_memory_stats()
    step = Predictor(model, None, "none", "probs", dtype=torch.bfloat16)
    batch = {
        "images": torch.randint(0, 256, (16, 6, 6, h, h), dtype=torch.uint8, device=dev),
        "mean": torch.full((16, 6), 0.5, device=dev),
        "std": torch.full((16, 6), 0.2, device=dev),
    }
    for _ in range(3):
        probs = step(batch)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(probs).all()) or tuple(probs.shape) != (16, 1108):
        fail(f"predict step gave {tuple(probs.shape)} with non-finite values")
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        step(batch)
    torch.cuda.synchronize()
    ms_batch = (time.perf_counter() - t0) * 1e3 / iters
    ev_ms = cuda_ms(lambda: step(batch), iters, warmup=0)
    peak = torch.cuda.max_memory_allocated()
    print(f"predict bf16 B=16 G=6 6x512^2: {ms_batch:.3f} ms/batch host clock, "
          f"{ev_ms:.3f} ms/batch CUDA events, {16 * 6 * 1e3 / ms_batch:.1f} views/s, "
          f"peak memory {peak / 2**30:.3f} GiB")

    # where the predict step's device time goes, by kernel
    from torch.profiler import ProfilerActivity, profile

    steps = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    # device-side events only: an aten op's own device total repeats its kernels'
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in kernels)
    if not kernels:
        fail("the profiler recorded no device time")
    print(f"profile of {steps} predict steps: {device_us / 1e3 / steps:.3f} ms device time "
          f"per step, {100 * device_us / 1e3 / steps / ev_ms:.1f}% of the step's "
          f"{ev_ms:.3f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {100 * e.self_device_time_total / device_us:5.1f}%  "
              f"{e.self_device_time_total / 1e3 / steps:8.3f} ms/step  "
              f"x{e.count // steps:<4d} {e.key[:110]}")
    print(card)

    shutil.rmtree(WORK, ignore_errors=True)
    ms, plain, bound = k1[512]
    print(json.dumps({"kernels": [{
        "name": "crop_norm", "route": "cuda", "source": "rxtpu_torch/csrc/crop_norm.cu",
        "replaces": "rxtpu/ops/pallas_norm.py:26", "launches": launches["crop_norm"],
        "max_abs_err": k1_err, "ms": ms, "plain_ms": plain, "bound_ms": bound,
        "bound_by": "bytes", "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
