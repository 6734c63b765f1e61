#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rxtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending the run with a non-zero exit when it fails:

1. the card (nvidia-smi name and power limit) and the kernel build from
   ``rxtpu_torch/csrc`` (one nvcc per source, all at once);
2. every kernel against its plain PyTorch version on the card, bit for bit:
   K1 (crop_norm) in bf16, int8 (with exact .5 ties) and f32 at the test
   shape and the 364 crop; K2-K4 (the shear passes) at the train shapes
   (288 planes of 512^2, crop 364 and an odd 363, shifts past both clamps,
   uint8 and f32 input, every reversal pair, f32 and bf16 out); then the
   composed shear augment of one [16, 3, 6, 512, 512] batch against the
   composed plain path;
3. training end to end through ``rxtpu_torch.cli.main`` at full width
   (ResNet-50 + MLP head, 1108 classes, G=3 views of 6x512^2, batch 16, bf16,
   crop 364) on a synthetic fixture: 2 epochs of 4 steps with validation,
   then the test phase; the kernel launch counts of this run are read, the
   logged losses and the checkpoints checked, and ``--resume`` on the
   finished run must train nothing and still write the submission;
4. the test phase end to end (plate-leak assignment) on the checkpoint
   phase 3 trained;
5. the card against the CPU: f32 predict logits on one full-width batch, and
   one f32 train step (loss, updated parameters and BN statistics, momentum
   buffers) against the same step in f64, with the CPU's f32 step beside it;
6. learning: the loss falls over train steps on one fixed full-width batch;
7. timings by CUDA events after warm-up: K2-K4 next to their bounds and
   plain versions, the whole augment next to one ``F.grid_sample`` warp,
   the train step (ms, views/s, peak memory, device time by kernel with the
   augment's share), and K1 and the predict step as before.

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
import shutil
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
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


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from rxtpu_torch.ops import _build
        from rxtpu_torch.ops import shear as ps
        from rxtpu_torch.ops.crop_norm import (
            crop_normalize, crop_normalize_reference, eval_batch_normalize,
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
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

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
    print(f"train fixture in {time.perf_counter() - t0:.2f} s "
          f"({os.path.getsize(os.path.join(fx['pack_dir'], 'train.rxpack')) / 1e6:.1f} MB "
          f"train pack)")
    argv = ["--experiment_id", "smoke", "--pack", fx["pack_dir"], "--data-dir",
            fx["data_dir"], "--stats", fx["stats"], "--out-dir", train_dir,
            "--split-by-experiment", "--epochs", "2", "--no-plate-leak", "--device", "cuda"]
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

    # ---- 4. the test phase on the trained checkpoint ------------------------
    phase("4 test phase end to end at full width on the trained checkpoint")
    from rxtpu_torch.data.synthetic import make_test_fixture, randomize_
    from rxtpu_torch.models.twosites import TwoSitesNN

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
    with open(os.path.join(test_dir, "submission_smoke.csv"), newline="") as f:
        sub = list(csv.DictReader(f))
    if [r["id_code"] for r in sub] != [r["id_code"] for r in fx["test_rows"]]:
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
    torch.backends.cudnn.allow_tf32 = True
    del runs, ref, net

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

    # ---- 7. timings -------------------------------------------------------------
    phase("7 timings")
    import torch.nn.functional as F

    # the kernels on the main path's own shifts: the draws' residual angles
    # and crops of phase 2's batch, through the fused pipeline's geometry
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
        plain_ms = cuda_ms(plain_fn, 10)
        moved, ops = bounds[name]
        bnd = bound_ms(moved, ops)
        shear_times[name] = (ms, plain_ms, bnd)
        print(f"{name:18s} {ms:.4f} ms (bound {bnd:.4f} ms: {moved / 1e6:.1f} MB, "
              f"{100 * bnd / ms:.1f}% of it), plain {plain_ms:.4f} ms")
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

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_profile(fn, steps, label, ref_ms):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        # device-side events only: an aten op's own device total repeats its kernels'
        kernels = [e for e in prof.key_averages()
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
        return kernels, device_us

    kernels, device_us = device_profile(lambda: step(state, fixed, 0, True), 3,
                                        "train steps", step_ev)
    shear_us = sum(e.self_device_time_total for e in kernels if "shear_" in e.key)
    print(f"augment share of the train step: K2-K4 {100 * shear_us / device_us:.1f}% of device "
          f"time; the whole augment by events {aug_ms:.3f} ms = "
          f"{100 * aug_ms / step_ev:.1f}% of the step")
    del state, train_model, fixed, x8, ti, timing_inputs, kf, calls, s1m, s2m

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
        ms, plain_ms, bnd = shear_times[name]
        entries.append({
            "name": name, "route": "cuda", "source": "rxtpu_torch/csrc/shear.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": shear_err[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": "bytes", "library_ms": None,
        })
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
