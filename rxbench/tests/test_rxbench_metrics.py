"""The arithmetic of the metric readers, the trace reduction and the work
counts; the frozen bounds against ``chip_smoke.py``'s."""

import numpy as np
import pytest
import torch

import chip_smoke
from rxbench import spec
from rxbench.peaks import BF16_FLOPS
from rxbench.trace import _attribute, _union, breakdown
from rxbench.work import bounds
from rxbench.work.flops import backbone_macs, view_flops

read = spec.Cell.reader
CFG = spec.load().cell("resnet50-mlp.train").config


def test_published_macs():
    assert backbone_macs("resnet50", 3, 224) == pytest.approx(4.1e9, rel=0.02)
    assert backbone_macs("densenet121", 3, 224) == pytest.approx(2.87e9, rel=0.02)


def _train(**kw):
    rec = {"mode": "train", "views": 1920, "window_s": 5.0, "input_wait_s": 0.5,
           "setup_s": 12.5, "peak_bytes": 3 * 2 ** 30, "cfg": CFG,
           "traffic": {"crop": 364, "G": 3, "bs_per_device": 64, "src": 512,
                       "fuse_blocks": False},
           "trace": {"busy_s": 0.9, "window_s": 1.0, "kernels": {}, "idle": {}},
           "traced_steps": []}
    rec.update(kw)
    return rec


def test_end_to_end_readers():
    rec = _train()
    assert read("train_views_per_s")(rec) == 384.0
    assert read("predict_views_per_s")(rec) is None
    assert read("peak_mem_gib")(rec) == 3.0
    assert read("setup_s")(rec) == 12.5


def test_per_layer_readers():
    rec = _train()
    assert read("input_wait_pct.train")(rec) == pytest.approx(10.0)
    assert read("input_wait_pct.predict")(rec) is None
    assert read("device_idle_pct.train")(rec) == pytest.approx(10.0)
    assert read("device_idle_pct.train")(_train(trace=None)) is None
    mfu = read("train_mfu_pct")(rec)
    assert mfu == pytest.approx(100 * view_flops(CFG, 364, 3, True) * 1920 / 5.0 / BF16_FLOPS)
    assert 0 < mfu < 100
    # host-clock shares leave the traced stretch out, where the profiler costs time
    traced = _train(traced_s=2.0, traced_views=1536, traced_input_wait_s=0.2)
    assert read("train_mfu_pct")(traced) == pytest.approx(
        100 * view_flops(CFG, 364, 3, True) * 384 / 3.0 / BF16_FLOPS)
    assert read("input_wait_pct.train")(traced) == pytest.approx(10.0)
    all_traced = _train(traced_s=5.0, traced_views=1920, traced_input_wait_s=0.5)
    assert read("train_mfu_pct")(all_traced) is None
    assert read("input_wait_pct.train")(all_traced) is None
    assert read("augment_roofline")(rec) is None  # no traced steps: nothing to read
    assert read("fused_block_roofline")(rec) is None


def test_crop_norm_roofline():
    trace = {"busy_s": 1, "window_s": 1, "idle": {},
             "kernels": {"void crop_norm_kernel<bf16>(...)": [0.004, 2], "other": [1.0, 9]}}
    rec = {"mode": "predict", "trace": trace,
           "traffic": {"bs_per_device": 64, "G": 6, "src": 512}}
    want = 2 * bounds.k1_bound_ms(64 * 36, 512, 2) / 1e3 / 0.004
    assert read("crop_norm_roofline")(rec) == pytest.approx(100 * want)


def test_augment_roofline_reads_each_traced_step():
    traffic = {"bs_per_device": 2, "G": 3, "src": 64, "crop": 48}
    kernels = {"shear_x_kernel<u8>": [1e-3, 2], "shear_y_kernel": [1e-3, 2],
               "shear_finish_kernel": [1e-3, 2]}
    rec = {"mode": "train", "traffic": traffic, "seed": 5, "device": torch.device("cpu"),
           "traced_steps": [3, 4], "trace": {"kernels": kernels}}
    value = read("augment_roofline")(rec)
    assert 0 < value < 100
    rec["traced_steps"] = [3]  # launches that do not match the steps: nothing read
    assert read("augment_roofline")(rec) is None


def test_fused_block_roofline():
    trace = {"kernels": {"void pipe_gemm_kernel<1>(A)": [0.5, 10],
                         "reduce_kernel(float const*, float*, int, int, int)": [0.5, 3],
                         "void at::native::reduce_kernel<512>(...)": [9.0, 5]}}
    rec = _train(trace=trace, traced_steps=[7, 8],
                 traffic={"bs_per_device": 64, "G": 3, "fuse_blocks": True})
    want = 2 * bounds.fused_step_bound_ms(192) / 1e3 / 1.0
    assert read("fused_block_roofline")(rec) == pytest.approx(100 * want)


def test_union_and_attribution():
    iv = np.array([[0, 10], [5, 20], [30, 40]])
    assert _union(iv).tolist() == [[0, 20], [30, 40]]
    gaps = np.array([[20, 30], [40, 100]])
    spans = [(0, 25, "host_in_step"), (25, 60, "host_in_next"), (50, 55, "host_in_readback")]
    got = _attribute(gaps, spans)
    assert got["host_in_step"] == pytest.approx(5e-9)
    assert got["host_in_next"] == pytest.approx(20e-9)
    assert got["host_in_readback"] == pytest.approx(5e-9)
    assert got["host_in_other"] == pytest.approx(40e-9)
    b = breakdown({"kernels": {"a": [2.0, 1], "b": [3.0, 1]}, "idle": dict(got)})
    assert b["device_ops"][0] == ["b", 3.0] and len(b["idle_gaps"]) == 4


@pytest.mark.parametrize("n,crop,out_bytes", [(2304, 512, 2), (1152, 364, 2), (96, 512, 1)])
def test_k1_bound_frozen(n, crop, out_bytes):
    assert bounds.k1_bound_ms(n, crop, out_bytes) == chip_smoke.k1_bound_ms(n, crop, out_bytes)
    assert bounds.bound_ms(1e9, 1e9) == chip_smoke.bound_ms(1e9, 1e9)


def test_shear_bounds_frozen():
    g = torch.Generator().manual_seed(0)
    p, h, crop = 48, 512, 364
    kf = {"shear_pass": (torch.randint(0, 40, (p, h), generator=g),),
          "shear_pass_rows": (torch.randint(0, 300, (p, h), generator=g),),
          "shear_pass_finish": (torch.randint(0, 300, (p, crop), generator=g),)}
    pads = [(112, 8), (184, 56), (112, 96)]
    assert bounds.shear_bounds(kf, pads, p, h, h, crop) == chip_smoke.shear_bounds(
        kf, pads, p, h, h, crop)


@pytest.mark.parametrize("name", bounds.FUSED_BODIES)
@pytest.mark.parametrize("shape", bounds.FUSED_BLOCKS)
def test_fb_work_frozen(name, shape):
    side, c, f, proj, _ = shape
    r = 192 * side * side
    assert bounds.fb_work(name, r, c, f, proj) == chip_smoke.fb_work(name, r, c, f, proj)
    assert (bounds.HBM_BYTES_PER_S, bounds.BF16_FLOPS) == (chip_smoke.HBM_BYTES_PER_S,
                                                           chip_smoke.BF16_FLOPS)


def test_fused_blocks_are_chip_smokes():
    ours = [(s, c, f, p, n) for s, c, f, p, n in bounds.FUSED_BLOCKS]
    theirs = [(s, c, f, p, n) for _, s, c, f, p, n in chip_smoke.FB_SHAPES]
    assert ours == theirs


def test_grad1_rel_is_the_median_leafs_gap_without_the_decay():
    from rxbench import check

    ref = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([0.0, 2.0])}
    prog = {"a": torch.tensor([3.0, 4.5]), "b": torch.tensor([0.0, 2.3])}
    decay = {"a": torch.zeros(2), "b": torch.tensor([0.0, 1.0])}
    numbers = check.train_numbers({"losses": [1.0], "logits1": [], "g1": prog, "delta": prog},
                                  {"losses": [1.0], "logits1": [], "g1": ref, "delta": ref}, decay)
    # a: 0.5 / 5; b: 0.3 / 1, its decay term taken out of the reference's norm
    assert numbers["grad1_rel"] == pytest.approx((0.1 + 0.3) / 2)
    assert numbers["worst_leaves"]["grad1_rel"][0] == (pytest.approx(0.3), "b")


def test_logit_rel_centres_each_row():
    from rxbench.check import _logit_rel

    ref = [torch.tensor([[1.0, 2.0, 3.0], [0.0, 0.0, 3.0]])]
    prog = [torch.tensor([[1.0, 2.0, 3.5], [0.0, 0.0, 3.0]]) + 5.0]  # a shift is no gap
    # row 1: centred gap [-1/6, -1/6, 1/3] over centred [-1, 0, 1]; row 2 equal
    assert _logit_rel(prog, ref) == pytest.approx((np.sqrt(1 / 18) / np.sqrt(2 / 3)) / 2)
    assert _logit_rel([prog[0][:1]], ref) == float("inf")  # rows left out
