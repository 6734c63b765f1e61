"""The port's K6/K7 fused bottleneck and the CLI's stats pass across ranks,
on the CPU with gloo.

- The fused block at world 2 with its BN sums all-reduced over the data
  ranks (forward and backward) against the port's fused block at world 1
  on the same views and against rxtpu's fused block on the whole batch,
  which is what rxtpu's GSPMD data mesh computes (its Pallas call has no
  partitioning rule, so it sees every row). K6/K7's plain bodies run here;
  ``chip_smoke.py`` phase 3e (b) runs the kernels at world 2 on the card.
- ``load_or_compute_stats`` at world 2 with the artifact missing: rank 0's
  pass outlasts the default group's timeout while rank 1 waits for it.

Ranks are subprocesses of ``tests/torch_dist_worker.py`` (no JAX), started
by ``tests/torch_dist_launch.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxtpu_torch.models.norm import BatchNorm

import torch_dist_worker as worker
from torch_dist_launch import launch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# World 2 against world 1: the sums are added in another order, so a value
# near a bf16 rounding boundary may round the other way (one bf16 ulp, 2^-8
# of it). Bounds: y max |diff| / max|y| one such ulp; the running
# statistics' max |diff| and dx's and each gradient's relative L2 some ten
# times this CPU's readings (see the test), far below what a rank's own sums
# give (without the backward's all-reduce, dx lies 0.14 off and the
# gradients 0.75; without the forward's too, y lies 0.13 off). Against
# rxtpu's block on the whole batch: the bounds that hold the port's fused
# block to rxtpu's in tests/test_torch_port_fused_block.py.
FUSED_Y, FUSED_STATS, FUSED_GRAD = 2.0**-8, 1e-6, 1e-5
RX_Y, RX_STATS, RX_GRAD = 2.0**-6, 2e-3, 0.08


def _fused_inputs(proj: bool):
    """A bottleneck (16 -> 8 -> 32 with the projection, 32 -> 8 -> 32
    without), its parameters and running statistics away from their init, 4
    views of 8x8 in bf16 and the output weights."""
    from rxtpu_torch.models.resnet import BottleneckBlock

    c, f, v, h, w = (16 if proj else 32), 8, 4, 8, 8
    rng = np.random.default_rng(11)
    block = BottleneckBlock(c, f)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.4, tuple(p.shape)).astype(np.float32)))
        for mod in block.modules():
            if isinstance(mod, BatchNorm):
                n = mod.weight.shape
                mod.weight.copy_(torch.from_numpy(rng.normal(1, 0.4, n).astype(np.float32)))
                mod.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)))
                mod.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))
    x = torch.from_numpy(rng.normal(0, 1, (v, h * w, c)).astype(np.float32)).to(torch.bfloat16)
    wout = torch.from_numpy(rng.normal(0, 1, (v, h * w, 4 * f)).astype(np.float32))
    return {"x": x, "wout": wout, "height": h, "width": w, "state": block.state_dict()}


def _rx_fused(inp):
    """rxtpu's fused block (its Pallas kernels in interpret mode) on the whole
    batch, as its GSPMD data mesh runs it: (y, batch statistics by BN, dx,
    gradients in the kernels' layouts), pad rows stripped."""
    from rxtpu.ops import fused_block as rx_fb
    from rxtpu_torch.ops.fused_block import conv1x1_to_mat, conv3x3_to_taps

    sd, x, h, w = inp["state"], inp["x"], inp["height"], inp["width"]
    params = {"w1": conv1x1_to_mat(sd["Conv_0.weight"]),
              "w2": conv3x3_to_taps(sd["Conv_1.weight"]),
              "w3": conv1x1_to_mat(sd["Conv_2.weight"])}
    for i in range(3):
        params[f"g{i + 1}"] = sd[f"BatchNorm_{i}.weight"]
        params[f"b{i + 1}"] = sd[f"BatchNorm_{i}.bias"]
    proj = "conv_proj.weight" in sd
    if proj:
        params.update(wp=conv1x1_to_mat(sd["conv_proj.weight"]), gp=sd["norm_proj.weight"],
                      bp=sd["norm_proj.bias"])
    f, c = params["w1"].shape[1], x.shape[2]
    cfg = rx_fb.plan_block(h, w, f, c, proj=proj, interpret=True)
    xp = rx_fb.pad_pixels(jnp.asarray(x.float().numpy(), jnp.bfloat16), cfg)
    wp_ = rx_fb.pad_pixels(jnp.asarray(inp["wout"].numpy()), cfg)
    jp = {k: jnp.asarray(t.numpy()) for k, t in params.items()}

    def loss(prm, xx):
        yy, st = rx_fb.bottleneck_fused(cfg, xx, prm)
        return jnp.sum(yy.astype(jnp.float32) * wp_), (yy, st)

    (_, (ry, rstats)), (rg, rgx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(jp, xp)
    p = h * w
    return (np.asarray(ry.astype(jnp.float32))[:, :p], rstats,
            np.asarray(rgx.astype(jnp.float32))[:, :p], {k: np.asarray(g) for k, g in rg.items()})


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("proj", [False, True], ids=["identity", "proj"])
def test_fused_block_world2_equals_world1_and_rxtpu(proj, tmp_path):
    """The fused bottleneck at world 2 (2 views a rank), its BN sums
    all-reduced forward and backward, against the port's fused block at
    world 1 on all 4 views (y, dx, running statistics with the global n,
    parameter gradients) and against rxtpu's fused block on the whole batch
    (as rxtpu's GSPMD mesh computes it: its Pallas call sees every row).
    Readings on this CPU, both blocks: y and dx equal to world 1's, the
    statistics within 1.2e-7 and the gradients within 2.0e-7 (relative L2);
    y and dx equal to rxtpu's."""
    from rxtpu_torch.ops.fused_block import conv1x1_to_mat, conv3x3_to_taps

    inp = _fused_inputs(proj)
    want = worker.fused_case(inp, None)
    got = launch("fused", 2, inp, tmp_path)
    y = torch.cat([g["y"] for g in got]).numpy()
    dx = torch.cat([g["dx"] for g in got]).numpy()
    top = float(np.abs(want["y"].numpy()).max())
    assert float(np.abs(y - want["y"].numpy()).max()) <= FUSED_Y * top
    assert _rel_l2(dx, want["dx"]) <= FUSED_GRAD
    for g in got:
        for k, v in want["stats"].items():
            assert float((g["stats"][k] - v).abs().max()) <= FUSED_STATS, k
        for k, v in want["grads"].items():
            assert _rel_l2(g["grads"][k], v) <= FUSED_GRAD, k

    ry, rstats, rdx, rgrads = _rx_fused(inp)
    assert float(np.abs(y - ry).max()) <= RX_Y * float(np.abs(ry).max())
    assert _rel_l2(dx, rdx) <= RX_GRAD
    n = inp["x"].shape[0] * inp["x"].shape[1]
    state = inp["state"]
    bns = {"bn1": "BatchNorm_0", "bn2": "BatchNorm_1", "bn3": "BatchNorm_2", "bnp": "norm_proj"}
    assert sorted(rstats) == sorted(b for b, key in bns.items()
                                    if f"{key}.running_mean" in state)
    for bn, (mean, var) in rstats.items():
        key = bns[bn]
        for g in got:  # world 2's running statistics: rxtpu's batch statistics over all n rows
            np.testing.assert_allclose(
                g["stats"][f"{key}.running_mean"].numpy(),
                0.9 * state[f"{key}.running_mean"].numpy() + 0.1 * np.asarray(mean).reshape(-1),
                atol=RX_STATS, rtol=0, err_msg=key)
            np.testing.assert_allclose(
                g["stats"][f"{key}.running_var"].numpy(),
                0.9 * state[f"{key}.running_var"].numpy()
                + 0.1 * np.asarray(var).reshape(-1) * n / (n - 1),
                atol=RX_STATS, rtol=0, err_msg=key)
    layouts = {"Conv_0.weight": ("w1", conv1x1_to_mat), "Conv_1.weight": ("w2", conv3x3_to_taps),
               "Conv_2.weight": ("w3", conv1x1_to_mat), "conv_proj.weight": ("wp", conv1x1_to_mat)}
    for i, key in enumerate(("BatchNorm_0", "BatchNorm_1", "BatchNorm_2")):
        layouts[f"{key}.weight"] = (f"g{i + 1}", lambda t: t)
        layouts[f"{key}.bias"] = (f"b{i + 1}", lambda t: t)
    layouts.update({"norm_proj.weight": ("gp", lambda t: t), "norm_proj.bias": ("bp", lambda t: t)})
    assert sorted(layouts[k][0] for k in got[0]["grads"]) == sorted(rgrads)
    for k, g in got[0]["grads"].items():
        name, to_layout = layouts[k]
        assert _rel_l2(to_layout(g).numpy(), rgrads[name]) <= RX_GRAD, k


def test_stats_pass_on_rank0_outlasts_the_group_timeout(tmp_path):
    """The CLI's stats pass at world 2 with the artifact missing: rank 0 runs
    it alone (a stand-in that takes 12 s) while rank 1 waits, though the
    default group's timeout is 5 s and would end a barrier on that group;
    both ranks get rank 0's statistics, only rank 0 ran a pass, and the
    default group still works after the wait."""
    stats = {"E1": {"mean": np.linspace(0.1, 0.6, 6), "std": np.linspace(0.2, 0.3, 6)},
             "E2": {"mean": np.linspace(0.3, 0.4, 6), "std": np.linspace(0.1, 0.5, 6)}}
    inp = {"timeout_s": 5, "pass_s": 12, "stats": stats, "path": str(tmp_path / "stats.json")}
    got = launch("stats", 2, inp, tmp_path)
    assert [g["passes"] for g in got] == [1, 0]
    for g in got:
        assert sorted(g["stats"]) == sorted(stats)
        for e, v in stats.items():
            for k in ("mean", "std"):
                np.testing.assert_array_equal(np.asarray(g["stats"][e][k]), v[k])
