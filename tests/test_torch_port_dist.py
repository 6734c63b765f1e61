"""rxtpu_torch's multi-rank pieces (``rxtpu_torch/parallel``) on the CPU, with
gloo: the input slices, the cross-rank BatchNorm, the tensor-parallel head,
the train step at world 2 and at world 4 (data 2 x model 2) and the int8
calibration, each against the port at world 1 on the same global batch and,
where rxtpu has the piece, against rxtpu.

Ranks run as subprocesses of ``tests/torch_dist_worker.py``, which imports
no JAX; each has a wall-clock limit and a free port, and ``init_process_group``
a finite timeout, so a rank that dies or hangs fails the test with its
stderr instead of hanging the suite. Shapes are tiny (resnet18, 64^2 sources,
48^2 crops, one intra-op thread per rank).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxtpu.config import Config as RxConfig, ModelConfig as RxModelConfig
from rxtpu.config import TrainConfig as RxTrainConfig
from rxtpu.data.pack import PackStore as RxPackStore
from rxtpu.data.pipeline import ByteStore as RxByteStore, Pipeline as RxPipeline
from rxtpu.data.records import load_metadata as rx_load_metadata
from rxtpu.data.records import read_metadata_csvs as rx_read_metadata_csvs
from rxtpu.models.norm import TorchBatchNorm as FlaxBatchNorm
from rxtpu.parallel import make_mesh as rx_make_mesh, place_state as rx_place_state
from rxtpu.parallel import shard_batch as rx_shard_batch
from rxtpu.parallel import multihost as rx_multihost
from rxtpu.tools import main as rx_tools_main
from rxtpu.train.setup import build_model as rx_build_model
from rxtpu.train.setup import create_train_state as rx_create_train_state
from rxtpu.train.step import make_train_step as rx_make_train_step
from rxtpu_torch.data.pack import PackStore
from rxtpu_torch.data.pipeline import ByteStore, Pipeline
from rxtpu_torch.data.records import load_metadata, read_metadata_csvs
from rxtpu_torch.models.convert import from_flax
from rxtpu_torch.models.heads import MLPHead
from rxtpu_torch.models.norm import BatchNorm
from rxtpu_torch.parallel import host_shard_bounds, shard_records_for_host

import torch_dist_worker as worker
from torch_dist_launch import finish, launch, start


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the slicing contract and the per-rank Pipeline
# ---------------------------------------------------------------------------

def test_host_shard_bounds_match_rxtpu():
    for global_batch in (1, 6, 8, 12, 128):
        for num_hosts in (1, 2, 3, 4, 8):
            for host_id in range(num_hosts):
                if global_batch % num_hosts:
                    with pytest.raises(AssertionError):
                        rx_multihost.host_shard_bounds(global_batch, num_hosts, host_id)
                    with pytest.raises(ValueError, match="does not split"):
                        host_shard_bounds(global_batch, num_hosts, host_id)
                    continue
                assert host_shard_bounds(global_batch, num_hosts, host_id) == \
                    rx_multihost.host_shard_bounds(global_batch, num_hosts, host_id)
    order = np.random.default_rng(0).permutation(48)
    for global_batch, num_hosts in ((8, 2), (12, 4), (16, 4), (48, 8)):
        for host_id in range(num_hosts):
            got = shard_records_for_host(order, global_batch, num_hosts, host_id)
            want = rx_multihost.shard_records_for_host(order, global_batch, num_hosts, host_id)
            assert len(got) == len(want) == 48 // global_batch
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    for ragged in (order[:47], order[:13]):  # not a multiple of the global batch
        with pytest.raises(ValueError, match="pad the tail batch"):
            rx_multihost.shard_records_for_host(ragged, 8, 2, 0)
        with pytest.raises(ValueError, match="pad the tail batch"):
            shard_records_for_host(ragged, 8, 2, 0)


@pytest.fixture(scope="module")
def pipe_sources(synthetic_root, tmp_path_factory):
    root, _ = synthetic_root
    packs = tmp_path_factory.mktemp("dist_packs")
    rx_tools_main(["pack", "--data", root, "--out", str(packs)])
    rng = np.random.default_rng(0)
    out = {}
    for split in ("train", "test"):
        rx_rows, rx_ctrl = rx_read_metadata_csvs(os.path.join(root, "metadata"), split)
        rows, ctrl = read_metadata_csvs(os.path.join(root, "metadata"), split)
        rx_index = rx_load_metadata(rx_rows, rx_ctrl, split)
        index = load_metadata(rows, ctrl, split)
        out[split] = dict(
            rx_index=rx_index, index=index,
            pack=(RxPackStore(str(packs / f"{split}.rxpack")),
                  PackStore(str(packs / f"{split}.rxpack"))),
            bytes=(RxByteStore(rx_index, root, preload=True), ByteStore(index, root)))
    stats = {e: {"mean": rng.uniform(0.2, 0.6, 6), "std": rng.uniform(0.1, 0.3, 6)}
             for e in sorted({r.experiment for s in ("train", "test")
                              for r in out[s]["index"].records})}
    return out, stats


@pytest.mark.parametrize("source", ["pack", "bytes"])
@pytest.mark.parametrize("num_hosts", [2, 4])
def test_pipeline_rank_slices_equal_world1_and_rxtpu(pipe_sources, source, num_hosts):
    """Each host assembles only its rows; concatenated they are the one-host
    batches bit for bit in every mode (the view draws keyed by the global
    row), from a pack and from a JPEG ByteStore; each slice equals rxtpu's
    sliced Pipeline's, and its id_codes are its rows' of rxtpu's global list."""
    srcs, stats = pipe_sources
    bs = 8
    for mode in ("train", "val", "test"):
        s = srcs["test" if mode == "test" else "train"]
        rx_store, store = s[source]
        kw = dict(seed=5, shuffle=mode == "train", drop_last=mode == "train")
        src_kw = {} if source == "pack" else dict(src_size=64)

        def port(n, h):
            return list(Pipeline(s["index"], store, stats, bs, mode, num_hosts=n, host_id=h,
                                 **src_kw, **kw).epoch(1))

        whole = port(1, 0)
        slices = [port(num_hosts, h) for h in range(num_hosts)]
        rx = [list(RxPipeline(s["rx_index"], rx_store, stats, bs, mode, 64, num_hosts=num_hosts,
                              host_id=h, **kw).epoch(1)) for h in range(num_hosts)]
        assert whole and all(len(x) == len(whole) for x in slices + rx), mode
        k = bs // num_hosts
        for bi, w in enumerate(whole):
            for key in ("images", "labels", "mean", "std", "valid"):
                got = np.concatenate([slices[h][bi][key] for h in range(num_hosts)])
                np.testing.assert_array_equal(got, w[key], err_msg=f"{mode} {key}")
                for h in range(num_hosts):
                    np.testing.assert_array_equal(slices[h][bi][key], rx[h][bi][key],
                                                  err_msg=f"{mode} {key} host {h}")
            for h in range(num_hosts):
                assert slices[h][bi]["id_codes"] == rx[h][bi]["id_codes"][h * k:(h + 1) * k]
                assert slices[h][bi]["id_codes"] == w["id_codes"][h * k:(h + 1) * k]
        if mode != "train":  # the tail batch is padded: some rank's rows are all padding
            assert any(not slices[h][-1]["valid"].any() for h in range(num_hosts)) \
                or num_hosts == 2


# ---------------------------------------------------------------------------
# the cross-rank BatchNorm and the tensor-parallel head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 5), (8, 5, 6, 7)])
def test_sync_batchnorm_world2_equals_whole_batch_and_rxtpu(shape, tmp_path):
    """Two ranks of 8 (or 4) rows each against one BN on the whole batch:
    output, running statistics, input and weight gradients, in f64 to rtol
    1e-10 and in f32 to rtol 1e-6 (f32 sums over half the rows round
    differently, so values near zero also get atol 1e-6 of their unit
    scale); and against rxtpu's
    ``BatchNorm(axis_name=...)`` under a 2-device ``pmap`` at the lockstep
    BN tolerances (tests/test_torch_port_train.py:58-86)."""
    rng = np.random.default_rng(3)
    c = shape[1]
    x = torch.from_numpy(rng.normal(1.0, 2.0, shape).astype(np.float32))
    gy = torch.from_numpy(rng.normal(0.0, 1.0, shape).astype(np.float32))
    ref_bn = BatchNorm(c)
    with torch.no_grad():
        ref_bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
        ref_bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
        ref_bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
        ref_bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    state = {k: v.clone() for k, v in ref_bn.state_dict().items()}
    want_by = worker.bn_case({"x": x, "gy": gy, "state": state}, None)
    got_by = [g for g in launch("bn", 2, {"x": x, "gy": gy, "state": state}, tmp_path)]
    for dt, close in ((torch.float64, dict(rtol=1e-10, atol=0)),
                      (torch.float32, dict(rtol=1e-6, atol=1e-6))):
        want, got = want_by[dt], [g[dt] for g in got_by]
        np.testing.assert_allclose(torch.cat([g["y"] for g in got]).numpy(),
                                   want["y"].numpy(), **close)
        np.testing.assert_allclose(torch.cat([g["x_grad"] for g in got]).numpy(),
                                   want["x_grad"].numpy(), **close)
        for g in got:  # f32 parameters and buffers: each rank's part rounds to f32
            for k in ("running_mean", "running_var", "weight_grad", "bias_grad"):
                np.testing.assert_allclose(g[k].numpy(), want[k].numpy(), rtol=1e-6,
                                           atol=1e-6, err_msg=f"{dt} {k}")
    got = [g[torch.float32] for g in got_by]
    # the global n: Bessel's correction over all 2 x rows, not a rank's
    n = x.numel() // c
    biased = np.moveaxis(x.numpy(), 1, -1).reshape(-1, c).var(axis=0)
    np.testing.assert_allclose(got[0]["running_var"].numpy(),
                               0.9 * state["running_var"].numpy() + 0.1 * biased * n / (n - 1),
                               rtol=1e-5)

    # rxtpu: channels last, one shard of rows per device
    xs = np.moveaxis(x.numpy(), 1, -1).reshape((2, shape[0] // 2) + shape[2:] + (c,))
    params = {"scale": jnp.asarray(state["weight"].numpy()),
              "bias": jnp.asarray(state["bias"].numpy())}
    stats = {"mean": jnp.asarray(state["running_mean"].numpy()),
             "var": jnp.asarray(state["running_var"].numpy())}
    bn = FlaxBatchNorm(use_running_average=False, axis_name="batch")

    def apply(xr):
        y, mut = bn.apply({"params": params, "batch_stats": stats}, xr, mutable=["batch_stats"])
        return y, mut["batch_stats"]

    ry, rstats = jax.pmap(apply, axis_name="batch", devices=jax.devices()[:2])(jnp.asarray(xs))
    ry = np.moveaxis(np.asarray(ry).reshape((shape[0],) + shape[2:] + (c,)), -1, 1)
    np.testing.assert_allclose(torch.cat([g["y"] for g in got]).numpy(), ry,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0]["running_mean"].numpy(), np.asarray(rstats["mean"][0]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[0]["running_var"].numpy(), np.asarray(rstats["var"][0]),
                               rtol=1e-6)


def test_tensor_parallel_head_equals_unsplit(tmp_path):
    """The MLP head with fc1 and fc2 split over 2 model ranks: the same
    output, each shard's gradient the slice of the whole weight's, the
    replicated biases' gradients and the input's (summed over the ranks)."""
    rng = np.random.default_rng(4)
    in_f, size_f, classes, b = 12, 16, 8, 6
    head = MLPHead(in_f, classes, size_f, dropout=0.0)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.5, tuple(p.shape)).astype(np.float32)))
    inp = {"x": torch.from_numpy(rng.normal(0, 1, (b, in_f)).astype(np.float32)),
           "gy": torch.from_numpy(rng.normal(0, 1, (b, classes)).astype(np.float32)),
           "size_features": size_f, "state": head.state_dict(), "model_parallel": 2}
    want = worker.tp_case(inp, None)
    got = launch("tp", 2, inp, tmp_path)
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["y"].numpy(), want["y"].numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g["x_grad"].numpy(), want["x_grad"].numpy(),
                                   rtol=1e-6, atol=1e-6)
        for name, gw in want["grads"].items():
            gr = g["grads"][name]
            if name in ("fc1.weight", "fc2.weight"):
                k = gw.shape[0] // 2
                assert tuple(gr.shape) == (k,) + tuple(gw.shape[1:]), name
                gw = gw[r * k:(r + 1) * k]
            np.testing.assert_allclose(gr.numpy(), gw.numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=name)


# ---------------------------------------------------------------------------
# one train step at world 2 and 4 against world 1 and rxtpu's 8-device mesh
# ---------------------------------------------------------------------------

B, SRC, CROP, CLASSES, SIZE_F = 8, 64, 48, 8, 16


def _rx_state():
    """rxtpu's resnet18 model and initial train state (f32, no dropout)."""
    cfg = RxConfig(model=RxModelConfig(backbone="resnet18", nb_classes=CLASSES,
                                       size_features=SIZE_F, dropout=0.0, pretrained=False,
                                       compute_dtype="float32"),
                   train=RxTrainConfig(bs_per_device=1, lr=0.05, nb_epochs=3),
                   experiment_id="x")
    model = rx_build_model(cfg)
    state, _ = rx_create_train_state(cfg, model, steps_per_epoch=1)
    return model, state


def _rx_mesh_step(model, state, views: np.ndarray, labels: np.ndarray, model_parallel: int):
    """rxtpu's f32 step on its 8-device mesh, fed views (``augment="none"``,
    as test_sgd_steps_match_rxtpu)."""
    mesh = rx_make_mesh(n_devices=8, model_parallel=model_parallel)
    step = rx_make_train_step(model, CROP, donate=False, augment="none")
    batch = {"images": np.transpose(views, (0, 1, 3, 4, 2)).copy(), "labels": labels,
             "mean": np.zeros((B, 6), np.float32), "std": np.ones((B, 6), np.float32)}
    with mesh:
        _, m = step(rx_place_state(state, mesh), rx_shard_batch(batch, mesh),
                    jax.random.PRNGKey(0), jnp.asarray(True))
    return {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("world,model_parallel", [(2, 1), (4, 2)])
def test_train_step_world_n_equals_world1_and_rxtpu_mesh(world, model_parallel, tmp_path):
    """(a) From the same seed on the same global batch of 8 (shear augment,
    dropout 0.3: the draws are the global batch's), world 2 (data 2) and
    world 4 (data 2 x model 2) against the port's world-1 step: the loss
    within rtol 1e-5, the accuracy equal, the parameters and BN statistics
    within atol 2e-5 (rxtpu's DP bound, tests/test_sharding.py:80-88), the
    tensor-parallel momentum shards the slices of world 1's. (b) From
    rxtpu's initial weights, fed the same views: the loss within rtol 1e-5
    and the grad norms within rtol 1e-3 of rxtpu's 8-device mesh step (with
    model_parallel 2 for the tensor-parallel head)."""
    rng = np.random.default_rng(world)
    labels = rng.integers(0, CLASSES, B).astype(np.int32)
    images = (12 * labels[:, None, None, None, None]
              + rng.integers(0, 60, (B, 3, 6, SRC, SRC))).astype(np.uint8)
    mean = rng.uniform(0.2, 0.6, (B, 6)).astype(np.float32)
    std = rng.uniform(0.1, 0.3, (B, 6)).astype(np.float32)
    seeded = dict(images=torch.from_numpy(images), labels=torch.from_numpy(labels),
                  mean=torch.from_numpy(mean), std=torch.from_numpy(std), augment="shear",
                  dropout=0.3, state=None)
    views = rng.normal(size=(B, 3, 6, CROP, CROP)).astype(np.float32)
    rx_model, rx_state = _rx_state()
    params0 = from_flax(jax.device_get(rx_state.params), jax.device_get(rx_state.batch_stats))
    fed = dict(images=torch.from_numpy(views), labels=torch.from_numpy(labels),
               mean=torch.zeros(B, 6), std=torch.ones(B, 6), augment="none", dropout=0.0,
               state=params0)
    common = dict(batch=B, crop=CROP, classes=CLASSES, size_features=SIZE_F, seed=11)
    cases = [{**common, **seeded}, {**common, **fed}]
    # the ranks run while this process computes the references
    ranks = start("step", world, {"cases": cases, "model_parallel": model_parallel}, tmp_path)
    rx_m = _rx_mesh_step(rx_model, rx_state, views, labels, model_parallel)
    want = worker.step_case(cases[0], None)
    got = finish(ranks)

    for r, out in enumerate(got):
        a, b = out["cases"]
        assert a["lr"] == want["lr"] == pytest.approx(0.0005 * B)
        np.testing.assert_allclose(a["metrics"]["loss"], want["metrics"]["loss"], rtol=1e-5)
        assert a["metrics"]["accuracy"] == want["metrics"]["accuracy"]
        for k in ("grad_norm", "grad_norm/backbone", "grad_norm/head"):
            np.testing.assert_allclose(a["metrics"][k], want["metrics"][k], rtol=1e-4,
                                       err_msg=k)
        for k, v in want["state_dict"].items():
            np.testing.assert_allclose(a["state_dict"][k].numpy(), v.numpy(), atol=2e-5,
                                       err_msg=k)
        tp = {"head.fc1.weight", "head.fc2.weight"} if model_parallel > 1 else set()
        assert set(a["tp"]) == tp
        m_rank = r % model_parallel
        for name, buf in a["momentum"].items():
            whole = want["momentum"][name]
            if name in tp:
                k = whole.shape[0] // model_parallel
                whole = whole[m_rank * k:(m_rank + 1) * k]
            assert buf.shape == whole.shape, name
            np.testing.assert_allclose(buf.numpy(), whole.numpy(), atol=2e-5, err_msg=name)
        np.testing.assert_allclose(b["metrics"]["loss"], rx_m["loss"], rtol=1e-5)
        assert b["metrics"]["accuracy"] == rx_m["accuracy"]
        for k in ("grad_norm", "grad_norm/backbone", "grad_norm/head"):
            np.testing.assert_allclose(b["metrics"][k], rx_m[k], rtol=1e-3, err_msg=k)


# ---------------------------------------------------------------------------
# the int8 calibration
# ---------------------------------------------------------------------------

def test_calibrate_world2_bit_equal_to_world1(tmp_path):
    """Each rank observes its rows of every calibration batch and the absmax
    is max-reduced over the ranks: the qstats equal world 1's, bit for bit."""
    from rxtpu_torch.data.synthetic import randomize_
    from rxtpu_torch.models.twosites import TwoSitesNN

    rng = np.random.default_rng(6)
    model = randomize_(TwoSitesNN("resnet18", nb_classes=CLASSES, size_features=SIZE_F), seed=1)
    batches = [{"images": torch.from_numpy(rng.integers(0, 256, (4, 6, 6, SRC, SRC),
                                                        dtype=np.uint8)),
                "mean": torch.from_numpy(rng.uniform(0.2, 0.6, (4, 6)).astype(np.float32)),
                "std": torch.from_numpy(rng.uniform(0.1, 0.3, (4, 6)).astype(np.float32))}
               for _ in range(2)]
    inp = {"classes": CLASSES, "size_features": SIZE_F, "state": model.state_dict(),
           "batches": batches, "crop": CROP}
    want = worker.calib_case(inp, None)["qstats"]
    got = launch("calib", 2, inp, tmp_path)
    leaves = worker_leaves(want)
    assert len(leaves) > 20
    for g in got:
        gl = worker_leaves(g["qstats"])
        assert [n for n, _ in gl] == [n for n, _ in leaves]
        for (name, a), (_, b) in zip(gl, leaves):
            assert torch.equal(a, b), name


def worker_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in worker_leaves(v, f"{prefix}{k}/")]
    return [(prefix, tree)]
