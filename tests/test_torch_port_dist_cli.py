"""The port's CLI at world 2 on the CPU (gloo), against its world-1 run on
the same global batch, on the plate-balanced fixture of
``tests/test_torch_port_serve.py`` (its raw pack):

- ``--distributed`` with explicit cluster flags in two processes, plainly
  and with ``--model-parallel 2``: the same submission bytes as world 1,
  the stats artifact computed on rank 0 alone, one metrics file, one best
  and one rolling checkpoint written by rank 0 with whole weights (the
  layout a world-1 run writes and, through ``save_rxtpu_pickle``, rxtpu's
  reader takes), the train losses step by step;
- ``--resume`` at world 2 from world 1's rolling checkpoint;
- ``--distributed`` in one process with no cluster runs at world 1 with
  rxtpu's warning, and raises with a cluster hint set or with cluster flags
  that do not parse.

The ranks run ``tests/torch_dist_worker.py cli``: the CLI in f32 (a bf16
run adds noise and hides nothing) with every train step logged, no JAX.
Tolerances: f32 training amplifies rounding step by step, about tenfold a
step here (batch-statistics BN on 32^2 crops of random planes). Over this
fixture's first epoch (4 steps at lr 5e-4) world 2's weights lay 2.5e-4 (max
abs) from world 1's and world 1 with oneDNN's convs turned off, a
rounding-only change, 1.3e-4 (train losses 1.5e-5 and 1.1e-5 relative);
after the resumed epoch, 5.5e-4 (losses 2.3e-4). With BN whole on each rank
(``--model-parallel 2`` at world 2) the weights lay 6e-6 away. So weights
are held to atol 2e-3 and the train losses to rtol 1e-3; the loss before
any step to rtol 1e-6; ``tests/test_torch_port_dist.py`` holds one step to
rxtpu's DP bound.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rxtpu_torch.cli as port_cli
from rxtpu.config import Config as RxConfig, ModelConfig as RxModelConfig
from rxtpu.data.synthetic import make_plate_balanced_synthetic_dataset
from rxtpu.tools import main as rx_tools_main
from rxtpu.train.checkpoint import load_checkpoint as rx_load_checkpoint
from rxtpu.train.setup import build_model as rx_build_model
from rxtpu_torch.train.checkpoint import load_train_state, save_rxtpu_pickle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
RUN_TIMEOUT_S = 240
COMMON = ["--nb-classes", "8", "--backbone", "resnet18", "--crop-size", "32",
          "--experiment-types", "0", "--pack", "packs", "--device", "cpu", "--lr", "0.0005"]
GLOBAL_BATCH = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(root, eid: str, world: int, extra):
    """The CLI in ``world`` processes (``--distributed`` with explicit
    cluster flags when world > 1), writing into ``{root}/{eid}``."""
    os.makedirs(root / eid, exist_ok=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")])}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    argv = ["--experiment_id", eid, "--out-dir", eid,
            "--batch-size", str(GLOBAL_BATCH // world)] + COMMON + list(extra)
    port = _free_port()
    procs = []
    for r in range(world):
        cluster = [] if world == 1 else [
            "--distributed", "--coordinator-address", f"127.0.0.1:{port}",
            "--num-processes", str(world), "--process-id", str(r)]
        procs.append(subprocess.Popen([sys.executable, WORKER, "cli"] + argv + cluster,
                                      cwd=root, env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return eid, procs, time.monotonic() + RUN_TIMEOUT_S


def _finish(run):
    """Each rank's output; any failure or overrun fails the test with every
    rank's output, and no process is left running."""
    eid, procs, deadline = run
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                logs.append(p.communicate()[0])
                pytest.fail(f"run {eid} timed out after {RUN_TIMEOUT_S} s:\n" + "\n".join(logs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode for p in procs):
        pytest.fail(f"run {eid}: return codes {[p.returncode for p in procs]}\n"
                    + "\n".join(logs))
    return logs


def _losses(root, eid):
    with open(root / "board" / eid / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    return ([r["training/loss"] for r in recs if "training/loss" in r],
            [r["validation/loss"] for r in recs if "validation/loss" in r])


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The fixture, world 1's run, then at once: world 2, world 2 with
    ``--model-parallel 2``, and ``--resume --epochs 2`` from world 1's
    rolling checkpoint at world 2 and at world 1."""
    root = tmp_path_factory.mktemp("dist_cli")
    manifest = make_plate_balanced_synthetic_dataset(
        str(root / "data"), nb_classes=8, n_train_experiments=10, n_test_experiments=1,
        test_types=(0,), img_size=48)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        rx_tools_main(["pack", "--data", "data", "--out", "packs"])
    finally:
        os.chdir(cwd)
    logs = {"w1": _finish(_start(root, "w1", 1, ["--epochs", "1",
                                                 "--stats", "stats_w1.json"]))}
    for eid in ("rs2", "rs1"):  # both resume from world 1's state
        for kind in ("best_model", "last"):
            shutil.copy(root / "models" / f"{kind}_w1.ckpt", root / "models" / f"{kind}_{eid}.ckpt")
    started = [_start(root, "w2", 2, ["--epochs", "1", "--stats", "stats_w2.json"]),
               _start(root, "tp", 2, ["--epochs", "1", "--stats", "stats_w1.json",
                                      "--model-parallel", "2"]),
               _start(root, "rs2", 2, ["--epochs", "2", "--stats", "stats_w1.json", "--resume"]),
               _start(root, "rs1", 1, ["--epochs", "2", "--stats", "stats_w1.json", "--resume"])]
    for run in started:
        logs[run[0]] = _finish(run)
    return root, manifest, logs


@pytest.mark.parametrize("eid", ["w2", "tp"])
def test_cli_world2_matches_world1(runs, eid):
    root, manifest, logs = runs
    out = "\n".join(logs[eid])
    assert f"Devices: 2 (cpu), global batch {GLOBAL_BATCH}, rank 0/2, model parallel " \
           f"{2 if eid == 'tp' else 1}" in out
    assert f"Devices: 2 (cpu), global batch {GLOBAL_BATCH}, rank 1/2" in out
    # the submission: rank 0 writes it, byte for byte world 1's
    assert os.listdir(root / eid) == [f"submission_{eid}.csv"]
    assert _read(root / eid / f"submission_{eid}.csv") == _read(root / "w1" / "submission_w1.csv")
    assert len(_read(root / "w1" / "submission_w1.csv").splitlines()) == \
        len(manifest["test"]) + 1
    if eid == "w2":  # computed on rank 0 alone, read by rank 1 after the barrier
        assert _read(root / "stats_w2.json") == _read(root / "stats_w1.json")
        assert out.count("missing; computing...") == 1
    # one metrics file, the train losses step by step, validation
    train1, val1 = _losses(root, "w1")
    train2, val2 = _losses(root, eid)
    assert len(train2) == len(train1) == 4 and len(val2) == len(val1) == 2
    np.testing.assert_allclose(train2, train1, rtol=1e-3)
    np.testing.assert_allclose(val2[0], val1[0], rtol=1e-6)  # before any step
    # one best and one rolling checkpoint, whole weights, world 1's layout
    files = sorted(f for f in os.listdir(root / "models") if f"_{eid}.ckpt" in f)
    assert files == [f"best_model_{eid}.ckpt", f"last_{eid}.ckpt"]
    for kind in ("best_model", "last"):
        want = load_train_state(str(root / "models" / f"{kind}_w1.ckpt"))
        got = load_train_state(str(root / "models" / f"{kind}_{eid}.ckpt"))
        assert got["step"] == want["step"] and got.get("epoch") == want.get("epoch")
        assert got["best_metric"] == want["best_metric"]
        for k, v in want["state_dict"].items():
            assert got["state_dict"][k].shape == v.shape, k
            np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(), atol=2e-3,
                                       err_msg=k)
        for i, slot in want["optimizer"]["state"].items():
            assert got["optimizer"]["state"][i]["momentum_buffer"].shape == \
                slot["momentum_buffer"].shape
    # rxtpu's reader takes the tensor-parallel run's file (through the pickle layout)
    last = load_train_state(str(root / "models" / f"last_{eid}.ckpt"))
    names = list(last["state_dict"])
    params = [n for n in names if not n.endswith(("running_mean", "running_var"))]
    order = [i for g in last["optimizer"]["param_groups"] for i in g["params"]]
    momentum = {n: last["optimizer"]["state"][i]["momentum_buffer"]
                for n, i in zip(params, order)}
    pickle_path = str(root / f"rx_{eid}.pkl")
    save_rxtpu_pickle(pickle_path, last["state_dict"], momentum, last["step"], epoch=1)
    rx_payload = rx_load_checkpoint(pickle_path)
    cfg = RxConfig(model=RxModelConfig(backbone="resnet18", nb_classes=8, pretrained=False),
                   experiment_id="x")
    init = jax.eval_shape(lambda: rx_build_model(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32, 6)), train=False))
    for tree, want in ((rx_payload["params"], init["params"]),
                       (rx_payload["batch_stats"], init["batch_stats"])):
        assert jax.tree_util.tree_map(np.shape, tree) == \
            jax.tree_util.tree_map(lambda a: a.shape, want)


def test_cli_resume_at_world2_from_world1_checkpoint(runs):
    """World 2 resumes world 1's rolling checkpoint (epoch 1) for one more
    epoch as world 1 does: the same steps, losses, weights and submission."""
    root, _, logs = runs
    for eid in ("rs2", "rs1"):
        assert "Resumed from epoch 1 (step 4)" in "\n".join(logs[eid])
    want = load_train_state(str(root / "models" / "last_rs1.ckpt"))
    got = load_train_state(str(root / "models" / "last_rs2.ckpt"))
    assert got["epoch"] == want["epoch"] == 2 and got["step"] == want["step"] == 8
    for k, v in want["state_dict"].items():
        np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(), atol=2e-3, err_msg=k)
    np.testing.assert_allclose(_losses(root, "rs2")[0], _losses(root, "rs1")[0], rtol=1e-3)
    assert _read(root / "rs2" / "submission_rs2.csv") == _read(root / "rs1" / "submission_rs1.csv")


def _f32(resolve):
    def patched(args):
        cfg = resolve(args)
        cfg.model.compute_dtype = "float32"
        return cfg
    return patched


def test_distributed_without_cluster_runs_at_world1(runs, monkeypatch, capsys):
    """``--distributed`` in one process: no cluster and no hint, so rxtpu's
    warning and world 1 (the test phase on world 1's checkpoint writes its
    submission); with ``SLURM_JOB_ID`` set, or cluster flags that do not
    parse, it raises (``rxtpu/parallel/multihost.py:105-127``)."""
    root, _, _ = runs
    monkeypatch.chdir(root)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "SLURM_JOB_ID",
              "OMPI_COMM_WORLD_SIZE", "TPU_WORKER_HOSTNAMES", "TPU_WORKER_ID",
              "MEGASCALE_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(port_cli, "resolve_config", _f32(port_cli.resolve_config))
    os.makedirs("single", exist_ok=True)
    argv = ["--experiment_id", "w1", "--batch-size", str(GLOBAL_BATCH), "--stats",
            "stats_w1.json", "--epochs", "1"] + COMMON
    assert port_cli.main(argv + ["--distributed", "--out-dir", "single"]) == 0
    err = capsys.readouterr().err
    assert "found no cluster" in err and "continuing single-process" in err
    assert not torch.distributed.is_initialized()
    assert _read("single/submission_w1.csv") == _read("w1/submission_w1.csv")
    monkeypatch.setenv("SLURM_JOB_ID", "1234")
    with pytest.raises(RuntimeError, match="cluster environment hints are present "
                                           r"\(SLURM_JOB_ID\)"):
        port_cli.main(argv + ["--distributed", "--out-dir", "single"])
    monkeypatch.delenv("SLURM_JOB_ID")
    with pytest.raises(ValueError, match="is not host:port"):
        port_cli.main(argv + ["--distributed", "--coordinator-address", "nowhere",
                              "--num-processes", "2", "--process-id", "0"])
    with pytest.raises(ValueError, match="need all of"):
        port_cli.main(argv + ["--distributed", "--process-id", "0"])
    with pytest.raises(SystemExit, match="--model-parallel 2 does not divide one process"):
        port_cli.main(argv + ["--model-parallel", "2"])
    assert not torch.distributed.is_initialized()
