"""One rank of the port's multi-rank tests (``tests/test_torch_port_dist*.py``).

    python tests/torch_dist_worker.py CASE RANK WORLD PORT INPUT OUTPUT
    python tests/torch_dist_worker.py cli ARGS...

Forms a gloo process group of WORLD ranks on 127.0.0.1:PORT, runs CASE on
the tensors in INPUT (a ``torch.save`` dict) and writes this rank's
results to OUTPUT (``torch.save``); or runs ``rxtpu_torch.cli.main(ARGS)``
with the model computing in f32 (the tests compare runs closely, and bf16
would add noise and hide nothing) and every train step logged. It imports
torch, numpy and
``rxtpu_torch`` only, never JAX: the ranks stand for processes on hosts
that have none. The functions below also run in one process without a
group (``mesh=None``): the tests' world-1 references.
"""

from __future__ import annotations

import sys
import time
from typing import Dict

import torch

from rxtpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from rxtpu_torch.models.norm import BatchNorm
from rxtpu_torch.parallel import multihost
from rxtpu_torch.parallel import (
    initialize_distributed, make_mesh, place_state, tp_named_parameters, whole_state_dict,
)


def bn_case(inp: Dict, mesh) -> Dict:
    """One train-mode BN forward and backward of ``sum(gy * y)`` on the
    rank's rows of ``x``, in f32 and in f64 (statistics in the input's
    dtype); the weight and bias gradients summed over the ranks (each rank
    holds its rows' part)."""
    return {dt: bn_once(inp["x"].to(dt), inp["gy"].to(dt), inp["state"], mesh)
            for dt in (torch.float32, torch.float64)}


def bn_once(x: torch.Tensor, gy: torch.Tensor, state: Dict, mesh) -> Dict:
    rows = slice(None)
    if mesh is not None:
        k = x.shape[0] // mesh.world
        rows = slice(mesh.rank * k, (mesh.rank + 1) * k)
    bn = BatchNorm(x.shape[1], group=None if mesh is None else mesh.data_group)
    bn.load_state_dict(state)
    xr = x[rows].clone().requires_grad_(True)
    y = bn.train()(xr)
    (y * gy[rows]).sum().backward()
    grads = torch.stack([bn.weight.grad, bn.bias.grad])
    if mesh is not None:
        torch.distributed.all_reduce(grads)
    return {"y": y.detach(), "x_grad": xr.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var, "weight_grad": grads[0], "bias_grad": grads[1]}


def fused_case(inp: Dict, mesh) -> Dict:
    """One stride-1 bottleneck through ``fused_bottleneck`` (K6/K7's plain
    bodies on the CPU) in train mode, forward and backward of ``sum(wout *
    y)`` on the rank's views of ``x``, its BatchNorms synced over the data
    ranks: the rank's ``y`` and ``dx``, the running statistics, and the
    parameter gradients summed over the ranks (each rank holds its rows'
    part)."""
    from rxtpu_torch.models.fused import fused_bottleneck
    from rxtpu_torch.models.resnet import BottleneckBlock

    x, wout, h, w = inp["x"], inp["wout"], inp["height"], inp["width"]
    block = BottleneckBlock(x.shape[2], wout.shape[2] // 4)
    block.load_state_dict(inp["state"])
    rows = slice(None)
    if mesh is not None:
        k = x.shape[0] // mesh.data_size
        rows = slice(mesh.data_rank * k, (mesh.data_rank + 1) * k)
        for mod in block.modules():
            if isinstance(mod, BatchNorm):
                mod.group = mesh.bn_group
    xr = x[rows].clone().requires_grad_(True)
    y = fused_bottleneck(block.train(), xr, h, w)
    (y.float() * wout[rows]).sum().backward()
    grads = {n: p.grad for n, p in block.named_parameters()}
    if mesh is not None:
        for g in grads.values():
            torch.distributed.all_reduce(g)
    return {"y": y.detach().float(), "dx": xr.grad.float(), "grads": grads,
            "stats": {k: v.clone() for k, v in block.state_dict().items() if "running" in k}}


def stats_case(inp: Dict, mesh) -> Dict:
    """The CLI's stats pass when the artifact is missing, with rank 0's pass
    (a stand-in that sleeps ``inp["pass_s"]``, then writes ``inp["stats"]``)
    outlasting the default group's timeout: every rank's stats, and the
    number of passes this rank ran."""
    import rxtpu_torch.cli as cli
    import rxtpu_torch.tools as tools
    from rxtpu_torch.data.stats import save_stats

    passes = []

    def slow_pass(data_dir, out_path, **kwargs):
        passes.append(out_path)
        time.sleep(inp["pass_s"])
        save_stats(inp["stats"], out_path)
        return inp["stats"]

    tools.run_stats = slow_pass
    cfg = Config(data=DataConfig(stats_path=inp["path"]))
    stats = cli.load_or_compute_stats(cfg, torch.device("cpu"))
    torch.distributed.barrier()  # the default group still works after the wait
    return {"stats": stats, "passes": len(passes)}


def tp_case(inp: Dict, mesh) -> Dict:
    """The MLP head (train mode, no dropout) forward and backward of ``sum(gy
    * y)`` on the whole batch, its kernels split over the mesh's model
    ranks; each rank returns its shards' gradients."""
    from rxtpu_torch.models.heads import MLPHead

    x = inp["x"].clone().requires_grad_(True)
    head = MLPHead(x.shape[1], inp["gy"].shape[1], inp["size_features"], dropout=0.0,
                   tp_group=None if mesh is None else mesh.tp_group)
    head.load_state_dict(inp["state"])
    if mesh is not None:
        for p in (head.fc1.weight, head.fc2.weight):
            k = p.shape[0] // mesh.model_parallel
            p.data = p.data[mesh.model_rank * k:(mesh.model_rank + 1) * k].clone()
    y = head.train()(x)
    (y * inp["gy"]).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad,
            "grads": {n: p.grad for n, p in head.named_parameters()}}


def step_config(case: Dict, world: int) -> Config:
    return Config(
        data=DataConfig(crop_size=case["crop"]),
        model=ModelConfig(backbone="resnet18", nb_classes=case["classes"],
                          size_features=case["size_features"], dropout=case["dropout"],
                          pretrained=False, compute_dtype="float32"),
        train=TrainConfig(bs_per_device=case["batch"] // world, nb_epochs=3, seed=case["seed"]),
        experiment_id="dist")


def step_case(case: Dict, mesh) -> Dict:
    """One f32 train step of the port on the rank's rows of a global batch
    (``case["batch"]`` rows): the model from ``case["state"]`` when given,
    else initialized from the seed; returns the metrics, the whole updated
    weights and BN statistics, and the rank's momentum buffers by name."""
    from rxtpu_torch.train.setup import build_model, create_train_state
    from rxtpu_torch.train.step import make_train_step

    world = 1 if mesh is None else mesh.world
    cfg = step_config(case, world)
    model = build_model(cfg, mesh)
    state, lr = create_train_state(cfg, model, steps_per_epoch=1, device=torch.device("cpu"),
                                   n_devices=world)
    if case.get("state") is not None:
        model.load_state_dict(case["state"])
    place_state(state, mesh)
    batch = {k: case[k] for k in ("images", "labels", "mean", "std")}
    if mesh is not None:
        k = case["batch"] // mesh.data_size
        rows = slice(mesh.data_rank * k, (mesh.data_rank + 1) * k)
        batch = {name: v[rows] for name, v in batch.items()}
    step = make_train_step(model, case["crop"], augment=case["augment"],
                           compute_dtype=torch.float32, mesh=mesh)
    metrics = step(state, batch, case["seed"], True)
    names = [n for n, _ in model.named_parameters()]
    return {"lr": lr, "metrics": {k: float(v) for k, v in metrics.items()},
            "state_dict": {k: v.clone() for k, v in whole_state_dict(model, mesh).items()},
            "momentum": {n: state.optimizer.state[p]["momentum_buffer"].clone()
                         for n, p in zip(names, model.parameters())},
            "tp": [n for n, _ in tp_named_parameters(model, mesh)]}


def calib_case(inp: Dict, mesh) -> Dict:
    """``calibrate``'s qstats over the rank's rows of each batch."""
    from rxtpu_torch.infer.quant import calibrate
    from rxtpu_torch.models.twosites import TwoSitesNN

    model = TwoSitesNN("resnet18", nb_classes=inp["classes"],
                       size_features=inp["size_features"])
    model.load_state_dict(inp["state"])
    batches = inp["batches"]
    if mesh is not None:
        k = batches[0]["images"].shape[0] // mesh.world
        rows = slice(mesh.rank * k, (mesh.rank + 1) * k)
        batches = [{n: v[rows] for n, v in b.items()} for b in batches]
    return {"qstats": calibrate(model.eval(), batches, inp["crop"], torch.float32,
                                group=None if mesh is None else mesh.data_group)}


def run(name: str, inp: Dict, mesh) -> Dict:
    if name == "step":
        return {"cases": [step_case(c, mesh) for c in inp["cases"]]}
    return {"bn": bn_case, "tp": tp_case, "calib": calib_case, "fused": fused_case,
            "stats": stats_case}[name](inp, mesh)


def cli_f32(argv) -> int:
    import rxtpu_torch.cli as cli

    resolve = cli.resolve_config

    def f32(args):
        cfg = resolve(args)
        cfg.model.compute_dtype = "float32"
        cfg.train.log_every_steps = 1
        return cfg

    cli.resolve_config = f32
    torch.set_num_threads(1)
    return cli.main(argv)


def main(argv) -> int:
    if argv[0] == "cli":
        return cli_f32(argv[1:])
    name, rank, world, port, inp_path, out_path = argv
    torch.set_num_threads(1)
    torch.manual_seed(0)
    inp = torch.load(inp_path, weights_only=False)
    multihost.TIMEOUT_S = inp.get("timeout_s", multihost.TIMEOUT_S)
    initialize_distributed(f"127.0.0.1:{port}", int(world), int(rank), device="cpu")
    mesh = make_mesh(int(inp.get("model_parallel", 1)))
    torch.save(run(name, inp, mesh), out_path)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
