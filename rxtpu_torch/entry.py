"""Entry points of the port (counterpart of ``__graft_entry__.py``): the
flagship model's eval forward, and the multi-rank dry run.

``entry()`` gives ``(fn, (x,))``: ``fn`` is the eval forward of a seeded
ResNet-50 ``TwoSitesNN`` (1108 classes, BN on its running statistics) in
bf16 under autocast, on the card unless ``device="cpu"``; ``x`` are seeded
bf16 views ``[2, 3, 6, 364, 364]`` in the port's NCHW view layout (rxtpu's
are NHWC ``[2, 3, 364, 364, 6]``).

``dryrun_multichip(n)`` runs rxtpu's dry run as ``n`` gloo ranks on the CPU,
each a process started with ``spawn`` on a free port of 127.0.0.1, on
rxtpu's mesh layout: data ``n/2`` x model 2 when ``n`` is even, else data
``n`` x model 1. Every rank checks, on ResNet-50 with 1108 classes in bf16
under autocast and a global batch of one row per data rank:

1. one train step with the shear augment (64^2 sources, 48^2 crop), the
   batch its data rank's rows and the head split over the model ranks: a
   finite loss and ``step == 1``;
2. the same step at world 1 on the whole batch (rxtpu's multihost feed
   check: the global batch assembled from per-rank slices gives the whole
   batch's step): the loss within 1e-5;
3. the G=6 predict at full size (no crop) with the updated whole model:
   ``[batch, 1108]``, finite, every row summing to 1 within 1e-2;
4. the W8A8 int8 predict, calibrated on that batch: finite, rows summing
   to 1 within 1e-2;
5. a checkpoint of the whole weights saved and loaded into a new model on
   the mesh, whose predict repeats 3.'s bit for bit.

It raises when a rank fails or outlives its time limit (every rank is
stopped), and prints one summary line.
"""

from __future__ import annotations

import math
import os
import socket
import tempfile
import traceback
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

NB_CLASSES = 1108
RANK_TIMEOUT_S = 600


def _seeded_resnet50(seed: int = 0):
    from rxtpu_torch.models.resnet import init_weights
    from rxtpu_torch.models.twosites import TwoSitesNN

    model = TwoSitesNN("resnet50", nb_classes=NB_CLASSES)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model


def entry(device: Optional[str] = None) -> Tuple[Callable, Tuple[torch.Tensor]]:
    """(fn, (x,)): ``fn(views)`` -> f32 logits ``[B, 1108]`` of the seeded
    ResNet-50 ``TwoSitesNN`` in eval mode, bf16 under autocast; ``x`` bf16
    ``[2, 3, 6, 364, 364]``. On the card unless ``device`` says otherwise."""
    from rxtpu_torch.config import resolve_device
    from rxtpu_torch.infer.fold import Autocast

    dev = resolve_device(device or "cuda")
    net = Autocast(_seeded_resnet50().to(dev).eval(), torch.bfloat16)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 3, 6, 364, 364), generator=gen).to(torch.bfloat16).to(dev)

    @torch.inference_mode()
    def fn(views: torch.Tensor) -> torch.Tensor:
        return net(views).float()

    return fn, (x,)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dryrun_rank(rank: int, world: int, port: int, workdir: str, results) -> None:
    """One rank of ``dryrun_multichip``: its checks' numbers, or its
    traceback, go to ``results``."""
    try:
        torch.set_num_threads(1)
        from rxtpu_torch.parallel import initialize_distributed, make_mesh

        initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
        try:
            out = _dryrun_checks(make_mesh(2 if world % 2 == 0 else 1), workdir)
        finally:
            torch.distributed.destroy_process_group()
        results.put((rank, out, None))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, None, traceback.format_exc()))


def _dryrun_checks(mesh, workdir: str) -> Dict[str, float]:
    from rxtpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from rxtpu_torch.infer.predict import Predictor
    from rxtpu_torch.infer.quant import QuantPredictor, calibrate, prepare_quantized
    from rxtpu_torch.parallel import place_state, whole_model, whole_state_dict
    from rxtpu_torch.train.checkpoint import load_train_state, save_checkpoint
    from rxtpu_torch.train.setup import build_model, create_train_state
    from rxtpu_torch.train.step import make_train_step

    cpu = torch.device("cpu")
    src, crop = 64, 48
    cfg = Config(data=DataConfig(path_data="unused", crop_size=crop, src_size=src),
                 model=ModelConfig(backbone="resnet50", nb_classes=NB_CLASSES,
                                   pretrained=False, compute_dtype="bfloat16"),
                 train=TrainConfig(nb_epochs=2, bs_per_device=1), experiment_id="dryrun")
    bs = cfg.train.bs_per_device * mesh.data_size
    rng = np.random.default_rng(0)
    batch = {
        "images": torch.from_numpy(rng.integers(0, 256, (bs, 3, 6, src, src), dtype=np.uint8)),
        "labels": torch.from_numpy(rng.integers(0, NB_CLASSES, bs).astype(np.int32)),
        "mean": torch.full((bs, 6), 0.4), "std": torch.full((bs, 6), 0.2),
    }

    def train_once(m, rows_of):
        model = build_model(cfg, m)
        state, _ = create_train_state(cfg, model, 2, cpu, n_devices=mesh.world)
        place_state(state, m)
        step = make_train_step(model, crop, augment="shear", compute_dtype=torch.bfloat16,
                               mesh=m)
        metrics = step(state, {k: v[rows_of] for k, v in batch.items()}, cfg.train.seed, True)
        return state, float(metrics["loss"])

    k = bs // mesh.data_size
    state, loss = train_once(mesh, slice(mesh.data_rank * k, (mesh.data_rank + 1) * k))
    if not math.isfinite(loss) or state.step != 1:
        raise RuntimeError(f"train step: loss {loss}, step {state.step}")
    _, loss_whole = train_once(None, slice(None))
    if abs(loss - loss_whole) >= 1e-5:
        raise RuntimeError(f"per-rank slices' loss {loss} != the whole batch's {loss_whole}")

    pbatch = {
        "images": torch.from_numpy(rng.integers(0, 256, (bs, 6, 6, src, src), dtype=np.uint8)),
        "mean": torch.full((bs, 6), 0.4), "std": torch.full((bs, 6), 0.2),
    }

    def check_probs(name, p):
        if tuple(p.shape) != (bs, NB_CLASSES) or not bool(torch.isfinite(p).all()):
            raise RuntimeError(f"{name}: shape {tuple(p.shape)} or non-finite values")
        if float((p.sum(1) - 1.0).abs().max()) > 1e-2:
            raise RuntimeError(f"{name}: rows do not sum to 1")

    model = whole_model(state.model, mesh).eval()
    probs = Predictor(model, None, dtype=torch.bfloat16)(pbatch)
    check_probs("G=6 predict", probs)
    qstats = calibrate(model, [pbatch], None, torch.bfloat16)
    qprobs = QuantPredictor(prepare_quantized(model, qstats), None)(pbatch)
    check_probs("int8 predict", qprobs)

    path = os.path.join(workdir, f"last_rank{mesh.rank}.ckpt")
    save_checkpoint(path, whole_state_dict(state.model, mesh), step=state.step)
    restored = build_model(cfg, mesh)
    rstate, _ = create_train_state(cfg, restored, 2, cpu, n_devices=mesh.world)
    restored.load_state_dict(load_train_state(path)["state_dict"])  # whole weights, then cut
    place_state(rstate, mesh)
    probs2 = Predictor(whole_model(restored, mesh).eval(), None, dtype=torch.bfloat16)(pbatch)
    if not torch.equal(probs, probs2):
        raise RuntimeError("the restored checkpoint's predict differs")
    return {"loss": loss, "loss_whole": loss_whole, "data": mesh.data_size,
            "model": mesh.model_parallel, "batch": bs}


def dryrun_multichip(n_devices: int) -> None:
    """rxtpu's multi-chip dry run as ``n_devices`` gloo ranks on the CPU (see
    the module docstring); raises on any failure."""
    import multiprocessing as mp
    import queue

    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    with tempfile.TemporaryDirectory() as workdir:
        procs = [ctx.Process(target=_dryrun_rank, args=(r, n_devices, port, workdir, results))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        got = {}
        try:
            # drain the queue before joining: a rank blocks until its result is read
            for _ in range(n_devices):
                rank, out, err = results.get(timeout=RANK_TIMEOUT_S)
                if err is not None:
                    raise RuntimeError(f"dryrun_multichip rank {rank} failed:\n{err}")
                got[rank] = out
        except queue.Empty:
            raise RuntimeError(f"dryrun_multichip: ranks {sorted(set(range(n_devices)) - set(got))} "
                               f"gave no result within {RANK_TIMEOUT_S} s") from None
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    out = got[0]
    print(f"dryrun_multichip OK: resnet50/bf16/shear on {n_devices} gloo ranks, mesh "
          f"data={out['data']} model={out['model']}, global batch {out['batch']}, loss "
          f"{out['loss']:.4f} (whole batch at world 1 {out['loss_whole']:.4f}); G=6 predict "
          f"[{out['batch']}, {NB_CLASSES}] ok (+ int8 W8A8); checkpoint restore reproduces "
          f"predict")
