"""Train cells: the steps of the port's epoch loop, epochs chained.

Set-up writes the split's pack, makes the weights on the device from the
seed, builds the program's model, train state and step
(``rxtpu_torch.train.step.make_train_step``: augment K2-K4, autocast
forward, float32 cross-entropy, backward, masked nesterov SGD) and its feed
(``Pipeline.epoch`` over a ``PackStore``, then ``device_prefetch``), and
drives the first three steps through that same step and feed: they are the
steps the comparison checks (a forward hook on the program's model keeps
the first one's logits), and they warm every shape. The window then
runs the loop of ``run_training``'s epoch (the lag-one loss readback
included, validation and checkpoints left out) on the same objects until
``seconds`` have passed, epoch after epoch.

After the window the program is freed and the reference follows the first
three steps in float32 (``rxbench.reference``); ``rxbench.check`` compares.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch
import torch.nn.functional as F

from rxbench import check
from rxbench.reference import augment as ref_aug
from rxbench.reference import batches as ref_batches
from rxbench.reference.model import TwoSites, seeded_state
from rxbench.trace import DeviceTrace, Spans

CHECKED_STEPS = 3


def _lr(cfg: dict, batch: int, steps_per_epoch: int, step: int) -> float:
    """rxtpu's per-epoch cosine from ``lr_per_well`` x batch to 1% of it."""
    import math

    lr0 = cfg["lr_per_well"] * batch
    epoch = min(step // steps_per_epoch, cfg["nb_epochs"])
    eta_min = lr0 * 0.01
    return eta_min + (lr0 - eta_min) * 0.5 * (1.0 + math.cos(math.pi * epoch / cfg["nb_epochs"]))


def initial_state(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        shapes = TwoSites(cfg)
    return seeded_state(shapes, seed, device)


def decay_terms(cfg: dict, init: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each leaf's weight decay term in the first gradient, on the host."""
    return {n: cfg["weight_decay"] * t.cpu() for n, t in init.items()}


def program(job, ds, init: Dict[str, torch.Tensor]) -> dict:
    """Set-up, the checked steps and the window on the program. Returns the
    observations the comparison reads and the record the metrics read."""
    from rxtpu_torch.data.pack import PackStore
    from rxtpu_torch.data.pipeline import Pipeline, device_prefetch
    from rxtpu_torch.data.records import load_metadata
    from rxtpu_torch.models.twosites import TwoSitesNN
    from rxtpu_torch.train.optim import make_schedule
    from rxtpu_torch.train.step import TrainState, make_train_step

    cfg, tr, device, seed = job.cfg, job.traffic, job.device, job.seed
    batch, g = tr["bs_per_device"], tr["G"]
    model = TwoSitesNN(backbone=cfg["backbone"], nb_classes=cfg["nb_classes"],
                       size_features=cfg["size_features"], dropout=cfg["dropout"],
                       head=cfg["head"], arcface_margin=cfg["arcface_margin"],
                       arcface_scale=cfg["arcface_scale"], fuse_blocks=tr["fuse_blocks"])
    model.to(device)
    model.load_state_dict(init)
    index = load_metadata(ds.rows, ds.control_rows, "train")
    pipe = Pipeline(index, PackStore(ds.pack_path), ds.stats, batch_size=batch, mode="train",
                    seed=seed, prefetch_depth=tr["prefetch_depth"],
                    decoder_threads=tr["decoder_threads"])
    schedule = make_schedule(cfg["lr_per_well"] * batch, cfg["nb_epochs"], len(pipe), True)
    state = TrainState.create(model, schedule, momentum=cfg["momentum"],
                              nesterov=cfg["nesterov"], weight_decay=cfg["weight_decay"])
    step = make_train_step(model, tr["crop"], augment=tr["augment"],
                           compute_dtype=getattr(torch, tr["compute_dtype"]))
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())

    def feed():
        epoch = 1
        while True:
            gen = pipe.epoch(epoch)
            try:
                host = ({k: v for k, v in b.items() if k not in ("id_codes", "valid")}
                        for b in gen)
                yield from device_prefetch(host, device)
            finally:
                gen.close()
            epoch += 1

    spans = Spans()
    it = feed()

    def one(prev):
        with spans("host_in_next"):
            b = next(it)
        with spans("host_in_step"):
            m = step(state, b, seed, True)
        with spans("host_in_readback"):
            if prev is not None:  # lag-one readback, as run_training's
                float(prev["loss"])
        return m

    logits = []  # the program's own logits of the first step, read by a hook
    hook = model.register_forward_hook(
        lambda mod, args, out: logits.append(out.detach().float().cpu()))
    try:
        ms = [one(None)]
        hook.remove()
        # the first gradient as the optimizer got it: its momentum buffer
        g1 = {n: state.optimizer.state.get(p, {}).get("momentum_buffer", torch.zeros_like(p))
              .detach().to("cpu", copy=True) for n, p in zip(names, params)}
        for _ in range(CHECKED_STEPS - 1):
            ms.append(one(ms[-1]))
        delta = {n: p.detach().cpu() - init[n].cpu() for n, p in zip(names, params)}
        losses = [float(m["loss"]) for m in ms]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        job.window_start()

        spans.seconds.clear()
        trace = DeviceTrace(spans) if job.trace else None
        traced_steps, prev, units = [], ms[-1], 0
        traced = {"traced_s": 0.0, "traced_views": 0, "traced_input_wait_s": 0.0}
        t0 = time.perf_counter()

        def traced_so_far():
            return {"traced_s": time.perf_counter() - t0, "traced_views": units * batch * g,
                    "traced_input_wait_s": spans.seconds["host_in_next"]}

        tracing = trace is not None
        if tracing:
            trace.start()
        while True:
            if tracing and units == tr["trace_units"]:
                trace.stop()
                tracing = False
                traced = traced_so_far()
            prev = one(prev)
            units += 1
            if tracing:
                traced_steps.append(state.step - 1)
            if time.perf_counter() - t0 >= job.seconds:
                break
        if tracing:  # the window ended inside the traced stretch
            trace.stop()
            traced = traced_so_far()
        float(prev["loss"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    finally:
        it.close()
    record = {"mode": "train", "units": units, "views": units * batch * g,
              "window_s": window_s, "input_wait_s": spans.seconds["host_in_next"],
              "traced_steps": traced_steps, "steps_per_epoch": len(pipe), **traced,
              "trace": trace.reduce() if trace else None}
    del state, step, model, params, pipe, it, prev, ms
    gc.collect()
    return {"losses": losses, "logits1": logits, "g1": g1, "delta": delta, "record": record,
            "steps_per_epoch": record["steps_per_epoch"]}


def reference(job, ds, init: Dict[str, torch.Tensor], steps_per_epoch: int,
              quant=None, rows: int = None, autocast: torch.dtype = None) -> dict:
    """The first ``CHECKED_STEPS`` steps in float32 (TF32 off), from the
    same weights, rows and draws; ``quant`` computes convs and linears
    through it (the control); ``rows`` keeps the first rows of each batch
    only (a fault's reading); ``autocast`` runs the forward under
    ``torch.autocast`` in that dtype (a second witness of the program's
    rounding)."""
    cfg, tr, device, seed = job.cfg, job.traffic, job.device, job.seed
    batch, g, crop = tr["bs_per_device"], tr["G"], tr["crop"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        model = TwoSites(cfg, checkpoint=True).to(device)
        model.load_state_dict(init)
        model.ctx.quant = quant
        names = [n for n, _ in model.named_parameters()]
        params = list(model.parameters())
        wd, mu = cfg["weight_decay"], cfg["momentum"]
        bufs, losses, logits1, g1 = None, [], [], None
        for s in range(CHECKED_STEPS):
            b = ref_batches.train_batch(ds, seed, 1, s, batch, device)
            draws = ref_aug.draws(seed, s, batch * g, tr["src"], crop)
            views = ref_aug.augment(b["images"], b["mean"], b["std"], draws, crop)
            labels = b["labels"].long()
            if rows is not None:
                views, labels = views[:rows], labels[:rows]
            del b
            model.ctx.generator = torch.Generator(device=device).manual_seed(
                ref_aug.step_seed(seed, s, 1))
            with torch.autocast(device.type, dtype=autocast or torch.float32,
                                enabled=autocast is not None):
                logits = model(views, labels)
            loss = F.cross_entropy(logits.float(), labels)
            grads = torch.autograd.grad(loss, params)
            del views
            losses.append(float(loss.detach()))
            if s == 0:
                logits1.append(logits.detach().float().cpu())
            with torch.no_grad():
                gs = [gr + wd * p for gr, p in zip(grads, params)]
                if s == 0:
                    g1 = {n: t.cpu() for n, t in zip(names, gs)}
                    bufs = [t.clone() for t in gs]
                else:
                    bufs = [mu * bf + t for bf, t in zip(bufs, gs)]
                lr = _lr(cfg, batch, steps_per_epoch, s)
                for p, t, bf in zip(params, gs, bufs):
                    p -= lr * (t + mu * bf if cfg["nesterov"] else bf)
        delta = {n: p.detach().cpu() - init[n].cpu() for n, p in zip(names, params)}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return {"losses": losses, "logits1": logits1, "g1": g1, "delta": delta}


def run(job) -> dict:
    ds = job.dataset()
    init = initial_state(job.cfg, job.seed, job.device)
    prog = program(job, ds, init)
    job.program_done()
    ref = reference(job, ds, init, prog["steps_per_epoch"])
    numbers = check.train_numbers(prog, ref, decay_terms(job.cfg, init))
    prog["record"]["notes"] = {"loss": prog["losses"], "reference_loss": ref["losses"],
                               **numbers.pop("worst_leaves"),
                               **{k: v for k, v in numbers.items() if k not in job.cell.limits}}
    prog["record"]["checks"] = numbers
    return prog["record"]
