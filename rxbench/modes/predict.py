"""Predict cells: the port's test phase, pass after pass.

Set-up writes the split's pack, makes the weights on the device from the
seed, gives their BatchNorms sound running statistics (the reference
model's batch statistics of a calibration batch: random weights with unit
statistics would blow the activations up layer by layer), builds the
program's ``Predictor`` (``rxtpu_torch.infer.fold.fold``: the BN-folded
twin in bf16 behind K1) and a test ``Pipeline``, and runs
``predict_dataset`` over the first ``warm_batches`` batches: every shape,
the pinned-memory cache and the pack's pages are warm before the window. The window calls ``predict_dataset`` over the whole
split, pass after pass, until ``seconds`` have passed.

After the window the program is freed; every answer's well and
probability sum are checked, and a sample of the answers, drawn from the
seed, against the float32 reference's (``rxbench.check``).
"""

from __future__ import annotations

import gc
import resource
import time
from typing import Dict, List

import numpy as np
import torch

from rxbench import check
from rxbench.reference import batches as ref_batches
from rxbench.reference.model import TwoSites, seeded_state
from rxbench.trace import DeviceTrace, Spans

CALIBRATION_WELLS = 32
REFERENCE_CHUNK = 4


class TimedPipe:
    """The test pipeline as ``predict_dataset`` drains it, with the host's
    wait for each batch under a ``host_in_next`` span; ``batches`` (None:
    all) ends each epoch early, for the warm-up."""

    def __init__(self, pipe, spans: Spans, batches: int = None):
        self.pipe, self.spans, self.batches = pipe, spans, batches

    def epoch(self, epoch: int = 0, start_batch: int = 0):
        gen = self.pipe.epoch(epoch, start_batch)
        try:
            for _ in range(len(self.pipe) if self.batches is None else self.batches):
                with self.spans("host_in_next"):
                    item = next(gen, None)
                if item is None:
                    return
                yield item
        finally:
            gen.close()


def _minor_faults() -> int:
    """The process's minor page faults so far: memory touched for the first time."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_minflt


def normalized(batch: Dict[str, torch.Tensor], crop: int = None) -> torch.Tensor:
    """float32 ``(x/255 - mean)/std`` views of a uint8 batch, center-cropped
    to ``crop`` (None: full size)."""
    x = batch["images"]
    if crop is not None:
        off = (x.shape[-1] - crop) // 2
        x = x[..., off:off + crop, off:off + crop]
    x = x.float() / 255.0
    shape = (x.shape[0], 1, x.shape[2], 1, 1)
    return (x - batch["mean"].view(shape)) / batch["std"].view(shape)


@torch.no_grad()
def calibrated_state(job, ds) -> Dict[str, torch.Tensor]:
    """The seeded weights with each BN's running statistics set to its batch
    statistics over wells spread evenly over the split, by the reference
    model."""
    with torch.device("meta"):
        shapes = TwoSites(job.cfg)
    init = seeded_state(shapes, job.seed, job.device)
    model = TwoSites(job.cfg).to(job.device)
    model.load_state_dict(init)
    model.ctx.bn_mode = "calibrate"
    step = max(1, len(ds.rows) // CALIBRATION_WELLS)
    wells = list(range(0, step * CALIBRATION_WELLS, step))[:CALIBRATION_WELLS]
    batch, _ = ref_batches.test_rows(ds, wells, job.seed, job.device)
    model(normalized(batch, job.traffic["crop"]))
    out = {k: v.clone() for k, v in model.state_dict().items()}
    del model, batch
    return out


def program(job, ds, weights: Dict[str, torch.Tensor]) -> dict:
    from rxtpu_torch.data.pack import PackStore
    from rxtpu_torch.data.pipeline import Pipeline
    from rxtpu_torch.data.records import load_metadata
    from rxtpu_torch.infer.predict import Predictor, predict_dataset
    from rxtpu_torch.models.twosites import TwoSitesNN

    cfg, tr, device, seed = job.cfg, job.traffic, job.device, job.seed
    model = TwoSitesNN(backbone=cfg["backbone"], nb_classes=cfg["nb_classes"],
                       size_features=cfg["size_features"], dropout=cfg["dropout"],
                       head=cfg["head"], arcface_margin=cfg["arcface_margin"],
                       arcface_scale=cfg["arcface_scale"])
    model.to(device)
    model.load_state_dict(weights)
    model.eval()
    step = job.make_predictor(model) if job.make_predictor else Predictor(
        model, crop_size=tr["crop"], tta="none", dtype=getattr(torch, tr["compute_dtype"]))
    del model
    index = load_metadata(ds.rows, ds.control_rows, "test")
    pipe = Pipeline(index, PackStore(ds.pack_path), ds.stats, batch_size=tr["bs_per_device"],
                    mode="test", seed=seed, prefetch_depth=tr["prefetch_depth"],
                    decoder_threads=tr["decoder_threads"])
    # the warm-up runs the window's own path over the first batches: it
    # builds every kernel, fills the pinned-memory cache and maps the pack
    predict_dataset(step, TimedPipe(pipe, Spans(), tr["warm_batches"]), device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    job.window_start()

    spans = Spans()
    timed = TimedPipe(pipe, spans)
    trace = DeviceTrace(spans) if job.trace else None
    passes: List[tuple] = []
    per_pass = {"pass_s": [], "pass_next_s": [], "pass_minflt": []}
    traced = {"traced_s": 0.0, "traced_views": 0, "traced_input_wait_s": 0.0}
    t0 = time.perf_counter()
    while True:
        tracing = trace is not None and not passes
        if tracing:
            trace.start()
        t, waited, faults = time.perf_counter(), spans.seconds["host_in_next"], _minor_faults()
        with spans("host_in_step"):
            probs, ids = predict_dataset(step, timed, device)
        if tracing:
            trace.stop()
        now = time.perf_counter()
        passes.append((probs, ids))
        for key, v in zip(per_pass, (now - t, spans.seconds["host_in_next"] - waited,
                                     _minor_faults() - faults)):
            per_pass[key].append(v)
        if tracing:
            traced = {"traced_s": now - t0, "traced_views": len(ids) * tr["G"],
                      "traced_input_wait_s": spans.seconds["host_in_next"]}
        if now - t0 >= job.seconds:
            break
    window_s = time.perf_counter() - t0
    record = {"mode": "predict", "units": len(passes) * len(pipe),
              "views": sum(len(ids) for _, ids in passes) * tr["G"], "window_s": window_s,
              "input_wait_s": spans.seconds["host_in_next"], "passes": len(passes),
              "batches_per_pass": len(pipe), "trace": trace.reduce() if trace else None,
              **traced, "notes": per_pass}
    del step, pipe, timed
    gc.collect()
    return {"passes": passes, "record": record}


@torch.no_grad()
def reference_logprobs(job, ds, weights, positions: List[int]) -> np.ndarray:
    """float32 log-probabilities of the wells at ``positions`` (TF32 off)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        model = TwoSites(job.cfg).to(job.device)
        model.load_state_dict(weights)
        model.ctx.bn_mode = "eval"
        out = []
        for i in range(0, len(positions), REFERENCE_CHUNK):
            batch, _ = ref_batches.test_rows(ds, positions[i:i + REFERENCE_CHUNK], job.seed,
                                             job.device)
            views = normalized(batch, job.traffic["crop"])
            out.append(torch.log_softmax(model(views), -1).double().cpu())
        return torch.cat(out).numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def sample(job, passes: List[tuple]) -> List[tuple]:
    """(pass, row) pairs drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence((job.seed, 0xC4EC)))
    n = len(passes[0][1])
    k = min(job.traffic["check_rows"], n)
    return [(int(rng.integers(0, len(passes))), int(r)) for r in rng.choice(n, k, replace=False)]


def run(job) -> dict:
    ds = job.dataset()
    weights = calibrated_state(job, ds)
    job.reset_peak()
    prog = program(job, ds, weights)
    job.program_done()
    picks = sample(job, prog["passes"])
    ref = reference_logprobs(job, ds, weights, [r for _, r in picks])
    expected = [r["id_code"] for r in ds.rows]
    numbers = check.predict_numbers(prog["passes"], expected, picks, ref)
    prog["record"]["checks"] = numbers
    prog["record"]["notes"].update({k: v for k, v in numbers.items()
                                    if k not in job.cell.limits})
    return prog["record"]
