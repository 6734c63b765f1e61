"""The readings that a cell's limits are set from, many seeds in one process.

    python -m rxbench.readings --workload <name> --seeds 1,2,3 --what program,control,half

At the cell's own size, on the card, for each seed, the numbers that
decide ``correct`` (``rxbench.check``), as one JSON line each:

- ``program``: the program against the reference, as a run compares them
  (a train cell's first three steps; a predict cell's one pass);
- ``control``: the same comparison with the program's place taken by the
  nearest lower precision than the configuration's bf16: for a train cell
  the reference computed in float8 as H100 recipes compute it (conv and
  linear inputs and weights in e4m3, their outputs' gradients in e5m2,
  accumulation and outputs unrounded: ``reference.model.Float8``), for a
  predict cell the program's own int8 path (``--quantize int8``:
  ``calibrate``, ``prepare_quantized``, ``QuantPredictor``);
- ``half`` (train): the reference with half of each batch left out, the
  mean taken over the rest, in the program's place;
- ``bf16`` (train): the reference under ``torch.autocast`` in bf16 in the
  program's place: a second witness of what bf16 rounding alone reads.

A seed's numbers are the lower reading's (``program``) or an upper
reading's (the others); the limits sit between them.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile

import torch

from rxbench import check, spec
from rxbench.run import Job, cache_dirs


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def train_readings(job, what):
    from rxbench.modes import train as T
    from rxbench.reference.model import Float8

    ds = job.dataset()
    init = T.initial_state(job.cfg, job.seed, job.device)
    spe = len(ds.rows) // job.traffic["bs_per_device"]
    out = {}
    ref = T.reference(job, ds, init, spe)
    decay = T.decay_terms(job.cfg, init)
    if "program" in what:
        prog = T.program(job, ds, init)
        _free()
        out["program"] = check.train_numbers(prog, ref, decay)
    if "control" in what:
        out["control"] = check.train_numbers(
            T.reference(job, ds, init, spe, quant=Float8()), ref, decay)
    if "bf16" in what:
        out["bf16"] = check.train_numbers(
            T.reference(job, ds, init, spe, autocast=torch.bfloat16), ref, decay)
    if "half" in what:
        out["half"] = check.train_numbers(
            T.reference(job, ds, init, spe, rows=job.traffic["bs_per_device"] // 2), ref, decay)
    return out


def predict_readings(job, what):
    from rxbench.modes import predict as P
    from rxbench.reference import batches as ref_batches

    ds = job.dataset()
    weights = P.calibrated_state(job, ds)
    expected = [r["id_code"] for r in ds.rows]
    out = {}
    for kind in ("program", "control"):
        if kind not in what:
            continue
        if kind == "control":
            job.make_predictor = lambda model: _int8_predictor(model, ds, job, ref_batches)
        prog = P.program(job, ds, weights)
        _free()
        picks = P.sample(job, prog["passes"])
        ref = P.reference_logprobs(job, ds, weights, [r for _, r in picks])
        out[kind] = check.predict_numbers(prog["passes"], expected, picks, ref)
        job.make_predictor = None
    return out


def _int8_predictor(model, ds, job, ref_batches):
    """The program's int8 test phase, calibrated on the split's first batch
    as the CLI's ``--calib-batches 1``."""
    from rxtpu_torch.infer.quant import QuantPredictor, calibrate, prepare_quantized

    rows = list(range(job.traffic["bs_per_device"]))
    batch, _ = ref_batches.test_rows(ds, rows, job.seed, job.device)
    batch = {k: batch[k] for k in ("images", "mean", "std")}
    qstats = calibrate(model, [batch], None, torch.bfloat16)
    return QuantPredictor(prepare_quantized(model, qstats, torch.bfloat16), None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program,control,half")
    args = ap.parse_args(argv)
    cell = spec.load().cell(args.workload)
    cache_dirs()
    if not torch.cuda.is_available():
        print("rxbench.readings: no CUDA device", file=sys.stderr)
        return 2
    what = set(args.what.split(","))
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory(prefix="rxbench-") as workdir:
            job = Job(cell, seed, 0.0, False, torch.device("cuda"), workdir)
            fn = train_readings if cell.traffic["mode"] == "train" else predict_readings
            for kind, numbers in fn(job, what).items():
                print(json.dumps({"workload": cell.name, "seed": seed, "what": kind,
                                  "numbers": numbers}), flush=True)
        _free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
