"""Run one benchmark cell once and print its result line.

    python -m rxbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix,
limits, mode and metric readers are found by name (``rxbench.spec``). The
run refuses to report without a CUDA device, or with fewer than the cell
asks for, and exits non-zero without a result. Set-up (``setup_s``) runs
from the start of this process to the start of the window; the window
runs ``seconds``; after it the program is freed, the peak memory read and
the comparison with the reference made. The last lines on standard error
are the numbers compared, each beside its limit; the last line on
standard output is the result, whose ``checks`` key comes last.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Callable, Optional  # noqa: E402

from rxbench import spec  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "rxtpu"}


def cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    checkout's first run builds (the port's own nvcc builds go to
    ``rxtpu_torch/build``, fixed in its code, also inside the checkout)."""
    base = os.path.join(spec.ROOT, "rxbench", ".cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not run."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & FORBIDDEN)


class Job:
    """One run of one cell: what the mode reads, and the set-up clock."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
                 workdir: str):
        self.cell, self.cfg, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.workdir = device, workdir
        self.make_predictor: Optional[Callable] = None
        self.setup_s = self.peak_bytes = None

    def dataset(self):
        from rxbench.inputs import make_dataset

        return make_dataset(self.traffic, self.seed, self.workdir, self.device)

    def reset_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)

    def window_start(self) -> None:
        self.setup_s = time.perf_counter() - T0

    def program_done(self) -> None:
        """The program's peak memory, read before the reference runs; the
        program's state is freed."""
        import torch

        gc.collect()
        if self.device.type == "cuda":
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.empty_cache()


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """Run the cell on ``device`` and return its result object."""
    import torch

    workdir = tempfile.mkdtemp(prefix="rxbench-")
    try:
        job = Job(cell, seed, seconds, trace, torch.device(device), workdir)
        record = cell.mode.run(job)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    record.update(cfg=cell.config, traffic=cell.traffic, setup_s=job.setup_s,
                  peak_bytes=job.peak_bytes, seed=seed, device=job.device)
    from rxbench.check import judge

    checks = judge(record["checks"], cell.limits)
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in names:
        value = cell.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if job.device.type == "cuda" else job.device.type,
           "kind": torch.cuda.get_device_name(job.device) if job.device.type == "cuda"
           else "cpu", "count": 1, "memory_peak_bytes": job.peak_bytes}
    result = {"correct": all(c["ok"] for c in checks.values()), "attempted": record["units"],
              "failed": sum(not c["ok"] for c in checks.values()), "metrics": metrics,
              "device": dev}
    if trace and record["trace"] is not None:
        from rxbench.trace import breakdown

        dev["busy_s"] = record["trace"]["busy_s"]
        dev["window_s"] = record["trace"]["window_s"]
        result["breakdown"] = breakdown(record["trace"])
    # a number that is not finite goes out as its name: the line stays JSON
    result["checks"] = {n: {"value": c["value"] if math.isfinite(c["value"]) else str(c["value"]),
                            "limit": c["limit"]} for n, c in checks.items()}
    result["notes"] = record.get("notes", {})
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load().cell(args.workload)
    cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"rxbench: the cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    loaded = forbidden_modules()
    if loaded:
        print(f"rxbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, v in result.pop("notes").items():
        print(f"note {name} = {v!r}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
