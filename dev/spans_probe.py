"""Run one benchmark cell through ``rxbench.run.execute`` with the port's
span recorder (``rxtpu_torch.utils.spans``) on over the window, or off, and
lay the port's spans on the device trace's idle gaps. No benchmark file
changes: the window's start, the program's end, the mode's record, the
trace's start and stop, and its idle attribution (whose gaps the probe
reads) are wrapped at run time in this process. It stays until the
benchmark reads the port's spans itself.

    python3 dev/spans_probe.py --workload W --seed N --seconds S --trace 0|1 \
        --recorder 0|1 --out result.json [--device cpu]

From the root of the repository, on a CUDA device (``--device cpu``
rehearses at a tiny size). It writes a JSON object: the result's metrics
and checks; per span the totals and, over the window after its traced
stretch (the base of ``input_wait_pct.*``), the share of time inside it
(``untraced_pct``) and its per-unit times; in a traced run, per consumer
span the idle time of the traced stretch that it overlaps, as % of the
stretch (``idle_in_pct``), and how far each ``pipeline.wait`` lies
outside the benchmark's ``host_in_next`` ranges (``clock_check``).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402

from rxbench import run, spec, trace  # noqa: E402

CONSUMER = ("pipeline.wait", "prefetch.stage", "predict.step", "predict.readback")
SHARES = ("pipeline.wait", "prefetch.stage", "pipeline.assemble", "predict.step",
          "predict.readback")


def overlap(a, b):
    """Total length of the intersection of two sets of intervals."""
    a = trace._union(np.asarray(a, np.int64).reshape(-1, 2))
    b = trace._union(np.asarray(b, np.int64).reshape(-1, 2))
    i = j = 0
    tot = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return int(tot)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--recorder", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    cell = spec.load().cell(a.workload)
    if a.device == "cpu":  # a rehearsal at a tiny size
        sys.path.insert(0, "rxbench/tests")
        from conftest import tiny_cell

        extra = {"crop": 48} if cell.traffic.get("crop") else {}
        cell = tiny_cell(a.workload, bs_per_device=4, src=64, **extra)
    run.cache_dirs()
    from rxtpu_torch.utils import spans

    got = {}
    orig_ws, orig_done = run.Job.window_start, run.Job.program_done

    def window_start(self):
        orig_ws(self)
        got["start_ns"] = time.perf_counter_ns()
        if a.recorder:
            got["rec"] = spans.start()

    def program_done(self):
        if a.recorder:
            spans.stop()
        orig_done(self)

    run.Job.window_start, run.Job.program_done = window_start, program_done
    orig_start, orig_stop = trace.DeviceTrace.start, trace.DeviceTrace.stop
    orig_attribute = trace._attribute

    def trace_start(self):
        orig_start(self)
        got["traced_from"] = time.time_ns()  # the window mark opened just before

    def trace_stop(self):
        orig_stop(self)
        got["traced_to"] = time.time_ns()

    def attribute(gaps, host):  # the reduction's own idle gaps and host spans
        got["gaps"], got["host"] = gaps, host
        return orig_attribute(gaps, host)

    trace.DeviceTrace.start, trace.DeviceTrace.stop = trace_start, trace_stop
    trace._attribute = attribute
    mode = cell.mode
    orig_run = mode.run

    def mode_run(job):
        rec = orig_run(job)
        got["record"] = rec
        return rec

    mode.run = mode_run
    import torch

    result = run.execute(cell, a.seed, a.seconds, bool(a.trace), a.device)
    out = {"workload": a.workload, "seed": a.seed, "trace": a.trace, "recorder": a.recorder,
           "correct": result["correct"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "checks": result["checks"], "device": result["device"],
           "breakdown": result.get("breakdown"),
           "card": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"}
    rec, record = got.get("rec"), got["record"]
    if rec is not None:
        s0 = got["start_ns"]
        traced_end = s0 + int(record.get("traced_s", 0.0) * 1e9)
        w_end = s0 + int(record["window_s"] * 1e9)
        unt_s = (w_end - traced_end) / 1e9
        kept = list(rec.spans)
        out["spans_kept"], out["dropped"] = len(kept), rec.dropped
        out["totals"] = {k: {"n": v[0], "s": v[1] / 1e9, "self_s": v[2] / 1e9}
                         for k, v in rec.totals.items()}
        out["counters"] = dict(rec.counters)
        out["untraced_s"] = unt_s
        shares = {}
        for name in SHARES:
            iv = [(s.start_ns, s.end_ns) for s in kept if s.name == name]
            shares[name] = 100.0 * overlap(iv, [(traced_end, w_end)]) / 1e9 / unt_s \
                if unt_s > 0 else None
        out["untraced_pct"] = shares
        # per-batch means over the untraced part
        per = {}
        for name in SHARES:
            d = [s.duration_ns / 1e6 for s in kept if s.name == name and s.start_ns >= traced_end]
            if d:
                per[name] = {"n": len(d), "mean_ms": float(np.mean(d)),
                             "p50_ms": float(np.median(d)), "max_ms": float(np.max(d))}
        out["per_unit_ms"] = per
        if "gaps" in got:
            gaps = got["gaps"]
            w0, w1 = got["traced_from"], got["traced_to"]
            wsec = result["device"]["window_s"]
            idle = {}
            for name in CONSUMER + ("pipeline.assemble",):
                iv = [(rec.wall_ns(s.start_ns), rec.wall_ns(s.end_ns)) for s in kept
                      if s.name == name]
                idle[name] = 100.0 * overlap(gaps, iv) / 1e9 / wsec
            consumer = [(rec.wall_ns(s.start_ns), rec.wall_ns(s.end_ns)) for s in kept
                        if s.name in CONSUMER]
            idle["none_of_the_consumers_spans"] = 100.0 * (
                (gaps[:, 1] - gaps[:, 0]).sum() - overlap(gaps, consumer)) / 1e9 / wsec
            idle["device_idle"] = 100.0 * (gaps[:, 1] - gaps[:, 0]).sum() / 1e9 / wsec
            out["idle_in_pct"] = idle
            out["trace_window_s"] = wsec
            out["n_gaps"] = int(len(gaps))
            # clock check: each port pipeline.wait inside the traced window against the
            # benchmark's host_in_next ranges (profiler stamps)
            nxt = sorted((s, t) for s, t, n in got["host"] if n == "host_in_next")
            offs = []
            for s in kept:
                if s.name != "pipeline.wait":
                    continue
                a0, a1 = rec.wall_ns(s.start_ns), rec.wall_ns(s.end_ns)
                if not (w0 <= a0 <= w1):
                    continue
                best = min(nxt, key=lambda r: max(r[0] - a0, a1 - r[1], 0), default=None)
                if best is not None:
                    offs.append(max(best[0] - a0, a1 - best[1], 0) / 1e6)
            out["clock_check"] = {"waits": len(offs),
                                  "outside_host_in_next_ms_max": max(offs) if offs else None,
                                  "outside_host_in_next_ms_p50": float(np.median(offs))
                                  if offs else None}
    out["record"] = {k: record[k] for k in ("window_s", "traced_s", "views", "units",
                                             "input_wait_s", "traced_input_wait_s")
                     if k in record}
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps({k: out.get(k) for k in ("workload", "seed", "trace", "recorder", "correct",
                                              "metrics", "untraced_pct", "idle_in_pct",
                                              "clock_check", "per_unit_ms", "counters")},
                     default=str))


if __name__ == "__main__":
    main()
