"""Host spans of the benchmark's loop and the device trace of a traced run.

``Spans`` times named host regions of the benchmark's own loop on the host
clock (the input wait reads them), and in a traced run also marks them for
the profiler, so that the device's idle gaps can be laid against what the
host was doing. Spans of one kind may nest; the innermost one names the
time.

``DeviceTrace`` runs ``torch.profiler`` (host and CUDA activity) over part
of the window and reduces it: the union of the device's operation
intervals (kernels, copies, fills) inside the traced window is its busy
time, the rest its idle time; idle time is split by the host span that was
open, ``host_in_other`` where none was; device time is summed per kernel
name.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

WINDOW_MARK = "rxbench_window"


class Spans:
    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.marking = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        mark = torch.profiler.record_function(name) if self.marking else None
        if mark is not None:
            mark.__enter__()
        try:
            yield
        finally:
            if mark is not None:
                mark.__exit__(None, None, None)
            self.seconds[name] += time.perf_counter() - t


def _union(intervals: np.ndarray) -> np.ndarray:
    """Sorted, merged [start, end) rows of an [n, 2] array."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.int64)


def _attribute(gaps: np.ndarray, spans: List[Tuple[int, int, str]]) -> Dict[str, float]:
    """Seconds of the ``gaps`` (merged [start, end) ns) under each host span,
    the innermost (latest opened) where spans nest."""
    cuts = sorted({t for s, e, _ in spans for t in (s, e)})
    out: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        points = [g0] + cuts[bisect.bisect_right(cuts, g0):bisect.bisect_left(cuts, g1)] + [g1]
        for a, b in zip(points[:-1], points[1:]):
            mid = (a + b) / 2
            open_ = [(s, name) for s, e, name in spans if s <= mid < e]
            out[max(open_)[1] if open_ else "host_in_other"] += (b - a) / 1e9
    return out


class DeviceTrace:
    """One profiled stretch of a run: ``start()``, the units, ``stop()``."""

    def __init__(self, spans: Spans):
        self.spans, self.prof, self._mark = spans, None, None
        self.units = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU]
                            + ([ProfilerActivity.CUDA] if cuda else []))
        self.prof.__enter__()
        self.spans.marking = True
        self._mark = torch.profiler.record_function(WINDOW_MARK)
        self._mark.__enter__()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self.spans.marking = False
        self.prof.__exit__(None, None, None)

    def reduce(self) -> Optional[dict]:
        """{window_s, busy_s, kernels: {name: [seconds, count]}, idle: {span:
        seconds}}, or None when the profiler saw no device operation."""
        window = None
        device, host = [], []
        per_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for e in self.prof.profiler.kineto_results.events():
            name, s, t = e.name(), e.start_ns(), e.end_ns()
            mark = name == WINDOW_MARK or name.startswith("host_in_")
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not mark:  # kernels, copies, fills; not a range's device shadow
                    device.append((s, t))
                    per_name[name][0] += (t - s) / 1e9
                    per_name[name][1] += 1
            elif mark and name == WINDOW_MARK:
                window = (s, t)
            elif mark:
                host.append((s, t, name))
        if window is None or not device:
            return None
        w0, w1 = window
        iv = np.clip(np.asarray(device, dtype=np.int64), w0, w1)
        busy = _union(iv)
        starts = np.concatenate([[w0], busy[:, 1]])
        ends = np.concatenate([busy[:, 0], [w1]])
        gaps = np.stack([starts, ends], 1)
        gaps = gaps[gaps[:, 1] > gaps[:, 0]]
        return {"window_s": (w1 - w0) / 1e9,
                "busy_s": float((busy[:, 1] - busy[:, 0]).sum()) / 1e9,
                "kernels": dict(per_name),
                "idle": dict(_attribute(gaps, host))}


def breakdown(trace: dict) -> dict:
    """The ten device operations that took most time and the idle gaps by
    host span, as [name, seconds] lists."""
    ops = sorted(((n, v[0]) for n, v in trace["kernels"].items()), key=lambda x: -x[1])
    idle = sorted(trace["idle"].items(), key=lambda x: -x[1])
    return {"device_ops": [[n[:120], s] for n, s in ops[:10]],
            "idle_gaps": [[n, s] for n, s in idle[:10]]}


def kernel_seconds(trace: dict, match) -> Tuple[float, int]:
    """Summed device seconds and launches of the kernels whose name ``match`` accepts."""
    secs, count = 0.0, 0
    for name, (s, n) in trace["kernels"].items():
        if match(name):
            secs, count = secs + s, count + n
    return secs, count


def untraced(rec: dict) -> Optional[Tuple[int, float, float]]:
    """(views, seconds, input-wait seconds) of the window outside its traced
    stretch, where the profiler's cost does not reach; None where the window
    ran nothing there."""
    views = rec["views"] - rec.get("traced_views", 0)
    seconds = rec["window_s"] - rec.get("traced_s", 0.0)
    if views <= 0 or seconds <= 0:
        return None
    return views, seconds, rec["input_wait_s"] - rec.get("traced_input_wait_s", 0.0)
