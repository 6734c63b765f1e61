"""Metric logging and step timing (counterpart of ``rxtpu/train/metrics.py``).

``MetricLogger`` appends JSON lines to ``{board_dir}/{experiment_id}/
metrics.jsonl`` and flushes each one. ``StepTimer`` splits a training
loop's wall time into waiting for input and stepping; ``input_stall_pct``
is the waiting share. Its two phases are also the spans ``train.input``
and ``train.step`` of ``rxtpu_torch.utils.spans`` while a recorder is on.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from rxtpu_torch.utils import spans

class MetricLogger:
    def __init__(self, board_dir: str, experiment_id: str):
        self.dir = os.path.join(board_dir, experiment_id)
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "") -> None:
        rec = {"step": int(step)}
        for k, v in metrics.items():
            rec[f"{prefix}/{k}" if prefix else k] = float(v)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StepTimer:
    """Wall-clock accounting of a training loop::

        with timer.waiting():   batch = next(it)       # input time
        with timer.stepping():  m = step(state, ...)   # step time

    ``batch`` (the batch's index in its epoch) goes to the phase's span.
    """

    def __init__(self):
        self.reset()

    class _Phase:
        def __init__(self, timer, attr, name, batch):
            self.timer, self.attr, self.name, self.batch = timer, attr, name, batch

        def __enter__(self):
            self.t0 = time.perf_counter_ns()
            self.span = spans.begin(self.name, self.batch, self.t0)

        def __exit__(self, *exc):
            t1 = time.perf_counter_ns()
            spans.end(self.span, t1)
            dt = (t1 - self.t0) / 1e9
            setattr(self.timer, self.attr, getattr(self.timer, self.attr) + dt)
            if self.attr == "step_s":
                self.timer.n_steps += 1

    def waiting(self, batch: Optional[int] = None):
        return self._Phase(self, "wait_s", "train.input", batch)

    def stepping(self, batch: Optional[int] = None):
        return self._Phase(self, "step_s", "train.step", batch)

    @property
    def total_s(self) -> float:
        return self.wait_s + self.step_s

    @property
    def stall_fraction(self) -> float:
        return self.wait_s / self.total_s if self.total_s > 0 else 0.0

    @property
    def mean_step_s(self) -> float:
        return self.step_s / self.n_steps if self.n_steps else 0.0

    def reset(self) -> None:
        self.wait_s = self.step_s = 0.0
        self.n_steps = 0

    def summary(self) -> Dict[str, float]:
        return {"step_time_s": self.mean_step_s,
                "input_stall_pct": 100.0 * self.stall_fraction}
