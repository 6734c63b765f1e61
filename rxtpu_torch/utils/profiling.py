"""Profiling hooks (counterpart of ``rxtpu/utils/profiling.py``).

``trace`` wraps a region in ``torch.profiler`` (host activity, and the
card's kernels when a CUDA device is present) and writes a TensorBoard
trace (``*.pt.trace.json``, readable by TensorBoard's profiler plugin and
by Perfetto) into ``logdir``; the CLI's ``--profile`` wraps the whole
``run_training`` in it, into ``board/{experiment_id}/profile``.
``profile_step_loop`` runs a step loop under the port's ``StepTimer``
(input wait against step time), optionally under a trace.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Optional

import torch

from rxtpu_torch.train.metrics import StepTimer


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True):
    """Profile the region into ``logdir``; yields the ``torch.profiler.profile``
    (None when not enabled)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def profile_step_loop(step_fn: Callable, batches: Iterable, logdir: Optional[str] = None,
                      max_steps: int = 10) -> Dict[str, float]:
    """Run up to ``max_steps`` of ``step_fn(batch)``, under a trace when
    ``logdir`` is given; returns the ``StepTimer`` summary (step time, input
    stall %). On a card each step ends with ``torch.cuda.synchronize``:
    launches return at once, so without the wait the step time would be the
    host's enqueue time and the stall share meaningless."""
    timer = StepTimer()
    with trace(logdir, enabled=logdir is not None):
        it = iter(batches)
        for _ in range(max_steps):
            with timer.waiting():
                batch = next(it, None)
            if batch is None:
                break
            with timer.stepping():
                step_fn(batch)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
    return timer.summary()
