"""Profiling hooks (counterpart of ``rxtpu/utils/profiling.py``).

``trace`` wraps a region in ``torch.profiler`` (host activity, and the
card's kernels when a CUDA device is present) and writes a TensorBoard
trace (``*.pt.trace.json``, readable by TensorBoard's profiler plugin and
by Perfetto) into ``logdir``. For the same region it turns the port's span
recorder on (``rxtpu_torch.utils.spans``, with a profiler range per span,
so the trace shows them in the threads the profiler sees) and writes
``spans.jsonl`` beside the trace: one line per span, from every thread,
with its ``name``, ``thread``, ``id``, ``parent`` (the enclosing span's
id), ``batch`` (the batch's index in its epoch), ``start_ns`` and
``end_ns`` on the profiler's clock and ``self_ns`` (less its children).
The names:

- ``pipeline.assemble``: the ``Pipeline``'s producer thread building one
  batch (a pack's memcpy or a decode);
- ``pipeline.wait``: the consumer waiting on the ``Pipeline``'s queue;
- ``prefetch.stage``: ``device_prefetch``'s pinned copy of one batch and
  the enqueue of its copy to the card (``stack_window``'s of one window);
- ``predict.step`` / ``predict.readback``: the test phase's step call and
  the wait for its probabilities on the host;
- ``train.input`` / ``train.step``: ``run_training``'s ``next()`` of the
  feed and the step (``StepTimer``'s two phases); ``train.readback``: the
  lag-one loss read inside the step; ``train.validate``;
  ``train.checkpoint``: the rolling checkpoint's save.

The CLI's ``--profile`` wraps the whole ``run_training`` in it, into
``board/{experiment_id}/profile``, and the test phase's predict loop, into
``board/{experiment_id}/profile/predict``; while the recorder is on,
``run_training`` writes each epoch's seconds per span and counter totals
on a ``perf`` line of ``metrics.jsonl`` after the epoch's rolling
checkpoint (``perf/queue_wait_s``, ``perf/stage_s``, ``perf/assemble_s``,
``perf/readback_s``, ``perf/staged_gib``, ``perf/checkpoint_s``, ...:
``PERF_SECONDS`` and ``PERF_COUNTERS`` of ``rxtpu_torch.train.loop``). ``profile_step_loop``
runs a step loop under the port's ``StepTimer`` (input wait against step
time), optionally under a trace.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Iterable, Optional

import torch

from rxtpu_torch.utils import spans


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True, worker_name: Optional[str] = None):
    """Profile the region into ``logdir``; yields the ``torch.profiler.profile``
    (None when not enabled). ``worker_name`` starts the trace file's name
    (default: host and process id), so each rank of a run names its own, and
    the spans' (``{worker_name}.spans.jsonl``; ``spans.jsonl`` without one).
    Where a span recorder is on already, it is left to its owner."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir, worker_name)) as prof, \
            spans.recording(enabled=not spans.ON, ranges=True) as rec:
        yield prof
    if rec is not None:
        os.makedirs(logdir, exist_ok=True)
        rec.write_jsonl(os.path.join(
            logdir, f"{worker_name}.spans.jsonl" if worker_name else "spans.jsonl"))


def profile_step_loop(step_fn: Callable, batches: Iterable, logdir: Optional[str] = None,
                      max_steps: int = 10) -> Dict[str, float]:
    """Run up to ``max_steps`` of ``step_fn(batch)``, under a trace when
    ``logdir`` is given; returns the ``StepTimer`` summary (step time, input
    stall %). On a card each step ends with ``torch.cuda.synchronize``:
    launches return at once, so without the wait the step time would be the
    host's enqueue time and the stall share meaningless."""
    from rxtpu_torch.train.metrics import StepTimer  # train.metrics imports utils.spans

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
