"""Spans and counters of the port's host work, off unless turned on.

A span is one named stretch of one thread's work: its name, thread, start
and end (``time.perf_counter_ns``), the span open around it on the same
thread (its parent) and a ``batch`` attribute, the batch's index in its
epoch (a window's index in the windowed predict), so that one batch's
assembly, wait and staging link up. Counters are named integer sums::

    rec = spans.start()
    with spans.span("pipeline.wait", batch=i):
        item = q.get()
    spans.count("pipeline.gets")
    spans.stop()              # rec.spans, rec.totals, rec.counters

``recording()`` does the same as a context manager. While no recorder is
on (the default), a span site costs one check of the module flag ``ON``
and records nothing; a site whose counter is dear to compute tests ``ON``
itself. Finished spans are kept in memory in a bounded buffer
(``max_spans``; the oldest go first, ``dropped`` counts them) and handed
out at the end; the per-name totals (count, seconds, self seconds: a
span's duration less its children's) and the counters are exact however
long the run.

Clock: the recorder takes one pair (``perf_counter_ns``, ``time_ns``) when
it starts; ``wall_ns`` maps a stamp of any thread onto ``time_ns``'s clock,
which is the clock of ``torch.profiler``'s event stamps, so the spans can
be laid on a device trace. With ``ranges=True`` every span also opens a
``torch.profiler.record_function`` range of its name, which a profiler
captures in the threads it sees (not in one started before it). Off by
default: a range's device shadow would count as device work in a trace's
busy time.

The names the port records, and where:

- ``pipeline.assemble`` (producer thread): ``Pipeline._make_batch`` of one
  batch; counter ``pipeline.assembled_bytes``, its arrays' bytes;
- ``pipeline.wait`` (consumer): the consumer's get from the ``Pipeline``'s
  queue; counters ``pipeline.gets`` and ``pipeline.gets_empty`` (the queue
  was empty at the get);
- ``prefetch.stage`` (consumer): ``device_prefetch``'s put of one batch
  (``pin_memory()`` and the ``non_blocking`` copy's enqueue) and
  ``stack_window``'s stacking of one window; counter
  ``prefetch.staged_bytes``, the host arrays' bytes;
- ``predict.step``, ``predict.readback``: ``predict_dataset``'s step call
  and its ``.cpu()``; in the windowed predict the replay's call and the
  wait for the window's output copy;
- ``train.input``, ``train.step``, ``train.readback``, ``train.validate``,
  ``train.checkpoint``: ``run_training``'s ``next()`` of the feed, the step
  (the lag-one readback inside it), the lag-one ``float(loss)``, validation
  (its own feed's spans inside it) and the rolling checkpoint's save.

This module imports nothing of the port.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

ON = False
_rec: Optional["Recorder"] = None
_ids = itertools.count(1)
_local = threading.local()


class Span:
    """One finished span. Stamps are ``perf_counter_ns``."""

    __slots__ = ("name", "thread", "id", "parent", "batch", "start_ns", "end_ns", "child_ns")

    def __init__(self, name, thread, id_, parent, batch, start_ns, end_ns, child_ns):
        self.name, self.thread, self.id, self.parent = name, thread, id_, parent
        self.batch, self.start_ns, self.end_ns, self.child_ns = batch, start_ns, end_ns, child_ns

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def self_ns(self) -> int:
        return self.duration_ns - self.child_ns


class _Open:
    """A span begun and not yet ended."""

    __slots__ = ("rec", "name", "thread", "id", "parent", "batch", "start_ns", "child_ns",
                 "range")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        end(self)


class _Null:
    """What ``span`` gives while no recorder is on."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_NULL = _Null()


class Recorder:
    def __init__(self, max_spans: int = 200_000, ranges: bool = False):
        self.ranges = ranges
        self.spans: deque = deque(maxlen=max_spans)
        self.dropped = 0
        self.totals: Dict[str, List[int]] = {}  # name -> [count, ns, self ns]
        self.counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.active = True
        self.clock = (time.perf_counter_ns(), time.time_ns())

    def wall_ns(self, t: int) -> int:
        """A ``perf_counter_ns`` stamp on ``time_ns``'s (the profiler's) clock."""
        return t - self.clock[0] + self.clock[1]

    def _finish(self, s: Span) -> None:
        with self._lock:
            if not self.active:
                return
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(s)
            tot = self.totals.get(s.name)
            if tot is None:
                tot = self.totals[s.name] = [0, 0, 0]
            tot[0] += 1
            tot[1] += s.duration_ns
            tot[2] += s.self_ns

    def _count(self, name: str, n: int) -> None:
        with self._lock:
            if self.active:
                self.counters[name] = self.counters.get(name, 0) + n

    def snapshot(self) -> dict:
        """Totals and counters so far, to subtract later (``since``)."""
        with self._lock:
            return {"totals": {k: list(v) for k, v in self.totals.items()},
                    "counters": dict(self.counters)}

    def since(self, before: dict) -> dict:
        """{"seconds": {name: s}, "counts": {name: n}, "counters": {name: n}}
        of what was recorded after the ``snapshot`` ``before``."""
        now = self.snapshot()
        seconds, counts = {}, {}
        for name, (n, ns, _) in now["totals"].items():
            n0, ns0, _ = before["totals"].get(name, (0, 0, 0))
            seconds[name], counts[name] = (ns - ns0) / 1e9, n - n0
        counters = {k: v - before["counters"].get(k, 0) for k, v in now["counters"].items()}
        return {"seconds": seconds, "counts": counts, "counters": counters}

    def rows(self) -> Iterator[dict]:
        """The kept spans as dicts, stamps on the profiler's clock (ns)."""
        with self._lock:
            kept = list(self.spans)
        for s in kept:
            yield {"name": s.name, "thread": s.thread, "id": s.id, "parent": s.parent,
                   "batch": s.batch, "start_ns": self.wall_ns(s.start_ns),
                   "end_ns": self.wall_ns(s.end_ns), "self_ns": s.self_ns}

    def write_jsonl(self, path: str) -> None:
        """One line per kept span (``rows``)."""
        with open(path, "w") as f:
            for row in self.rows():
                f.write(json.dumps(row) + "\n")


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        _local.thread = threading.current_thread().name
    return stack


def note_batch(i: Optional[int]) -> None:
    """The batch this thread handed out last (``Pipeline.epoch``'s consumer;
    None once the epoch ends): the ``batch`` of this recorder's spans on the
    thread that name none and have no enclosing span."""
    if ON:
        _local.batch = (_rec, i)


def begin(name: str, batch: Optional[int] = None, t: Optional[int] = None
          ) -> Optional[_Open]:
    """Open a span on this thread (None while no recorder is on). ``batch``
    defaults to the enclosing span's, else to the thread's ``note_batch``;
    ``t`` to now."""
    if not ON:
        return None
    rec = _rec
    if rec is None:  # stopped by another thread since
        return None
    stack = _stack()
    parent = stack[-1] if stack else None
    o = _Open()
    o.rec, o.name, o.thread, o.id = rec, name, _local.thread, next(_ids)
    o.parent = parent.id if parent is not None else None
    if batch is None:
        if parent is not None:
            batch = parent.batch
        else:
            noted = getattr(_local, "batch", None)
            batch = noted[1] if noted is not None and noted[0] is rec else None
    o.batch = batch
    o.child_ns = 0
    o.range = None
    if rec.ranges:
        import torch

        o.range = torch.profiler.record_function(name)
        o.range.__enter__()
    stack.append(o)
    o.start_ns = time.perf_counter_ns() if t is None else t
    return o


def end(o: Optional[_Open], t: Optional[int] = None) -> None:
    """Close ``o`` (from ``begin``; None does nothing) at ``t`` (default now)."""
    if o is None:
        return
    t = time.perf_counter_ns() if t is None else t
    stack = _stack()
    if stack and stack[-1] is o:
        stack.pop()
    if o.range is not None:
        o.range.__exit__(None, None, None)
    d = t - o.start_ns
    if stack and stack[-1].rec is o.rec:
        stack[-1].child_ns += d
    o.rec._finish(Span(o.name, o.thread, o.id, o.parent, o.batch, o.start_ns, t, o.child_ns))


def span(name: str, batch: Optional[int] = None):
    """A context manager over ``begin`` / ``end``."""
    if not ON:
        return _NULL
    return begin(name, batch)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if ON:
        rec = _rec
        if rec is not None:
            rec._count(name, int(n))


def start(max_spans: int = 200_000, ranges: bool = False) -> Recorder:
    """Turn a new recorder on; it stays on until ``stop``."""
    global ON, _rec
    if ON:
        raise RuntimeError("a span recorder is already on")
    _rec = Recorder(max_spans, ranges)
    ON = True
    return _rec


def stop() -> Optional[Recorder]:
    """Turn the recorder off and return it (None if none was on). Spans
    still open then are not recorded."""
    global ON, _rec
    rec, ON, _rec = _rec, False, None
    if rec is not None:
        with rec._lock:
            rec.active = False
    return rec


def current() -> Optional[Recorder]:
    """The recorder that is on, or None."""
    return _rec


@contextlib.contextmanager
def recording(enabled: bool = True, max_spans: int = 200_000, ranges: bool = False):
    """Yield a recorder that is on for the block (None when not ``enabled``)."""
    if not enabled:
        yield None
        return
    rec = start(max_spans, ranges)
    try:
        yield rec
    finally:
        stop()
