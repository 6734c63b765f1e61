"""The port's span recorder (``rxtpu_torch.utils.spans``) on the CPU.

- off (the default), an epoch of a ``PackStore`` ``Pipeline`` through
  ``device_prefetch`` records nothing;
- on: one ``pipeline.assemble`` per batch on the producer thread, one
  ``pipeline.wait`` and one ``prefetch.stage`` per batch on the consumer,
  the staged bytes the arrays' ``nbytes``, one batch's spans sharing their
  ``batch``; a span's self time is its duration less its children's;
- ``predict_dataset``: ``predict.step`` and ``predict.readback`` once a
  batch, and once a window with ``scan_window`` 2;
- the clock pair maps a span within 1 ms of a ``record_function`` range
  around it; no span opens a profiler range unless asked to;
- ``StepTimer``'s summary is its sums, its phases the ``train.*`` spans;
- the CLI's ``--profile`` writes ``spans.jsonl`` for training and for the
  test phase, and the epoch's ``perf/`` totals on a line of their own.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import rxtpu_torch.cli as port_cli
from rxtpu_torch.data.pack import PackStore
from rxtpu_torch.data.pipeline import Pipeline, device_prefetch
from rxtpu_torch.data.records import load_metadata, read_metadata_csvs
from rxtpu_torch.data.stats import load_stats
from rxtpu_torch.data.synthetic import make_test_fixture, make_train_fixture
from rxtpu_torch.infer.predict import predict_dataset
from rxtpu_torch.train.metrics import StepTimer
from rxtpu_torch.utils import spans

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_recorder_left_on():
    yield
    spans.stop()


@pytest.fixture(scope="module")
def test_pipe(tmp_path_factory):
    """A 5-batch test pipeline (9 wells, batches of 2: the last holds one)."""
    fx = make_test_fixture(str(tmp_path_factory.mktemp("spans")), nb_classes=16,
                           n_test_wells=9, img_size=32)
    rows, ctrl = read_metadata_csvs(fx["data_dir"] + "/metadata", "test")
    pipe = Pipeline(load_metadata(rows, ctrl, "test"), PackStore(fx["pack"]),
                    load_stats(fx["stats"]), 2)
    assert len(pipe) == 5
    return pipe


def _drain(pipe):
    host = ({k: v for k, v in b.items() if k != "id_codes"} for b in pipe.epoch(0))
    return list(device_prefetch(host, CPU))


def _by_name(rec):
    out = {}
    for s in rec.spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_records_nothing(test_pipe):
    rec = spans.start()
    spans.stop()
    assert not spans.ON and spans.current() is None
    assert len(_drain(test_pipe)) == 5
    assert not rec.spans and not rec.totals and not rec.counters
    assert spans.span("pipeline.wait") is spans.span("predict.step")  # one shared no-op
    assert spans.begin("train.step") is None


def test_pipeline_spans_and_counters(test_pipe):
    with spans.recording() as rec:
        batches = _drain(test_pipe)
    by = _by_name(rec)
    assert sorted(by) == ["pipeline.assemble", "pipeline.wait", "prefetch.stage"]
    for name in by:
        assert sorted(s.batch for s in by[name]) == [0, 1, 2, 3, 4], name
    assert {s.thread for s in by["pipeline.assemble"]} == {"pipeline-producer"}
    me = threading.current_thread().name
    assert {s.thread for s in by["pipeline.wait"] + by["prefetch.stage"]} == {me}
    # one batch's wait comes before its staging, on the consumer
    for w, st in zip(sorted(by["pipeline.wait"], key=lambda s: s.batch),
                     sorted(by["prefetch.stage"], key=lambda s: s.batch)):
        assert w.batch == st.batch and w.end_ns <= st.start_ns
    arrays = sum(v.numel() * v.element_size() for b in batches for v in b.values()
                 if isinstance(v, torch.Tensor))
    assert rec.counters["prefetch.staged_bytes"] == arrays
    assert rec.counters["pipeline.assembled_bytes"] == arrays
    assert rec.counters["pipeline.gets"] == 5
    assert 0 <= rec.counters["pipeline.gets_empty"] <= 5
    assert rec.totals["pipeline.wait"][0] == 5
    assert all(s.parent is None and s.self_ns == s.duration_ns >= 0 for s in rec.spans)


def test_self_time_and_totals():
    with spans.recording() as rec:
        with spans.span("outer", batch=7):
            time.sleep(0.002)
            with spans.span("inner"):
                time.sleep(0.003)
            with spans.span("inner", batch=8):
                time.sleep(0.001)
        spans.count("n", 2)
        spans.count("n")
    inner, outer = sorted(rec.spans, key=lambda s: (s.name, s.start_ns))[:2], rec.spans[-1]
    assert outer.name == "outer" and [s.batch for s in inner] == [7, 8]
    assert all(s.parent == outer.id for s in inner)
    assert outer.child_ns == sum(s.duration_ns for s in inner)
    assert outer.self_ns == outer.duration_ns - outer.child_ns >= 2_000_000
    assert rec.totals["inner"][:2] == [2, sum(s.duration_ns for s in inner)]
    assert rec.totals["outer"][2] == outer.self_ns
    assert rec.counters == {"n": 3}


def test_bounded_buffer_keeps_exact_totals():
    with spans.recording(max_spans=3) as rec:
        for i in range(5):
            with spans.span("s", batch=i):
                pass
        before = rec.snapshot()
        with spans.span("s"):
            pass
        spans.count("c", 4)
    assert [s.batch for s in rec.spans] == [3, 4, None] and rec.dropped == 3
    assert rec.totals["s"][0] == 6
    d = rec.since(before)
    assert d["counts"] == {"s": 1} and d["counters"] == {"c": 4}


def _step(batch):
    return torch.softmax(batch["images"].float().mean((1, 2, 3, 4))[:, None].repeat(1, 3), -1)


@pytest.mark.parametrize("window", [1, 2])
def test_predict_spans(test_pipe, window):
    with spans.recording() as rec:
        probs, ids = predict_dataset(_step, test_pipe, CPU, scan_window=window)
    assert probs.shape == (9, 3) and len(ids) == 9
    by = _by_name(rec)
    units = 5 if window == 1 else 3  # windows of 2 over 5 batches
    for name in ("predict.step", "predict.readback"):
        assert sorted(s.batch for s in by[name]) == list(range(units)), name
    assert len(by["prefetch.stage"]) == units
    assert sorted(s.batch for s in by["pipeline.wait"]) == [0, 1, 2, 3, 4]
    one = next(iter(test_pipe.epoch(0)))  # every batch is padded to one size
    staged = sum(v.nbytes for k, v in one.items() if isinstance(v, np.ndarray) and k != "valid")
    # windows of 2 stage the tail window's pad batch too
    assert rec.counters["prefetch.staged_bytes"] == (5 if window == 1 else 6) * staged


def _events(prof):
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()]


def test_clock_maps_onto_the_profiler():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        with spans.recording() as rec:
            with record_function("around"):
                with spans.span("probe"):
                    time.sleep(0.005)
    (s,) = rec.spans
    (_, r0, r1), = [e for e in _events(prof) if e[0] == "around"]
    assert abs(rec.wall_ns(s.start_ns) - r0) < 1_000_000
    assert abs(rec.wall_ns(s.end_ns) - r1) < 1_000_000
    row = next(rec.rows())
    assert (row["start_ns"], row["end_ns"]) == (rec.wall_ns(s.start_ns), rec.wall_ns(s.end_ns))


@pytest.mark.parametrize("ranges", [False, True])
def test_profiler_ranges_only_when_asked(test_pipe, ranges):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.recording(ranges=ranges) as rec:
            predict_dataset(_step, test_pipe, CPU)
    names = {n for n, _, _ in _events(prof)}
    mine = {"pipeline.wait", "prefetch.stage", "predict.step", "predict.readback"}
    assert mine <= set(rec.totals)
    assert (names & set(rec.totals)) == (mine if ranges else set())


def test_step_timer_keeps_its_sums():
    timer = StepTimer()
    with spans.recording() as rec:
        for i in range(3):
            with timer.waiting(i):
                time.sleep(0.002)
            with timer.stepping(i):
                time.sleep(0.004)
    by = _by_name(rec)
    assert [s.batch for s in by["train.input"]] == [0, 1, 2]
    assert [s.batch for s in by["train.step"]] == [0, 1, 2]
    assert timer.wait_s == pytest.approx(sum(s.duration_ns for s in by["train.input"]) / 1e9)
    assert timer.step_s == pytest.approx(sum(s.duration_ns for s in by["train.step"]) / 1e9)
    s = timer.summary()
    assert sorted(s) == ["input_stall_pct", "step_time_s"] and timer.n_steps == 3
    assert s["step_time_s"] == pytest.approx(timer.step_s / 3)
    assert s["input_stall_pct"] == pytest.approx(100 * timer.wait_s / (timer.wait_s + timer.step_s))
    off = StepTimer()  # no recorder: the same sums, no span
    with off.stepping():
        time.sleep(0.002)
    assert off.n_steps == 1 and off.step_s >= 0.002


def test_cli_profile_writes_spans_and_perf(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    make_train_fixture("fx", nb_classes=8, wells_per_experiment=6, n_test_wells=5, img_size=64)
    assert port_cli.main([
        "--pack", "fx/packs", "--data-dir", "fx/data", "--stats", "fx/stats_experiments.json",
        "--experiment_id", "sp", "--nb-classes", "8", "--backbone", "resnet18",
        "--crop-size", "48", "--epochs", "1", "--batch-size", "2", "--split-by-experiment",
        "--no-plate-leak", "--device", "cpu", "--profile"]) in (0, None)
    assert not spans.ON
    with open("board/sp/profile/spans.jsonl") as f:
        rows = [json.loads(line) for line in f]
    names = {r["name"] for r in rows}
    assert {"train.input", "train.step", "train.readback", "train.validate",
            "train.checkpoint", "pipeline.wait", "pipeline.assemble",
            "prefetch.stage"} <= names
    steps = [r for r in rows if r["name"] == "train.step"]
    assert [r["batch"] for r in steps] == list(range(len(steps)))
    ids = {r["id"]: r for r in rows}
    for r in rows:
        if r["name"] == "train.readback":
            assert ids[r["parent"]]["name"] == "train.step"
            assert r["batch"] == ids[r["parent"]]["batch"] - 1
    with open("board/sp/metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    perf = [i for i, r in enumerate(lines) if any(k.startswith("perf/") for k in r)]
    assert len(perf) == 2  # StepTimer's before validation, the spans' after the checkpoint
    timer, p = lines[perf[0]], lines[perf[1]]
    assert sorted(timer) == ["perf/input_stall_pct", "perf/step_time_s", "step"]
    assert any(k.startswith("validation/") for r in lines[perf[0] + 1:perf[1]] for k in r)
    for key in ("queue_wait_s", "stage_s", "assemble_s", "readback_s", "validate_s",
                "checkpoint_s", "staged_gib", "assembled_gib", "gets", "gets_empty"):
        assert np.isfinite(p[f"perf/{key}"]), key
    assert p["perf/checkpoint_s"] > 0 and p["perf/staged_gib"] > 0
    with open("board/sp/profile/predict/spans.jsonl") as f:
        rows = [json.loads(line) for line in f]
    by = {}
    for r in rows:
        by.setdefault(r["name"], []).append(r["batch"])
    assert {"predict.step", "predict.readback", "pipeline.wait", "prefetch.stage",
            "pipeline.assemble"} <= set(by)
    assert not any(n.startswith("train.") for n in by)
    # one step and one readback a batch of each test experiment
    want = sorted(by["pipeline.wait"])
    assert sorted(by["predict.step"]) == sorted(by["predict.readback"]) == want
    trace_files = [n for n in os.listdir("board/sp/profile") if n.endswith(".pt.trace.json")]
    with open(os.path.join("board/sp/profile", trace_files[0])) as f:
        traced = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train.step", "train.input"} <= traced  # --profile asks for ranges


def test_threads_lose_no_update():
    """Sixteen recording threads, switching every microsecond: every span
    and count lands in the totals."""
    import sys

    n_threads, n = 16, 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with spans.recording(max_spans=10) as rec:
            def work(k):
                for i in range(n):
                    with spans.span("outer", batch=k):
                        with spans.span("inner"):
                            spans.count("c")

            threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert rec.totals["outer"][0] == rec.totals["inner"][0] == n_threads * n
    assert rec.counters["c"] == n_threads * n
    assert rec.totals["outer"][1] - rec.totals["outer"][2] == rec.totals["inner"][1]
    assert len(rec.spans) == 10 and rec.dropped == 2 * n_threads * n - 10
