"""BENCHMARK.json against the benchmark's contract, and every cell resolved
to its files by name."""

import json
import os
import re

import pytest

from rxbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DOC = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in DOC["workloads"]]


def test_top_level_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert DOC["paths"] == ["rxbench"]
    assert 1 <= DOC["run_seconds"] <= 51 and isinstance(DOC["run_seconds"], int)
    assert len(json.dumps(DOC)) < 64 * 1024


def test_names_units_and_keys():
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("rxbench/")
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
    for m in DOC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in DOC["per_layer"]:
        assert m["moves"] in {e["name"] for e in DOC["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.load().cell(name)
    assert cell.mode.run
    assert cell.config["name"] == [w for w in DOC["workloads"] if w["name"] == name][0]["config"]
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]))
    assert all(isinstance(v, (int, float)) for v in cell.limits.values())


@pytest.mark.parametrize("name", CELLS)
def test_per_layer_moves_a_metric_the_cell_reports(name):
    cell = spec.load().cell(name)
    reported = {m["name"] for m in cell.end_to_end}
    assert all(m["moves"] in reported for m in cell.per_layer)


def test_setup_s_is_reported_on_every_workload():
    setup = [m for m in DOC["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
