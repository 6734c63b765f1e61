"""Find a cell's pieces by the names ``BENCHMARK.json`` gives them.

- configuration ``<config>``: the JSON file that its ``configs`` entry names;
- traffic mix ``<traffic>``: ``rxbench/traffic/<traffic>.json``; its
  ``mode`` names the module ``rxbench/modes/<mode>.py`` that runs it;
- limits of cell ``<workload>``: ``rxbench/limits/<workload>.json``;
- metric ``<metric>``: the reader ``rxbench/metrics/<metric>.py``, whose
  ``read(record)`` returns the value or None when it finds nothing to read.

A cell reports each end-to-end and per-layer metric that lists it under
``workloads``, or that lists no cells.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import Callable, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "rxbench")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def mode(self):
        return importlib.import_module(f"rxbench.modes.{self.traffic['mode']}")

    @staticmethod
    def reader(metric: str) -> Callable[[dict], object]:
        path = os.path.join(BENCH, "metrics", f"{metric}.py")
        mod_spec = importlib.util.spec_from_file_location(f"rxbench_metric_{metric}", path)
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
        return module.read


class Benchmark:
    def __init__(self, doc: dict):
        self.doc = doc
        self.configs = {c["name"]: c for c in doc["configs"]}
        self.workloads = {w["name"]: w for w in doc["workloads"]}

    def cell(self, name: str) -> Cell:
        if name not in self.workloads:
            raise SystemExit(f"rxbench: no workload {name!r} in BENCHMARK.json")
        w = self.workloads[name]
        config = _json(os.path.join(ROOT, self.configs[w["config"]]["file"]))
        traffic = _json(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
        limits = _json(os.path.join(BENCH, "limits", f"{name}.json"))

        def mine(metrics):
            return [m for m in metrics if "workloads" not in m or name in m["workloads"]]

        return Cell(name, w["chips"], config, traffic, limits, mine(self.doc["end_to_end"]),
                    mine(self.doc["per_layer"]))


def load(path: str = None) -> Benchmark:
    return Benchmark(_json(path or os.path.join(ROOT, "BENCHMARK.json")))
