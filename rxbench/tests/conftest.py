"""Fixtures of the benchmark's own tests (run them with ``python -m pytest
rxbench/tests`` from the root of the repository)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """The CUDA device; the test skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny_cell(name: str, **traffic):
    """A cell of BENCHMARK.json at a size the CPU runs in seconds."""
    from rxbench import spec

    cell = spec.load().cell(name)
    small = {"bs_per_device": 8, "src": 96, "experiments": 1, "unique_views": 8,
             "trace_units": 2, "check_rows": 8}
    if cell.traffic.get("crop"):
        small["crop"] = 80
    cell.traffic = {**cell.traffic, **small, **traffic}
    return cell
