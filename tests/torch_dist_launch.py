"""Start the ranks of ``tests/torch_dist_worker.py`` for the port's
multi-rank tests (``tests/test_torch_port_dist*.py``) and collect their
results.

Each rank is a subprocess on the CPU with one intra-op thread, a free port
and a wall-clock limit: a rank that fails or hangs fails the test with
every rank's stderr, and no rank is left running.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Dict, List

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
RANK_TIMEOUT_S = 150


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(case: str, world: int, inp: Dict, tmp_path):
    """Start ``case`` of the worker in ``world`` gloo ranks (``finish`` waits)."""
    inp_path = str(tmp_path / f"{case}_w{world}_in.pt")
    torch.save(inp, inp_path)
    outs = [str(tmp_path / f"{case}_w{world}_r{r}.pt") for r in range(world)]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")])}
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, WORKER, case, str(r), str(world), port,
                               inp_path, outs[r]], cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(world)]
    return case, world, procs, outs, time.monotonic() + RANK_TIMEOUT_S


def finish(handle) -> List[Dict]:
    """Every rank's output. A rank that fails or outlives its wall-clock
    limit fails the test with every rank's stderr, and no rank is left
    running."""
    case, world, procs, outs, deadline = handle
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                logs.append(p.communicate())
                pytest.fail(f"{case} rank timed out after {RANK_TIMEOUT_S} s:\n"
                            + "\n".join(e for _, e in logs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode for p in procs):
        pytest.fail(f"{case} at world {world}: return codes "
                    f"{[p.returncode for p in procs]}\n" + "\n".join(e for _, e in logs))
    return [torch.load(o, weights_only=False) for o in outs]


def launch(case: str, world: int, inp: Dict, tmp_path) -> List[Dict]:
    return finish(start(case, world, inp, tmp_path))
