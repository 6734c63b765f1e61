"""The entry point's refusals, and the check on what a run loaded."""

import os
import shutil
import subprocess
import sys

import pytest

from rxbench import run, spec

CMD = [sys.executable, "-m", "rxbench.run", "--workload", "resnet50-mlp.train", "--seed",
       str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"]


def _no_result(proc):
    return proc.returncode != 0 and not any(
        line.startswith("{") for line in proc.stdout.splitlines())


@pytest.fixture
def no_card_env():
    return {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


def test_refuses_without_a_card(no_card_env):
    proc = subprocess.run(CMD, cwd=spec.ROOT, env=no_card_env, capture_output=True, text=True,
                          timeout=300)
    assert _no_result(proc), proc.stdout
    assert "CUDA device" in proc.stderr


def test_refuses_with_only_the_benchmark(tmp_path, no_card_env):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(spec.ROOT, "rxbench"), tmp_path / "rxbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = {**no_card_env, "PYTHONPATH": ""}
    proc = subprocess.run(CMD, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert _no_result(proc)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "rxtpu_torch_like", sys)
    monkeypatch.delitem(sys.modules, "rxtpu", raising=False)
    assert "rxtpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rxtpu.models", sys)
    assert "rxtpu" in run.forbidden_modules()


def test_a_run_loads_neither_jax_nor_rxtpu():
    code = ("import sys, torch\n"
            "sys.path.insert(0, 'rxbench/tests')\n"
            "from conftest import tiny_cell\n"
            "from rxbench import run\n"
            "res = run.execute(tiny_cell('resnet50-mlp.train', bs_per_device=4, src=64,"
            " crop=48), 5, 0.1, True, 'cpu')\n"
            "assert set(res) >= {'correct', 'attempted', 'failed', 'metrics', 'device'}\n"
            "print('LOADED', run.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout
