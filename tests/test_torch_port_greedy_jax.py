"""``--assign-method greedy_jax`` on the port: ``greedy_assign_jax`` (torch ops,
here on the CPU) bit-equal to rxtpu's ``greedy_assign_jax`` (a jitted
``fori_loop`` in f32) on seeded f32 inputs, exact ties, an all-zero row, more
rows than classes and f64 probabilities; and against the exact host
``greedy_assign`` where no near-ties exist.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rxtpu.infer.plate_leak import greedy_assign as rx_greedy_assign
from rxtpu.infer.plate_leak import greedy_assign_jax as rx_greedy_assign_jax
from rxtpu_torch.infer.plate_leak import greedy_assign, greedy_assign_jax, greedy_assign_loop


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check(preds: np.ndarray) -> np.ndarray:
    want = np.asarray(rx_greedy_assign_jax(preds))
    got = greedy_assign_jax(preds)
    assert got.dtype == want.dtype == np.float32 and got.shape == (preds.shape[0],)
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("n,c,seed", [(24, 16, 0), (16, 24, 1), (97, 97, 2), (277, 300, 3)])
def test_greedy_jax_bit_equal_to_rxtpu(n, c, seed):
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.full(c, 0.3), size=n).astype(np.float32)
    got = _check(probs)
    if n <= c:  # one class per row, each at most once
        assert len(set(got.tolist())) == n
    np.testing.assert_array_equal(got, greedy_assign(probs))  # no near-ties here
    np.testing.assert_array_equal(got, rx_greedy_assign(probs))


def test_greedy_jax_ties_zero_rows_and_more_rows_than_classes():
    # exact ties: equal rows and equal values within rows go to the first index
    ties = np.tile(np.asarray([[0.25, 0.25, 0.125, 0.125, 0.25]], np.float32), (4, 1))
    assert _check(ties).tolist() == [0.0, 1.0, 4.0, 2.0]
    ones = np.ones((6, 6), np.float32)
    np.testing.assert_array_equal(_check(ones), np.arange(6, dtype=np.float32))
    # an all-zero row: the zero-sum guard keeps it zero, it is assigned last
    rng = np.random.default_rng(5)
    zero_row = rng.dirichlet(np.ones(9), size=7).astype(np.float32)
    zero_row[2] = 0.0
    _check(zero_row)
    _check(np.zeros((5, 5), np.float32))
    # N > C: once every column is taken, the rest fall to row 0 and class 0
    _check(rng.dirichlet(np.ones(4), size=10).astype(np.float32))


def test_greedy_jax_f64_probabilities_go_to_f32():
    rng = np.random.default_rng(7)
    probs = rng.dirichlet(np.full(40, 0.5), size=33)
    assert probs.dtype == np.float64
    got = _check(probs)
    np.testing.assert_array_equal(got, greedy_assign_jax(probs.astype(np.float32)))
    # the loop itself takes any float tensor and computes in f32
    np.testing.assert_array_equal(greedy_assign_loop(torch.from_numpy(probs)).numpy(), got)
