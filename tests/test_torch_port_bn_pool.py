"""rxtpu_torch's retired ops and the train loop's progress bar against
rxtpu's, on the CPU.

- ``bn_train_apply`` (NCHW) against rxtpu's custom-VJP ``bn_train_apply``
  (NHWC): ``y``, ``mean``, ``var`` and the ``torch.autograd`` gradients of
  ``sum(sin(y))`` against ``jax.grad``, at ``tests/test_batchnorm.py``'s
  tolerances; ``FusedBatchNorm``'s running statistics after two train
  steps and its eval output against flax's module (momentum 0.99, biased
  variance);
- ``max_pool_3x3s2`` forward and backward against rxtpu's, on generic
  inputs and on one with tied maxima, where both send the gradient to every
  maximum (torch's own backward sends it to one);
- ``progress_bar`` with stderr faked as a tty and a stub tqdm: one update
  per train step with a ``loss`` postfix, closed after each epoch; None when
  stderr is not a tty; one ``\\r`` line when tqdm is not installed.
"""

from __future__ import annotations

import importlib.machinery
import io
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rxtpu.ops.batchnorm import FusedBatchNorm as RxFusedBatchNorm
from rxtpu.ops.batchnorm import bn_train_apply as rx_bn_train_apply
from rxtpu.ops.maxpool import max_pool_3x3s2 as rx_max_pool_3x3s2
from rxtpu_torch import cli as port_cli
from rxtpu_torch.ops import FusedBatchNorm, batch_stats_one_pass, bn_train_apply, max_pool_3x3s2
from rxtpu_torch.train import loop as port_loop


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().numpy(), 1, -1)


def test_bn_train_apply_forward_and_grads_match_rxtpu():
    rng = np.random.default_rng(3)
    x = rng.normal(1.0, 2.0, (8, 5, 7, 16)).astype(np.float32)  # NHWC
    scale = rng.normal(1.0, 0.2, 16).astype(np.float32)
    bias = rng.normal(0.0, 0.2, 16).astype(np.float32)

    def loss_rx(x, s, b):
        return jnp.sum(jnp.sin(rx_bn_train_apply(x, s, b, 1e-5)[0]))

    want_y, want_mean, want_var = rx_bn_train_apply(jnp.asarray(x), jnp.asarray(scale),
                                                    jnp.asarray(bias), 1e-5)
    want_g = jax.grad(loss_rx, (0, 1, 2))(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    xt = _nchw(x).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    y, mean, var = bn_train_apply(xt, st, bt, 1e-5)
    assert not mean.requires_grad and not var.requires_grad
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(_nhwc(y), np.asarray(want_y), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(want_var), rtol=1e-5, atol=1e-5)
    for got, want in zip((_nhwc(xt.grad), st.grad.numpy(), bt.grad.numpy()), want_g):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-5)
    m, v = batch_stats_one_pass(_nchw(x))
    np.testing.assert_allclose(v.numpy(), x.var((0, 1, 2)), rtol=1e-4)
    assert torch.equal(m, mean)


def test_fused_batchnorm_running_stats_match_rxtpu():
    """Two train steps (momentum 0.99, the biased batch variance), then the
    eval output on the running statistics; bf16 input keeps its dtype."""
    rng = np.random.default_rng(0)
    xs = [rng.normal(2.0, 3.0, (4, 6, 6, 8)).astype(np.float32) for _ in range(2)]
    rx = RxFusedBatchNorm(use_running_average=False)
    variables = rx.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    port = FusedBatchNorm(8, use_running_average=False)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(rng.normal(1.0, 0.1, 8).astype(np.float32)))
        port.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.1, 8).astype(np.float32)))
    variables = {"params": {"scale": jnp.asarray(port.weight.detach().numpy()),
                            "bias": jnp.asarray(port.bias.detach().numpy())},
                 "batch_stats": variables["batch_stats"]}
    for x in xs:
        want, mut = rx.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {**variables, "batch_stats": mut["batch_stats"]}
        got = port(_nchw(x))
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(variables["batch_stats"]["mean"]), rtol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(variables["batch_stats"]["var"]), rtol=1e-6)
    want = RxFusedBatchNorm(use_running_average=True).apply(variables, jnp.asarray(xs[0]))
    port.use_running_average = None  # now given per call
    got = port(_nchw(xs[0]), use_running_average=True)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert port(_nchw(xs[0]).to(torch.bfloat16), use_running_average=True).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="exactly once"):
        port(_nchw(xs[0]))


def _pool_both(x: np.ndarray, dy: np.ndarray):
    """(port y, port dx, rxtpu y, rxtpu dx) for NHWC ``x`` and the cotangent ``dy``."""
    xt = _nchw(x).requires_grad_(True)
    y = max_pool_3x3s2(xt)
    (y * _nchw(dy)).sum().backward()
    ry, vjp = jax.vjp(rx_max_pool_3x3s2, jnp.asarray(x))
    (rdx,) = vjp(jnp.asarray(dy))
    return _nhwc(y), _nhwc(xt.grad), np.asarray(ry), np.asarray(rdx)


@pytest.mark.parametrize("h,w", [(9, 9), (10, 7), (182, 182)])
def test_max_pool_matches_rxtpu(h, w):
    rng = np.random.default_rng(h * w)
    c = 3 if h > 100 else 5
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    dy = rng.normal(size=(2, (h + 1) // 2, (w + 1) // 2, c)).astype(np.float32)
    y, dx, ry, rdx = _pool_both(x, dy)
    np.testing.assert_array_equal(y, ry)
    # an input position in up to four windows sums up to four dy terms, which
    # XLA may reassociate (measured: 4 of 810 values one f32 ulp apart); torch's backward too
    np.testing.assert_allclose(dx, rdx, rtol=1e-6, atol=1e-6)
    # generic inputs have no ties: torch's own backward agrees
    xt = _nchw(x).requires_grad_(True)
    (F.max_pool2d(xt, 3, 2, 1) * _nchw(dy)).sum().backward()
    np.testing.assert_allclose(_nhwc(xt.grad), dx, rtol=1e-6, atol=1e-6)
    assert ((_nhwc(xt.grad) != 0) == (dx != 0)).all()


def test_max_pool_ties_route_to_every_maximum():
    """A constant input: every window's nine values tie, so each input
    position gets the sum of the dy of every window that holds it, in both
    packages; torch's own backward gives each window's dy to one position."""
    x = np.ones((1, 6, 6, 2), np.float32)
    dy = np.random.default_rng(1).normal(size=(1, 3, 3, 2)).astype(np.float32)
    y, dx, ry, rdx = _pool_both(x, dy)
    np.testing.assert_array_equal(y, ry)
    np.testing.assert_allclose(dx, rdx, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dx[0, 1, 1], dy[0, 0, 0] + dy[0, 0, 1] + dy[0, 1, 0]
                               + dy[0, 1, 1], rtol=1e-6)
    xt = _nchw(x).requires_grad_(True)
    (F.max_pool2d(xt, 3, 2, 1) * _nchw(dy)).sum().backward()
    assert (_nhwc(xt.grad) != 0).sum() <= dy.size < (dx != 0).sum()


class _TTY(io.StringIO):
    def isatty(self) -> bool:
        return True


class _StubBar:
    made = []

    def __init__(self, total, desc, leave):
        self.total, self.desc, self.leave = total, desc, leave
        self.updates, self.postfix, self.closed = 0, [], False
        _StubBar.made.append(self)

    def update(self, n=1):
        self.updates += n

    def set_postfix(self, refresh=True, **kw):
        self.postfix.append(kw)

    def close(self):
        self.closed = True


def test_progress_bar_through_the_train_loop(tmp_path, monkeypatch):
    """The CLI's two epochs of 6 steps: one bar per epoch (``epoch 1``,
    ``epoch 2``), 6 updates each with a ``loss`` postfix (nan before the
    first lag-one readback), each closed."""
    from rxtpu_torch.data.synthetic import make_train_fixture

    fx = make_train_fixture(str(tmp_path / "fx"), nb_classes=8, n_experiments=3,
                            wells_per_experiment=6, n_test_wells=5, img_size=32)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "stderr", _TTY())
    stub = types.ModuleType("tqdm")
    stub.__spec__ = importlib.machinery.ModuleSpec("tqdm", None)
    stub.tqdm = _StubBar
    monkeypatch.setitem(sys.modules, "tqdm", stub)
    _StubBar.made = []
    argv = ["--experiment_id", "pb", "--pack", fx["pack_dir"], "--data-dir", fx["data_dir"],
            "--stats", fx["stats"], "--nb-classes", "8", "--backbone", "resnet18",
            "--crop-size", "24", "--epochs", "2", "--batch-size", "2",
            "--split-by-experiment", "--no-plate-leak", "--device", "cpu"]
    assert port_cli.main(argv) == 0
    assert [b.desc for b in _StubBar.made] == ["epoch 1", "epoch 2"]
    for bar in _StubBar.made:
        assert bar.total == bar.updates == len(bar.postfix) == 6 and bar.closed
        assert bar.postfix[0] == {"loss": "nan"}
        assert all(float(p["loss"]) > 0 for p in bar.postfix[1:])


def test_progress_bar_without_tty_or_tqdm(monkeypatch):
    monkeypatch.setattr(sys, "stderr", io.StringIO())
    assert port_loop.progress_bar(4, 1) is None
    tty = _TTY()
    monkeypatch.setattr(sys, "stderr", tty)
    monkeypatch.setitem(sys.modules, "tqdm", None)  # not installed
    bar = port_loop.progress_bar(4, 3)
    bar.update(1)
    bar.set_postfix(loss="2.500", refresh=False)
    bar.update(1)
    bar.close()
    out = tty.getvalue()
    assert out.startswith("\repoch 3: 1/4") and "\repoch 3: 2/4 loss=2.500" in out
    assert "\n" not in out and out.endswith("\r")
