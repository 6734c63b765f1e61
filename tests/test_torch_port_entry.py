"""rxtpu_torch.entry against ``__graft_entry__.py``, on the CPU: ``entry()``'s
seeded ResNet-50 eval forward in bf16 against rxtpu's ``TwoSitesNN.apply``
on the same input, weights carried across by ``models/convert.py``
``to_flax``; ``dryrun_multichip(2)`` (two gloo ranks, data 1 x model 2)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rxtpu.models.twosites import TwoSitesNN as FlaxTwoSitesNN
from rxtpu_torch import entry as port_entry
from rxtpu_torch.models.convert import to_flax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_matches_rxtpu_apply():
    """The forward on ``x`` itself: [2, 1108] f32, finite, the same bits over
    two calls, and within 1e-2 of max|logit| of rxtpu's bf16 forward (the
    two round bf16 convs and sums at other places; measured 0.5% on a small
    input)."""
    fn, (x,) = port_entry.entry(device="cpu")
    assert x.dtype == torch.bfloat16 and tuple(x.shape) == (2, 3, 6, 364, 364)
    got = fn(x)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 1108)
    assert bool(torch.isfinite(got).all()) and torch.equal(got, fn(x))
    params, stats = to_flax(port_entry._seeded_resnet50().state_dict())
    flax_model = FlaxTwoSitesNN(backbone="resnet50", nb_classes=1108)
    x_nhwc = jnp.asarray(np.moveaxis(x.float().numpy(), 2, -1)).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(lambda v, xx: flax_model.apply(v, xx, train=False))(
        {"params": params, "batch_stats": stats}, x_nhwc), np.float32)
    scale = np.abs(want).max()
    assert scale > 1e-3
    np.testing.assert_allclose(got.numpy(), want, atol=1e-2 * scale, rtol=0)


def test_entry_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()


def test_dryrun_multichip_two_ranks(capsys):
    port_entry.dryrun_multichip(2)
    out = capsys.readouterr().out
    assert "dryrun_multichip OK" in out and "data=1 model=2" in out
    with pytest.raises(ValueError):
        port_entry.dryrun_multichip(0)
