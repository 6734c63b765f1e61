"""rxtpu_torch's training pieces against rxtpu's, in f32 on the CPU: the
train-mode BatchNorm, the train forward, one and two SGD steps of the train
step (frozen and unfrozen backbone), the optimizer against optax, the LR
schedule, the eval step, the pretrained port and the initialization.

Tolerances. A single train-mode BN agrees to f32 rounding. Through a
network, every train-mode BN divides by its batch's std, so the convs'
f32 summation-order differences (XLA's CPU convs vs oneDNN's) are
amplified layer by layer (``tests/test_torch_parity.py:339``): logits
agree to atol 1e-4 * max(1, max|logit|), the loss to rtol 1e-5 and the
gradient norms to rtol 1e-3. Parameters are compared through their
updates (new - old): measured after two steps of a resnet18 at most 1.1%
relative L2 for one tensor (a deep BN bias) and 2e-4 over all of them, so
the bounds are 3e-2 per tensor and 1e-3 overall. A wrong weight decay,
momentum, nesterov term or freeze mask moves an update by O(100%).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rxtpu.config import Config, ModelConfig, TrainConfig
from rxtpu.models.norm import BatchNorm as FlaxBatchNorm
from rxtpu.models.twosites import TwoSitesNN as FlaxTwoSitesNN
from rxtpu.train import optim as rx_optim
from rxtpu.train.setup import build_model as rx_build_model
from rxtpu.train.setup import create_train_state as rx_create_train_state
from rxtpu.train.step import make_eval_step as rx_make_eval_step
from rxtpu.train.step import make_train_step as rx_make_train_step
from rxtpu_torch.models.convert import from_flax
from rxtpu_torch.models.norm import BatchNorm, Dropout
from rxtpu_torch.models.resnet import BottleneckBlock, init_weights, make_backbone
from rxtpu_torch.models.twosites import TwoSitesNN
from rxtpu_torch.train import optim
from rxtpu_torch.train.step import EvalStep, TrainState, make_train_step
from test_torch_port_models import assert_logits_close, randomize_flax

KW = dict(backbone="resnet18", nb_classes=8, size_features=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes run as fast on one intra-op thread, and the suite runs
    test files in parallel workers that would otherwise each start one
    thread per core and contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(16, 5), (4, 7, 6, 5)])
def test_batchnorm_train_matches_rxtpu(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, shape).astype(np.float32)
    c = shape[-1]
    variables = {
        "params": {"scale": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32),
                   "bias": jnp.asarray(rng.normal(0, 0.1, c), jnp.float32)},
        "batch_stats": {"mean": jnp.asarray(rng.normal(0, 0.1, c), jnp.float32),
                        "var": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)},
    }
    ref, mutated = FlaxBatchNorm(use_running_average=False).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(c)
    bn.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())  # channels second
    out = bn.train()(xt)
    np.testing.assert_allclose(np.moveaxis(out.detach().numpy(), 1, -1), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    n = x.size // c
    assert n > 1
    # the running variance is stored unbiased: n/(n-1) off the biased one
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]), rtol=1e-6)
    biased = x.reshape(-1, c).var(axis=0)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 * variables["batch_stats"]["var"] + 0.1 * biased * n / (n - 1),
                               rtol=1e-5)
    out.sum().backward()  # gradients flow through the batch statistics
    assert bn.weight.grad is not None and torch.isfinite(bn.weight.grad).all()


def test_two_sites_train_forward_matches_rxtpu():
    flax_model = FlaxTwoSitesNN(**KW, dropout=0.0, dtype=jnp.float32)
    x = np.random.default_rng(1).normal(size=(4, 3, 48, 48, 6)).astype(np.float32)
    variables = randomize_flax(
        flax_model.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False), 2)
    ref, mutated = flax_model.apply(variables, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
    port = TwoSitesNN(**KW, dropout=0.0)
    port.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    out = port.train()(torch.from_numpy(np.moveaxis(x, -1, 2).copy()))
    assert out.dtype == torch.float32 and out.shape == (4, 8)
    assert_logits_close(out.detach().numpy(), np.asarray(ref))
    new = from_flax(variables["params"], mutated["batch_stats"])
    for k in ("backbone.bn_init.running_var", "head.bn1.running_var", "head.bn2.running_mean"):
        np.testing.assert_allclose(port.state_dict()[k].numpy(), new[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def _rx_state(lr=0.05, bs=4):
    cfg = Config(model=ModelConfig(**KW, dropout=0.0, compute_dtype="float32"),
                 train=TrainConfig(bs_per_device=bs, lr=lr, nb_epochs=3), experiment_id="x")
    model = rx_build_model(cfg)
    state, lr = rx_create_train_state(cfg, model, steps_per_epoch=1)
    return cfg, model, state, lr


def _trace(opt_state):
    return opt_state[0].trace  # optax.sgd = chain(trace, scale_by_learning_rate)


def _rel(u: np.ndarray, u_ref: np.ndarray) -> float:
    return float(np.linalg.norm(u - u_ref) / max(np.linalg.norm(u_ref), 1e-30))


@pytest.mark.parametrize("backbone_trainable", [False, True])
def test_sgd_steps_match_rxtpu(backbone_trainable):
    cfg, flax_model, state, lr = _rx_state()
    b = cfg.train.bs_per_device
    rng = np.random.default_rng(0)
    views = rng.normal(size=(b, 3, 6, 48, 48)).astype(np.float32)
    labels = rng.integers(0, 8, b).astype(np.int32)
    rx_step = rx_make_train_step(flax_model, 48, donate=False, augment="none")

    port = TwoSitesNN(**KW, dropout=0.0)
    params0 = from_flax(jax.device_get(state.params), jax.device_get(state.batch_stats))
    port.load_state_dict(params0)
    pstate = TrainState.create(port, optim.make_schedule(lr, 3, 1),
                               weight_decay=cfg.train.weight_decay)
    step = make_train_step(port, 48, augment="none", compute_dtype=torch.float32)
    names = [n for n, _ in port.named_parameters()]

    for i in range(2):
        state, m = rx_step(
            state, {"images": jnp.asarray(np.transpose(views, (0, 1, 3, 4, 2))),
                    "labels": jnp.asarray(labels), "mean": jnp.zeros((b, 6)),
                    "std": jnp.ones((b, 6))},
            jax.random.PRNGKey(0), jnp.asarray(backbone_trainable))
        pm = step(pstate, {"images": torch.from_numpy(views),
                           "labels": torch.from_numpy(labels),
                           "mean": torch.zeros(b, 6), "std": torch.ones(b, 6)},
                  0, backbone_trainable)
        assert pstate.step == int(state.step) == i + 1
        assert sorted(pm) == sorted(m)
        np.testing.assert_allclose(float(pm["loss"]), float(m["loss"]), rtol=1e-5)
        assert float(pm["accuracy"]) == float(m["accuracy"])
        assert float(pm["lr"]) == pytest.approx(float(m["lr"]), rel=1e-6)
        for k in ("grad_norm", "grad_norm/backbone", "grad_norm/head"):
            np.testing.assert_allclose(float(pm[k]), float(m[k]), rtol=1e-3, err_msg=k)

        ref = from_flax(jax.device_get(state.params), jax.device_get(state.batch_stats))
        got = port.state_dict()
        buffers = [pstate.optimizer.state[p]["momentum_buffer"] for p in port.parameters()]
        trace = from_flax(jax.device_get(_trace(state.opt_state)))
        num = den = 0.0
        for k in ref:
            u, u_ref = got[k].numpy() - params0[k].numpy(), ref[k].numpy() - params0[k].numpy()
            frozen = not backbone_trainable and k.startswith("backbone.")
            if frozen and k in names:
                # frozen: unchanged to the bit, momentum exactly zero
                assert np.array_equal(got[k].numpy(), params0[k].numpy()), k
                assert not buffers[names.index(k)].any(), k
                continue
            if np.linalg.norm(u_ref) > 0:
                assert _rel(u, u_ref) < 3e-2, (k, _rel(u, u_ref))
            num += float(np.linalg.norm(u - u_ref)) ** 2
            den += float(np.linalg.norm(u_ref)) ** 2
        assert den > 0 and (num / den) ** 0.5 < 1e-3
        for name, buf in zip(names, buffers):
            if backbone_trainable or not name.startswith("backbone."):
                assert _rel(buf.numpy(), trace[name].numpy()) < 3e-2, name


def test_torch_sgd_computes_optax_nesterov():
    """torch.optim.SGD(nesterov, weight_decay=0) fed g + wd*p follows
    optax.sgd(nesterov=True): the same trace and parameters over steps with
    a changing lr, to f32 rounding (torch may fuse ``p - lr*d`` into an FMA)."""
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(64,)).astype(np.float32)
    grads = rng.normal(size=(5, 64)).astype(np.float32)
    lrs = [0.1, 0.1, 0.05, 0.05, 0.01]
    wd = 3e-5
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = optim.make_optimizer([p])
    tx = optax.sgd(learning_rate=lambda step: jnp.asarray(lrs)[step], momentum=0.9,
                   nesterov=True)
    params, opt_state = jnp.asarray(p0), None
    opt_state = tx.init(params)
    for g, lr in zip(grads, lrs):
        p.grad = torch.from_numpy(g.copy())
        optim.masked_grads_with_wd([p], [True], wd)
        opt.param_groups[0]["lr"] = lr
        opt.step()
        g_in = jnp.asarray(g) + wd * params
        updates, opt_state = tx.update(g_in, opt_state, params)
        params = optax.apply_updates(params, updates)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(opt.state[p]["momentum_buffer"].numpy(),
                               np.asarray(_trace(opt_state)), rtol=1e-6, atol=1e-7)
    # a frozen parameter: zero optimizer input, zero momentum, no move
    q = torch.nn.Parameter(torch.ones(3))
    q.grad = torch.full((3,), 5.0)
    opt_q = optim.make_optimizer([q])
    optim.masked_grads_with_wd([q], [False], wd)
    opt_q.param_groups[0]["lr"] = 0.1
    opt_q.step()
    assert torch.equal(q.detach(), torch.ones(3))
    assert not opt_q.state[q]["momentum_buffer"].any()


@pytest.mark.parametrize("scheduler", [True, False])
def test_lr_schedule_matches_rxtpu(scheduler):
    for lr, epochs, spe in ((0.008, 100, 7), (0.05, 3, 2), (1e-3, 1, 1)):
        ref = rx_optim.make_schedule(lr, epochs, spe, scheduler)
        got = optim.make_schedule(lr, epochs, spe, scheduler)
        for step in range(0, (epochs + 2) * spe):
            assert got(step) == pytest.approx(float(ref(jnp.asarray(step))), rel=1e-6), step
        assert isinstance(got(0), float)


def test_head_only_mask_and_unfreezing_match_rxtpu():
    _, _, state, _ = _rx_state()
    ref = from_flax(jax.tree_util.tree_map(np.asarray, rx_optim.head_only_mask(state.params)))
    names = [n for n, _ in TwoSitesNN(**KW).named_parameters()]
    assert optim.head_only_mask(names) == [bool(ref[n]) for n in names]
    assert any(optim.head_only_mask(names)) and not all(optim.head_only_mask(names))
    for epoch in range(5):
        for pretrained in (False, True):
            assert optim.backbone_trainable_at_epoch(epoch, pretrained) == \
                rx_optim.backbone_trainable_at_epoch(epoch, pretrained)


def test_eval_step_matches_rxtpu():
    _, flax_model, state, _ = _rx_state()
    variables = randomize_flax({"params": state.params, "batch_stats": state.batch_stats}, 5)
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    rng = np.random.default_rng(6)
    batch = {"images": rng.integers(0, 256, (4, 3, 6, 64, 64), dtype=np.uint8),
             "labels": rng.integers(0, 8, 4).astype(np.int32),
             "mean": rng.uniform(0.1, 0.6, (4, 6)).astype(np.float32),
             "std": rng.uniform(0.05, 0.3, (4, 6)).astype(np.float32),
             "valid": np.array([1, 1, 1, 0], np.float32)}
    ref = rx_make_eval_step(flax_model, 48)(state, {k: jnp.asarray(v) for k, v in batch.items()})
    port = TwoSitesNN(**KW, dropout=0.0)
    port.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    got = EvalStep(port, 48, torch.float32)({k: torch.from_numpy(v)
                                                   for k, v in batch.items()})
    assert float(got["count"]) == float(ref["count"]) == 3.0
    assert float(got["correct"]) == float(ref["correct"])
    np.testing.assert_allclose(float(got["loss_sum"]), float(ref["loss_sum"]), rtol=1e-5)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_pretrained_port_matches_rxtpu(arch):
    from rxtpu.models.pretrained import port_torch_resnet as rx_port
    from rxtpu.models.pretrained import stem_kernel_from_rgb as rx_stem
    from rxtpu.models.pretrained import synthetic_resnet_state_dict
    from rxtpu_torch.models.pretrained import port_torch_resnet, stem_kernel_from_rgb

    sd = synthetic_resnet_state_dict(arch, seed=3)
    stem = stem_kernel_from_rgb(sd["conv1.weight"])
    assert stem.shape == (64, 6, 7, 7)
    np.testing.assert_array_equal(
        stem, np.transpose(rx_stem(np.transpose(sd["conv1.weight"], (2, 3, 1, 0))), (3, 2, 0, 1)))
    kw = dict(backbone=arch, nb_classes=8, size_features=16)
    variables = FlaxTwoSitesNN(**kw, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32, 6)), train=False)
    params, stats = rx_port(sd, dict(variables["params"]), dict(variables["batch_stats"]),
                            arch=arch)
    want = from_flax(params, stats)
    model_sd = from_flax(variables["params"], variables["batch_stats"])
    got = port_torch_resnet({k: torch.from_numpy(v) for k, v in sd.items()}, model_sd, arch)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    TwoSitesNN(**kw).load_state_dict(got)


def test_init_follows_rxtpu_distributions():
    model = TwoSitesNN("resnet50", nb_classes=1108)
    init_weights(model, torch.Generator().manual_seed(0))
    w = model.backbone.stage3_block2.Conv_1.weight  # 3x3, 256 -> 256
    assert float(w.detach().std()) == pytest.approx((2.0 / (256 * 9)) ** 0.5, rel=0.02)
    fc1 = model.head.fc1.weight
    assert float(fc1.detach().std()) == pytest.approx((1.0 / fc1.shape[1]) ** 0.5, rel=0.02)
    limit = 2.0 * (1.0 / fc1.shape[1]) ** 0.5 / 0.87962566103423978
    assert float(fc1.detach().abs().max()) <= limit * (1 + 1e-6)
    assert not model.head.fc1.bias.any() and not model.head.fc2.bias.any()
    for mod in model.modules():
        if isinstance(mod, BottleneckBlock):
            assert not mod.BatchNorm_2.weight.any()
            assert (mod.BatchNorm_1.weight == 1).all() and (mod.norm_proj is None
                                                            or (mod.norm_proj.weight == 1).all())
    a = init_weights(make_backbone("resnet18"), torch.Generator().manual_seed(5)).state_dict()
    b = init_weights(make_backbone("resnet18"), torch.Generator().manual_seed(5)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_dropout_draws_from_its_generator():
    drop = Dropout(0.3).train()
    x = torch.ones(4096)
    a = drop.__class__(0.3).train()
    drop.generator = torch.Generator().manual_seed(1)
    a.generator = torch.Generator().manual_seed(1)
    y, z = drop(x), a(x)
    assert torch.equal(y, z)
    kept = y != 0
    assert 0.65 < float(kept.float().mean()) < 0.75
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert torch.equal(drop.eval()(x), x) and torch.equal(Dropout(0.0).train()(x), x)
