"""Train and eval steps (counterpart of ``rxtpu/train/step.py``).

The train step: per-step generators seeded by ``(seed, step)`` (as rxtpu's
``fold_in(base_key, step)``, so a resumed run draws the same numbers), the
augmentation on the raw uint8 batch (K2-K4 for ``shear``), the forward in
the compute dtype under ``torch.autocast``, the f32 cross-entropy, the
backward, the masked weight decay and the SGD update. The augmentation has
no gradient: it acts on the input before the model. Metrics: ``loss``,
``accuracy``, ``grad_norm``, ``grad_norm/{backbone,head}`` (of the raw
gradients) and the ``lr`` this step used, as 0-dim tensors on the device.

The eval step: K1 center crop + normalize (``eval_batch_normalize``, bf16
views), the BN-folded twin in the compute dtype, then exact sums
``loss_sum``, ``correct`` and ``count`` over the valid rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rxtpu_torch.infer.fold import fold_for_inference
from rxtpu_torch.ops import eval_batch_normalize, get_augment_fn
from rxtpu_torch.train.optim import head_only_mask, make_optimizer, masked_grads_with_wd

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), its optimizer, the global
    step and what the step needs besides: the head mask in
    ``model.parameters()`` order, the weight decay and the lr schedule."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Callable[[int], float]
    head_mask: List[bool]
    weight_decay: float = 0.0
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, lr_schedule: Callable[[int], float],
               momentum: float = 0.9, nesterov: bool = True,
               weight_decay: float = 0.0) -> "TrainState":
        names = [n for n, _ in model.named_parameters()]
        return cls(model=model, optimizer=make_optimizer(model.parameters(), momentum, nesterov),
                   lr_schedule=lr_schedule, head_mask=head_only_mask(names),
                   weight_decay=weight_decay)


def step_seed(seed: int, step: int, stream: int) -> int:
    """A 64-bit seed for one (run seed, global step, stream) triple."""
    return int(np.random.SeedSequence([seed, step, stream]).generate_state(1, np.uint64)[0])


def step_generators(seed: int, step: int, device: torch.device
                    ) -> Tuple[torch.Generator, torch.Generator]:
    """(augmentation generator on the CPU, dropout generator on ``device``).
    The augmentation draws are tiny, so they come from the CPU and are the
    same whatever device the step runs on."""
    aug = torch.Generator().manual_seed(step_seed(seed, step, 0))
    drop = torch.Generator(device=device).manual_seed(step_seed(seed, step, 1))
    return aug, drop


def _norm(sq: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack(sq).sum().sqrt()


def make_train_step(model: torch.nn.Module, crop_size: int, augment: str = "shear",
                    compute_dtype: torch.dtype = torch.bfloat16) -> Callable:
    """``step(state, batch, seed, backbone_trainable) -> metrics``; updates
    ``state`` in place. batch: images uint8 [B, G, C, H, W], labels int
    [B], mean/std f32 [B, C], all on one device (for ``augment="none"``,
    images are normalized NCHW views)."""
    augment_fn = get_augment_fn(augment)
    autocast = compute_dtype != torch.float32

    def step_fn(state: TrainState, batch: Batch, seed: int,
                backbone_trainable: bool) -> Dict[str, torch.Tensor]:
        model = state.model
        images = batch["images"]
        device = images.device
        aug_gen, drop_gen = step_generators(seed, state.step, device)
        views = augment_fn(images, batch["mean"], batch["std"], aug_gen,
                           crop_size=crop_size, train=True)
        labels = batch["labels"].long()
        model.train()
        model.set_dropout_generator(drop_gen)
        state.optimizer.zero_grad(set_to_none=True)
        with torch.autocast(device.type, dtype=compute_dtype, enabled=autocast):
            logits = model(views)
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        model.set_dropout_generator(None)

        params = list(model.parameters())
        with torch.no_grad():
            sq = [n.square() for n in torch._foreach_norm([p.grad.float() for p in params])]
            metrics = {
                "loss": loss.detach(),
                "accuracy": (logits.argmax(-1) == labels).float().mean(),
                "grad_norm": _norm(sq),
                "grad_norm/backbone": _norm([s for s, h in zip(sq, state.head_mask) if not h]),
                "grad_norm/head": _norm([s for s, h in zip(sq, state.head_mask) if h]),
            }
        masked_grads_with_wd(params, [backbone_trainable or h for h in state.head_mask],
                             state.weight_decay)
        lr = state.lr_schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        metrics["lr"] = torch.tensor(lr, dtype=torch.float32)
        state.step += 1
        return metrics

    return step_fn


class EvalStep:
    """The eval step over the BN-folded twin of ``model`` as it is now; build
    a new one after the weights change."""

    def __init__(self, model: torch.nn.Module, crop_size: int,
                 dtype: torch.dtype = torch.bfloat16):
        self.net = fold_for_inference(model).to(dtype)
        self.crop_size = crop_size

    @torch.inference_mode()
    def __call__(self, batch: Batch) -> Dict[str, torch.Tensor]:
        views = eval_batch_normalize(batch["images"], batch["mean"], batch["std"],
                                     self.crop_size)
        logits = self.net(views).float()
        labels = batch["labels"].long()
        valid = batch.get("valid")
        if valid is None:
            valid = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        losses = F.cross_entropy(logits, labels, reduction="none")
        correct = (logits.argmax(-1) == labels).float()
        return {"loss_sum": (losses * valid).sum(), "correct": (correct * valid).sum(),
                "count": valid.sum()}
