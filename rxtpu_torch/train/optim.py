"""Optimizer and schedule (counterpart of ``rxtpu/train/optim.py``).

- SGD(momentum 0.9, nesterov) is ``torch.optim.SGD(nesterov=True,
  weight_decay=0)``: fed ``g + wd*p`` it computes optax's nesterov trace
  (``trace = g + m*trace``, ``update = -lr * (g + m*trace)``), which
  ``tests/test_torch_port_train.py`` holds against optax. So torch's
  ``momentum_buffer`` is optax's trace, and ``sgd_state_from_trace`` loads
  an rxtpu trace (by parameter name) as the optimizer's state.
- The coupled weight decay is added to the gradient here, under the freeze
  mask: where a parameter is frozen its optimizer input is exactly zero, so
  its momentum buffer stays zero and its update is zero (torch skips params
  without grads the same way). ``wd*p`` is rounded before the add, as rxtpu
  computes it.
- ``cosine_epoch_schedule`` steps once per EPOCH, in f32 as rxtpu computes it.
- Progressive unfreezing: when pretrained, epochs 1..2 train the head only.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence

import numpy as np
import torch


def cosine_epoch_schedule(lr0: float, nb_epochs: int, steps_per_epoch: int,
                          eta_min_ratio: float = 0.01) -> Callable[[int], float]:
    """lr(epoch) = eta_min + (lr0 - eta_min) * (1 + cos(pi * epoch / T)) / 2."""
    eta_min = lr0 * eta_min_ratio

    def schedule(step: int) -> float:
        epoch = min(int(step) // steps_per_epoch, nb_epochs)
        frac = np.float32(epoch) / np.float32(nb_epochs)
        cos = np.cos(np.float32(np.pi) * frac)
        half = (lr0 - eta_min) * 0.5  # a python float in rxtpu too
        return float(np.float32(eta_min) + np.float32(half) * (np.float32(1.0) + cos))

    return schedule


def make_schedule(lr: float, nb_epochs: int, steps_per_epoch: int,
                  use_scheduler: bool = True) -> Callable[[int], float]:
    """The step -> lr function the optimizer follows and the step logs."""
    if use_scheduler:
        return cosine_epoch_schedule(lr, nb_epochs, max(1, steps_per_epoch))
    lr32 = float(np.float32(lr))
    return lambda step: lr32


def make_optimizer(params, momentum: float = 0.9, nesterov: bool = True) -> torch.optim.SGD:
    """SGD with (nesterov) momentum; the lr is set before every step from
    the schedule, and weight decay is added by ``masked_grads_with_wd``."""
    return torch.optim.SGD(params, lr=0.0, momentum=momentum, nesterov=nesterov,
                           weight_decay=0.0, dampening=0.0)


def sgd_state_from_trace(optimizer: torch.optim.SGD, names: Sequence[str],
                         trace: Mapping[str, torch.Tensor]) -> Dict:
    """A ``state_dict`` for ``optimizer`` (``make_optimizer`` over the
    parameters that ``names`` name, in order) whose ``momentum_buffer`` of
    each parameter is its optax trace. Every buffer is set, zeros included:
    a frozen parameter's zero trace must stay zero, where an unset buffer
    would be seeded with the first gradient."""
    if set(trace) != set(names):
        raise ValueError(f"the trace names {sorted(set(trace) ^ set(names))} do not match "
                         "the model's parameters")
    current = optimizer.state_dict()
    order = [i for group in current["param_groups"] for i in group["params"]]
    if len(order) != len(names):
        raise ValueError(f"{len(names)} names for the optimizer's {len(order)} parameters")
    return {"state": {i: {"momentum_buffer": trace[n]} for i, n in zip(order, names)},
            "param_groups": current["param_groups"]}


@torch.no_grad()
def masked_grads_with_wd(params: Sequence[torch.Tensor], trainable: Sequence[bool],
                         weight_decay: float) -> None:
    """In place on ``p.grad``: ``g + wd*p`` where trainable, exactly zero
    where frozen."""
    frozen = [p.grad for p, t in zip(params, trainable) if not t]
    if frozen:
        torch._foreach_zero_(frozen)
    live = [p for p, t in zip(params, trainable) if t]
    if live and weight_decay:
        torch._foreach_add_([p.grad for p in live], torch._foreach_mul(live, weight_decay))


def head_only_mask(names: Sequence[str], head_scope: str = "head") -> List[bool]:
    """True for the parameters of the classification head (trainable while
    the backbone is frozen)."""
    return [n.split(".")[0] == head_scope for n in names]


def backbone_trainable_at_epoch(epoch: int, pretrained: bool, head_only_epochs: int = 2) -> bool:
    """When pretrained, epochs 1..head_only_epochs are head-only."""
    if not pretrained:
        return True
    return epoch > head_only_epochs
