"""Data parallelism with an optional tensor-parallel head (counterpart of
``rxtpu/parallel/dp.py``).

rxtpu expresses both through GSPMD shardings under ``jit``; the port does
by hand what XLA inserts there. Every rank initializes the whole model from
``cfg.train.seed``, so world N starts from world 1's weights; then:

- ``place_state`` keeps the rank's rows of each tensor-parallel weight
  (``mesh.tp_parameters``) and of its SGD momentum;
- ``allreduce_grads`` averages the gradients over the data group after the
  backward, one flat bucket per dtype in parameter order, so the
  replicated parameters of one model group stay identical;
- ``whole_state_dict`` / ``whole_optimizer_state`` / ``whole_model`` gather
  the shards back (checkpoints, validation), so a tensor-parallel run's
  files have a world-1 run's layout;
- the rank's feed is ``device_prefetch`` of its ``Pipeline`` slices, so
  rxtpu's ``make_put`` has no counterpart.

``state.model`` stays a plain ``TwoSitesNN`` (no ``DistributedDataParallel``
wrapper), so the converters, the BN fold, int8 and the checkpoints see the
names they always see.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from rxtpu_torch.parallel.mesh import Mesh, tp_parameters
from rxtpu_torch.parallel.multihost import all_gather_rows


def tp_named_parameters(model: nn.Module, mesh: Optional[Mesh]) -> List[Tuple[str, nn.Parameter]]:
    """The tensor-parallel parameters under ``mesh`` (none without a model axis)."""
    if mesh is None or mesh.model_parallel == 1:
        return []
    params = dict(model.named_parameters())
    return [(n, params[n]) for n in tp_parameters(model)]


def _rows(n: int, mesh: Mesh) -> Tuple[int, int]:
    if n % mesh.model_parallel:
        raise ValueError(f"{n} output rows do not split over {mesh.model_parallel} model ranks")
    k = n // mesh.model_parallel
    return mesh.model_rank * k, (mesh.model_rank + 1) * k


@torch.no_grad()
def place_state(state, mesh: Optional[Mesh]):
    """Slice each tensor-parallel weight of ``state`` (a ``TrainState``
    holding whole weights) and its momentum buffer, when it has one, to the
    rank's rows, in place; returns ``state``."""
    for _, p in tp_named_parameters(state.model, mesh):
        lo, hi = _rows(p.shape[0], mesh)
        p.data = p.data[lo:hi].clone()
        slot = state.optimizer.state.get(p)
        if slot and slot.get("momentum_buffer") is not None:
            slot["momentum_buffer"] = slot["momentum_buffer"][lo:hi].clone()
    return state


@torch.no_grad()
def allreduce_grads(params: Sequence[torch.Tensor], group) -> None:
    """Each ``p.grad`` becomes its mean over ``group``."""
    size = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        if size > 1:
            flat.div_(size)
        parts = flat.split([g.numel() for g in grads])
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(parts, grads)])


def _gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return all_gather_rows(t.detach().contiguous(), mesh.model_group)


@torch.no_grad()
def whole_state_dict(model: nn.Module, mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with each tensor-parallel shard gathered to its
    whole weight (a collective over the model group: every rank calls it)."""
    sd = model.state_dict()
    for name, _ in tp_named_parameters(model, mesh):
        sd[name] = _gather(sd[name], mesh)
    return sd


@torch.no_grad()
def whole_optimizer_state(optimizer: torch.optim.Optimizer, model: nn.Module,
                          mesh: Optional[Mesh]) -> Dict:
    """``optimizer.state_dict()`` with the tensor-parallel momentum gathered
    (a collective, as ``whole_state_dict``)."""
    sd = optimizer.state_dict()
    names = [n for n, _ in model.named_parameters()]
    for name, _ in tp_named_parameters(model, mesh):
        i = names.index(name)
        slot = sd["state"].get(i)
        if slot and slot.get("momentum_buffer") is not None:
            sd["state"][i] = {**slot, "momentum_buffer": _gather(slot["momentum_buffer"], mesh)}
    return sd


@torch.no_grad()
def whole_model(model: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """``model`` itself without tensor parallelism; else a plain twin
    (``model.arch``, no mesh) on its device holding the whole weights."""
    if not tp_named_parameters(model, mesh):
        return model
    twin = type(model)(**model.arch)
    twin.load_state_dict(whole_state_dict(model, mesh))
    return twin.to(next(model.parameters()).device).train(model.training)
