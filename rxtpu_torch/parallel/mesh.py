"""The rank's place on rxtpu's ``("data", "model")`` mesh (counterpart of
``rxtpu/parallel/mesh.py``).

rxtpu lays its devices out as ``reshape(world // M, M)``: a model group is
M consecutive ranks, a data group the ranks with the same ``rank % M``. The
batch is split over ``"data"`` (each data rank holds ``global / (world /
M)`` rows, which the members of one model group share) and, for M > 1, the
head's 2-D kernels over ``"model"`` on their output dim (flax's ``[in,
out]`` kernel is torch's ``[out, in]`` ``Linear.weight``: dim 0 here).

``make_mesh`` needs the default process group (``initialize_distributed``)
and creates every subgroup on every rank, in one order, as
``torch.distributed.new_group`` requires.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch.distributed as dist
from torch import nn


@dataclasses.dataclass
class Mesh:
    world: int
    rank: int
    model_parallel: int
    data_group: object                 # this rank's data group (the world group when M == 1)
    model_group: Optional[object]      # this rank's model group; None when M == 1

    @property
    def data_size(self) -> int:
        return self.world // self.model_parallel

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_parallel

    @property
    def bn_group(self) -> Optional[object]:
        """The group train-mode BN reduces over: None with one data rank, so
        that a world-1 run takes the single-process path unchanged."""
        return self.data_group if self.data_size > 1 else None

    @property
    def tp_group(self) -> Optional[object]:
        return self.model_group if self.model_parallel > 1 else None

    def batch_rows(self, local_rows: int) -> Tuple[int, int]:
        """(first global row, global rows) of this rank's slice of a batch of
        ``local_rows`` per data rank."""
        return self.data_rank * local_rows, self.data_size * local_rows


def make_mesh(model_parallel: int = 1) -> Mesh:
    """This rank's mesh over the default process group; raises when the
    world does not split into model groups of ``model_parallel``."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"world size {world} does not split into model groups of "
                         f"{model_parallel}")
    if model_parallel == 1:
        return Mesh(world, rank, 1, dist.group.WORLD, None)
    data_size = world // model_parallel
    data_group = model_group = None
    for m in range(model_parallel):
        g = dist.new_group([d * model_parallel + m for d in range(data_size)])
        if rank % model_parallel == m:
            data_group = g
    for d in range(data_size):
        g = dist.new_group([d * model_parallel + m for m in range(model_parallel)])
        if rank // model_parallel == d:
            model_group = g
    return Mesh(world, rank, model_parallel, data_group, model_group)


def tp_parameters(model: nn.Module) -> List[str]:
    """Names of the head's 2-D kernels that ``"model"`` splits (rxtpu's
    ``param_shardings``): each ``Linear.weight`` under ``head`` (the MLP
    head's fc1 and fc2; the ArcFace head's fc1, its class weight is not a
    kernel and stays replicated)."""
    head = getattr(model, "head", None)
    if head is None:
        return []
    return [f"head.{name}.weight" for name, mod in head.named_modules()
            if isinstance(mod, nn.Linear)]
