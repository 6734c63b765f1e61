"""Process groups and per-rank input slices (counterpart of
``rxtpu/parallel/multihost.py``).

rxtpu's pod recipe carries over rank by rank: every rank builds the SAME
global sample order (a seeded permutation) and decodes only its contiguous
1/num_hosts slice of every global batch, so no rank ever holds another's
rows and no input crosses ranks. One process drives one GPU.

- ``initialize_distributed`` forms the process group from explicit flags
  (``tcp://`` init) or from torchrun's environment, with rxtpu's error
  rules: explicit arguments that do not parse raise; with no cluster and
  none of rxtpu's cluster hints it warns and stays at world 1; with no
  cluster but a hint set it raises. ``backend=None`` is NCCL on CUDA and
  gloo on the CPU; a failure to form the group is never answered by another
  backend or device.
- ``host_shard_bounds`` / ``shard_records_for_host``: the slicing contract.
- Host-side helpers: ``barrier``, ``broadcast_one_to_all`` (bytes),
  ``all_gather_rows`` (rank order), ``all_gather_objects`` and
  ``run_on_rank0`` (host work on rank 0 that the others wait for longer than
  the group's timeout: the stats pass).
- Differentiable collectives for the train step: ``all_reduce_sum`` (its
  backward all-reduces too: SyncBN's statistics), ``copy_to_group``
  (identity forward, all-reduce backward) and ``gather_last_dim`` (an
  all-gather along the last dim whose backward takes the rank's own slice).

Every gather is an all-reduce of a zero-filled buffer holding the rank's
part: exact (x + 0 = x), and the one collective that NCCL and gloo both
run on CUDA tensors.
"""

from __future__ import annotations

import datetime
import os
import re
import sys
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

CLUSTER_HINTS = ("SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE", "TPU_WORKER_HOSTNAMES",
                 "TPU_WORKER_ID", "MEGASCALE_COORDINATOR_ADDRESS")
TIMEOUT_S = 600  # init_process_group's timeout: a missing peer ends the run, never hangs it
RANK0_WAIT_S = 24 * 3600  # run_on_rank0's wait: a stats pass over a whole dataset on one rank


def host_shard_bounds(global_batch: int, num_hosts: int, host_id: int) -> Tuple[int, int]:
    """[start, stop) rows of a global batch owned by ``host_id``; the batch
    must split evenly (the pipeline pads every batch to a static shape)."""
    if global_batch % num_hosts:
        raise ValueError(f"batch {global_batch} does not split over {num_hosts} hosts")
    per_host = global_batch // num_hosts
    return host_id * per_host, (host_id + 1) * per_host


def shard_records_for_host(order: np.ndarray, global_batch: int, num_hosts: int,
                           host_id: int) -> List[np.ndarray]:
    """A global epoch order split into this host's per-batch index slices.
    A ragged order raises: truncating would drop up to global_batch - 1
    samples (pad the tail batch first, as ``Pipeline`` does)."""
    if len(order) % global_batch:
        raise ValueError(f"epoch order length {len(order)} is not a multiple of "
                         f"global_batch {global_batch}; pad the tail batch first")
    lo, hi = host_shard_bounds(global_batch, num_hosts, host_id)
    return [order[i * global_batch:(i + 1) * global_batch][lo:hi]
            for i in range(len(order) // global_batch)]


def _tcp_address(address: Optional[str]) -> str:
    m = re.fullmatch(r"\[?([^\[\]]+?)\]?:(\d+)", address or "")
    if m is None:
        raise ValueError(f"coordinator address {address!r} is not host:port")
    return f"tcp://{m.group(1)}:{m.group(2)}"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None, device: str = "cuda") -> int:
    """Form the default process group; returns this process's rank (0 when
    no cluster is found, which leaves no group). A second call returns the
    rank of the group already formed. On CUDA the rank's device becomes
    current first: ``LOCAL_RANK``, else ``process_id % device_count``."""
    if dist.is_initialized():
        return dist.get_rank()
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    if explicit:
        # `is not None`, not truthiness: process_id 0 is an explicit argument
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("explicit cluster arguments need all of coordinator_address, "
                             "num_processes and process_id")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} is not in [0, {num_processes})")
        init = dict(init_method=_tcp_address(coordinator_address),
                    world_size=num_processes, rank=process_id)
        rank = process_id
    elif os.environ.get("RANK") is not None and os.environ.get("WORLD_SIZE") is not None:
        init = dict(init_method="env://")  # torchrun: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE
        rank = int(os.environ["RANK"])
    else:
        found = [h for h in CLUSTER_HINTS if os.environ.get(h)]
        if found:
            raise RuntimeError(
                "no cluster found (no explicit arguments, no torchrun environment) but "
                f"cluster environment hints are present ({', '.join(found)}); pass explicit "
                "coordinator_address/num_processes/process_id or launch with torchrun rather "
                "than training each host independently")
        print("initialize_distributed: found no cluster (no explicit arguments, no torchrun "
              "environment); continuing single-process", file=sys.stderr)
        return 0
    cuda = torch.device(device).type == "cuda"
    if cuda:
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend or ("nccl" if cuda else "gloo"),
                            timeout=datetime.timedelta(seconds=TIMEOUT_S), **init)
    return dist.get_rank()


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def comm_device() -> torch.device:
    """Where host-side helpers put their tensors: the current card under
    NCCL (it reduces nothing else), the CPU otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if not is_distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def broadcast_one_to_all(data: bytes) -> bytes:
    """Rank 0's ``data`` on every rank."""
    if not is_distributed():
        return data
    box = [data]
    dist.broadcast_object_list(box, src=0, device=comm_device())
    return box[0]


def run_on_rank0(fn: Callable[[], Any], timeout_s: float = RANK0_WAIT_S) -> Any:
    """``fn()`` on rank 0 while every other rank waits for it to end, at a
    barrier of a gloo group of its own whose timeout is ``timeout_s``: the
    default group's ``TIMEOUT_S`` bounds its collectives, not this wait.
    Returns rank 0's result there and None elsewhere; every rank calls it at
    the same point. If rank 0 fails, the others' barrier fails with it."""
    if not is_distributed():
        return fn()
    group = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn() if dist.get_rank() == 0 else None
        dist.barrier(group=group)
    finally:
        dist.destroy_process_group(group)
    return out


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """``[n, ...]`` per rank -> ``[size * n, ...]`` in rank order, on every
    rank of ``group`` (every rank's ``n`` the same)."""
    size, r = dist.get_world_size(group), dist.get_rank(group)
    out = torch.zeros((size,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    out[r] = t
    dist.all_reduce(out, group=group)
    return out.reshape((size * t.shape[0],) + tuple(t.shape[1:]))


def all_gather_objects(obj: Any, group=None) -> List[Any]:
    """Every rank's ``obj``, in rank order."""
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``; the gradient of each rank's copy is the sum of
    every rank's gradient of the result."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToGroup(torch.autograd.Function):
    """Identity; the input's gradient, partial on each rank, is summed."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g32 = g.to(torch.promote_types(g.dtype, torch.float32)).contiguous().clone()
        dist.all_reduce(g32, group=ctx.group)
        return g32.to(g.dtype), None


class _GatherLastDim(torch.autograd.Function):
    """``[..., k]`` per rank -> ``[..., size * k]``; the backward takes the
    rank's own slice of the gradient and sums nothing: every rank computes
    the same loss from the gathered result."""

    @staticmethod
    def forward(ctx, x, group):
        size, r = dist.get_world_size(group), dist.get_rank(group)
        k = x.shape[-1]
        ctx.bounds = (r * k, (r + 1) * k)
        wide = torch.promote_types(x.dtype, torch.float32)  # bf16 passes through exactly
        out = torch.zeros(tuple(x.shape[:-1]) + (size * k,), dtype=wide, device=x.device)
        out[..., r * k:(r + 1) * k] = x
        dist.all_reduce(out, group=group)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.bounds
        return g[..., lo:hi].contiguous(), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def gather_last_dim(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherLastDim.apply(x, group)
