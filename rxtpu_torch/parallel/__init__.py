from rxtpu_torch.parallel.dp import (
    allreduce_grads, place_state, tp_named_parameters, whole_model,
    whole_optimizer_state, whole_state_dict,
)
from rxtpu_torch.parallel.mesh import Mesh, make_mesh, tp_parameters
from rxtpu_torch.parallel.multihost import (
    all_gather_objects, all_gather_rows, all_reduce_sum, barrier, broadcast_one_to_all,
    copy_to_group, gather_last_dim, host_shard_bounds, initialize_distributed,
    is_distributed, run_on_rank0, shard_records_for_host,
)

__all__ = [
    "Mesh", "all_gather_objects", "all_gather_rows", "all_reduce_sum", "allreduce_grads",
    "barrier", "broadcast_one_to_all", "copy_to_group", "gather_last_dim",
    "host_shard_bounds", "initialize_distributed", "is_distributed", "make_mesh",
    "place_state", "run_on_rank0", "shard_records_for_host", "tp_named_parameters", "tp_parameters",
    "whole_model", "whole_optimizer_state", "whole_state_dict",
]
