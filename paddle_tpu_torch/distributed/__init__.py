"""`paddle.distributed` — the port's collective layer and training over
a mesh of processes (`torch.distributed`: NCCL on the card, gloo on the
CPU), and the pieces the serving fleet shares with them.

- `env` (rank and world from the launcher's env), `collective` (groups
  and the eager collectives; its names are re-exported here),
  `communication` (and `stream`), `spawn`, `launch`
  (`python -m paddle_tpu_torch.distributed.launch`);
- `mesh` (a device mesh over processes and its differentiable
  collectives) and `hybrid` (the LLaMA train and eval steps on one
  device or over a dp x pp x cp x tp mesh);
- `quant_comm` (the block-scaled int8 wire codec), `membership`
  (liveness by heartbeat) and `fault_tolerance.chaos` (fault injection).

The reference's DataParallel, sharding, fleet and checkpoint names
(ROADMAP item 7b) and its store, elastic, pipeline and auto-parallel
names (item 7c) come later.
"""
from . import env  # noqa: F401
from .env import ParallelEnv, get_rank, get_world_size  # noqa: F401
from .collective import (  # noqa: F401
    Group,
    P2POp,
    ReduceOp,
    Task,
    all_gather,
    all_gather_into_tensor,
    all_gather_object,
    all_reduce,
    alltoall,
    alltoall_single,
    barrier,
    batch_isend_irecv,
    broadcast,
    broadcast_object_list,
    destroy_process_group,
    get_backend,
    get_global_rank,
    get_group,
    init_parallel_env,
    irecv,
    is_initialized,
    isend,
    new_group,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
)
from .spawn import spawn  # noqa: F401
from . import fault_tolerance  # noqa: E402,F401


def __getattr__(name):
    import importlib

    if name == "stream":
        mod = importlib.import_module(".communication.stream", __name__)
    elif name in ("communication", "launch", "mesh", "hybrid"):
        mod = importlib.import_module(f".{name}", __name__)
    else:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = mod
    return mod
