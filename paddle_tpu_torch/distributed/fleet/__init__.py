"""fleet: the hybrid-parallel training facade — the port of
`paddle_tpu/distributed/fleet/__init__.py`. The module-level functions
delegate to the Fleet singleton (`fleet.init(...)`).
"""
from .base.distributed_strategy import DistributedStrategy  # noqa: F401
from .base.topology import (  # noqa: F401
    CommunicateTopology,
    HybridCommunicateGroup,
    get_hcg,
)
from .fleet import Fleet, fleet as _fleet_singleton  # noqa: F401

init = _fleet_singleton.init
is_first_worker = _fleet_singleton.is_first_worker
worker_index = _fleet_singleton.worker_index
worker_num = _fleet_singleton.worker_num
worker_rank = _fleet_singleton.worker_index
distributed_model = _fleet_singleton.distributed_model
distributed_optimizer = _fleet_singleton.distributed_optimizer
get_hybrid_communicate_group = _fleet_singleton.get_hybrid_communicate_group
barrier_worker = _fleet_singleton.barrier_worker
is_server = _fleet_singleton.is_server
is_worker = _fleet_singleton.is_worker
init_worker = _fleet_singleton.init_worker
init_server = _fleet_singleton.init_server
run_server = _fleet_singleton.run_server
stop_worker = _fleet_singleton.stop_worker


def __getattr__(name):
    import importlib

    if name in ("meta_parallel", "meta_optimizers", "utils", "layers", "base"):
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
