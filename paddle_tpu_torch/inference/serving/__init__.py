"""LLM serving: the paged-KV engine of the port and the fleet around it.

:class:`PagedServingEngine` (``engine.py``) over the paged block pool
with prefix caching (``block_manager.py``) and the continuous-batching
scheduler with chunked prefill, preemption, deadlines and load shedding
(``scheduler.py``); multi-tenant LoRA adapters (``adapters.py``),
speculative decoding with a draft model (``speculative.py``), and a
router over health-checked replicas with replay-and-confirm failover
(``replica.py``, ``router.py``); the dense slot engine the paged one is
held against (``slot_engine.py``), and disaggregated prefill / decode
pools with lease-fenced KV page migration, a fleet prefix index and a
decode-pool autoscaler (``disagg.py``) — the ported counterparts of
`paddle_tpu/inference/serving/`.
"""
from .adapters import (ADAPTER_TARGETS, AdapterCorruptError, AdapterManager,
                       AdapterMissingError, AdapterTransport, LoraAdapter,
                       NoAdapterSlotsError, load_adapter, make_adapter,
                       pack_adapter, rank_class, save_adapter,
                       unpack_adapter)
from .block_manager import BlockManager, NoFreeBlocksError
from .disagg import (DisaggRouter, FleetPrefixIndex, MigrationError,
                     MigrationTimeout, PageCorruptError, PageTransport,
                     PoolAutoscaler, StaleEpochError, parse_pools)
from .engine import Completion, PagedServingEngine, TokenEvent
from .replica import ReplicaDeadError, ReplicaHandle, ReplicaKilledError
from .router import FailoverMismatchError, RouterRequest, ServingRouter
from .scheduler import (DeadlineExceededError, RejectedError,
                        ScheduledBatch, Scheduler, Sequence)
from .slot_engine import Request, ServingEngine
from .speculative import DraftModel

__all__ = [
    "BlockManager", "NoFreeBlocksError",
    "PagedServingEngine", "TokenEvent", "Completion",
    "RejectedError", "DeadlineExceededError",
    "ScheduledBatch", "Scheduler", "Sequence",
    "LoraAdapter", "AdapterManager", "AdapterTransport",
    "AdapterMissingError", "NoAdapterSlotsError", "AdapterCorruptError",
    "make_adapter", "save_adapter", "load_adapter", "pack_adapter",
    "unpack_adapter", "rank_class", "ADAPTER_TARGETS",
    "DraftModel",
    "ReplicaHandle", "ReplicaKilledError", "ReplicaDeadError",
    "ServingRouter", "RouterRequest", "FailoverMismatchError",
    "Request", "ServingEngine",
    "DisaggRouter", "PoolAutoscaler", "PageTransport", "FleetPrefixIndex",
    "MigrationError", "MigrationTimeout", "StaleEpochError",
    "PageCorruptError", "parse_pools",
]
