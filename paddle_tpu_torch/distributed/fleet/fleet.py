"""The fleet facade: the port of `paddle_tpu/distributed/fleet/fleet.py`
(Paddle's fleet.py: `fleet.init` :218, `distributed_model`
(fleet/model.py:32), `distributed_optimizer` :1427).

`init` forms the collective world (`collective.init_parallel_env`: the
default group already formed, else one on the card; a caller wanting
the CPU's gloo world forms it first with `init_parallel_env('cpu')`)
and builds the hybrid topology from `DistributedStrategy.hybrid_configs`
as one process mesh (`distributed/mesh.py`, axes in the strategy's
order), whose groups the `HybridCommunicateGroup` hands out.
`distributed_model` picks the wrapper by the degrees: `TensorParallel`
(mp), `SegmentParallel` (sep), `DataParallel` (dp), else the model
itself. The routes that need code of later slices raise
`NotImplementedError` naming their ROADMAP item: pipeline parallelism
(`pp_degree > 1`) and the compiled hybrid engine
(`hybrid_configs["compiled"]`), item 7c; the parameter-server mode
(`init(is_collective=False)`, `init_server`, `run_server`), item 7d.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .. import collective as coll
from .. import mesh as M
from ..env import get_rank, get_world_size
from .base.distributed_strategy import DistributedStrategy
from .base.topology import (
    CommunicateTopology,
    HybridCommunicateGroup,
    set_hcg,
)

_PS = ("the parameter-server mode comes with ROADMAP item 7d "
       "(distributed/ps)")


class Fleet:
    def __init__(self):
        self._strategy: Optional[DistributedStrategy] = None
        self._is_collective = True
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._mesh = None
        self._initialized = False

    # ------------------------------------------------------------------
    def init(self, role_maker=None, is_collective: bool = True,
             strategy: Optional[DistributedStrategy] = None,
             log_level="INFO"):
        if not is_collective:
            raise NotImplementedError(_PS)
        self._strategy = strategy or DistributedStrategy()
        self._is_collective = True
        base = coll.init_parallel_env()

        h = self._strategy.hybrid_configs
        order = list(h.get("order") or ["dp", "pp", "sharding", "sep", "mp"])
        degree_key = {"dp": "dp_degree", "pp": "pp_degree",
                      "sharding": "sharding_degree", "sep": "sep_degree",
                      "mp": "mp_degree"}
        dims = [max(1, int(h.get(degree_key[n], 1))) for n in order]
        world = get_world_size()
        prod = int(np.prod(dims))
        if prod not in (0, world) and world > 1:
            # the remaining degree goes to dp, as the reference infers it
            rest = prod // max(1, dims[order.index("dp")])
            if world % rest == 0:
                dims[order.index("dp")] = world // rest
        topo = CommunicateTopology(order, dims)
        self._mesh = M.build(list(zip(order, dims)),
                             device=base.device_type)
        self._hcg = HybridCommunicateGroup(topo, self._mesh)
        set_hcg(self._hcg)
        self._initialized = True
        return self

    # ------------------------------------------------------------------
    @property
    def is_initialized(self) -> bool:
        return self._initialized

    def is_first_worker(self) -> bool:
        return get_rank() == 0

    def worker_index(self) -> int:
        return get_rank()

    def worker_num(self) -> int:
        return get_world_size()

    def get_hybrid_communicate_group(self) -> HybridCommunicateGroup:
        return self._hcg

    @property
    def mesh(self):
        return self._mesh

    def barrier_worker(self):
        coll.barrier()

    # ------------------------------------------------------------------
    def distributed_model(self, model):
        """Reference: fleet/model.py:32 (the wrapper by degree,
        :143-162)."""
        from ..parallel import DataParallel
        from .meta_parallel import SegmentParallel, TensorParallel

        hcg = self._hcg
        if hcg is None:
            return model
        if (self._strategy is not None
                and self._strategy.hybrid_configs.get("compiled")):
            raise NotImplementedError(
                "fleet's compiled hybrid engine (CompiledHybridModel, "
                "hybrid_configs['compiled']) comes with ROADMAP item 7c")
        if hcg.get_pipe_parallel_world_size() > 1:
            raise NotImplementedError(
                "pipeline parallelism (PipelineParallel, pp_degree > 1) "
                "comes with ROADMAP item 7c")
        if hcg.get_model_parallel_world_size() > 1:
            return TensorParallel(model, hcg, self._strategy)
        if hcg.get_sep_parallel_world_size() > 1:
            return SegmentParallel(model, hcg, self._strategy)
        if hcg.get_data_parallel_world_size() > 1:
            return DataParallel(model, group=hcg.get_data_parallel_group(),
                                find_unused_parameters=self._strategy
                                .find_unused_parameters)
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        """Reference: fleet.py:1427: the inner optimizer wrapped in
        `HybridParallelOptimizer`."""
        from .meta_optimizers.dygraph_optimizer.hybrid_parallel_optimizer \
            import HybridParallelOptimizer

        if self._hcg is None:
            return optimizer
        return HybridParallelOptimizer(optimizer, self._hcg,
                                       self._strategy or DistributedStrategy())

    # -- parameter-server mode (ROADMAP item 7d) --------------------------
    def is_server(self) -> bool:
        return False

    def is_worker(self) -> bool:
        return True

    def init_server(self, *model_dirs, **kwargs):
        raise NotImplementedError(_PS)

    def run_server(self):
        raise NotImplementedError(_PS)

    def init_worker(self, scopes=None):
        """Collective mode has no parameter server to reach: nothing to
        do, as in the reference."""
        return None

    def stop_worker(self):
        return None


fleet = Fleet()
