"""Hybrid-parallel process topology: the port of
`paddle_tpu/distributed/fleet/base/topology.py`.

`CommunicateTopology` (reference :26; Paddle's topology.py:70) is an N-D
cartesian rank grid, row-major over its axis names in order; its maps
between ranks and coordinates are the reference's, exactly.
`HybridCommunicateGroup` (reference :72; Paddle's :189) holds this
rank's group along each axis. The groups are the axes of a process mesh
(`distributed/mesh.py`), whose grid is the same row-major layout, so a
fleet mesh and the hybrid step's mesh share their groups where the axes
agree; the "check" group spans every rank.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ... import collective as coll
from ... import mesh as M
from ...env import get_rank

_HYBRID_ORDER = ["dp", "pp", "sharding", "sep", "mp"]


class CommunicateTopology:
    """Reference: fleet/base/topology.py:26."""

    def __init__(self, hybrid_group_names: Sequence[str] = _HYBRID_ORDER,
                 dims: Sequence[int] = (1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = None
        self._world = np.arange(int(np.prod(self._dims))).reshape(self._dims)

    def get_hybrid_group_names(self) -> List[str]:
        return list(self._parallel_names)

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return int(self._world.size)

    def get_rank(self, **kwargs) -> int:
        coord = tuple(kwargs[n] for n in self._parallel_names)
        return int(self._world[coord])

    def get_coord(self, rank: int):
        coord = np.argwhere(self._world == rank)[0]
        return dict(zip(self._parallel_names, (int(c) for c in coord)))

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        """All ranks whose coordinate on `axis_name` equals `index`."""
        ax = self._parallel_names.index(axis_name)
        return [int(r) for r in np.take(self._world, index, axis=ax).flatten()]

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """Groups of ranks varying only along `axis_name`."""
        ax = self._parallel_names.index(axis_name)
        moved = np.moveaxis(self._world, ax, -1)
        return [list(map(int, row))
                for row in moved.reshape(-1, self._dims[ax])]

    def get_fused_ranks(self, fused_axes: Sequence[str]) -> List[List[int]]:
        """Groups varying along all of `fused_axes` jointly."""
        axes = [self._parallel_names.index(a) for a in fused_axes]
        keep = [i for i in range(len(self._dims)) if i not in axes]
        moved = np.transpose(self._world, keep + sorted(axes))
        flat_keep = int(np.prod([self._dims[i] for i in keep])) if keep else 1
        return [list(map(int, row)) for row in moved.reshape(flat_keep, -1)]


class HybridCommunicateGroup:
    """Reference: fleet/base/topology.py:72. This rank's group along each
    axis of the topology, from a process mesh of the same layout (built
    on the default group's device unless one is given)."""

    def __init__(self, topology: CommunicateTopology,
                 mesh: Optional[M.Mesh] = None):
        self._topo = topology
        self.global_rank = get_rank()
        self.nranks = topology.world_size()
        names = topology.get_hybrid_group_names()

        self._dp_degree = topology.get_dim("dp") if "dp" in names else 1
        self._pp_degree = topology.get_dim("pp") if "pp" in names else 1
        self._sharding_degree = (topology.get_dim("sharding")
                                 if "sharding" in names else 1)
        self._sep_degree = topology.get_dim("sep") if "sep" in names else 1
        self._mp_degree = topology.get_dim("mp") if "mp" in names else 1

        if mesh is None:
            base = coll._default_group()
            mesh = M.build([(n, topology.get_dim(n)) for n in names],
                           device=base.device_type)
        self.mesh = mesh
        self._groups: Dict[str, coll.Group] = (
            {n: mesh.axis(n) for n in names} if mesh.is_member else {})
        self._check_group = coll.new_group(ranks=list(range(self.nranks)),
                                           axis_name="check")

    # --- degrees ---------------------------------------------------------
    def get_data_parallel_world_size(self) -> int:
        return self._dp_degree

    def get_model_parallel_world_size(self) -> int:
        return self._mp_degree

    def get_pipe_parallel_world_size(self) -> int:
        return self._pp_degree

    def get_sharding_parallel_world_size(self) -> int:
        return self._sharding_degree

    def get_sep_parallel_world_size(self) -> int:
        return self._sep_degree

    # --- ranks -----------------------------------------------------------
    def _coord(self):
        return self._topo.get_coord(min(self.global_rank, self.nranks - 1))

    def get_data_parallel_rank(self) -> int:
        return self._coord()["dp"]

    def get_model_parallel_rank(self) -> int:
        return self._coord()["mp"]

    def get_stage_id(self) -> int:
        return self._coord()["pp"]

    def get_pipe_parallel_rank(self) -> int:
        return self._coord()["pp"]

    def get_sharding_parallel_rank(self) -> int:
        return self._coord()["sharding"]

    def get_sep_parallel_rank(self) -> int:
        return self._coord()["sep"]

    # --- groups ----------------------------------------------------------
    def get_data_parallel_group(self) -> coll.Group:
        return self._groups["dp"]

    def get_model_parallel_group(self) -> coll.Group:
        return self._groups["mp"]

    def get_pipe_parallel_group(self) -> coll.Group:
        return self._groups["pp"]

    def get_sharding_parallel_group(self) -> coll.Group:
        return self._groups["sharding"]

    def get_sep_parallel_group(self) -> coll.Group:
        return self._groups["sep"]

    def get_check_parallel_group(self, *a) -> coll.Group:
        return self._check_group

    def get_data_parallel_group_src_rank(self) -> int:
        return self._groups["dp"].ranks[0]

    def get_model_parallel_group_src_rank(self) -> int:
        return self._groups["mp"].ranks[0]

    # --- pipeline helpers ------------------------------------------------
    def is_first_stage(self) -> bool:
        return self.get_stage_id() == 0

    def is_last_stage(self) -> bool:
        return self.get_stage_id() == self._pp_degree - 1

    def get_p2p_groups(self):
        return None

    def get_rank_from_stage(self, stage_id: int, **kwargs) -> int:
        coord = self._coord()
        coord["pp"] = stage_id
        coord.update(kwargs)
        return self._topo.get_rank(**coord)

    def topology(self) -> CommunicateTopology:
        return self._topo


_hcg: Optional[HybridCommunicateGroup] = None


def set_hcg(hcg: HybridCommunicateGroup):
    global _hcg
    _hcg = hcg


def get_hcg() -> Optional[HybridCommunicateGroup]:
    return _hcg
