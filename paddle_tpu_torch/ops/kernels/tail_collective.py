"""Op tail 5, the collective op names and executor plumbing of
`paddle_tpu/ops/kernels/tail_collective.py`: every name waits for
ROADMAP item 7, which ports the collective layer these ops run through
(`all_reduce`, `c_allreduce_*`, `broadcast`, ..., and the plumbing
registered beside them). Each raises NotImplementedError naming the
item; none is an identity stand-in.
"""
from __future__ import annotations

from ._util import waiting

NAMES = (
    "all_gather", "all_reduce", "all_to_all", "assign_out_", "assign_value_",
    "broadcast", "c_allgather", "c_allreduce_max", "c_allreduce_min",
    "c_allreduce_prod", "c_allreduce_sum", "c_broadcast", "c_concat",
    "c_identity", "c_reduce_sum", "c_scatter", "coalesce_tensor", "copy_to",
    "depend", "full_", "full_int_array", "full_with_tensor", "memcpy_d2h",
    "memcpy_h2d", "mp_allreduce_sum", "npu_identity", "reduce",
    "reduce_scatter", "set", "set_value_with_tensor", "shape", "share_data",
    "slice", "sync_calc_stream", "trans_layout",
)

for _name in NAMES:
    waiting(_name, 7)
