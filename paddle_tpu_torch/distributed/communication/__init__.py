"""`paddle.distributed.communication` — the port of
`paddle_tpu/distributed/communication/`: the collective wrappers of
`distributed.collective` under the reference's module path, and the
`stream` variants."""
from ..collective import (  # noqa: F401
    P2POp,
    ReduceOp,
    all_gather,
    all_gather_object,
    all_reduce,
    alltoall,
    alltoall_single,
    barrier,
    batch_isend_irecv,
    broadcast,
    broadcast_object_list,
    irecv,
    isend,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
)
from . import stream  # noqa: E402,F401
