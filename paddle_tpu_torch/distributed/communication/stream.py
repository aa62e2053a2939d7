"""`paddle.distributed.stream` — the port of
`paddle_tpu/distributed/communication/stream.py`: the collectives with
the reference's `sync_op` / `use_calc_stream` switches.

`sync_op=True` waits for the collective before returning its Task;
`use_calc_stream=True` (the reference: run inline on the compute stream,
no task) waits and returns None. On the card a wait orders the
communication stream's work before the caller's stream (torch's
`Work.wait`); on the CPU it blocks.
"""
from __future__ import annotations

from .. import collective as C

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "alltoall",
           "alltoall_single", "broadcast", "reduce", "scatter", "send",
           "recv"]


def _finish(task, sync_op: bool, use_calc_stream: bool):
    waitable = hasattr(task, "wait")
    if use_calc_stream:
        if waitable:
            task.wait()
            return None
        return task
    if sync_op and waitable:
        task.wait()
    return task


def all_reduce(tensor, op=C.ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=False):
    return _finish(C.all_reduce(tensor, op=op, group=group, sync_op=False),
                   sync_op, use_calc_stream)


def all_gather(tensor_or_tensor_list, tensor, group=None, sync_op=True,
               use_calc_stream=False):
    if isinstance(tensor_or_tensor_list, list):
        task = C.all_gather(tensor_or_tensor_list, tensor, group=group,
                            sync_op=False)
    else:
        task = C.all_gather_into_tensor(tensor_or_tensor_list, tensor,
                                        group=group, sync_op=False)
    return _finish(task, sync_op, use_calc_stream)


def reduce_scatter(tensor, tensor_or_tensor_list, op=C.ReduceOp.SUM,
                   group=None, sync_op=True, use_calc_stream=False):
    task = C.reduce_scatter(tensor, tensor_or_tensor_list, op=op,
                            group=group, sync_op=False)
    return _finish(task, sync_op, use_calc_stream)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True,
             use_calc_stream=False):
    task = C.alltoall(out_tensor_list, in_tensor_list, group=group,
                      sync_op=False)
    return _finish(task, sync_op, use_calc_stream)


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True,
                    use_calc_stream=False):
    task = C.alltoall_single(out_tensor, in_tensor,
                             in_split_sizes=in_split_sizes,
                             out_split_sizes=out_split_sizes, group=group,
                             sync_op=False)
    return _finish(task, sync_op, use_calc_stream)


def broadcast(tensor, src=0, group=None, sync_op=True,
              use_calc_stream=False):
    return _finish(C.broadcast(tensor, src=src, group=group, sync_op=False),
                   sync_op, use_calc_stream)


def reduce(tensor, dst=0, op=C.ReduceOp.SUM, group=None, sync_op=True,
           use_calc_stream=False):
    return _finish(C.reduce(tensor, dst=dst, op=op, group=group,
                            sync_op=False),
                   sync_op, use_calc_stream)


def scatter(tensor, tensor_or_tensor_list=None, src=0, group=None,
            sync_op=True, use_calc_stream=False):
    task = C.scatter(tensor, tensor_list=tensor_or_tensor_list, src=src,
                     group=group, sync_op=False)
    return _finish(task, sync_op, use_calc_stream)


def send(tensor, dst=0, group=None, sync_op=True, use_calc_stream=False):
    return _finish(C.send(tensor, dst=dst, group=group, sync_op=False),
                   sync_op, use_calc_stream)


def recv(tensor, src=0, group=None, sync_op=True, use_calc_stream=False):
    return _finish(C.recv(tensor, src=src, group=group, sync_op=False),
                   sync_op, use_calc_stream)
