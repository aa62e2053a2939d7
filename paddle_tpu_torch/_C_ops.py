"""Low-level op namespace of the port: every op in `ops.dispatch.OPS`.

Counterpart of `paddle_tpu/_C_ops.py`: an op is visible here exactly
when the port registers it. The name of an op that waits for another
item of the port (`ops/kernels/_util.py` `WAITING`) raises `WaitingOp`,
a NotImplementedError naming the item that is also an AttributeError;
any other name raises AttributeError."""
from .incubate.nn import functional as _functional  # noqa: F401  (registers)
from .ops.dispatch import OPS as _OPS
from .ops.kernels import fused_ops as _fused_ops  # noqa: F401  (registers)
from .ops.kernels import serving_attention as _serving  # noqa: F401
from .ops.kernels import tail_alias as _tail_alias  # noqa: F401
from .ops.kernels import graph_ops as _graph_ops  # noqa: F401
from .ops.kernels import rnn_ops as _rnn_ops  # noqa: F401
from .ops.kernels import tail_collective as _tail_collective  # noqa: F401
from .ops.kernels import tail_math as _tail_math  # noqa: F401
from .ops.kernels import tail_nn as _tail_nn  # noqa: F401
from .ops.kernels import tail_r4 as _tail_r4  # noqa: F401
from .ops.kernels import tail_r5 as _tail_r5  # noqa: F401
from .ops.kernels import tail_r5b as _tail_r5b  # noqa: F401
from .ops.kernels import tail_r5c as _tail_r5c  # noqa: F401
from .ops.kernels import tail_r5d as _tail_r5d  # noqa: F401
from .ops.kernels import tail_seq as _tail_seq  # noqa: F401
from .ops.kernels import vision_ops as _vision_ops  # noqa: F401
from .ops.kernels import yolo_loss as _yolo_loss  # noqa: F401
from .ops.kernels._util import WAITING as _WAITING
from .ops.kernels._util import waiting_error as _waiting_error


def __getattr__(name):
    if name in _OPS:
        return _OPS[name]
    if name in _WAITING:
        raise _waiting_error(name)
    raise AttributeError(
        f"_C_ops has no op {name!r}: not ported to paddle_tpu_torch yet "
        f"(ROADMAP Queue A)")


def __dir__():
    return sorted(_OPS)
