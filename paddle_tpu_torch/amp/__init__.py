"""Automatic mixed precision: port of `paddle_tpu/amp/`.

`auto_cast` applies the reference's per-op dtype policy (its O1 white and
black lists, O2, `decorate`) inside the port's `call_op`
(`ops/dispatch.py` `set_amp_hook`), not through `torch.autocast`, whose
lists differ: an op's output type under AMP is the reference's.
`GradScaler` passes through for bfloat16 and scales dynamically for
float16; `debugging` collects per-op statistics and checks outputs over
the same dispatch.
"""
from . import debugging  # noqa: F401
from .auto_cast import (amp_guard, amp_pre_dispatch, auto_cast,  # noqa: F401
                        black_list, decorate, white_list)
from .grad_scaler import AmpScaler, GradScaler  # noqa: F401


def is_bfloat16_supported(place=None):
    return True


def is_float16_supported(place=None):
    return True
