"""Low-level op namespace of the port: every op in `ops.dispatch.OPS`.

Counterpart of `paddle_tpu/_C_ops.py`: an op is visible here exactly
when the port registers it; any other name raises AttributeError, as an
op of the reference that is not ported yet."""
from .incubate.nn import functional as _functional  # noqa: F401  (registers)
from .ops.dispatch import OPS as _OPS
from .ops.kernels import fused_ops as _fused_ops  # noqa: F401  (registers)
from .ops.kernels import serving_attention as _serving  # noqa: F401
from .ops.kernels import tail_alias as _tail_alias  # noqa: F401


def __getattr__(name):
    if name in _OPS:
        return _OPS[name]
    raise AttributeError(
        f"_C_ops has no op {name!r}: not ported to paddle_tpu_torch yet "
        f"(ROADMAP Queue A)")


def __dir__():
    return sorted(_OPS)
