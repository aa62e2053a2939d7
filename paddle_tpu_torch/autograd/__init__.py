"""Autograd: paddle's entry points over torch's autograd (port of
`paddle_tpu/autograd/`; `functional.py` is not ported yet)."""
from ..ops.dispatch import (enable_grad, is_grad_enabled, no_grad,  # noqa: F401
                            set_grad_enabled)
from .backward_mode import backward  # noqa: F401
from .engine import grad, run_backward  # noqa: F401
from .py_layer import (LegacyPyLayer, PyLayer, PyLayerContext,  # noqa: F401
                       PyLayerMeta)
