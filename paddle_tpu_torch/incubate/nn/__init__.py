"""paddle.incubate.nn of the port: the fused functional ops
(`functional`). The fused Layer classes of
`paddle_tpu/incubate/nn/__init__.py` wait for the eager paddle API."""
from . import functional

__all__ = ["functional"]
