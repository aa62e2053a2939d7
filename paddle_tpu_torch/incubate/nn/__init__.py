"""paddle.incubate.nn of the port: the fused functional ops
(`functional`) and the fused Layer classes (`layer.py`), which load on
first use: the nn kernels import `functional`, and the layers import
`nn`."""
from . import functional

__all__ = ["functional", "FusedLinear", "FusedMultiHeadAttention",
           "FusedFeedForward", "FusedDropoutAdd",
           "FusedBiasDropoutResidualLayerNorm", "FusedMultiTransformer",
           "FusedTransformerEncoderLayer"]


def __getattr__(name):
    if name in __all__:
        from . import layer

        return getattr(layer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
