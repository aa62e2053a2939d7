"""paddle.incubate of the port: the fused functional ops
(`nn.functional`), the incubate optimizers (`LookAhead`, `ModelAverage`),
`inference` (the inference package) and the reference's aliases of
registered ops (`paddle_tpu/incubate/
__init__.py:13-23`). MoE, autograd, the distributed models and
`graph_send_recv` with the `segment_*` aliases wait for ROADMAP item 9.
"""
from . import nn
from .optimizer import LookAhead, ModelAverage
from ..ops import generated_bindings as _ops

graph_khop_sampler = _ops.graph_khop_sampler
graph_sample_neighbors = _ops.graph_sample_neighbors
graph_reindex = _ops.reindex_graph
identity_loss = _ops.identity_loss
softmax_mask_fuse = _ops.fused_softmax_mask
softmax_mask_fuse_upper_triangle = _ops.fused_softmax_mask_upper_triangle



def __getattr__(name):
    # paddle.incubate.inference: the inference package (the reference's
    # alias), loaded on first use
    if name == "inference":
        from .. import inference
        return inference
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["nn", "LookAhead", "ModelAverage", "graph_khop_sampler",
           "graph_sample_neighbors", "graph_reindex", "identity_loss",
           "softmax_mask_fuse", "softmax_mask_fuse_upper_triangle"]
