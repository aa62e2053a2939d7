"""Base of the meta-parallel wrappers: the port of
`paddle_tpu/distributed/fleet/meta_parallel/meta_parallel_base.py`. Wraps
a Layer, prepares its parameters for the wrapper's parallel dimension,
and forwards calls and the Layer protocol to it (`parallel.LayerWrapper`).
"""
from __future__ import annotations

from ....nn.layer.layers import Layer
from ...parallel import LayerWrapper


class MetaParallelBase(LayerWrapper):
    def __init__(self, layers: Layer, hcg, strategy):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        self._prepare_for_model()

    def _prepare_for_model(self):
        pass
