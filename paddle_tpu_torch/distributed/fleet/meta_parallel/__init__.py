"""Meta-parallel model wrappers (reference:
`paddle_tpu/distributed/fleet/meta_parallel/`): `TensorParallel` and
`SegmentParallel`, and the model-parallel layers and RNG tracker.

`PipelineParallel`, `PipelineLayer`, `LayerDesc`, `SharedLayerDesc` and
`SegmentLayers` come with the pipeline slice (ROADMAP item 7c); asking for
one raises `NotImplementedError` naming it.
"""
from .meta_parallel_base import MetaParallelBase  # noqa: F401
from .tensor_parallel import SegmentParallel, TensorParallel  # noqa: F401
from ..layers.mpu.mp_layers import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from ..layers.mpu.random import (  # noqa: F401
    RNGStatesTracker,
    get_rng_state_tracker,
)

PIPELINE_NAMES = ("PipelineParallel", "PipelineLayer", "LayerDesc",
                  "SharedLayerDesc", "SegmentLayers")


def __getattr__(name):
    if name in PIPELINE_NAMES:
        raise NotImplementedError(
            f"fleet.meta_parallel.{name} comes with the pipeline slice "
            f"(ROADMAP item 7c)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
