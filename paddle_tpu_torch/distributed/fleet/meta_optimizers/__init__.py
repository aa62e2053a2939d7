"""Fleet's meta optimizers (reference: `paddle_tpu/distributed/fleet/meta_optimizers/`)."""
from .dygraph_optimizer import (  # noqa: F401
    DygraphShardingOptimizer,
    HybridParallelOptimizer,
)
