from .dygraph_sharding_optimizer import DygraphShardingOptimizer  # noqa: F401
from .hybrid_parallel_optimizer import HybridParallelOptimizer  # noqa: F401
