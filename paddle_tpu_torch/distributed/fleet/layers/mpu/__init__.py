"""Model-parallel utility layers (reference: fleet/layers/mpu/)."""
from .mp_layers import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from .random import (  # noqa: F401
    RNGStatesTracker,
    get_rng_state_tracker,
    model_parallel_random_seed,
)
from . import mp_ops  # noqa: F401
