"""Framework-level utilities: port of `paddle_tpu/framework/`."""
from ..core.rng import get_rng_state, seed, set_rng_state  # noqa: F401
from .io_api import load, save  # noqa: F401
