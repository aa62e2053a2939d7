"""Training (the single-device train step, `hybrid`), and the pieces the
serving fleet shares with it: the block-scaled int8 wire codec
(`quant_comm`), liveness by heartbeat (`membership`) and fault injection
(`fault_tolerance.chaos`)."""
from . import hybrid

__all__ = ["hybrid"]
