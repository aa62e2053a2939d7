"""Training: the single-device train step (`hybrid`)."""
from . import hybrid

__all__ = ["hybrid"]
