"""Fault injection for the port's serving paths (`chaos`)."""
from . import chaos

__all__ = ["chaos"]
