"""paddle.vision of the port: `models` (LeNet) only so far."""
from . import models  # noqa: F401
