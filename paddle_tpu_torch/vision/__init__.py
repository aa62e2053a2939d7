"""paddle.vision of the port: `models` (LeNet) and `ops` (the detection
op surface)."""
from . import models  # noqa: F401
from . import ops  # noqa: F401
