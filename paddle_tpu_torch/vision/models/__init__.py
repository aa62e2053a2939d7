"""paddle.vision.models of the port: LeNet only so far (the rest of
`paddle_tpu/vision/models` is a later slice)."""
from .lenet import LeNet  # noqa: F401
