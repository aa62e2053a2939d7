"""paddle.vision of the port: `models` (LeNet), `ops` (the detection op
surface), and the image backend switch and `image_load` of the
reference's `paddle_tpu/vision/__init__.py`. `datasets`, `transforms`
and the other models (`ResNet`, `resnet18`, `resnet50`, ...) wait for
ROADMAP item 9."""
from . import models  # noqa: F401
from . import ops  # noqa: F401
from .models import LeNet  # noqa: F401

_image_backend = "pil"


def set_image_backend(backend):
    """'pil' (a PIL image), 'cv2' (an HWC BGR array) or 'tensor' (a CHW
    Tensor) (reference: vision/image.py set_image_backend)."""
    global _image_backend
    if backend not in ("pil", "cv2", "tensor"):
        raise ValueError(f"unsupported image backend {backend!r}")
    _image_backend = backend


def get_image_backend():
    return _image_backend


def image_load(path, backend=None):
    """Load a local image file (reference: vision/image.py image_load):
    'pil' -> PIL.Image, 'cv2' -> HWC BGR ndarray, 'tensor' -> CHW Tensor
    on the current place."""
    backend = backend or _image_backend
    from PIL import Image

    if backend == "pil":
        return Image.open(path)
    import numpy as _np

    with Image.open(path) as img:
        arr = _np.asarray(img.convert("RGB"))
    if backend == "cv2":
        return arr[:, :, ::-1].copy()   # cv2.imread's order is BGR
    from ..core.tensor import to_tensor

    return to_tensor(arr.transpose(2, 0, 1).copy())
