"""Vision: models, datasets, transforms and the detection operators
(counterpart of ``paddle_tpu/vision``), with the image-backend setting."""

from . import datasets, models, ops, transforms

__all__ = ["datasets", "models", "ops", "transforms", "set_image_backend",
           "get_image_backend", "image_load"]

_image_backend = ["pil"]


def set_image_backend(backend: str) -> None:
    """Record the image backend (``"pil"``, ``"cv2"`` or ``"numpy"``); the
    datasets read numpy arrays whatever it says."""
    if backend not in ("pil", "cv2", "numpy"):
        raise ValueError(f"unsupported image backend {backend!r}")
    _image_backend[0] = backend


def get_image_backend() -> str:
    return _image_backend[0]


def image_load(path, backend=None):
    """An image file through Pillow: the ``PIL.Image`` under the ``"pil"``
    backend, else its HWC array. Raises ``ImportError`` without Pillow."""
    import numpy as np

    try:
        from PIL import Image
    except ImportError:
        raise ImportError("image_load needs Pillow, which is not "
                          "installed; the datasets use synthetic arrays "
                          "instead") from None
    img = Image.open(path)
    if (backend or _image_backend[0]) == "pil":
        return img
    return np.asarray(img)
