"""Image bytes -> arrays.

Port of ``synapseml_tpu/io/binary.py::decode_image``. PIL is imported inside
the function, so the module (and every stage that imports it) loads on a
machine without PIL; only a call that decodes needs it.
"""

from __future__ import annotations

import io

import numpy as np

__all__ = ["decode_image"]


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes -> (H, W, C) uint8 array (RGB or grayscale expanded)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    if img.mode not in ("RGB", "L"):
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr
