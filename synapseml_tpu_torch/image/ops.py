"""Image ops on torch tensors: the OpenCV-equivalent op library.

Port of ``synapseml_tpu/image/ops.py``: the same functions, names and
semantics, over ``(N, H, W, C)`` tensors on the caller's device (``resize_shorter``
takes one ``(H, W, C)`` image). Color images are BGR, as the reference's
``ImageSchema`` stores them.

- ``resize`` is ``jax.image.resize`` (``image/resample.py``): half-pixel
  centres, linear and cubic antialiased when downsampling; integer input is
  cast to f32 and never rounded back.
- The blurs are depthwise separable convolutions with edge padding, the
  vertical pass first, in full f32 (:func:`~..runtime.device.full_f32`:
  cuDNN's TF32 switch, on by default, would round them to ~1e-3).
- ``bgr2gray`` weighs the channels in order (B, G, R) with OpenCV's luma.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..runtime.device import full_f32
from .resample import resize_array

__all__ = [
    "resize",
    "resize_shorter",
    "crop",
    "center_crop",
    "flip",
    "gaussian_kernel_2d",
    "gaussian_blur",
    "box_blur",
    "threshold",
    "color_convert",
    "normalize",
]


def resize(images: torch.Tensor, height: int, width: int, method: str = "linear") -> torch.Tensor:
    """Batched resize to (height, width). images: (N,H,W,C)."""
    n, _, _, c = images.shape
    with full_f32():
        return resize_array(images.to(torch.float32), (n, height, width, c), method)


def resize_shorter(image: torch.Tensor, size: int, method: str = "linear") -> torch.Tensor:
    """Single-image aspect-preserving resize: shorter side -> ``size``
    (reference ``ResizeImage.size`` + ``keepAspectRatio``)."""
    h, w = image.shape[:2]
    ratio = size / min(h, w)
    th, tw = int(round(ratio * h)), int(round(ratio * w))
    with full_f32():
        return resize_array(image.to(torch.float32), (th, tw, image.shape[2]), method)


def crop(images: torch.Tensor, x: int, y: int, width: int, height: int) -> torch.Tensor:
    """Rectangle crop at (x, y) (reference ``CropImage``). x is column, y is row."""
    return images[:, y : y + height, x : x + width, :]


def center_crop(images: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Center crop (reference ``CenterCropImage``)."""
    h, w = images.shape[1:3]
    cw, ch = min(width, w), min(height, h)
    mx, my = w // 2, h // 2
    x0, y0 = mx - cw // 2, my - ch // 2
    return images[:, y0 : y0 + ch, x0 : x0 + cw, :]


def flip(images: torch.Tensor, flip_code: int = 1) -> torch.Tensor:
    """OpenCV flip codes: 0 vertical (around x-axis), >0 horizontal, <0 both."""
    if flip_code == 0:
        return torch.flip(images, (1,))
    if flip_code > 0:
        return torch.flip(images, (2,))
    return torch.flip(images, (1, 2))


def gaussian_kernel_2d(aperture: int, sigma: float) -> np.ndarray:
    """2-D Gaussian kernel matching OpenCV ``getGaussianKernel`` semantics."""
    if sigma <= 0:
        sigma = 0.3 * ((aperture - 1) * 0.5 - 1) + 0.8
    half = (aperture - 1) / 2.0
    xs = np.arange(aperture) - half
    k1 = np.exp(-(xs**2) / (2.0 * sigma**2))
    k1 /= k1.sum()
    return np.outer(k1, k1)


def _separable_blur(images: torch.Tensor, kx: np.ndarray, ky: np.ndarray) -> torch.Tensor:
    """Depthwise separable 2-D filter with edge ('replicate') padding, per
    channel: ``ky`` down the rows, then ``kx`` along them (cross-correlation,
    as XLA's convolution)."""
    n, h, w, c = images.shape
    x = images.to(torch.float32).permute(0, 3, 1, 2)            # NCHW
    top = (len(ky) - 1) // 2
    left = (len(kx) - 1) // 2
    x = F.pad(x, (left, len(kx) - 1 - left, top, len(ky) - 1 - top), mode="replicate")
    kv = torch.from_numpy(np.asarray(ky, np.float32)).to(x.device)
    kh = torch.from_numpy(np.asarray(kx, np.float32)).to(x.device)
    with full_f32():
        x = F.conv2d(x, kv.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
        x = F.conv2d(x, kh.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    return x.permute(0, 2, 3, 1).contiguous()


def gaussian_blur(images: torch.Tensor, aperture: int, sigma: float) -> torch.Tensor:
    """Gaussian blur (reference ``Blur``/GaussianBlur path)."""
    if sigma <= 0:
        sigma = 0.3 * ((aperture - 1) * 0.5 - 1) + 0.8
    half = (aperture - 1) / 2.0
    xs = np.arange(aperture) - half
    k1 = np.exp(-(xs**2) / (2.0 * sigma**2))
    k1 = k1 / k1.sum()
    return _separable_blur(images, k1, k1)


def box_blur(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Normalized box filter (reference ``Blur`` stage with (h,w) aperture)."""
    kx = np.full(width, 1.0 / width)
    ky = np.full(height, 1.0 / height)
    return _separable_blur(images, kx, ky)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def threshold(images: torch.Tensor, thresh: float, max_val: float,
              kind: str = "binary") -> torch.Tensor:
    """OpenCV-style thresholding (reference ``Threshold`` stage); ``thresh``
    and ``max_val`` are rounded to f32 as the reference's weak scalars are."""
    x = images.to(torch.float32)
    t, mv, zero = _f32(thresh, x), _f32(max_val, x), _f32(0.0, x)
    if kind == "binary":
        return torch.where(x > t, mv, zero)
    if kind == "binary_inv":
        return torch.where(x > t, zero, mv)
    if kind == "trunc":
        return torch.minimum(x, t)
    if kind == "tozero":
        return torch.where(x > t, x, zero)
    if kind == "tozero_inv":
        return torch.where(x > t, zero, x)
    raise ValueError(f"unknown threshold kind {kind!r}")


_BGR2GRAY = np.array([0.114, 0.587, 0.299], dtype=np.float32)  # OpenCV luma, BGR order


def color_convert(images: torch.Tensor, code: str) -> torch.Tensor:
    """Color-format conversion (reference ``ColorFormat`` stage). Supported codes:
    'bgr2rgb', 'rgb2bgr', 'bgr2gray', 'rgb2gray', 'gray2bgr', 'gray2rgb'."""
    code = code.lower()
    if code in ("bgr2rgb", "rgb2bgr"):
        return torch.flip(images, (-1,))
    if code in ("bgr2gray", "rgb2gray"):
        w = _BGR2GRAY if code.startswith("bgr") else _BGR2GRAY[::-1].copy()
        x = images.to(torch.float32)
        gray = x[..., 0] * float(w[0])
        for ch in (1, 2):
            gray = gray + x[..., ch] * float(w[ch])
        return gray[..., None]
    if code in ("gray2bgr", "gray2rgb"):
        return images.repeat_interleave(3, dim=-1)
    raise ValueError(f"unknown color conversion {code!r}")


def normalize(images: torch.Tensor, mean: Sequence[float], std: Sequence[float],
              scale: float = 1.0) -> torch.Tensor:
    """(x*scale - mean)/std per channel, in f32."""
    x = images.to(torch.float32) * scale
    m = torch.as_tensor(np.asarray(mean, np.float32), device=x.device).reshape(1, 1, 1, -1)
    s = torch.as_tensor(np.asarray(std, np.float32), device=x.device).reshape(1, 1, 1, -1)
    return (x - m) / s
