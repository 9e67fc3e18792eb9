"""Pillow's image operations on uint8 numpy images, pixel for pixel.

``dream_tpu`` resizes, blends and composes PIL images
(``dream_tpu/visualize.py:218-244, 304-307``, ``dream_tpu/ops/pil_compat.py``).
The port runs where Pillow is not installed, so this module carries the
algorithms of Pillow's ``libImaging`` on ``[H, W]`` or ``[H, W, C]`` uint8
arrays:

- :func:`resize`: ``Image.resize(size, BILINEAR)`` (``Resample.c``).  The
  triangle filter's support grows with the downscale factor; each output
  sample's taps are normalized in double and turned into fixed point with
  ``PRECISION_BITS = 22`` (rounded half away from zero); the horizontal
  pass runs first and clips to uint8, then the vertical pass.  No
  ``reducing_gap``.
- :func:`blend`: ``Image.blend``: ``in1 + alpha * (in2 - in1)`` in C float
  with ``alpha`` a float, truncated to uint8.
- :func:`new`, :func:`paste`, :func:`crop`: ``Image.new``,
  ``Image.paste`` at an upper-left corner (clipped to the canvas) and
  ``Image.crop`` (outside the image reads as zeros).
- :func:`as_image`: what ``Image.fromarray(x.astype(np.uint8))`` keeps of
  an array (or of a torch tensor, moved to the host).

Sizes are ``(width, height)`` as in PIL.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def as_image(image) -> np.ndarray:
    """A uint8 image array from a numpy array (cast with wrap-around, as
    ``Image.fromarray(x.astype(np.uint8))``) or a torch tensor (moved to the
    host first)."""
    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    image = np.asarray(image)
    if image.ndim not in (2, 3):
        raise ValueError(f"expected an [H, W] or [H, W, C] image, got shape {image.shape}")
    return image if image.dtype == np.uint8 else image.astype(np.uint8)


def _check(image: np.ndarray) -> np.ndarray:
    if not (isinstance(image, np.ndarray) and image.dtype == np.uint8 and image.ndim in (2, 3)):
        raise TypeError("expected a uint8 [H, W] or [H, W, C] numpy array")
    return image


def _coefficients(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the bilinear
    filter over the whole input: tap indices and int32-range fixed-point
    weights, ``[out_size, ksize]`` each (unused taps weigh 0)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    used = taps[None, :] < xmax[:, None]
    x = (taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale)
    w = np.where(used, np.maximum(1.0 - np.abs(x), 0.0), 0.0)
    ww = np.zeros((out_size, 1))
    for k in range(ksize):  # summed tap by tap, in C's order
        ww[:, 0] += w[:, k]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    fixed = np.where(w < 0, (-0.5 + w * (1 << PRECISION_BITS)),
                     (0.5 + w * (1 << PRECISION_BITS))).astype(np.int64)
    index = np.minimum(xmin[:, None] + taps[None, :], in_size - 1)
    return index, np.where(used, fixed, 0)


def _clip8(acc: np.ndarray) -> np.ndarray:
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize(image: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """``Image.resize(size, resample=BILINEAR)``; ``size`` is (width, height)."""
    image = _check(image)
    width, height = int(size[0]), int(size[1])
    if width <= 0 or height <= 0:
        raise ValueError("resize: the size must be positive")
    out = image if image.ndim == 3 else image[..., None]
    in_h, in_w = out.shape[:2]
    if (width, height) == (in_w, in_h):
        return image.copy()
    half = np.int64(1 << (PRECISION_BITS - 1))
    if width != in_w:
        index, weight = _coefficients(in_w, width)
        acc = np.full((in_h, width, out.shape[2]), half, np.int64)
        for k in range(index.shape[1]):
            acc += out[:, index[:, k], :].astype(np.int64) * weight[None, :, k, None]
        out = _clip8(acc)
    if height != in_h:
        index, weight = _coefficients(in_h, height)
        acc = np.full((height, out.shape[1], out.shape[2]), half, np.int64)
        for k in range(index.shape[1]):
            acc += out[index[:, k]].astype(np.int64) * weight[:, k, None, None]
        out = _clip8(acc)
    return out if image.ndim == 3 else out[..., 0]


def blend(image1: np.ndarray, image2: np.ndarray, alpha: float) -> np.ndarray:
    """``Image.blend(image1, image2, alpha)``."""
    image1, image2 = _check(image1), _check(image2)
    if image1.shape != image2.shape:
        raise ValueError("images do not match")
    a = np.float32(alpha)
    in1 = image1.astype(np.float32)
    diff = (image2.astype(np.int32) - image1.astype(np.int32)).astype(np.float32)
    out = in1 + a * diff
    return np.clip(out, 0.0, 255.0).astype(np.uint8)


def new(size: Sequence[int], color=(0, 0, 0)) -> np.ndarray:
    """``Image.new("RGB", size, color)``."""
    width, height = int(size[0]), int(size[1])
    return np.broadcast_to(np.asarray(color, np.uint8), (height, width, 3)).copy()


def paste(canvas: np.ndarray, image: np.ndarray, box: Sequence[int] = (0, 0)) -> np.ndarray:
    """``canvas.paste(image, box)`` with ``box`` the upper-left corner, in
    place (returned).  A gray image pasted on RGB is replicated to RGB."""
    canvas, image = _check(canvas), _check(image)
    if canvas.ndim == 3 and image.ndim == 2:
        image = np.repeat(image[..., None], canvas.shape[2], axis=2)
    x, y = int(box[0]), int(box[1])
    h, w = image.shape[:2]
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, canvas.shape[1]), min(y + h, canvas.shape[0])
    if x0 < x1 and y0 < y1:
        canvas[y0:y1, x0:x1] = image[y0 - y : y1 - y, x0 - x : x1 - x]
    return canvas


def crop(image: np.ndarray, box: Sequence[int]) -> np.ndarray:
    """``Image.crop((left, upper, right, lower))``: a new array; what lies
    outside the image reads as zeros."""
    image = _check(image)
    left, upper, right, lower = (int(v) for v in box)
    out = np.zeros((max(lower - upper, 0), max(right - left, 0)) + image.shape[2:], np.uint8)
    return paste(out, image, (-left, -upper))
