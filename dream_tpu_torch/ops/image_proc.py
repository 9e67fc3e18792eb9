"""Batched image preprocessing: uint8 frames -> normalized float net input.

Port of ``dream_tpu/ops/image_proc.py``.  Images stay channels-last
``[B, H, W, 3]`` at this module's boundary, as in the JAX package, so the
two compare like with like; the network moves them to NCHW.

The JAX package resizes with ``jax.image.resize(bilinear, antialias=True)``:
a separable triangle filter, widened by the downscale factor, applied as a
dense ``[in, out]`` weight matrix per axis.  ``F.interpolate(antialias=True)``
builds its taps differently, so here the same matrices are built in numpy
float32 step for step after ``jax._src.image.scale.compute_weight_mat`` and
applied as two float32 matmuls.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from dream_tpu_torch.utils.resolutions import (
    KNOWN_IMAGE_PREPROC_TYPES,
    resolution_after_preprocessing,
    shrink_and_crop_resolution,
)


@functools.lru_cache(maxsize=None)
def resize_weight_matrix(input_size: int, output_size: int) -> np.ndarray:
    """``[output_size, input_size]`` antialiased bilinear resize operator.

    Row ``o`` holds the taps that produce output sample ``o``; the float32
    arithmetic follows jax's ``compute_weight_mat`` with the triangle kernel.
    """
    f32 = np.float32
    scale = output_size / input_size
    inv_scale = f32(1.0 / scale)
    kernel_scale = f32(max(1.0 / scale, 1.0))
    sample_f = (np.arange(output_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(input_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    weights = np.where(inside[None, :], weights, f32(0.0)).astype(f32)
    return np.ascontiguousarray(weights.T)


@functools.cache
def _cuda_weight_matrix(input_size: int, output_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(resize_weight_matrix(input_size, output_size)).to(device)


def _weight_matrix_for(x: torch.Tensor, input_size: int, output_size: int) -> torch.Tensor:
    """:func:`resize_weight_matrix` on ``x``'s device.  On a CUDA device a
    plain tensor gets a copy uploaded once and kept: a CUDA graph can hold
    no host-to-device copy, and its replays read the same tensor.  A
    tensor being traced (``torch.export``'s fake tensors) gets a fresh one,
    so that no traced value is kept."""
    if x.is_cuda and type(x) is torch.Tensor:
        return _cuda_weight_matrix(input_size, output_size, x.device)
    return torch.from_numpy(resize_weight_matrix(input_size, output_size)).to(x.device)


def resize_bilinear(images: torch.Tensor, resolution: Sequence[int]) -> torch.Tensor:
    """Antialiased bilinear resize of ``[B, H, W, C]`` images to (width, height).

    Returns float32 ``[B, h, w, C]``; an axis whose size does not change is
    left untouched, as in ``jax.image.resize``.
    """
    x = images.to(torch.float32)
    w_out, h_out = int(resolution[0]), int(resolution[1])
    h_in, w_in = x.shape[-3], x.shape[-2]
    x = x.permute(0, 3, 1, 2)  # [B, C, H, W]
    if h_in != h_out:
        x = torch.matmul(_weight_matrix_for(x, h_in, h_out), x)
    if w_in != w_out:
        x = torch.matmul(x, _weight_matrix_for(x, w_in, w_out).T)
    return x.permute(0, 2, 3, 1)


def shrink_and_crop_images(images: torch.Tensor, image_ref_resolution: Sequence[int]):
    """Center-crop to the reference aspect, then resize (reference
    dream/image_proc.py:291-315)."""
    in_res = (images.shape[-2], images.shape[-3])  # (width, height)
    cropped_res, (cu, cv) = shrink_and_crop_resolution(in_res, image_ref_resolution)
    cropped = images[:, cv : cv + cropped_res[1], cu : cu + cropped_res[0], :]
    return resize_bilinear(cropped, image_ref_resolution)


def preprocess_images(
    images: torch.Tensor, image_ref_resolution: Sequence[int], image_preprocessing: str
) -> torch.Tensor:
    """``[B, H, W, 3]`` uint8 -> float32 on the 0-255 scale, in the JAX
    package's four modes (reference dream/image_proc.py:26-51)."""
    if image_preprocessing not in KNOWN_IMAGE_PREPROC_TYPES:
        raise ValueError(f'Image preprocessing type "{image_preprocessing}" is not recognized.')
    if image_preprocessing == "none":
        return images.to(torch.float32)
    if image_preprocessing in ("resize", "shrink"):
        in_res = (images.shape[-2], images.shape[-3])
        target = resolution_after_preprocessing(
            in_res, image_ref_resolution, image_preprocessing
        )
        return resize_bilinear(images, target)
    return shrink_and_crop_images(images, image_ref_resolution)


def normalize_images(
    images: torch.Tensor, mean: Sequence[float], stdev: Sequence[float],
    input_scale: float = 255.0,
) -> torch.Tensor:
    """0-255 images -> ``(x / 255 - mean) / stdev`` (reference
    dream/network.py:449-456)."""
    x = images.to(torch.float32) / input_scale
    return (x - _filled(mean, x.device)) / _filled(stdev, x.device)


def _filled(values: Sequence[float], device: torch.device) -> torch.Tensor:
    """``torch.tensor(values)`` in float32 made by fills on ``device``: no
    host-to-device copy, which a CUDA graph could not hold."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32, device=device)
                        for v in values])


def preprocess_and_normalize(
    images: torch.Tensor,
    image_ref_resolution: Sequence[int],
    image_preprocessing: str,
    image_normalization: Optional[dict],
) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` -> float32 normalized net input ``[B, h, w, 3]``."""
    x = preprocess_images(images, image_ref_resolution, image_preprocessing)
    if image_normalization:
        return normalize_images(x, image_normalization["mean"], image_normalization["stdev"])
    return x / 255.0
