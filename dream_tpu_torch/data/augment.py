"""Batched data augmentation with keypoint tracking, on the images' device.

Port of ``dream_tpu/data/augment.py``: ShiftScaleRotate (an affine warp with
bilinear taps and reflect-101 borders), RandomBrightnessContrast with
``brightness_by_max=False`` and GaussNoise, each applied with probability
0.5 per image, in ``augment_sample``'s order: warp (key points follow the
forward affine), brightness/contrast (the mean taken after the warp), noise,
clip to 0-255.

Torch cannot reproduce jax's PRNG draws, so sampling is split from
applying: :func:`sample_augment_params` draws every per-image parameter
from an explicit ``torch.Generator`` with the JAX package's distributions,
and :func:`apply_augment` applies given parameters and given standard
normal noise, so a test can inject the JAX package's draws.  The warp runs
through :func:`dream_tpu_torch.ops.warp.warp_batch`: the CUDA kernel for
CUDA images.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from dream_tpu_torch.ops.warp import warp_batch, warp_batch_plain


class AugmentConfig(NamedTuple):
    gauss_noise_var_limit: Tuple[float, float] = (10.0, 50.0)
    brightness_limit: float = 0.2
    contrast_limit: float = 0.2
    shift_limit: float = 0.0625
    scale_limit: float = 0.1
    rotate_limit_deg: float = 15.0
    p_noise: float = 0.5
    p_brightness_contrast: float = 0.5
    p_shift_scale_rotate: float = 0.5


DEFAULT_AUGMENT = AugmentConfig()
WARP_BACKENDS = ("auto", "plain")


class AugmentParams(NamedTuple):
    """Per-image augmentation parameters of a batch of ``B`` images."""

    affines: torch.Tensor  # [B, 2, 3] forward affines (identity where not applied)
    brightness_contrast: torch.Tensor  # [B] bool: apply brightness/contrast
    alpha: torch.Tensor  # [B] contrast factor
    beta: torch.Tensor  # [B] brightness, relative to the image mean
    noise: torch.Tensor  # [B] bool: add Gaussian noise
    noise_var: torch.Tensor  # [B] noise variance on the 0-255 scale


def affine_matrices(apply: torch.Tensor, angle_deg: torch.Tensor, scale: torch.Tensor,
                    dx: torch.Tensor, dy: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``[B, 2, 3]`` forward affines, ``augment._affine_matrix``'s formula:
    rotation by ``angle_deg`` about the centre, scaled, then shifted by
    ``(dx, dy)`` pixels (``cv2.getRotationMatrix2D`` convention); identity
    where ``apply`` is false."""
    angle = torch.where(apply, angle_deg * (math.pi / 180.0), torch.zeros_like(angle_deg))
    scale = torch.where(apply, scale, torch.ones_like(scale))
    dx = torch.where(apply, dx, torch.zeros_like(dx))
    dy = torch.where(apply, dy, torch.zeros_like(dy))
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    cos, sin = torch.cos(angle) * scale, torch.sin(angle) * scale
    row0 = torch.stack([cos, sin, (1 - cos) * cx - sin * cy + dx], dim=-1)
    row1 = torch.stack([-sin, cos, sin * cx + (1 - cos) * cy + dy], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _uniform(generator: torch.Generator, n: int, low: float, high: float) -> torch.Tensor:
    u = torch.rand(n, generator=generator, device=generator.device)
    return low + (high - low) * u


def _bernoulli(generator: torch.Generator, n: int, p: float) -> torch.Tensor:
    return torch.rand(n, generator=generator, device=generator.device) < p


def sample_augment_params(generator: torch.Generator, n: int, height: int, width: int,
                          cfg: AugmentConfig = DEFAULT_AUGMENT) -> AugmentParams:
    """Draw ``n`` images' parameters on the generator's device, from the
    distributions of ``augment._affine_matrix``, ``_brightness_contrast``
    and ``_gauss_noise``."""
    affines = affine_matrices(
        _bernoulli(generator, n, cfg.p_shift_scale_rotate),
        _uniform(generator, n, -cfg.rotate_limit_deg, cfg.rotate_limit_deg),
        1.0 + _uniform(generator, n, -cfg.scale_limit, cfg.scale_limit),
        _uniform(generator, n, -cfg.shift_limit, cfg.shift_limit) * width,
        _uniform(generator, n, -cfg.shift_limit, cfg.shift_limit) * height,
        height, width,
    )
    return AugmentParams(
        affines=affines,
        brightness_contrast=_bernoulli(generator, n, cfg.p_brightness_contrast),
        alpha=1.0 + _uniform(generator, n, -cfg.contrast_limit, cfg.contrast_limit),
        beta=_uniform(generator, n, -cfg.brightness_limit, cfg.brightness_limit),
        noise=_bernoulli(generator, n, cfg.p_noise),
        noise_var=_uniform(generator, n, *cfg.gauss_noise_var_limit),
    )


def transform_keypoints(keypoints: torch.Tensor, affines: torch.Tensor) -> torch.Tensor:
    """``[B, n_kp, 2]`` pixel key points through ``[B, 2, 3]`` forward affines
    (``augment._transform_keypoints``: homogeneous ``kp @ A^T``)."""
    ones = torch.ones(keypoints.shape[:-1] + (1,), dtype=keypoints.dtype, device=keypoints.device)
    return torch.cat([keypoints, ones], dim=-1) @ affines.to(keypoints.dtype).transpose(-1, -2)


def apply_augment(images: torch.Tensor, keypoints: torch.Tensor, params: AugmentParams,
                  noise: torch.Tensor, warp_backend: str = "auto"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Augment ``[B, H, W, C]`` 0-255 images and ``[B, n_kp, 2]`` key points.

    ``noise`` is ``[B, H, W, C]`` standard normal draws, scaled by each
    image's ``sqrt(noise_var)``.  ``warp_backend`` ``"auto"`` warps in the
    CUDA kernel for CUDA images and in the plain version for CPU images;
    ``"plain"`` forces the plain version (the counterpart of
    ``augment_batch``'s ``warp_backend="gather"``).
    """
    if warp_backend not in WARP_BACKENDS:
        raise ValueError(f"warp_backend must be one of {WARP_BACKENDS}, got {warp_backend!r}")
    warp = warp_batch if warp_backend == "auto" else warp_batch_plain
    affines = params.affines.to(images.device)
    out = warp(images.to(torch.float32), affines)
    keypoints = transform_keypoints(keypoints, affines)

    def per_image(v: torch.Tensor) -> torch.Tensor:
        return v.to(out.device)[:, None, None, None]

    mean = out.mean(dim=(1, 2, 3), keepdim=True)
    contrasted = out * per_image(params.alpha) + per_image(params.beta) * mean
    out = torch.where(per_image(params.brightness_contrast), contrasted, out)
    noisy = out + noise * torch.sqrt(per_image(params.noise_var))
    out = torch.where(per_image(params.noise), noisy, out)
    return out.clamp(0.0, 255.0), keypoints


def augment_batch(generator: torch.Generator, images: torch.Tensor, keypoints: torch.Tensor,
                  cfg: AugmentConfig = DEFAULT_AUGMENT, warp_backend: str = "auto",
                  shard: Optional[Tuple[int, int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample parameters and noise from ``generator`` (on the images'
    device) and apply them: the port of ``augment.augment_batch``.

    With ``shard = (i, n_shards)`` the images are part ``i`` of a global
    batch of ``n_shards`` equal parts: the global batch's parameters and
    noise are drawn and this part's rows of them applied, so the parts of a
    data-parallel step are augmented as the whole batch would be."""
    if generator.device.type != images.device.type:
        raise ValueError(f"generator on {generator.device}, images on {images.device}")
    n, h, w = images.shape[0], images.shape[1], images.shape[2]
    index, n_shards = shard if shard is not None else (0, 1)
    params = sample_augment_params(generator, n * n_shards, h, w, cfg)
    noise = torch.randn((n * n_shards,) + tuple(images.shape[1:]), generator=generator,
                        device=images.device)
    if n_shards > 1:
        rows = slice(index * n, (index + 1) * n)
        params = AugmentParams(*(field[rows] for field in params))
        noise = noise[rows]
    return apply_augment(images, keypoints, params, noise, warp_backend)
