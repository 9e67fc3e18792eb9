"""The device-side batch transform of training: raw frames -> a training batch.

Port of ``dream_tpu/data/dataset.py:295-347`` (``make_batch_processor``)
and of ``:528-562`` (``collect_calibration_batches``) over frames in
memory.  The NDDS-on-disk reader and the loaders of that module are not
ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dream_tpu_torch.data.augment import DEFAULT_AUGMENT, AugmentConfig, augment_batch
from dream_tpu_torch.ops import coords as coord_ops
from dream_tpu_torch.ops.belief_maps import create_belief_maps
from dream_tpu_torch.ops.image_proc import normalize_images, preprocess_images


def make_batch_processor(
    image_raw_resolution: Tuple[int, int],
    network_input_resolution: Tuple[int, int],
    network_output_resolution: Tuple[int, int],
    image_preprocessing: str,
    image_normalization: Optional[dict],
    augment: bool = False,
    augment_config: AugmentConfig = DEFAULT_AUGMENT,
    include_belief_maps: bool = True,
    warp_backend: str = "auto",
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build the batch transform.

    Returns ``process(generator, image_rgb_raw_u8, kp_projs_raw) -> dict``
    with ``image_rgb_input`` (normalized net input, NHWC),
    ``keypoint_projections_input`` (net-input frame),
    ``keypoint_projections_output`` (net-output frame) and, unless
    ``include_belief_maps`` is false, ``belief_maps [B, n_kp, h, w]``.
    The work runs on the raw images' device; ``generator`` (on that device)
    drives the augmentation and is not read when ``augment`` is false.
    ``warp_backend`` is passed to :func:`augment_batch`.
    """
    to_netin = coord_ops.affine_netin_from_raw(
        image_raw_resolution, network_input_resolution, image_preprocessing
    )
    to_netout = coord_ops.affine_netout_from_netin(
        network_input_resolution, network_output_resolution
    )

    def process(generator: Optional[torch.Generator], image_rgb_raw: torch.Tensor,
                kp_projs_raw: torch.Tensor) -> Dict[str, torch.Tensor]:
        images = preprocess_images(
            image_rgb_raw, network_input_resolution, image_preprocessing
        )  # float32, 0-255 scale
        kp_netin = to_netin(kp_projs_raw.to(images.device, torch.float32))
        if augment:
            images, kp_netin = augment_batch(
                generator, images, kp_netin, augment_config, warp_backend
            )
        if image_normalization:
            net_input = normalize_images(
                images, image_normalization["mean"], image_normalization["stdev"]
            )
        else:
            net_input = images / 255.0
        kp_netout = to_netout(kp_netin)
        out = {
            "image_rgb_input": net_input,
            "keypoint_projections_input": kp_netin,
            "keypoint_projections_output": kp_netout,
        }
        if include_belief_maps:
            out["belief_maps"] = create_belief_maps(kp_netout, network_output_resolution)
        return out

    return process


def collect_calibration_batches(frames: np.ndarray, process: Callable[..., Dict[str, torch.Tensor]],
                                n_frames: int, batch_size: int = 16) -> List[torch.Tensor]:
    """Net-input batches of at least ``n_frames`` frames for int8 calibration.

    ``frames`` is uint8 ``[F, H, W, 3]``; batches of ``batch_size`` are taken
    from its head in order, the last one kept even when short, and run
    through ``process`` (a non-augmenting :func:`make_batch_processor`
    closure, fed placeholder key points) until ``n_frames`` are reached.
    Returns the ``image_rgb_input`` batches.
    """
    if batch_size <= 0:
        raise ValueError("batch_size must be positive")
    batches: List[torch.Tensor] = []
    n = 0
    for start in range(0, len(frames), batch_size):
        images = torch.as_tensor(np.asarray(frames[start : start + batch_size], dtype=np.uint8))
        kp_raw = torch.zeros((images.shape[0], 1, 2), dtype=torch.float32)
        batches.append(process(None, images, kp_raw)["image_rgb_input"])
        n += images.shape[0]
        if n >= n_frames:
            break
    if not batches:
        raise ValueError("calibration frames are empty")
    return batches
