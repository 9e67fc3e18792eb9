"""Keypoint coordinate-frame conversions as composable affine transforms.

A numpy/torch rewrite of ``dream_tpu/ops/coords.py``.  Every map between
the raw / net-input / net-output pixel frames is an axis-aligned affine
transform ``kp' = kp * scale + offset``, so they all collapse into one
:class:`KeypointAffine` with compose/invert, applied to whole ``[..., 2]``
arrays at once: a torch tensor stays a tensor on its device, anything else
becomes a float64 numpy array.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from dream_tpu_torch.utils.resolutions import (
    KNOWN_IMAGE_PREPROC_TYPES,
    shrink_resolution,
    shrink_and_crop_resolution,
)


class KeypointAffine(NamedTuple):
    """Axis-aligned 2D affine map ``kp' = kp * scale + offset``.

    ``scale`` and ``offset`` are length-2 tuples of Python floats.
    """

    scale: Tuple[float, float]
    offset: Tuple[float, float]

    def __call__(self, keypoints):
        if isinstance(keypoints, torch.Tensor):
            # Per axis with Python scalars: no host-to-device copy (which a
            # CUDA graph could not hold), the same roundings.
            return torch.stack([keypoints[..., i] * self.scale[i] + self.offset[i] for i in (0, 1)],
                               dim=-1)
        return self.apply_numpy(keypoints)

    def apply_numpy(self, keypoints):
        kp = np.asarray(keypoints, dtype=float)
        return kp * np.asarray(self.scale) + np.asarray(self.offset)

    def compose(self, inner: "KeypointAffine") -> "KeypointAffine":
        """Returns the transform equivalent to ``self(inner(kp))``."""
        sx, sy = self.scale
        isx, isy = inner.scale
        iox, ioy = inner.offset
        return KeypointAffine(
            scale=(sx * isx, sy * isy),
            offset=(sx * iox + self.offset[0], sy * ioy + self.offset[1]),
        )

    def invert(self) -> "KeypointAffine":
        sx, sy = self.scale
        ox, oy = self.offset
        return KeypointAffine(scale=(1.0 / sx, 1.0 / sy), offset=(-ox / sx, -oy / sy))


IDENTITY = KeypointAffine(scale=(1.0, 1.0), offset=(0.0, 0.0))


def _scale_between(src_res: Sequence[int], dst_res: Sequence[int]) -> KeypointAffine:
    return KeypointAffine(
        scale=(float(dst_res[0]) / float(src_res[0]),
               float(dst_res[1]) / float(src_res[1])),
        offset=(0.0, 0.0),
    )


def affine_netin_from_netout(net_output_resolution, net_input_resolution):
    """Parity: reference dream/image_proc.py:135-147."""
    return _scale_between(net_output_resolution, net_input_resolution)


def affine_netout_from_netin(net_input_resolution, net_output_resolution):
    """Parity: reference dream/image_proc.py:150-162."""
    return _scale_between(net_input_resolution, net_output_resolution)


def affine_netin_from_raw(
    image_raw_resolution, net_input_resolution, image_preprocessing
) -> KeypointAffine:
    """Raw-frame -> net-input-frame keypoint map for a preprocessing mode.

    Parity: reference dream/image_proc.py:165-212.  Note for "shrink" the
    reference scales by shrink_res/raw_res, and for "shrink-and-crop" it first
    subtracts the crop offset then scales by net_in/cropped_res.
    """
    assert image_preprocessing in KNOWN_IMAGE_PREPROC_TYPES, (
        f'Image preprocessing type "{image_preprocessing}" is not recognized.'
    )
    if image_preprocessing == "none":
        return IDENTITY
    if image_preprocessing == "resize":
        return _scale_between(image_raw_resolution, net_input_resolution)
    if image_preprocessing == "shrink":
        shrink_res = shrink_resolution(image_raw_resolution, net_input_resolution)
        return _scale_between(image_raw_resolution, shrink_res)
    # shrink-and-crop
    cropped_res, cropped_coords = shrink_and_crop_resolution(
        image_raw_resolution, net_input_resolution
    )
    scale = _scale_between(cropped_res, net_input_resolution)
    shift = KeypointAffine(
        scale=(1.0, 1.0), offset=(-float(cropped_coords[0]), -float(cropped_coords[1]))
    )
    return scale.compose(shift)


def affine_raw_from_netin(
    net_input_resolution, image_raw_resolution, image_preprocessing
) -> KeypointAffine:
    """Net-input-frame -> raw-frame keypoint map.

    Parity: reference dream/image_proc.py:215-260.  NOTE: for "shrink" the
    reference maps netin->raw with scale raw/net_in (NOT the inverse of its
    raw->netin map, which uses the shrunk resolution); we reproduce that
    asymmetry exactly rather than calling ``invert()``.
    """
    assert image_preprocessing in KNOWN_IMAGE_PREPROC_TYPES, (
        f'Image preprocessing type "{image_preprocessing}" is not recognized.'
    )
    if image_preprocessing == "none":
        return IDENTITY
    if image_preprocessing in ("resize", "shrink"):
        return _scale_between(net_input_resolution, image_raw_resolution)
    # shrink-and-crop
    cropped_res, cropped_coords = shrink_and_crop_resolution(
        image_raw_resolution, net_input_resolution
    )
    scale = _scale_between(net_input_resolution, cropped_res)
    shift = KeypointAffine(
        scale=(1.0, 1.0), offset=(float(cropped_coords[0]), float(cropped_coords[1]))
    )
    return shift.compose(scale)


# -----------------------------------------------------------------------------
# Drop-in style function equivalents (batched; accept [..., 2] arrays).
# -----------------------------------------------------------------------------


def convert_keypoints_to_netin_from_netout(
    keypoints_netout, net_output_resolution, net_input_resolution
):
    return affine_netin_from_netout(net_output_resolution, net_input_resolution)(
        keypoints_netout
    )


def convert_keypoints_to_netout_from_netin(
    keypoints_netin, net_input_resolution, net_output_resolution
):
    return affine_netout_from_netin(net_input_resolution, net_output_resolution)(
        keypoints_netin
    )


def convert_keypoints_to_netin_from_raw(
    keypoints_raw, image_raw_resolution, net_input_resolution, image_preprocessing
):
    return affine_netin_from_raw(
        image_raw_resolution, net_input_resolution, image_preprocessing
    )(keypoints_raw)


def convert_keypoints_to_raw_from_netin(
    keypoints_netin, net_input_resolution, image_raw_resolution, image_preprocessing
):
    return affine_raw_from_netin(
        net_input_resolution, image_raw_resolution, image_preprocessing
    )(keypoints_netin)
