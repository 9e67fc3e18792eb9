"""Host-side visualization: keypoint overlays, belief-map colormaps, mosaics.

Port of ``dream_tpu/visualize.py`` (reference dream/image_proc.py:462-863).
Drawing is host work, as there: device tensors are moved to the host here
and nowhere else.  ``dream_tpu`` draws on PIL images with cv2, matplotlib
and PIL; the port's images are uint8 ``[H, W, 3]`` numpy arrays (a torch
tensor is accepted and moved to the host), drawn with the port's own exact
versions of those libraries' algorithms:

- dots, lines and text: :mod:`dream_tpu_torch.utils.raster` (OpenCV's
  ``circle`` with ``shift=4``, ``line`` and ``putText``);
- colormaps and colour names: :mod:`dream_tpu_torch.utils.colormaps`
  (matplotlib's ``inferno``, the CSS3 names);
- resizes, blends and mosaics: :mod:`dream_tpu_torch.utils.resample`
  (Pillow's BILINEAR ``resize``, ``blend``, ``new`` and ``paste``).

Every function returns a new array and leaves its input as it was.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from dream_tpu_torch.utils import colormaps, raster, resample
from dream_tpu_torch.utils.png import read_image


def _host_array(x, dtype=None) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _load(image_input) -> np.ndarray:
    """A path (PNG or JPEG), an array or a tensor -> uint8 image (a copy)."""
    if isinstance(image_input, str):
        return read_image(image_input)
    return np.array(resample.as_image(image_input))


def image_from_tensor(net_input_array, normalization: Optional[dict] = None) -> np.ndarray:
    """Net-input ``[H, W, 3]`` float array -> uint8 image
    (reference dream/image_proc.py:596-609).

    With ``normalization`` (``{"mean": [...], "stdev": [...]}``) the
    normalization is inverted first; otherwise values are taken to be in
    [0, 1].  Values are rounded to the nearest level, ties to even."""
    arr = _host_array(net_input_array, np.float32)
    if not (arr.ndim == 3 and arr.shape[-1] == 3):
        raise ValueError(f"Expected [H, W, 3] net-input array, got shape {arr.shape}.")
    if normalization is not None:
        arr = arr * np.asarray(normalization["stdev"]) + np.asarray(normalization["mean"])
    return np.uint8(np.clip(np.rint(arr * 255.0), 0.0, 255.0))


def images_from_tensor(net_input_batch, normalization: Optional[dict] = None) -> List[np.ndarray]:
    """``[B, H, W, 3]`` -> list of uint8 images (reference
    dream/image_proc.py:611-631)."""
    batch = _host_array(net_input_batch)
    if batch.ndim != 4:
        raise ValueError(f"Expected [B, H, W, 3] net-input batch, got shape {batch.shape}.")
    return [image_from_tensor(a, normalization) for a in batch]


def overlay_points_on_image(
    image_input,
    image_points,
    image_point_names: Optional[Sequence[str]] = None,
    annotation_color_dot="red",
    annotation_color_text="red",
    point_diameter=6.0,
    point_thickness: int = -1,
) -> np.ndarray:
    """Subpixel circles (and names) over an image (reference
    dream/image_proc.py:462-593).

    Points below -999 (the no-detection sentinel, scaled or raw) and
    non-finite points are skipped.  Colours are names or RGB triples, one
    for all points or one a point; so is ``point_diameter``.  Circles are
    drawn at ``int(p * 16)`` with ``shift=4``; a name at ``(int(x) + 10,
    int(y))``."""
    image = _load(image_input)
    if image_points is None or len(image_points) == 0:
        return image
    n_points = len(image_points)
    if image_point_names and n_points != len(image_point_names):
        raise ValueError("one name a point is needed")
    dot_colors = ([annotation_color_dot] * n_points if isinstance(annotation_color_dot, str)
                  else list(annotation_color_dot))
    text_colors = ([annotation_color_text] * n_points if isinstance(annotation_color_text, str)
                   else list(annotation_color_text))
    diameters = ([point_diameter] * n_points if isinstance(point_diameter, (int, float))
                 else list(point_diameter))
    shift = 4
    factor = 1 << shift
    for idx in range(n_points):
        point = image_points[idx]
        if point is None or len(point) == 0:
            continue
        if point[0] < -999.0 or point[1] < -999.0 or not np.all(np.isfinite(point)):
            continue
        center = (int(point[0] * factor), int(point[1] * factor))
        radius = int(diameters[idx] / 2.0 * factor)
        raster.circle(image, center, radius, colormaps.to_rgb(dot_colors[idx]),
                      thickness=int(point_thickness), shift=shift)
        if image_point_names:
            raster.put_text(image, image_point_names[idx], (int(point[0]) + 10, int(point[1])),
                            colormaps.to_rgb(text_colors[idx]))
    return image


def image_from_belief_map(belief_map, normalize: bool = True, colormap: Optional[str] = "inferno",
                          normalization_method: int = 6) -> np.ndarray:
    """Colormapped belief map (reference dream/image_proc.py:634-723): a
    ``[H, W]`` (or ``[1, H, W]``) array -> uint8 ``[H, W, 3]``, or
    ``[H, W]`` gray without a colormap.

    Normalization methods, in float32: 0 min-max; 1 clip below at 0, then
    divide by the max; 2, 3, 4 subtract the median, the 25th or the 75th
    percentile first; 5 clip below at 0; 6 (default) clip to [0, 1]."""
    bm = _host_array(belief_map, np.float32)
    if bm.ndim == 3:
        if bm.shape[0] != 1:
            raise ValueError(f"Expected one [H, W] belief map, got shape {bm.shape}.")
        bm = bm[0]
    if bm.ndim != 2:
        raise ValueError(f"Expected one [H, W] belief map, got shape {bm.shape}.")
    if normalize:
        if normalization_method == 0:
            bm = bm - bm.min()
            bm = bm / (bm.max() + 1e-12)
        elif normalization_method == 1:
            bm = np.clip(bm, 0.0, bm.max())
            bm = bm / (bm.max() + 1e-12)
        elif normalization_method in (2, 3, 4):
            if normalization_method == 2:
                bm = bm - np.median(bm)
            else:
                bm = bm - np.percentile(bm, 25 if normalization_method == 3 else 75)
            bm = np.clip(bm, 0.0, bm.max())
            bm = bm / (bm.max() + 1e-12)
        elif normalization_method == 5:
            bm = np.clip(bm, 0.0, bm.max())
        elif normalization_method == 6:
            bm = np.clip(bm, 0.0, 1.0)
        else:
            raise ValueError("Normalization method not defined.")
    if colormap:
        rgba = colormaps.colormap_rgba(bm, colormap)
        return np.uint8(255 * rgba[..., :3])
    return np.uint8(255 * bm)


def images_from_belief_maps(belief_maps, **kwargs) -> List[np.ndarray]:
    """``[N, H, W]`` maps -> list of :func:`image_from_belief_map` images."""
    bm = _host_array(belief_maps)
    if bm.ndim != 3:
        raise ValueError(f"Expected [N, H, W] belief maps, got shape {bm.shape}.")
    return [image_from_belief_map(m, **kwargs) for m in bm]


def mosaic_images(image_array_input, rows: Optional[int] = None, cols: Optional[int] = None,
                  outer_padding_px: int = 0, inner_padding_px: int = 0,
                  fill_color_rgb=(255, 255, 255)) -> np.ndarray:
    """Grid mosaic, row by row (reference dream/image_proc.py:752-863), of
    images of one size, or of PNG or JPEG files by path."""
    if image_array_input is None or len(image_array_input) == 0 or isinstance(image_array_input, str):
        raise ValueError("mosaic_images needs a list of images")
    images = [_load(im) for im in image_array_input]
    n = len(images)
    h, w = images[0].shape[:2]
    if any(im.shape[:2] != (h, w) for im in images):
        raise ValueError("All images must have the same resolution.")
    if not (rows or cols):
        raise ValueError("mosaic_images needs rows or cols")
    if not rows:
        rows = int(math.ceil(float(n) / float(cols)))
    if not cols:
        cols = int(math.ceil(float(n) / float(rows)))
    if rows * cols < n:
        raise ValueError(f"{rows} x {cols} cells cannot hold {n} images")
    mosaic = resample.new((cols * w + 2 * outer_padding_px + (cols - 1) * inner_padding_px,
                           rows * h + 2 * outer_padding_px + (rows - 1) * inner_padding_px),
                          tuple(fill_color_rgb))
    for idx, image in enumerate(images):
        r, c = divmod(idx, cols)
        resample.paste(mosaic, image, (c * w + outer_padding_px + c * inner_padding_px,
                                       r * h + outer_padding_px + r * inner_padding_px))
    return mosaic


def overlay_pose_triad(image, camera_K, translation, quaternion_xyzw, axis_length_m: float = 0.1,
                       thickness: int = 3) -> np.ndarray:
    """The robot base's coordinate triad (x red, y green, z blue) over the
    camera image, projected through the camera-from-robot pose: the
    reference ROS node's keypoint_frame_overlay (reference
    scripts/launch_dream_ros.py:498-626).  An axis point behind the camera
    leaves the image as it is."""
    import torch

    from dream_tpu_torch.ops.geometric_vision import rotation_matrix_from_quaternion

    drawn = _load(image)
    # float32, as dream_tpu builds it from jnp.asarray(quaternion).
    q = torch.as_tensor(np.asarray(quaternion_xyzw), dtype=torch.float32)
    R = rotation_matrix_from_quaternion(q).numpy()
    t = np.asarray(translation)
    K = np.asarray(camera_K)
    points_robot = np.array([[0.0, 0.0, 0.0], [axis_length_m, 0.0, 0.0],
                             [0.0, axis_length_m, 0.0], [0.0, 0.0, axis_length_m]])
    points_cam = points_robot @ R.T + t
    if np.any(points_cam[:, 2] <= 1e-6):
        return drawn
    proj = points_cam @ K.T
    proj = proj[:, :2] / proj[:, 2:3]
    origin = tuple(int(v) for v in proj[0])
    for axis_end, color in zip(proj[1:], [(255, 0, 0), (0, 255, 0), (0, 0, 255)]):
        raster.line(drawn, origin, tuple(int(v) for v in axis_end), color, thickness)
    return drawn


def blend_belief_overlay(image, belief_map, alpha: float = 0.5, **kwargs) -> np.ndarray:
    """The colormapped belief map, resized (bilinear) to the image and
    blended over it (reference dream/datasets.py:257-262 pattern)."""
    base = _load(image)
    if base.ndim == 2:
        base = np.repeat(base[..., None], 3, axis=2)
    bm_img = resample.resize(image_from_belief_map(belief_map, **kwargs),
                             (base.shape[1], base.shape[0]))
    return resample.blend(base, bm_img, alpha)
