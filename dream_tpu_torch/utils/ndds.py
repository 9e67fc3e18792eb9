"""NDDS dataset discovery and parsing.

Port of ``dream_tpu/utils/ndds.py:20-193``, the same on-disk contract: a
directory of digit-prefixed ``<frame>.json`` files with sibling
``<frame>.rgb.<ext>`` images, plus ``_camera_settings.json`` and
``_object_settings.json``.  Frames and configs are found in the same order
and returned in the same dict layout; data files are JSON, with the port's
YAML reader as the fallback the JAX package has.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from dream_tpu_torch.utils.config import load_yaml


def _load_data_file(path: str) -> dict:
    try:
        with open(path, "r") as f:
            return json.load(f)
    except json.JSONDecodeError:
        return load_yaml(path)


def _require(path: str, what: str = "path") -> None:
    if not os.path.exists(path):
        raise FileNotFoundError(f'Expected {what} "{path}" to exist, but it does not.')


def is_ndds_dataset(input_dir: str, data_extension: str = "json") -> bool:
    """Whether ``input_dir`` holds digit-prefixed data files."""
    input_dir = os.path.expanduser(input_dir)
    _require(input_dir)
    ext = "." + data_extension
    return any(f.endswith(ext) and f[0].isdigit() for f in os.listdir(input_dir))


def find_ndds_data_in_dir(
    input_dir: str,
    data_extension: str = "json",
    image_extension: Optional[str] = None,
    requested_image_types="all",
) -> Tuple[Optional[List[dict]], Optional[dict]]:
    """``(found_data, found_configs)``: each frame is ``{"name",
    "data_path", "image_paths": {"rgb": ..., ...}}`` in sorted order, the
    configs ``{"camera": path|None, "object": path|None, "unsorted": [...]}``;
    ``(None, None)`` when no frame is found."""
    input_dir = os.path.expanduser(input_dir)
    _require(input_dir)
    dirlist = os.listdir(input_dir)
    data_full_ext = "." + data_extension

    if image_extension is None:
        candidates = ["png", "jpg"]
        counts = [len([f for f in dirlist if f.endswith(ext)]) for ext in candidates]
        image_extension = candidates[int(np.argmax(counts))]
    image_full_ext = "." + image_extension

    data_filenames = sorted(f for f in dirlist if f.endswith(data_full_ext))
    data_names = [os.path.splitext(f)[0] for f in data_filenames if f[0].isdigit()]
    if not data_names:
        return None, None
    data_paths = [os.path.join(input_dir, f) for f in data_filenames if f[0].isdigit()]

    if requested_image_types == "all":
        first = data_names[0]
        matching = [f for f in dirlist if f.startswith(first) and f.endswith(image_full_ext)]
        find_rgb = first + ".rgb" + image_full_ext in matching
        find_depth = first + ".depth" + image_full_ext in matching
        find_cs = first + ".cs" + image_full_ext in matching
    elif requested_image_types:
        for t in requested_image_types:
            if t not in ("rgb", "depth", "cs"):
                raise ValueError(f'Image type "{t}" not recognized.')
        find_rgb = "rgb" in requested_image_types
        find_depth = "depth" in requested_image_types
        find_cs = "cs" in requested_image_types
    else:
        find_rgb = find_depth = find_cs = False

    image_lists = {}
    for flag, key, tag in [(find_rgb, "rgb", ".rgb"), (find_depth, "depth", ".depth"),
                           (find_cs, "class_segmentation", ".cs")]:
        if not flag:
            continue
        paths = [os.path.join(input_dir, name + tag + image_full_ext) for name in data_names]
        for p in paths:
            _require(p, "image")
        image_lists[key] = paths

    found_data = []
    for i, (name, data_path) in enumerate(zip(data_names, data_paths)):
        entry = {"name": name, "data_path": data_path}
        if image_lists:
            entry["image_paths"] = {k: v[i] for k, v in image_lists.items()}
        found_data.append(entry)

    found_configs = {"camera": None, "object": None, "unsorted": []}
    for f in data_filenames:
        if f[0].isdigit():
            continue
        if f == "_camera_settings" + data_full_ext:
            found_configs["camera"] = os.path.join(input_dir, f)
        elif f == "_object_settings" + data_full_ext:
            found_configs["object"] = os.path.join(input_dir, f)
        else:
            found_configs["unsorted"].append(os.path.join(input_dir, f))
    return found_data, found_configs


def load_camera_intrinsics(camera_data_path: str) -> np.ndarray:
    """3x3 K from ``_camera_settings``."""
    _require(camera_data_path)
    intr = _load_data_file(camera_data_path)["camera_settings"][0]["intrinsic_settings"]
    return np.array([[intr["fx"], 0.0, intr["cx"]], [0.0, intr["fy"], intr["cy"]], [0.0, 0.0, 1.0]])


def load_image_resolution(camera_data_path: str) -> Tuple[int, int]:
    """``(width, height)`` from ``_camera_settings``."""
    _require(camera_data_path)
    size = _load_data_file(camera_data_path)["camera_settings"][0]["captured_image_size"]
    return (size["width"], size["height"])


def load_keypoints(data_path: str, object_name: str, keypoint_names) -> dict:
    """A frame's keypoint camera-frame positions and projections, in the
    order of ``keypoint_names``."""
    _require(data_path, "data_path")
    data = _load_data_file(data_path)
    if "objects" not in data:
        raise KeyError(f'Expected "objects" key to exist in data file "{data_path}".')
    object_names = [o["class"] for o in data["objects"]]
    if object_name not in object_names:
        raise KeyError(f'Requested object_name "{object_name}" does not exist in the data file objects.')
    object_keypoints = data["objects"][object_names.index(object_name)]["keypoints"]
    names = [kp["name"] for kp in object_keypoints]
    keypoint_data = {"positions_wrt_cam": [], "projections": []}
    for kp_name in keypoint_names:
        if kp_name not in names:
            raise KeyError(
                f"Expected keypoint '{kp_name}' to exist in the data file '{data_path}', "
                f"but it does not.  Rather, the keypoints are '{names}'"
            )
        kp = object_keypoints[names.index(kp_name)]
        keypoint_data["positions_wrt_cam"].append(kp["location"])
        keypoint_data["projections"].append(kp["projected_location"])
    return keypoint_data
