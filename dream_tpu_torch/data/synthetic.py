"""Synthetic manipulator frames, in memory and as an NDDS dataset on disk.

A numpy copy of ``dream_tpu/data/synthetic.py``: a chain of 3D keypoints
posed rigidly with a random camera transform and rendered as anti-aliased
disks and limb segments over a noisy background.
:func:`generate_synthetic_ndds` writes the frames as an NDDS dataset (PNG +
JSON) through the port's PNG writer, and :func:`generate_synthetic_frames`
returns the same frames in memory; both draw from one random stream, so for
a seed they give the very frames, projections and camera-frame keypoints
that ``dream_tpu``'s ``generate_synthetic_ndds`` writes, with no PIL.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from dream_tpu_torch.utils.png import write_png

DEFAULT_KEYPOINT_NAMES = [
    "panda_link0",
    "panda_link2",
    "panda_link3",
    "panda_link4",
    "panda_link6",
    "panda_link7",
    "panda_hand",
]

# A fixed, panda-arm-like kinematic chain in the robot base frame (meters).
_CANONICAL_CHAIN = np.array(
    [
        [0.00, 0.00, 0.05],
        [0.00, 0.00, 0.35],
        [0.08, 0.00, 0.55],
        [0.20, 0.05, 0.70],
        [0.35, 0.10, 0.72],
        [0.45, 0.12, 0.65],
        [0.52, 0.15, 0.55],
    ]
)

# Max centered radius of the 7-point canonical chain; larger chains scale the
# camera distance by (radius / this) so the rendered robot subtends a similar
# image fraction regardless of keypoint count.
_CANONICAL_RADIUS = 0.5172


def chain_points(n_keypoints: int) -> np.ndarray:
    """Deterministic [n, 3] keypoint chain for any keypoint count.

    The single source of truth for the synthetic manipulator geometry, used
    by :func:`render_random_scene`, :func:`generate_synthetic_frames` and
    :func:`generate_synthetic_ndds`.  The first 7
    points are the panda-like canonical chain; further points (kuka's 8,
    baxter's 17 — reference manip_configs/{kuka,baxter}.yaml) continue along
    a gentle helix so no subset of keypoints is collinear (collinear
    extensions would degrade the PnP geometry the datasets exist to test).
    """
    assert n_keypoints >= 1, n_keypoints
    base = _CANONICAL_CHAIN
    if n_keypoints <= len(base):
        return base[:n_keypoints].copy()
    i = np.arange(1, n_keypoints - len(base) + 1, dtype=np.float64)
    ext = base[-1] + np.stack(
        [0.06 * i, 0.12 * np.sin(0.7 * i), 0.10 * np.cos(0.7 * i) - 0.10],
        axis=1,
    )
    return np.concatenate([base, ext])


def _camera_distance_scale(chain: np.ndarray) -> float:
    """Camera z-range multiplier keeping big chains framed like the panda."""
    centered = chain - chain.mean(axis=0)
    radius = float(np.linalg.norm(centered, axis=1).max())
    return max(1.0, radius / _CANONICAL_RADIUS)


def _rotation_matrix(rng: np.random.RandomState) -> np.ndarray:
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    angle = rng.uniform(0.0, 2.0 * np.pi)
    K = np.array(
        [
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ]
    )
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def _paint_segment(img, xx, yy, a, b, radius, color):
    ab = b - a
    denom = float(ab @ ab) + 1e-9
    t = ((xx - a[0]) * ab[0] + (yy - a[1]) * ab[1]) / denom
    t = np.clip(t, 0.0, 1.0)
    dx = xx - (a[0] + t * ab[0])
    dy = yy - (a[1] + t * ab[1])
    dist = np.sqrt(dx * dx + dy * dy)
    alpha = np.clip(radius + 1.0 - dist, 0.0, 1.0)[..., None]
    return img * (1 - alpha) + color * alpha


def _paint_disk(img, xx, yy, p, radius, color):
    dist = np.sqrt((xx - p[0]) ** 2 + (yy - p[1]) ** 2)
    alpha = np.clip(radius + 1.0 - dist, 0.0, 1.0)[..., None]
    return img * (1 - alpha) + color * alpha


def _paint_rect(img, xx, yy, x0, y0, rw, rh, color):
    alpha = (
        (xx >= x0) & (xx < x0 + rw) & (yy >= y0) & (yy < y0 + rh)
    ).astype(np.float32)[..., None]
    return img * (1 - alpha) + color * alpha


def _render_frame(
    resolution: Tuple[int, int],
    kp_projs: np.ndarray,
    depths: np.ndarray,
    rng: np.random.RandomState,
    domain_randomization: bool = False,
) -> np.ndarray:
    """Vectorized stick-figure render: background + limbs + keypoint disks.

    ``domain_randomization`` adds the randomization axes of the reference's
    "DR" synthetic datasets (reference data/DOWNLOAD.sh names its synthetic
    test splits synth_test_dr/_non_dr): textured backgrounds (sinusoid +
    checker patterns), background distractor shapes, randomized robot/limb
    colors, global lighting (per-channel gain + vignette), and foreground
    occluders that may cover keypoints (GT labels are unaffected, as with a
    real renderer's occlusions).
    """
    w, h = resolution
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    # Smooth random background (low-frequency gradients + noise).
    gx, gy = rng.uniform(-1, 1, 2)
    base = rng.uniform(40, 180, size=3)
    img = np.empty((h, w, 3), dtype=np.float32)
    grad = (gx * xx / w + gy * yy / h) * rng.uniform(20, 60)
    for c in range(3):
        img[..., c] = base[c] + grad
    img += rng.randn(h, w, 3) * rng.uniform(2.0, 8.0)

    if domain_randomization:
        # Texture: a few random sinusoidal plaids.
        for _ in range(rng.randint(1, 4)):
            wavelength = rng.uniform(15, 160)
            theta = rng.uniform(0, np.pi)
            phase = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(5, 30)
            pattern = np.sin(
                2 * np.pi * (np.cos(theta) * xx + np.sin(theta) * yy)
                / wavelength + phase
            )
            img += amp * pattern[..., None] * rng.uniform(0.3, 1.0, size=3)
        # Texture: optional checkerboard region.
        if rng.rand() < 0.5:
            cell = rng.randint(12, 60)
            check = (((xx // cell) + (yy // cell)) % 2).astype(np.float32)
            img = img * (1 - 0.3 * check[..., None]) + 0.3 * check[
                ..., None
            ] * rng.uniform(0, 255, size=3)
        # Background distractor shapes (behind the robot).
        for _ in range(rng.randint(3, 9)):
            color = rng.uniform(0, 255, size=3)
            if rng.rand() < 0.5:
                a = rng.uniform([0, 0], [w, h])
                b = a + rng.uniform(-150, 150, size=2)
                img = _paint_segment(img, xx, yy, a, b, rng.uniform(2, 7), color)
            else:
                p = rng.uniform([0, 0], [w, h])
                img = _paint_disk(img, xx, yy, p, rng.uniform(4, 25), color)

    # Limb segments: distance-to-segment field, vectorized over pixels.
    if domain_randomization:
        limb_color = rng.uniform(60, 230, size=3)
    else:
        limb_color = np.array([200.0, 200.0, 210.0]) + rng.randn(3) * 10
    for a, b in zip(kp_projs[:-1], kp_projs[1:]):
        img = _paint_segment(img, xx, yy, a, b, 4.0, limb_color)

    # Keypoint disks, radius shrinking with depth, distinct colors.  18
    # entries so every keypoint of a baxter-scale 17-point chain gets a
    # unique color cue (a modulo-repeated palette would alias the identity
    # signal the detector trains on).
    palette = np.array(
        [
            [230, 60, 60],
            [60, 200, 60],
            [70, 90, 230],
            [230, 200, 50],
            [200, 60, 220],
            [50, 210, 210],
            [240, 140, 40],
            [150, 150, 240],
            [120, 230, 120],
            [230, 120, 170],
            [90, 160, 90],
            [170, 110, 60],
            [60, 120, 160],
            [220, 220, 140],
            [140, 70, 120],
            [100, 220, 180],
            [250, 90, 120],
            [110, 110, 110],
        ],
        dtype=np.float32,
    )
    if domain_randomization:
        palette = np.clip(palette + rng.uniform(-30, 30, palette.shape), 0, 255)
    for i, (p, z) in enumerate(zip(kp_projs, depths)):
        radius = np.clip(14.0 / max(z, 0.3), 3.0, 18.0)
        img = _paint_disk(img, xx, yy, p, radius, palette[i % len(palette)])

    if domain_randomization:
        # Foreground occluders: may cover keypoints; labels unchanged.
        if rng.rand() < 0.5:
            for _ in range(rng.randint(1, 4)):
                color = rng.uniform(0, 255, size=3)
                if rng.rand() < 0.5:
                    img = _paint_rect(
                        img, xx, yy,
                        rng.uniform(0, w), rng.uniform(0, h),
                        rng.uniform(15, 90), rng.uniform(15, 90), color,
                    )
                else:
                    p = rng.uniform([0, 0], [w, h])
                    img = _paint_disk(img, xx, yy, p, rng.uniform(10, 45), color)
        # Lighting: per-channel gain + vignette.
        img *= rng.uniform(0.6, 1.3, size=3)
        vstrength = rng.uniform(0.0, 0.5)
        r2 = ((xx - w / 2) ** 2 + (yy - h / 2) ** 2) / ((w / 2) ** 2 + (h / 2) ** 2)
        img *= (1.0 - vstrength * r2)[..., None]

    return np.clip(img, 0, 255).astype(np.uint8)


def render_random_scene(
    rng: np.random.RandomState,
    image_resolution: Tuple[int, int] = (640, 480),
    n_keypoints: int = 7,
    out_of_frame: bool = False,
    domain_randomization: bool = False,
):
    """Render one random synthetic scene in memory.

    Returns ``(image_u8 [H,W,3], kp_projs [n,2], positions_wrt_cam [n,3])`` —
    the same statistics ``generate_synthetic_ndds`` writes to disk, for
    callers that stream frames (e.g. encoder self-pretraining,
    scripts/pretrain_encoder.py) instead of materializing a dataset.
    """
    K = _camera_K(image_resolution)
    chain = chain_points(n_keypoints)
    zs = _camera_distance_scale(chain)
    R = _rotation_matrix(rng)
    if out_of_frame:
        t = np.array(
            [rng.uniform(0.5, 0.9), rng.uniform(-0.1, 0.1),
             rng.uniform(1.0 * zs, 1.6 * zs)]
        )
    else:
        t = np.array(
            [rng.uniform(-0.25, 0.25), rng.uniform(-0.2, 0.2),
             rng.uniform(1.2 * zs, 2.6 * zs)]
        )
    centered = chain - chain.mean(axis=0)
    Xc = centered @ R.T + t
    proj = Xc @ K.T
    kp_projs = proj[:, :2] / proj[:, 2:3]
    img = _render_frame(
        image_resolution, kp_projs, Xc[:, 2], rng,
        domain_randomization=domain_randomization,
    )
    return img, kp_projs, Xc


def _posed_frames(n_frames, image_resolution, n_keypoints, seed, out_of_frame_fraction,
                  domain_randomization):
    """The synthetic set's frames in order, each ``(image_u8, kp_projs, Xc)``
    from :func:`render_random_scene` on one ``RandomState(seed)`` stream, as
    ``dream_tpu.data.synthetic.generate_synthetic_ndds`` draws them (its
    first ``out_of_frame_fraction`` of frames pushed partly out of view)."""
    rng = np.random.RandomState(seed)
    for idx in range(n_frames):
        yield render_random_scene(rng, image_resolution, n_keypoints,
                                  out_of_frame=idx < int(n_frames * out_of_frame_fraction),
                                  domain_randomization=domain_randomization)


def _camera_K(image_resolution: Tuple[int, int]) -> np.ndarray:
    w, h = image_resolution
    return np.array([[0.96 * w, 0, w / 2.0], [0, 0.96 * w, h / 2.0], [0, 0, 1.0]])


def generate_synthetic_frames(
    n_frames: int = 32,
    image_resolution: Tuple[int, int] = (640, 480),
    keypoint_names: Optional[Sequence[str]] = None,
    seed: int = 0,
    out_of_frame_fraction: float = 0.1,
    domain_randomization: bool = False,
) -> Dict[str, np.ndarray]:
    """In-memory counterpart of :func:`generate_synthetic_ndds`.

    Returns ``images`` uint8 ``[F, H, W, 3]``, ``projections`` ``[F, n, 2]``
    (raw-frame pixels), ``positions`` ``[F, n, 3]`` (camera frame, m) and
    ``camera_K`` ``[3, 3]``.  The seed-99, 64-frame, 640x480 panda set is the
    holdout of scripts/reproduce_headline.sh.
    """
    keypoint_names = list(keypoint_names or DEFAULT_KEYPOINT_NAMES)
    frames = list(_posed_frames(n_frames, image_resolution, len(keypoint_names), seed,
                                out_of_frame_fraction, domain_randomization))
    images, projections, positions = zip(*frames)
    return {
        "images": np.stack(images),
        "projections": np.stack(projections),
        "positions": np.stack(positions),
        "camera_K": _camera_K(image_resolution),
    }


def generate_synthetic_ndds(
    output_dir: str,
    n_frames: int = 32,
    image_resolution: Tuple[int, int] = (640, 480),
    keypoint_names: Optional[Sequence[str]] = None,
    object_class: str = "panda",
    seed: int = 0,
    out_of_frame_fraction: float = 0.1,
    image_extension: str = "png",
    domain_randomization: bool = False,
) -> str:
    """Write a synthetic NDDS dataset and return its path.

    Port of ``dream_tpu/data/synthetic.py:288-382``: the same files
    (``NNNNNN.rgb.png``, ``NNNNNN.json``, ``_camera_settings.json``,
    ``_object_settings.json``) with the same keys and float values, the
    frames from the renderer :func:`generate_synthetic_frames` uses, so a
    frame on disk decodes to the frame in memory (PNG is lossless).  Only
    PNG is written.
    """
    if image_extension != "png":
        raise ValueError(f"the port writes PNG frames only, not {image_extension!r}")
    os.makedirs(output_dir, exist_ok=True)
    keypoint_names = list(keypoint_names or DEFAULT_KEYPOINT_NAMES)
    w, h = image_resolution
    K = _camera_K(image_resolution)
    camera_settings = {
        "camera_settings": [
            {
                "name": "synthetic",
                "intrinsic_settings": {
                    "fx": K[0, 0], "fy": K[1, 1], "cx": K[0, 2], "cy": K[1, 2], "s": 0,
                },
                "captured_image_size": {"width": w, "height": h},
            }
        ]
    }
    with open(os.path.join(output_dir, "_camera_settings.json"), "w") as f:
        json.dump(camera_settings, f, indent=2)
    with open(os.path.join(output_dir, "_object_settings.json"), "w") as f:
        json.dump({"exported_objects": [{"class": object_class}]}, f, indent=2)

    frames = _posed_frames(n_frames, image_resolution, len(keypoint_names), seed,
                           out_of_frame_fraction, domain_randomization)
    for idx, (image, kp_projs, Xc) in enumerate(frames):
        name = f"{idx:06d}"
        write_png(os.path.join(output_dir, f"{name}.rgb.png"), image)
        frame_data = {
            "objects": [
                {
                    "class": object_class,
                    "keypoints": [
                        {
                            "name": kp_name,
                            "location": Xc[i].tolist(),
                            "projected_location": kp_projs[i].tolist(),
                        }
                        for i, kp_name in enumerate(keypoint_names)
                    ],
                }
            ]
        }
        with open(os.path.join(output_dir, f"{name}.json"), "w") as f:
            json.dump(frame_data, f)
    return output_dir
