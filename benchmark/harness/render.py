"""The traffic generator's frames: a frozen copy of the port's synthetic renderer.

A chain of 3D keypoints (the panda-like chain, continued along a helix for
longer chains), posed rigidly in front of a pinhole camera at a random
rotation and offset, drawn as anti-aliased limb segments and keypoint disks
over a noisy gradient background.  Frames are uint8 640x480 unless asked
otherwise.  :func:`render_pool` renders a pool of frames in worker
processes, frame ``i`` drawn from its own stream seeded by ``(seed, i)``, so a
pool depends on the seed alone, not on the number of workers.

Frozen here so that a change to the program cannot move the benchmark's
traffic.  Imports numpy alone: the workers start quickly.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Tuple

import numpy as np

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
    by :func:`render_random_scene`.  The first 7
    points are the panda-like canonical chain; further points (kuka's 8,
    baxter's 17, as the DREAM manipulator configs list them) continue along
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


def _render_frame(
    resolution: Tuple[int, int],
    kp_projs: np.ndarray,
    depths: np.ndarray,
    rng: np.random.RandomState,
) -> np.ndarray:
    """Vectorized stick-figure render: background + limbs + keypoint disks."""
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

    # Limb segments: distance-to-segment field, vectorized over pixels.
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
    for i, (p, z) in enumerate(zip(kp_projs, depths)):
        radius = np.clip(14.0 / max(z, 0.3), 3.0, 18.0)
        img = _paint_disk(img, xx, yy, p, radius, palette[i % len(palette)])

    return np.clip(img, 0, 255).astype(np.uint8)


def render_random_scene(
    rng: np.random.RandomState,
    image_resolution: Tuple[int, int] = (640, 480),
    n_keypoints: int = 7,
    out_of_frame: bool = False,
):
    """Render one random synthetic scene in memory.

    Returns ``(image_u8 [H,W,3], kp_projs [n,2], positions_wrt_cam [n,3])`` —
    a frame with its keypoints' pixels and camera-frame positions.
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
    img = _render_frame(image_resolution, kp_projs, Xc[:, 2], rng)
    return img, kp_projs, Xc


def _camera_K(image_resolution: Tuple[int, int]) -> np.ndarray:
    w, h = image_resolution
    return np.array([[0.96 * w, 0, w / 2.0], [0, 0.96 * w, h / 2.0], [0, 0, 1.0]])


def _frame(args) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    seed, index, resolution, n_keypoints, out_of_frame = args
    rng = np.random.RandomState(np.random.SeedSequence([seed, index]).generate_state(4))
    return render_random_scene(rng, resolution, n_keypoints, out_of_frame=out_of_frame)


def render_pool(seed: int, n_frames: int, n_keypoints: int, resolution: Tuple[int, int] = (640, 480),
                out_of_frame_fraction: float = 0.1, workers: int = 0) -> Dict[str, np.ndarray]:
    """``n_frames`` frames, the first ``out_of_frame_fraction`` of them pushed
    partly out of view.  Returns ``images`` uint8 ``[F, H, W, 3]``,
    ``projections`` ``[F, n, 2]`` (raw-frame pixels), ``positions`` ``[F, n,
    3]`` (camera frame, m) and ``camera_K`` ``[3, 3]``.  ``workers`` processes
    render (0: one a core, at most one a frame; 1: in this process)."""
    jobs = [(int(seed), i, tuple(resolution), n_keypoints, i < int(n_frames * out_of_frame_fraction))
            for i in range(n_frames)]
    workers = workers or min(n_frames, os.cpu_count() or 1)
    if workers <= 1:
        frames = [_frame(job) for job in jobs]
    else:
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            frames = list(pool.map(_frame, jobs))
    images, projections, positions = zip(*frames)
    return {"images": np.stack(images), "projections": np.stack(projections),
            "positions": np.stack(positions), "camera_K": _camera_K(resolution)}
