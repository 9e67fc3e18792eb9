"""Evaluation: in-memory frames -> keypoint (PCK) and PnP (ADD) metrics.

Port of ``dream_tpu/analysis.py``: :func:`keypoint_metrics` (``:93``) and
:func:`pnp_metrics` (``:159``) keep the reference's metric definitions
(reference dream/analysis.py:858-994):

- PCK AUC: threshold sweep 0 -> 20 px in 0.01 px steps, trapezoidal rule,
  normalized by the threshold and by the number of in-frame GT keypoints;
- ADD AUC: sweep 0 -> 0.1 m in 1e-5 m steps, denominator = frames with >= 4
  in-frame GT keypoints.

:func:`evaluate_frames` does what ``analyze_ndds_dataset`` (``:260-600``)
does on its plain-PnP path, over frames already in memory: optional int8
calibration on the first frames, batched inference on the device, the
net-output -> raw coordinate map, batched PnP over all frames, and ADD
under both rotation conventions.  The report text and the CSV writers are
not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from dream_tpu_torch.data.dataset import collect_calibration_batches, make_batch_processor
from dream_tpu_torch.ops import coords as coord_ops
from dream_tpu_torch.ops import geometric_vision as gv


def keypoint_metrics(keypoints_detected, keypoints_gt, image_resolution,
                     auc_pixel_threshold: float = 20.0) -> Dict[str, Any]:
    """Parity: reference dream/analysis.py:858-944."""
    det = np.asarray(keypoints_detected, dtype=float)
    gt = np.asarray(keypoints_gt, dtype=float)
    gt_outframe = (
        (gt[:, 0] < 0.0) | (gt[:, 0] > image_resolution[0])
        | (gt[:, 1] < 0.0) | (gt[:, 1] > image_resolution[1])
    )
    detected_missing = (det[:, 0] < -999.0) & (det[:, 1] < -999.0)
    found_mask = ~gt_outframe & ~detected_missing
    num_gt_inframe = int(np.sum(~gt_outframe))
    kp_errors = det[found_mask] - gt[found_mask]
    out = {
        "num_gt_outframe": int(np.sum(gt_outframe)),
        "num_missing_gt_outframe": int(np.sum(gt_outframe & detected_missing)),
        "num_found_gt_outframe": int(np.sum(gt_outframe & ~detected_missing)),
        "num_gt_inframe": num_gt_inframe,
        "num_found_gt_inframe": int(np.sum(found_mask)),
        "num_missing_gt_inframe": int(np.sum(~gt_outframe & detected_missing)),
        "l2_error_mean_px": None,
        "l2_error_median_px": None,
        "l2_error_std_px": None,
        "l2_error_auc": None,
        "l2_error_auc_thresh_px": auc_pixel_threshold,
    }
    if len(kp_errors) > 0:
        l2 = np.linalg.norm(kp_errors, axis=1)
        delta_pixel = 0.01
        pck_values = np.arange(0, auc_pixel_threshold, delta_pixel)
        # Counts of errors strictly below each threshold (reference :916).
        y_values = np.sum(l2[None, :] < pck_values[:, None], axis=1)
        out.update(
            l2_error_mean_px=float(np.mean(l2)),
            l2_error_median_px=float(np.median(l2)),
            l2_error_std_px=float(np.std(l2)),
            l2_error_auc=float(
                np.trapezoid(y_values, dx=delta_pixel) / auc_pixel_threshold / num_gt_inframe
            ),
        )
    return out


def pnp_metrics(pnp_add, num_inframe_projs_gt, num_min_inframe_projs_gt_for_pnp: int = 4,
                add_auc_threshold: float = 0.1, pnp_magic_number: float = -999.0) -> Dict[str, Any]:
    """Parity: reference dream/analysis.py:947-994."""
    pnp_add = np.asarray(pnp_add, dtype=float)
    num_inframe_projs_gt = np.asarray(num_inframe_projs_gt)
    found_mask = pnp_add > pnp_magic_number
    add_found = pnp_add[found_mask]
    num_found = int(np.sum(found_mask))
    num_possible = int(np.sum(num_inframe_projs_gt >= num_min_inframe_projs_gt_for_pnp))
    delta = 0.00001
    thresholds = np.arange(0.0, add_auc_threshold, delta)
    counts = (
        np.sum(add_found[None, :] <= thresholds[:, None], axis=1) / float(num_possible)
        if num_possible
        else np.zeros_like(thresholds)
    )
    nan = float("nan")
    return {
        "num_pnp_found": num_found,
        "num_pnp_not_found": num_possible - num_found,
        "num_pnp_possible": num_possible,
        "num_min_inframe_projs_gt_for_pnp": num_min_inframe_projs_gt_for_pnp,
        "pnp_magic_number": pnp_magic_number,
        "add_mean": float(np.mean(add_found)) if num_found else nan,
        "add_median": float(np.median(add_found)) if num_found else nan,
        "add_std": float(np.std(add_found)) if num_found else nan,
        "add_auc": float(np.trapezoid(counts, dx=delta) / add_auc_threshold),
        "add_auc_thresh": add_auc_threshold,
    }


def evaluate_frames(network, frames: np.ndarray, gt: Mapping[str, np.ndarray],
                    camera_K: np.ndarray, batch_size: int = 16,
                    int8_calibration_frames: int = 0) -> Dict[str, Any]:
    """Keypoint and plain-PnP evaluation of in-memory frames.

    Args:
      network: a :class:`dream_tpu_torch.network.DreamNetwork`.
      frames: uint8 ``[F, H, W, 3]`` raw frames.
      gt: ``{"projections": [F, n_kp, 2] raw-frame pixels,
        "positions": [F, n_kp, 3] camera-frame keypoints (m)}``.
      camera_K: ``[3, 3]`` intrinsics.
      batch_size: frames per inference batch.
      int8_calibration_frames: when positive, first calibrate the network's
        int8 inference (``enable_int8_inference``) on this many frames from
        the head of ``frames``, in batches of ``batch_size``, as
        ``analyze_ndds_dataset`` does.

    Returns a dict with ``keypoints`` (:func:`keypoint_metrics`), ``pnp`` and
    ``pnp_transposed`` (:func:`pnp_metrics` under the standard and the
    alternate rotation convention), and the per-frame arrays
    ``detected_raw``, ``pnp_valid``, ``add``.
    """
    if batch_size <= 0:
        raise ValueError("batch_size must be positive")
    frames = np.asarray(frames, dtype=np.uint8)
    n_frames = frames.shape[0]
    raw_res = (frames.shape[2], frames.shape[1])
    preprocessing = network.image_preprocessing()
    netin_res, netout_res = network.net_resolutions_from_image_raw_resolution(raw_res)
    kp_to_raw = coord_ops.affine_raw_from_netin(netin_res, raw_res, preprocessing).compose(
        coord_ops.affine_netin_from_netout(netout_res, netin_res)
    )
    device = network.device

    if int8_calibration_frames:
        process = make_batch_processor(raw_res, netin_res, netout_res, preprocessing,
                                       network.image_normalization, include_belief_maps=False)
        network.enable_int8_inference(collect_calibration_batches(
            frames, lambda g, images, kp: process(g, images.to(device), kp.to(device)),
            int8_calibration_frames, batch_size,
        ))

    detected = []
    for start in range(0, n_frames, batch_size):
        batch = torch.from_numpy(frames[start : start + batch_size])
        _, kp_netout = network.inference(network.preprocess(batch))
        # Sentinel-preserving netout -> raw map (sentinels stay < -999).
        detected.append(kp_to_raw(kp_netout))
    detected_raw_t = torch.cat(detected)
    detected_raw = detected_raw_t.cpu().numpy()
    gt_raw = np.asarray(gt["projections"], dtype=float)
    n_kp = gt_raw.shape[1]

    kp_result = keypoint_metrics(
        detected_raw.reshape(-1, 2), gt_raw.reshape(n_frames * n_kp, 2), raw_res
    )

    n_inframe = np.sum(
        (gt_raw[:, :, 0] > 0.0) & (gt_raw[:, :, 0] < raw_res[0])
        & (gt_raw[:, :, 1] > 0.0) & (gt_raw[:, :, 1] < raw_res[1]),
        axis=1,
    )
    positions = torch.as_tensor(np.asarray(gt["positions"]), dtype=torch.float32, device=device)
    K = torch.as_tensor(np.asarray(camera_K), dtype=torch.float32, device=device)
    result = gv.solve_pnp(positions, detected_raw_t, K)
    # ADD over the detected keypoints only, the rows fed to PnP (reference
    # kp_pos_gt_pnp, dream/analysis.py:322-339).
    detect_mask = ~((detected_raw_t[..., 0] < -999.0) & (detected_raw_t[..., 1] < -999.0))
    valid = result.valid.cpu().numpy()
    adds = {}
    for convention in ("standard", "transposed"):
        add = gv.add_from_pose(
            result.translation, result.quaternion, positions, detect_mask,
            rotation_convention=convention,
        ).cpu().numpy()
        adds[convention] = np.where(valid, add.astype(float), -999.99)
    return {
        "keypoints": kp_result,
        "pnp": pnp_metrics(adds["standard"], n_inframe),
        "pnp_transposed": pnp_metrics(adds["transposed"], n_inframe),
        "detected_raw": detected_raw,
        "pnp_valid": valid,
        "add": adds["standard"],
    }
