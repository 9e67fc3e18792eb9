"""Evaluation: frames in memory or an NDDS dataset -> PCK and ADD metrics.

Port of ``dream_tpu/analysis.py``: :func:`keypoint_metrics` (``:93``) and
:func:`pnp_metrics` (``:159``) keep the reference's metric definitions
(reference dream/analysis.py:858-994):

- PCK AUC: threshold sweep 0 -> 20 px in 0.01 px steps, trapezoidal rule,
  normalized by the threshold and by the number of in-frame GT keypoints;
- ADD AUC: sweep 0 -> 0.1 m in 1e-5 m steps, denominator = frames with >= 4
  in-frame GT keypoints.

:func:`analyze_ndds_dataset` (``:260-618``) evaluates a checkpoint on an
NDDS dataset on disk: optional int8 calibration on the dataset's first
frames, batched inference on the device, the net-output -> raw coordinate
map, batched PnP over all frames in any of its modes (plain,
score-weighted, soft detections, leave-one-out rejection, RANSAC), ADD
under both rotation conventions, and the three report files
(``keypoints.csv``, ``pnp_results.csv`` and ``analysis_results.txt``, in
the JAX package's layout, ``:212-259`` and ``:620-739``), and by default
the best, median and worst samples' mosaics (``:838-876``).
:func:`evaluate_frames` does the plain-PnP evaluation over frames already
in memory; :func:`sample_range_analysis` (``:740-835``) writes one
sample's belief-map mosaics and net-input overlay;
:func:`plot_train_valid_loss` (``:44-85``) draws the loss curves of a
training log.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from dream_tpu_torch.data.dataset import (
    DataLoader,
    ManipulatorNDDSDataset,
    ManipulatorNDDSDatasetDebugLevels,
    collect_calibration_batches,
    make_batch_processor,
)
from dream_tpu_torch.ops import coords as coord_ops
from dream_tpu_torch.ops import geometric_vision as gv
from dream_tpu_torch.utils import ndds as ndds_utils


def plot_train_valid_loss(epochs, training_loss, validation_loss, dataset_name=None,
                          save_plot_path=None):
    """Training-vs-validation loss plot (``dream_tpu/analysis.py:44-85``):
    lines of a float a epoch, or the mean of each epoch's per-batch losses
    with +-1 standard deviation error bars.  Drawn by the port's renderer
    (:mod:`dream_tpu_torch.utils.plot`) and returned as its
    :class:`~dream_tpu_torch.utils.plot.Plot`, where ``dream_tpu`` returns
    matplotlib's ``(fig, ax)``; written to ``save_plot_path`` when given
    (``.png`` or ``.pdf``; none gets ``.png``)."""
    from dream_tpu_torch.utils.plot import Plot

    if len(epochs) != len(training_loss) or len(epochs) != len(validation_loss):
        raise ValueError("epochs, training_loss and validation_loss differ in length")
    plot_title = "Training vs. validation loss"
    fig = Plot()
    if isinstance(training_loss[0], float):
        fig.plot(epochs, training_loss, ".-", label="Training")
        fig.plot(epochs, validation_loss, ".-", label="Validation")
    else:
        plot_title += " (batch-wise mean +- 1 stdev)"
        fig.errorbar(epochs, [np.mean(x) for x in training_loss],
                     yerr=[np.std(x) for x in training_loss], marker=".", linestyle="-",
                     label="Training")
        fig.errorbar(epochs, [np.mean(x) for x in validation_loss],
                     yerr=[np.std(x) for x in validation_loss], marker=".", linestyle="-",
                     label="Validation")
    fig.grid()
    fig.set_xlabel("Training epoch")
    fig.set_ylabel("Loss")
    fig.set_xlim((epochs[0], epochs[-1]))
    if dataset_name:
        plot_title += f": {dataset_name}"
    fig.set_title(plot_title)
    fig.legend(loc="best")
    if save_plot_path:
        fig.savefig(save_plot_path)
    return fig


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


def _pnp_and_add(positions: torch.Tensor, pnp_input_raw: torch.Tensor, camera_K: np.ndarray,
                 n_inframe: np.ndarray, weights: Optional[torch.Tensor] = None,
                 detect_mask: Optional[torch.Tensor] = None, ransac: bool = False,
                 reject_outliers_px: Optional[float] = None) -> Dict[str, Any]:
    """Batched PnP over all frames and ADD under both rotation conventions.

    ADD counts the keypoints fed to PnP (``detect_mask``, by default those
    detected), as the reference's ``kp_pos_gt_pnp`` does
    (dream/analysis.py:322-339); a failed frame's ADD is -999.99.
    """
    device = positions.device
    K = torch.as_tensor(np.asarray(camera_K), dtype=torch.float32, device=device)
    if ransac:
        generator = torch.Generator(device=device).manual_seed(0)
        result, _ = gv.solve_pnp_ransac(positions, pnp_input_raw, K, generator=generator,
                                        weights=weights)
    else:
        result = gv.solve_pnp(positions, pnp_input_raw, K, weights=weights,
                              reject_outliers_px=reject_outliers_px)
    if detect_mask is None:
        detect_mask = ~((pnp_input_raw[..., 0] < -999.0) & (pnp_input_raw[..., 1] < -999.0))
    valid = result.valid.cpu().numpy()
    adds = {}
    for convention in ("standard", "transposed"):
        add = gv.add_from_pose(result.translation, result.quaternion, positions, detect_mask,
                               rotation_convention=convention).cpu().numpy()
        adds[convention] = np.where(valid, add.astype(float), -999.99)
    return {
        "valid": valid,
        "translation": result.translation.cpu().numpy(),
        "quaternion": result.quaternion.cpu().numpy(),
        "add": adds["standard"],
        "pnp": pnp_metrics(adds["standard"], n_inframe),
        "pnp_transposed": pnp_metrics(adds["transposed"], n_inframe),
    }


def _inframe_counts(gt_raw: np.ndarray, raw_res) -> np.ndarray:
    """Keypoints strictly inside the frame, per frame."""
    return np.sum(
        (gt_raw[:, :, 0] > 0.0) & (gt_raw[:, :, 0] < raw_res[0])
        & (gt_raw[:, :, 1] > 0.0) & (gt_raw[:, :, 1] < raw_res[1]),
        axis=1,
    )


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
    positions = torch.as_tensor(np.asarray(gt["positions"]), dtype=torch.float32, device=device)
    pnp = _pnp_and_add(positions, detected_raw_t, camera_K, _inframe_counts(gt_raw, raw_res))
    return {
        "keypoints": kp_result,
        "pnp": pnp["pnp"],
        "pnp_transposed": pnp["pnp_transposed"],
        "detected_raw": detected_raw,
        "pnp_valid": pnp["valid"],
        "add": pnp["add"],
    }


def write_keypoint_csv(keypoint_path: str, sample_names, keypoints_detected, keypoints_gt) -> None:
    """``keypoints.csv``: a frame a row, detected then ground-truth raw-frame
    coordinates (``dream_tpu/analysis.py:212-235``)."""
    keypoints_detected = np.asarray(keypoints_detected)
    keypoints_gt = np.asarray(keypoints_gt)
    if keypoints_detected.shape != keypoints_gt.shape or keypoints_detected.shape[0] != len(sample_names):
        raise ValueError("keypoint arrays and sample names disagree in shape")
    n_keypoints = keypoints_detected.shape[1]
    n_elems = n_keypoints * 2
    with open(keypoint_path, "w", newline="") as csvfile:
        writer = csv.writer(csvfile)
        header = ["name"]
        header += [f"kp{k}{a}" for k in range(n_keypoints) for a in ("x", "y")]
        header += [f"kp{k}{a}_gt" for k in range(n_keypoints) for a in ("x", "y")]
        writer.writerow(header)
        for name, det, gt in zip(sample_names, keypoints_detected, keypoints_gt):
            writer.writerow([name] + det.reshape(n_elems).tolist() + gt.reshape(n_elems).tolist())


def write_pnp_csv(pnp_path: str, sample_names, pnp_attempts_successful, poses, pnp_add,
                  num_inframe_projs_gt) -> None:
    """``pnp_results.csv``: a frame a row, success, pose (xyz, quaternion
    xyzw), ADD and in-frame ground-truth count (``dream_tpu/analysis.py:238-253``)."""
    n = len(sample_names)
    if not n == len(pnp_attempts_successful) == len(poses) == len(pnp_add) == len(num_inframe_projs_gt):
        raise ValueError("PnP result lists and sample names disagree in length")
    with open(pnp_path, "w", newline="") as csvfile:
        writer = csv.writer(csvfile)
        writer.writerow(["name", "pnp_success", "pose_x", "pose_y", "pose_z", "pose_qx", "pose_qy",
                         "pose_qz", "pose_qw", "add", "n_inframe_gt_projs"])
        for name, ok, pose, add, n_inframe in zip(sample_names, pnp_attempts_successful, poses,
                                                  pnp_add, num_inframe_projs_gt):
            writer.writerow([name] + [ok] + list(pose) + [add] + [n_inframe])


def _pnp_weights(scores: np.ndarray, weight_by_score: bool, soft_detections: bool,
                 soft_min_score: float) -> np.ndarray:
    """Per-correspondence PnP weights from the best peak scores
    (``dream_tpu/analysis.py:475-496``): scores normalized per frame to max
    1 and floored at 0.3 when weighting by score, else 1; with soft
    detections, 0 below the absolute floor."""
    scores = np.clip(scores, 0.0, None)
    if weight_by_score:
        max_s = np.maximum(scores.max(axis=1, keepdims=True), 1e-9)
        weights = np.clip(scores / max_s, 0.3, 1.0)
    else:
        weights = np.ones_like(scores)
    if soft_detections:
        weights = np.where(scores > soft_min_score, weights, 0.0)
    return weights.astype(np.float32)


def analyze_ndds_dataset(
    network_params_path: str,
    network_config_path: str,
    dataset_dir: str,
    output_dir: str,
    visualize_belief_maps: bool = True,
    pnp_analysis: bool = True,
    force_overwrite: bool = False,
    image_preprocessing_override: Optional[str] = None,
    batch_size: int = 16,
    num_workers: int = 8,
    dream_network=None,
    pnp_ransac: bool = False,
    pnp_weight_by_score: bool = False,
    pnp_reject_outliers_px: Optional[float] = None,
    pnp_soft_detections: bool = False,
    pnp_soft_min_score: float = 0.05,
    int8_calibration_frames: int = 0,
    device: Any = "cuda",
):
    """Evaluate a checkpoint on an NDDS dataset; write ``keypoints.csv``,
    ``pnp_results.csv`` and ``analysis_results.txt`` to ``output_dir``.

    Port of ``dream_tpu/analysis.py:260-618``, with its PnP options:
    ``pnp_ransac`` (RANSAC, 5 px inliers), ``pnp_weight_by_score`` (each
    correspondence weighted by its peak score), ``pnp_reject_outliers_px``
    (leave-one-out rejection), ``pnp_soft_detections`` (every map's best
    peak above ``pnp_soft_min_score`` goes to PnP, even where the score-gap
    test rejected it from the keypoint metrics; PCK is unaffected).  The
    network is ``dream_network`` or built from the two paths on
    ``device``.  With ``visualize_belief_maps`` it writes
    ``best_samples.png``, ``medians_samples.png`` and ``worst_samples.png``
    (:func:`_write_sample_mosaics`, ranked by each frame's mean L2 error).
    Returns ``(keypoint metrics, PnP metrics or None)``.
    """
    if not (isinstance(batch_size, int) and batch_size > 0):
        raise ValueError("batch_size must be a positive integer")
    for path in (network_params_path, network_config_path, dataset_dir):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
    if not ndds_utils.is_ndds_dataset(dataset_dir):
        raise ValueError(f'Expected dataset_dir "{dataset_dir}" to be an NDDS Dataset, but it is not.')
    if os.path.exists(output_dir) and not force_overwrite:
        raise FileExistsError(f'Specified directory "{output_dir}" already exists.')
    os.makedirs(output_dir, exist_ok=True)
    need_scores = pnp_weight_by_score or pnp_soft_detections

    if dream_network is None:
        from dream_tpu_torch.network import create_network_from_config_file

        dream_network = create_network_from_config_file(network_config_path, network_params_path,
                                                        device=device)
    device = dream_network.device
    preprocessing = image_preprocessing_override or dream_network.image_preprocessing()
    found = ndds_utils.find_ndds_data_in_dir(dataset_dir)
    raw_res = ndds_utils.load_image_resolution(found[1]["camera"])
    netin_res, netout_res = dream_network.net_resolutions_from_image_raw_resolution(
        raw_res, image_preprocessing_override=preprocessing)
    dataset = ManipulatorNDDSDataset(
        found, dream_network.manipulator_name, dream_network.keypoint_names, netin_res, netout_res,
        dream_network.image_normalization, preprocessing, augment_data=False,
        include_ground_truth=True, include_belief_maps=False,
        debug_mode=ManipulatorNDDSDatasetDebugLevels.LIGHT, n_decode_threads=max(num_workers, 1),
    )
    process = make_batch_processor(raw_res, netin_res, netout_res, preprocessing,
                                   dream_network.image_normalization, include_belief_maps=False)
    kp_to_raw = coord_ops.affine_raw_from_netin(netin_res, raw_res, preprocessing).compose(
        coord_ops.affine_netin_from_netout(netout_res, netin_res))

    if int8_calibration_frames:
        print(f"Calibrating int8 inference on {int8_calibration_frames} frames...")
        dream_network.enable_int8_inference(collect_calibration_batches(
            dataset, lambda g, images, kp: process(g, images.to(device), kp.to(device)),
            int8_calibration_frames, batch_size,
        ))

    print("Conducting inference...")
    detected, scores, soft, gt_raw, positions, names = [], [], [], [], [], []
    for host_batch in DataLoader(dataset, batch_size, shuffle=False, drop_last=False):
        images = torch.from_numpy(host_batch["image_rgb_raw"]).to(device)
        kp_raw = torch.from_numpy(host_batch["keypoint_projections_raw"]).to(device)
        net_input = process(None, images, kp_raw)["image_rgb_input"]
        if need_scores:
            _, kp_netout, peak_scores, best_netout = dream_network.inference_detailed(net_input)
            scores.append(peak_scores)
            if pnp_soft_detections:
                soft.append(kp_to_raw(best_netout))
        else:
            _, kp_netout = dream_network.inference(net_input)
        # Sentinel-preserving netout -> raw map (sentinels stay < -999).
        detected.append(kp_to_raw(kp_netout))
        gt_raw.append(np.asarray(host_batch["keypoint_projections_raw"], dtype=float))
        positions.append(host_batch["keypoint_positions"])
        names += dataset.sample_names(host_batch["indices"])

    detected_t = torch.cat(detected)
    detected_raw = detected_t.cpu().numpy()
    gt_raw = np.concatenate(gt_raw)
    n_samples, n_kp = detected_raw.shape[0], detected_raw.shape[1]
    sample_results = [(i, {"name": names[i], "detected_raw": detected_raw[i]},
                       sample_l2_metric(detected_raw[i], gt_raw[i], raw_res))
                      for i in range(n_samples)]
    kp_metrics = keypoint_metrics(detected_raw.reshape(n_samples * n_kp, 2),
                                  gt_raw.reshape(n_samples * n_kp, 2), raw_res)
    write_keypoint_csv(os.path.join(output_dir, "keypoints.csv"), names, detected_raw, gt_raw)

    pnp_results = pnp_results_alt = None
    if pnp_analysis:
        n_inframe = _inframe_counts(gt_raw, raw_res)
        if need_scores:
            weights_np = _pnp_weights(torch.cat(scores).cpu().numpy(), pnp_weight_by_score,
                                      pnp_soft_detections, pnp_soft_min_score)
        else:
            weights_np = np.ones((n_samples, n_kp), np.float32)
        weights = torch.from_numpy(weights_np).to(device)
        pnp_input = torch.cat(soft) if pnp_soft_detections else detected_t
        detect_mask = ~((pnp_input[..., 0] < -999.0) & (pnp_input[..., 1] < -999.0))
        if pnp_soft_detections:
            # Soft detections feed every above-floor peak to PnP; ADD follows
            # what PnP used.
            detect_mask = detect_mask & (weights > 0)
        pnp = _pnp_and_add(torch.from_numpy(np.concatenate(positions)).to(device), pnp_input,
                           ndds_utils.load_camera_intrinsics(found[1]["camera"]), n_inframe,
                           weights=weights, detect_mask=detect_mask, ransac=pnp_ransac,
                           reject_outliers_px=pnp_reject_outliers_px)
        valid = pnp["valid"]
        poses = [pnp["translation"][i].tolist() + pnp["quaternion"][i].tolist() if valid[i]
                 else [-999.99] * 7 for i in range(n_samples)]
        adds = [float(a) if ok else -999.99 for a, ok in zip(pnp["add"], valid)]
        write_pnp_csv(os.path.join(output_dir, "pnp_results.csv"), names, valid.tolist(), poses,
                      adds, n_inframe.tolist())
        pnp_results, pnp_results_alt = pnp["pnp"], pnp["pnp_transposed"]

    write_analysis_report(os.path.join(output_dir, "analysis_results.txt"), dataset_dir,
                          network_config_path, n_samples, kp_metrics, pnp_results, pnp_analysis,
                          pnp_alt=pnp_results_alt)

    if visualize_belief_maps:
        # File-system and memory failures must not fail the analysis; a
        # fault in the drawing code must surface.
        try:
            _write_sample_mosaics(output_dir, dataset, sample_results)
        except (OSError, MemoryError) as exc:
            print(f"Sample mosaic generation skipped: {exc}")
    return kp_metrics, pnp_results


def sample_l2_metric(detected_raw: np.ndarray, gt_raw: np.ndarray, raw_res) -> float:
    """A frame's mean L2 error (px) over its detected keypoints whose ground
    truth is in the frame, 999.999 when there is none (reference
    dream/analysis.py:243-265, ``dream_tpu/analysis.py:414-434``)."""
    keep = (
        ~((detected_raw[:, 0] < -999.0) & (detected_raw[:, 1] < -999.0))
        & (gt_raw[:, 0] >= 0.0) & (gt_raw[:, 0] <= raw_res[0])
        & (gt_raw[:, 1] >= 0.0) & (gt_raw[:, 1] <= raw_res[1])
    )
    if not np.any(keep):
        return 999.999
    return float(np.mean(np.linalg.norm(detected_raw[keep] - gt_raw[keep], axis=1)))


def _write_sample_mosaics(output_dir: str, dataset, sample_results) -> None:
    """``best_samples.png``, ``medians_samples.png`` and ``worst_samples.png``
    (``dream_tpu/analysis.py:838-876``): a row of raw frames a group, the
    detections in red (6 px) under the ground truth in green (4 px).
    ``sample_results`` holds ``(index, {"name", "detected_raw"}, metric)``
    a frame; the groups are the lowest, the middle and the highest metrics
    (5 frames each from 50 frames on, a tenth below that, 1 below 10)."""
    from dream_tpu_torch import visualize as viz
    from dream_tpu_torch.utils.png import write_png

    n_samples = len(sample_results)
    sorted_results = sorted(sample_results, key=lambda x: x[2])
    n_outliers = min(5, n_samples // 10) if n_samples >= 10 else 1
    middle = int(np.floor(n_samples / 2.0 - n_outliers / 2.0))
    groups = {
        "best": sorted_results[:n_outliers],
        "medians": sorted_results[middle : middle + n_outliers],
        "worst": sorted_results[n_samples - n_outliers :],
    }
    for group_name, entries in groups.items():
        images = []
        for idx, info, _ in entries:
            img = viz.overlay_points_on_image(dataset.load_images([idx])[0], info["detected_raw"],
                                              annotation_color_dot="red")
            img = viz.overlay_points_on_image(img, dataset.kp_projs_raw[idx],
                                              annotation_color_dot="green", point_diameter=4.0)
            images.append(img)
        write_png(os.path.join(output_dir, f"{group_name}_samples.png"),
                  viz.mosaic_images(images, rows=1, cols=len(images), inner_padding_px=4))


def sample_range_analysis(raw_images, sample_kp_proj_detected_netout, sample_kp_proj_gt_netout,
                          sample_belief_maps, sample_names, sample_ranks, image_prefix: str,
                          output_dir: str, keypoint_names, images_net_input) -> None:
    """Per-sample visual diagnostics over a rank range
    (``dream_tpu/analysis.py:740-835``, reference dream/analysis.py:997-1189).

    For each sample it writes ``{prefix}_belief_maps_rank_{rank}_id_{name}.png``
    (the belief maps in two rows), ``..._belief_maps_kp_...`` (each map with
    the ground truth in green and the detection in red, 4 px) and
    ``..._net_input_kp_...`` (both sets over the net input).
    ``images_net_input`` is a list of uint8 images or a ``[B, h, w, 3]``
    float array in [0, 1] (truncated to uint8); ``raw_images`` is not read,
    as in ``dream_tpu``."""
    from dream_tpu_torch import visualize as viz
    from dream_tpu_torch.utils import resample
    from dream_tpu_torch.utils.png import write_png

    n_keypoints = len(keypoint_names)
    n_cols = int(np.ceil(n_keypoints / 2.0))
    if not isinstance(images_net_input, (list, tuple)):
        arr = np.asarray(images_net_input)
        images_net_input = [np.uint8(np.clip(a * 255.0, 0, 255)) for a in arr]
    first = np.asarray(sample_belief_maps[0])
    net_output_res = (first.shape[2], first.shape[1])

    def path(kind, rank, name):
        return os.path.join(output_dir, f"{image_prefix}_{kind}_rank_{rank}_id_{name}.png")

    for kp_det, kp_gt, belief_maps, name, rank, net_in_img in zip(
            sample_kp_proj_detected_netout, sample_kp_proj_gt_netout, sample_belief_maps,
            sample_names, sample_ranks, images_net_input):
        kp_det, kp_gt = np.asarray(kp_det), np.asarray(kp_gt)
        map_images = viz.images_from_belief_maps(np.asarray(belief_maps), normalization_method=6)
        write_png(path("belief_maps", rank, name),
                  viz.mosaic_images(map_images, rows=2, cols=n_cols, inner_padding_px=10))
        overlaid = [viz.overlay_points_on_image(map_images[k], [kp_gt[k], kp_det[k]],
                                                annotation_color_dot=["green", "red"], point_diameter=4)
                    for k in range(n_keypoints)]
        write_png(path("belief_maps_kp", rank, name),
                  viz.mosaic_images(overlaid, rows=2, cols=n_cols, inner_padding_px=10))
        net_in_img = resample.as_image(net_in_img)
        to_netin = coord_ops.affine_netin_from_netout(
            net_output_res, (net_in_img.shape[1], net_in_img.shape[0]))
        overlay = viz.overlay_points_on_image(net_in_img, to_netin.apply_numpy(kp_gt),
                                              annotation_color_dot="green", point_diameter=4)
        overlay = viz.overlay_points_on_image(overlay, to_netin.apply_numpy(kp_det),
                                              annotation_color_dot="red", point_diameter=4)
        write_png(path("net_input_kp", rank, name), overlay)


def write_analysis_report(path: str, dataset_dir: str, network_config_path: str, n_samples: int,
                          kp: Dict[str, Any], pnp: Optional[Dict[str, Any]], pnp_analysis: bool,
                          pnp_alt: Optional[Dict[str, Any]] = None) -> List[str]:
    """``analysis_results.txt``, line for line the JAX package's
    (``dream_tpu/analysis.py:620-739``); each line is printed too.  ``pnp_alt``
    adds the ADD line under the alternate (transposed-R) rotation
    convention.  Returns the lines."""
    lines: List[str] = []

    def emit(text):
        print(text)
        lines.append(text)

    def share(count, total):
        return "{:.3f}% ({}/{})".format(count / total * 100.0, count, total)

    emit(f"Analysis results for dataset: {dataset_dir}")
    emit(f"Number of frames in this dataset: {n_samples}")
    emit(f"Using network config defined from: {network_config_path}")
    emit("")
    if kp["num_gt_outframe"] > 0:
        emit("Percentage out-of-frame gt keypoints not found (correct): "
             + share(kp["num_missing_gt_outframe"], kp["num_gt_outframe"]))
        emit("Percentage out-of-frame gt keypoints found (incorrect): "
             + share(kp["num_found_gt_outframe"], kp["num_gt_outframe"]))
    else:
        emit("No out-of-frame gt keypoints.")
    if kp["num_gt_inframe"] > 0:
        emit("Percentage in-frame gt keypoints not found (incorrect): "
             + share(kp["num_missing_gt_inframe"], kp["num_gt_inframe"]))
        emit("Percentage in-frame gt keypoints found (correct): "
             + share(kp["num_found_gt_inframe"], kp["num_gt_inframe"]))
        if kp["num_found_gt_inframe"] > 0:
            emit("L2 error (px) for in-frame keypoints (n = {}):".format(kp["num_found_gt_inframe"]))
            emit("   AUC: {:.5f}".format(kp["l2_error_auc"]))
            emit("      AUC threshold: {:.5f}".format(kp["l2_error_auc_thresh_px"]))
            emit("   Mean: {:.5f}".format(kp["l2_error_mean_px"]))
            emit("   Median: {:.5f}".format(kp["l2_error_median_px"]))
            emit("   Std Dev: {:.5f}".format(kp["l2_error_std_px"]))
        else:
            emit("No in-frame gt keypoints were detected.")
    else:
        emit("No in-frame gt keypoints.")
    emit("")

    if pnp_analysis and pnp is not None:
        n_possible = pnp["num_pnp_possible"]
        if n_possible > 0:
            emit("Percentage of frames where PNP failed when viable (incorrect): "
                 + share(pnp["num_pnp_not_found"], n_possible))
            emit("Percentage of frames where PNP was successful when viable (correct): "
                 + share(pnp["num_pnp_found"], n_possible))
            emit("ADD (m) for frames where PNP was successful when viable (n = {}):".format(
                pnp["num_pnp_found"]))
            emit("   AUC: {:.5f}".format(pnp["add_auc"]))
            emit("      AUC threshold: {:.5f}".format(pnp["add_auc_thresh"]))
            emit("   Mean: {:.5f}".format(pnp["add_mean"]))
            emit("   Median: {:.5f}".format(pnp["add_median"]))
            emit("   Std Dev: {:.5f}".format(pnp["add_std"]))
            if pnp_alt is not None:
                emit("   [info] ADD AUC / mean under the alternate (transposed-R) rotation "
                     "convention: {:.5f} / {:.5f}".format(pnp_alt["add_auc"], pnp_alt["add_mean"]))
                emit("   [info] Primary numbers above use the 'standard' convention (R @ kp + t); "
                     "see dream_tpu_torch/ops/geometric_vision.py:add_from_pose.")
        else:
            emit("No frames where PNP is possible.")
        emit("")

    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return lines
