"""Video visualization: the port of ``scripts/visualize_network_inference.py``.

Inference overlays of a frame range, written as PNG frames, then encoded to
H.264 ``.mp4`` by an ``ffmpeg`` subprocess (reference
scripts/visualize_network_inference.py:24-658).  Two inputs:

- an NDDS dataset: batched inference on the card through the dataset,
  loader and batch processor of the evaluation CLI (reference :241-258),
  the ground truth drawn in green under the red detections (:293-318,
  451-455); ``--int8-calibration-frames`` first calibrates int8 inference
  on the range's leading frames;
- a directory of PNG or JPEG frames, read through the host loader:
  single-frame inference, no ground truth (:322-382).

Four visualization types (``-t``), each in ``<out>/<type>_frames/``:
``kp_overlay_raw``, ``kp_overlay_net_input``, ``kp_belief_overlay_raw`` and
``belief_overlay_raw``.  Where ``ffmpeg`` is not on ``PATH`` (or fails),
the encoding is skipped with a message and the frames stay, as in
``dream_tpu``.

Example:
  python3 -m dream_tpu_torch.cli.visualize_network_inference \\
      -i trained_models/results_r5/vggq/dream_vgg_q_r5.msgpack -d <ndds dir> -o out -f \\
      -t kp_overlay_raw belief_overlay_raw -s 0 -e 16
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time
from typing import Dict, Iterator

import numpy as np
import torch

from dream_tpu_torch import visualize as viz
from dream_tpu_torch.data.dataset import (
    DataLoader,
    ManipulatorNDDSDataset,
    collect_calibration_batches,
    make_batch_processor,
)
from dream_tpu_torch.network import create_network_from_config_file
from dream_tpu_torch.ops import coords as coord_ops
from dream_tpu_torch.utils.config import makedirs
from dream_tpu_torch.utils.ndds import find_ndds_data_in_dir, is_ndds_dataset, load_image_resolution
from dream_tpu_torch.utils.png import read_image, write_png

# Visualization types (reference scripts/visualize_network_inference.py:54-57).
KP_OVERLAY_RAW = "kp_overlay_raw"
KP_OVERLAY_NET_INPUT = "kp_overlay_net_input"
KP_BELIEF_OVERLAY_RAW = "kp_belief_overlay_raw"
BELIEF_OVERLAY_RAW = "belief_overlay_raw"
ALL_VIZ_TYPES = [KP_OVERLAY_RAW, KP_OVERLAY_NET_INPUT, KP_BELIEF_OVERLAY_RAW, BELIEF_OVERLAY_RAW]


def video_from_frames(frames_dir: str, video_path: str, fps: float) -> bool:
    """H.264 encode of ``frames_dir/*.png`` by ffmpeg (reference :24-49);
    returns whether the video was written.  A missing or failing ffmpeg is
    reported and leaves the frames."""
    cmd = ["ffmpeg", "-y", "-framerate", str(fps), "-pattern_type", "glob", "-i",
           os.path.join(frames_dir, "*.png"), "-c:v", "libx264", "-pix_fmt", "yuv420p", video_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (FileNotFoundError, subprocess.CalledProcessError) as exc:
        print(f"ffmpeg encoding skipped ({exc}); frames remain in {frames_dir}")
        return False
    print(f"Wrote {video_path}")
    return True


def _save_frame(viz_types, frame_dirs, name, seconds, raw_image, kp_raw, belief_maps, net_in_img,
                kp_netin, gt_raw=None, gt_netin=None) -> None:
    """One frame of each requested type; the ground truth (NDDS path only)
    in green (4 px) under the red detections (reference :451-455).
    ``seconds`` gathers each type's drawing and writing time."""
    def with_gt(img, gt):
        if gt is None:
            return img
        return viz.overlay_points_on_image(img, gt, annotation_color_dot="green", point_diameter=4.0)

    def save(kind, image):
        write_png(os.path.join(frame_dirs[kind], name), image)

    t0 = time.perf_counter()
    if KP_OVERLAY_RAW in viz_types:
        save(KP_OVERLAY_RAW, viz.overlay_points_on_image(with_gt(raw_image, gt_raw), kp_raw,
                                                         annotation_color_dot="red"))
        t0 = _lap(seconds, KP_OVERLAY_RAW, t0)
    if KP_OVERLAY_NET_INPUT in viz_types:
        save(KP_OVERLAY_NET_INPUT, viz.overlay_points_on_image(with_gt(net_in_img, gt_netin), kp_netin,
                                                               annotation_color_dot="red"))
        t0 = _lap(seconds, KP_OVERLAY_NET_INPUT, t0)
    if BELIEF_OVERLAY_RAW in viz_types or KP_BELIEF_OVERLAY_RAW in viz_types:
        # The maps' maximum blended over the frame, shared by both types.
        blend = viz.blend_belief_overlay(raw_image, np.max(belief_maps, axis=0))
        if BELIEF_OVERLAY_RAW in viz_types:
            save(BELIEF_OVERLAY_RAW, blend)
            t0 = _lap(seconds, BELIEF_OVERLAY_RAW, t0)
        if KP_BELIEF_OVERLAY_RAW in viz_types:
            save(KP_BELIEF_OVERLAY_RAW, viz.overlay_points_on_image(with_gt(blend, gt_raw), kp_raw,
                                                                    annotation_color_dot="red"))
            _lap(seconds, KP_BELIEF_OVERLAY_RAW, t0)


def _lap(seconds: Dict[str, float], kind: str, t0: float) -> float:
    now = time.perf_counter()
    seconds[kind] = seconds.get(kind, 0.0) + now - t0
    return now


def _ndds_frames(net, dataset_dir, start, end, batch_size, num_workers,
                 int8_calibration_frames=0) -> Iterator[dict]:
    """Batched inference on the network's device over an NDDS dataset's
    frames ``[start, end)``; yields each frame's visualization inputs with
    its ground truth (reference :241-318)."""
    found = find_ndds_data_in_dir(dataset_dir)
    raw_res = load_image_resolution(found[1]["camera"])
    preprocessing = net.image_preprocessing()
    netin_res, netout_res = net.net_resolutions_from_image_raw_resolution(raw_res)
    dataset = ManipulatorNDDSDataset(
        found, net.manipulator_name, net.keypoint_names, netin_res, netout_res,
        net.image_normalization, preprocessing, augment_data=False, include_ground_truth=True,
        include_belief_maps=False, n_decode_threads=max(num_workers, 1))
    n = len(dataset)
    end = n if end is None else min(end, n)
    indices = list(range(start, end))
    if not indices:
        raise ValueError(f"No frames in selected range [{start}, {end})")
    device = net.device
    process = make_batch_processor(raw_res, netin_res, netout_res, preprocessing,
                                   net.image_normalization, include_belief_maps=False)
    to_netin = coord_ops.affine_netin_from_netout(netout_res, netin_res)
    kp_to_raw = coord_ops.affine_raw_from_netin(netin_res, raw_res, preprocessing).compose(to_netin)
    gt_to_netin = coord_ops.affine_netin_from_raw(raw_res, netin_res, preprocessing)

    if int8_calibration_frames:
        net.enable_int8_inference(collect_calibration_batches(
            dataset, lambda g, images, kp: process(g, images.to(device), kp.to(device)),
            int8_calibration_frames, batch_size, indices=indices))
        print(f"int8 inference active (calibrated on {int8_calibration_frames} frames)")

    for host_batch in DataLoader(dataset, batch_size, shuffle=False, drop_last=False, indices=indices):
        images = torch.from_numpy(host_batch["image_rgb_raw"]).to(device)
        kp = torch.from_numpy(host_batch["keypoint_projections_raw"]).to(device)
        net_input = process(None, images, kp)["image_rgb_input"]
        belief_maps, detected_netout = net.inference(net_input)
        belief_maps = belief_maps.float().cpu().numpy()
        detected_netout = detected_netout.cpu().numpy()
        kp_netin = to_netin.apply_numpy(detected_netout)
        kp_raw = kp_to_raw.apply_numpy(detected_netout)
        net_inputs = net_input.float().cpu().numpy()
        gt_raw = np.asarray(host_batch["keypoint_projections_raw"], dtype=float)
        for b in range(belief_maps.shape[0]):
            yield dict(raw_image=host_batch["image_rgb_raw"][b], kp_raw=kp_raw[b],
                       belief_maps=belief_maps[b],
                       net_in_img=viz.image_from_tensor(net_inputs[b], net.image_normalization),
                       kp_netin=kp_netin[b], gt_raw=gt_raw[b],
                       gt_netin=gt_to_netin.apply_numpy(gt_raw[b]))


def _image_dir_frames(net, dataset_dir, start, end) -> Iterator[dict]:
    """Single-frame inference over a directory's images in name order; no
    ground truth on this path (reference :322-382)."""
    exts = (".png", ".jpg", ".jpeg")
    image_paths = sorted(os.path.join(dataset_dir, f) for f in os.listdir(dataset_dir)
                         if f.lower().endswith(exts))
    if not image_paths:
        raise ValueError(f"No frames found in {dataset_dir}")
    end = len(image_paths) if end is None else end
    for path in image_paths[start:end]:
        image = read_image(path)
        detection = net.keypoints_from_image(image, debug=True)
        yield dict(raw_image=image, kp_raw=detection["detected_keypoints"],
                   belief_maps=detection["belief_maps"].float().cpu().numpy(),
                   net_in_img=viz.image_from_tensor(detection["image_rgb_net_input"],
                                                    net.image_normalization),
                   kp_netin=detection["detected_keypoints_net_input"])


def visualize_network_inference(args: argparse.Namespace) -> dict:
    """Write the frames and the videos; returns ``{"frames": n,
    "seconds_by_type": {type: s drawing and writing}, "videos": {type:
    written}}``."""
    network_config_path = args.network_config or os.path.splitext(args.input_params_path)[0] + ".yaml"
    net = create_network_from_config_file(network_config_path, args.input_params_path,
                                          device=args.device)
    net.enable_evaluation()
    makedirs(args.output_dir, exist_ok=args.force_overwrite)
    viz_types = args.visualization_types
    frame_dirs = {}
    for vt in viz_types:
        frame_dirs[vt] = os.path.join(args.output_dir, vt + "_frames")
        os.makedirs(frame_dirs[vt], exist_ok=True)

    start = args.start_frame or 0
    if is_ndds_dataset(args.dataset_dir):
        frames = _ndds_frames(net, args.dataset_dir, start, args.end_frame, args.batch_size,
                              args.num_workers, int8_calibration_frames=args.int8_calibration_frames)
    else:
        if args.int8_calibration_frames:
            raise ValueError("--int8-calibration-frames needs an NDDS dataset")
        frames = _image_dir_frames(net, args.dataset_dir, start, args.end_frame)

    seconds: Dict[str, float] = {}
    n_done = 0
    for idx, frame in enumerate(frames):
        _save_frame(viz_types, frame_dirs, f"{idx:06d}.png", seconds, **frame)
        n_done += 1
        if n_done % 25 == 0:
            print(f"Processed {n_done} frames")
    print(f"Processed {n_done} frames total")
    print("Frames/s drawn and written by type: " + ", ".join(
        f"{vt} {n_done / seconds[vt]:.1f}" for vt in viz_types if seconds.get(vt)))
    videos = {vt: video_from_frames(frame_dirs[vt], os.path.join(args.output_dir, vt + ".mp4"),
                                    args.fps) for vt in viz_types}
    return {"frames": n_done, "seconds_by_type": seconds, "videos": videos}


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-i", "--input-params-path", required=True)
    parser.add_argument("-c", "--network-config", default=None)
    parser.add_argument("-d", "--dataset-dir", required=True,
                        help="NDDS dataset dir or a directory of PNG frames.")
    parser.add_argument("-o", "--output-dir", required=True)
    parser.add_argument("-f", "--force-overwrite", action="store_true", default=False)
    parser.add_argument("-t", "--visualization-types", nargs="+", choices=ALL_VIZ_TYPES,
                        default=[KP_OVERLAY_RAW])
    parser.add_argument("-b", "--batch-size", type=int, default=16)
    parser.add_argument("-w", "--num-workers", type=int, default=8)
    parser.add_argument("-fps", "--fps", type=float, default=30.0)
    parser.add_argument("-s", "--start-frame", type=int, default=None)
    parser.add_argument("-e", "--end-frame", type=int, default=None)
    parser.add_argument("--int8-calibration-frames", type=int, default=0,
                        help="Quantize the network to int8 (NDDS path only), calibrating on this "
                             "many leading frames of the selected range (0 = float).")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    return parser


if __name__ == "__main__":
    visualize_network_inference(make_parser().parse_args())
