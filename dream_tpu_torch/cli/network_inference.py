"""Single-image inference: the port of ``scripts/network_inference.py``.

Loads a checkpoint, detects the keypoints of one frame on the card
(``--device cpu`` for the CPU), prints them and, with ``-o``, writes the
reference's five visualizations (reference scripts/network_inference.py:
20-283) as files:

- ``keypoints_raw.png``: the detections and their names on the frame;
- ``keypoints_net_input.png``: the detections on the net input;
- ``belief_maps.png``: the belief maps in a row, each with its detection;
- ``belief_blends.png``: each belief map blended over the net input;
- ``keypoints_vs_gt.png``: ground truth (green) and detections (red), when
  the frame's NDDS ``.json`` lies beside it.

Frames are PNG or JPEG, read through the host loader
(:func:`dream_tpu_torch.utils.png.read_image`); any other format raises
``ValueError``.

Example:
  python3 -m dream_tpu_torch.cli.network_inference \\
      -i trained_models/results_r5/vggq/dream_vgg_q_r5.msgpack -m <dataset>/000000.rgb.png -o out
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from dream_tpu_torch import visualize as viz
from dream_tpu_torch.network import create_network_from_config_file
from dream_tpu_torch.utils.ndds import load_keypoints
from dream_tpu_torch.utils.png import read_image, write_png


def generate_belief_map_visualizations(belief_maps, keypoint_projs_detected) -> np.ndarray:
    """The belief maps in a row, each with its detection in green (4 px)
    (reference scripts/network_inference.py:20-52)."""
    images = viz.images_from_belief_maps(belief_maps, normalization_method=6)
    overlaid = [viz.overlay_points_on_image(img, [kp], annotation_color_dot="green", point_diameter=4)
                for kp, img in zip(keypoint_projs_detected, images)]
    return viz.mosaic_images(overlaid, rows=1, cols=len(overlaid), inner_padding_px=10)


def network_inference(args: argparse.Namespace) -> dict:
    """Detect, print and (with ``args.output_dir``) draw; returns the
    network's debug detection dict."""
    network_config_path = args.network_config or os.path.splitext(args.input_params_path)[0] + ".yaml"
    net = create_network_from_config_file(network_config_path, args.input_params_path,
                                          device=args.device)
    net.enable_evaluation()
    image_rgb = read_image(args.image_path)
    detection = net.keypoints_from_image(image_rgb, debug=True)
    kp_raw = detection["detected_keypoints"]

    print("Detected keypoints (raw frame):")
    for name, kp in zip(net.friendly_keypoint_names, kp_raw):
        found = kp[0] > -999.0 and kp[1] > -999.0
        print(f"  {name}: {kp if found else 'not detected'}")

    out_dir = args.output_dir
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        write_png(os.path.join(out_dir, "keypoints_raw.png"), viz.overlay_points_on_image(
            image_rgb, kp_raw, net.friendly_keypoint_names, annotation_color_dot="red",
            annotation_color_text="red"))
        net_in_img = viz.image_from_tensor(detection["image_rgb_net_input"], net.image_normalization)
        write_png(os.path.join(out_dir, "keypoints_net_input.png"), viz.overlay_points_on_image(
            net_in_img, detection["detected_keypoints_net_input"], annotation_color_dot="red"))
        belief_maps = detection["belief_maps"].float().cpu().numpy()
        write_png(os.path.join(out_dir, "belief_maps.png"), generate_belief_map_visualizations(
            belief_maps, detection["detected_keypoints_net_output"]))
        blends = [viz.blend_belief_overlay(net_in_img, bm) for bm in belief_maps]
        write_png(os.path.join(out_dir, "belief_blends.png"),
                  viz.mosaic_images(blends, rows=1, cols=len(blends)))
        json_path = os.path.splitext(args.image_path)[0].replace(".rgb", "") + ".json"
        if os.path.exists(json_path):
            gt = load_keypoints(json_path, net.manipulator_name, net.keypoint_names)
            img = viz.overlay_points_on_image(image_rgb, np.asarray(gt["projections"]),
                                              annotation_color_dot="green")
            write_png(os.path.join(out_dir, "keypoints_vs_gt.png"),
                      viz.overlay_points_on_image(img, kp_raw, annotation_color_dot="red"))
        print(f"Visualizations written to {out_dir}")
    return detection


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-i", "--input-params-path", required=True)
    parser.add_argument("-c", "--network-config", default=None)
    parser.add_argument("-m", "--image-path", required=True, help="A PNG or JPEG frame.")
    parser.add_argument("-o", "--output-dir", default=None,
                        help="Where to write the visualization PNGs.")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    return parser


if __name__ == "__main__":
    network_inference(make_parser().parse_args())
