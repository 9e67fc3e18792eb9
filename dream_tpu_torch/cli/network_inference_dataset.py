"""Evaluate a checkpoint on an NDDS dataset and write its reports.

The port's ``scripts/network_inference_dataset.py``, a thin wrapper over
:func:`dream_tpu_torch.analysis.analyze_ndds_dataset`: ``keypoints.csv``,
``pnp_results.csv`` and ``analysis_results.txt`` in ``-o``, and the best,
median and worst samples' mosaics (``best_samples.png``,
``medians_samples.png``, ``worst_samples.png``) unless
``--no-visualization``.

Example (the r5 flagship on its holdout):
  python3 -m dream_tpu_torch.cli.network_inference_dataset \\
      -i trained_models/results_r5/vggq/dream_vgg_q_r5.msgpack -d _scratch/hold64 \\
      -o _scratch/eval_vggq_r5 -f
"""

from __future__ import annotations

import argparse
import os

from dream_tpu_torch import analysis
from dream_tpu_torch.network import DreamNetwork
from dream_tpu_torch.utils.config import load_yaml


def network_inference_dataset(args: argparse.Namespace):
    network_config_path = args.network_config or os.path.splitext(args.input_params_path)[0] + ".yaml"
    config = load_yaml(network_config_path)
    if args.compute_dtype:
        # Evaluate under another compute dtype than the checkpoint's; the
        # parameters are float32 either way.
        config["architecture"]["compute_dtype"] = args.compute_dtype
    network = DreamNetwork.from_checkpoint(config, args.input_params_path, device=args.device)
    return analysis.analyze_ndds_dataset(
        args.input_params_path,
        network_config_path,
        args.dataset_dir,
        args.output_dir,
        visualize_belief_maps=not args.no_visualization,
        pnp_analysis=not args.no_pnp,
        force_overwrite=args.force_overwrite,
        image_preprocessing_override=args.image_preproc_override,
        batch_size=args.batch_size,
        num_workers=args.num_workers,
        dream_network=network,
        pnp_ransac=args.ransac,
        pnp_weight_by_score=args.pnp_weight_by_score,
        pnp_reject_outliers_px=args.pnp_reject_outliers_px,
        pnp_soft_detections=args.pnp_soft_detections,
        pnp_soft_min_score=args.pnp_soft_min_score,
        int8_calibration_frames=args.int8_calibration_frames,
    )


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-i", "--input-params-path", required=True,
                        help="Path to network parameters file (.msgpack).")
    parser.add_argument("-c", "--network-config", default=None,
                        help="Network config YAML; defaults to the params path with .yaml.")
    parser.add_argument("-d", "--dataset-dir", required=True)
    parser.add_argument("-o", "--output-dir", required=True)
    parser.add_argument("-b", "--batch-size", type=int, default=16)
    parser.add_argument("-w", "--num-workers", type=int, default=8)
    parser.add_argument("-f", "--force-overwrite", action="store_true", default=False)
    parser.add_argument("-p", "--image-preproc-override", default=None)
    parser.add_argument("--no-pnp", action="store_true", default=False)
    parser.add_argument("--ransac", action="store_true", default=False,
                        help="Use RANSAC PnP (5 px inlier threshold).")
    parser.add_argument("--pnp-weight-by-score", action="store_true", default=False,
                        help="Weight PnP correspondences by belief-map peak score.")
    parser.add_argument("--pnp-soft-detections", action="store_true", default=False,
                        help="Feed PnP the best belief-map peak for every keypoint (score-weighted), "
                             "even those the score-gap disambiguation rejects from the keypoint "
                             "metrics.")
    parser.add_argument("--pnp-soft-min-score", type=float, default=0.05,
                        help="Absolute peak-score floor for --pnp-soft-detections.")
    parser.add_argument("--pnp-reject-outliers-px", type=float, default=None,
                        help="Drop correspondences reprojecting worse than this many px after a "
                             "first solve, then re-refine (leave-one-out).")
    parser.add_argument("--no-visualization", action="store_true", default=False)
    parser.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default=None,
                        help="Override the checkpoint's compute dtype for inference (params are "
                             "f32 regardless).")
    parser.add_argument("--int8-calibration-frames", type=int, default=0,
                        help="Quantize the conv stack to int8, calibrating activation scales on "
                             "this many leading dataset frames (0 = float inference).")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    return parser


if __name__ == "__main__":
    network_inference_dataset(make_parser().parse_args())
