"""Generate a synthetic NDDS dataset for a manipulator config.

The port's ``scripts/make_synthetic_dataset.py``: renders random poses of a
keypoint chain with the robot's keypoint count and writes NDDS frames
(``NNNNNN.rgb.png``, ``NNNNNN.json``, ``_camera_settings.json``), the same
files the JAX package's script writes for a seed.  Rendering runs on the
host, so ``--device`` only names where later steps will run.

Examples:
  python3 -m dream_tpu_torch.cli.make_synthetic_dataset -m manip_configs/panda.yaml \\
      -o _scratch/synth_panda_768 -n 768 --seed 11
  python3 -m dream_tpu_torch.cli.make_synthetic_dataset -m manip_configs/baxter.yaml \\
      -o _scratch/synth_baxter_64 -n 64 --seed 97 --holdout
"""

from __future__ import annotations

import argparse
import time

from dream_tpu_torch.data.synthetic import generate_synthetic_ndds
from dream_tpu_torch.network import resolve_device
from dream_tpu_torch.utils.config import load_yaml


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Generate a synthetic NDDS dataset for a manipulator.")
    parser.add_argument(
        "-m", "--manipulator-config", required=True,
        help="Manipulator YAML (manip_configs/*.yaml) supplying the robot name and keypoint names.",
    )
    parser.add_argument("-o", "--output-dir", required=True)
    parser.add_argument("-n", "--n-frames", type=int, default=768)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--resolution", type=int, nargs=2, default=[640, 480], metavar=("W", "H"))
    parser.add_argument("--out-of-frame-fraction", type=float, default=0.1,
                        help="Fraction of frames posed with the robot partially out of view.")
    parser.add_argument("--holdout", action="store_true",
                        help="Shorthand for an evaluation split: no out-of-frame bias changes, "
                             "just a reminder to use a disjoint --seed.")
    parser.add_argument("--domain-randomization", action="store_true",
                        help="Textured backgrounds, distractors, occluders, lighting randomization.")
    parser.add_argument("--device", default="cuda",
                        help="Device of the port's run (cuda, or cpu); rendering runs on the host.")
    return parser


def main(args: argparse.Namespace = None) -> str:
    """Write the dataset ``args`` (the command line when None) describes."""
    if args is None:
        args = make_parser().parse_args()
    resolve_device(args.device)
    manip = load_yaml(args.manipulator_config)["manipulator"]
    names = [kp["name"] for kp in manip["keypoints"]]
    t0 = time.time()
    out = generate_synthetic_ndds(
        args.output_dir,
        n_frames=args.n_frames,
        image_resolution=tuple(args.resolution),
        keypoint_names=names,
        object_class=manip["name"],
        seed=args.seed,
        out_of_frame_fraction=args.out_of_frame_fraction,
        domain_randomization=args.domain_randomization,
    )
    print(f"wrote {args.n_frames} frames ({manip['name']}, {len(names)} kps, "
          f"seed {args.seed}) to {out} in {time.time() - t0:.1f}s")
    return out


if __name__ == "__main__":
    main()
