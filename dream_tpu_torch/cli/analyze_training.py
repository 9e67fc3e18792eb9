"""Training analysis: the loss plot of a run and the re-analysis of its dataset.

The port's ``scripts/analyze_training.py``: ``-a loss`` draws
``train_valid_loss.png`` from the ``training_log.pkl`` beside the
checkpoint (:func:`dream_tpu_torch.analysis.plot_train_valid_loss`, the
port's renderer), ``-a viz`` evaluates the checkpoint on the dataset its
sidecar names (:func:`dream_tpu_torch.analysis.analyze_ndds_dataset`:
``keypoints.csv``, ``pnp_results.csv``, ``analysis_results.txt`` and the
sample mosaics), on ``--device`` (default ``cuda``).

Example:
  python3 -m dream_tpu_torch.cli.analyze_training -i run/best_network.msgpack -o run/analysis
"""

from __future__ import annotations

import argparse
import os
import pickle

from dream_tpu_torch import analysis
from dream_tpu_torch.utils.config import load_yaml, makedirs

LOSS_TEXT = "loss"
VIZ_TEXT = "viz"


def analyze_training(args):
    if not os.path.exists(args.input_params_path):
        raise FileNotFoundError(args.input_params_path)
    input_config_path = args.input_config_path or (
        os.path.splitext(args.input_params_path)[0] + ".yaml")
    if not os.path.exists(input_config_path):
        raise FileNotFoundError(input_config_path)

    makedirs(args.output_dir, exist_ok=args.force_overwrite)

    if LOSS_TEXT in args.analyses:
        training_log_path = os.path.join(os.path.dirname(args.input_params_path),
                                         "training_log.pkl")
        with open(training_log_path, "rb") as f:
            training_log = pickle.load(f)
        analysis.plot_train_valid_loss(
            training_log["epochs"], training_log["batch_training_losses"],
            training_log["batch_validation_losses"],
            save_plot_path=os.path.join(args.output_dir, "train_valid_loss.png"))

    if VIZ_TEXT in args.analyses:
        dataset_dir = os.path.expanduser(load_yaml(input_config_path)["data_path"])
        return analysis.analyze_ndds_dataset(
            args.input_params_path, input_config_path, dataset_dir, args.output_dir,
            batch_size=args.batch_size, force_overwrite=True, device=args.device)
    return None


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-i", "--input-params-path", required=True)
    parser.add_argument("-c", "--input-config-path", default=None)
    parser.add_argument("-o", "--output-dir", required=True)
    parser.add_argument("-f", "--force-overwrite", action="store_true", default=False)
    parser.add_argument("-a", "--analyses", nargs="+", choices=[LOSS_TEXT, VIZ_TEXT],
                        default=[LOSS_TEXT, VIZ_TEXT])
    parser.add_argument("-b", "--batch-size", type=int, default=16)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu.")
    return parser


if __name__ == "__main__":
    analyze_training(make_parser().parse_args())
