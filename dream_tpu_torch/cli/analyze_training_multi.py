"""Aggregate analysis of N training runs (seed-variance studies).

The port's ``scripts/analyze_training_multi.py``: the best, median and
worst instance by the sum of the last half of their training losses, the
same prints, and the three figure kinds, drawn by the port's renderer
(:mod:`dream_tpu_torch.utils.plot`): ``training_results_instances.png``
(every instance, the three selected ones wide), ``training_results_aggregate.png``
(mean +- 1 std band, mean, median, min, max) and a
``train_valid_loss_<instance>.png`` for each instance.  ``dream_tpu`` shows
the figures in a window when ``-o`` is not given; the port has no window,
so ``-o`` is required.

Example:
  python3 -m dream_tpu_torch.cli.analyze_training_multi -i runs -o runs/analysis
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from dream_tpu_torch import analysis
from dream_tpu_torch.utils.config import makedirs
from dream_tpu_torch.utils.plot import Plot


def analyze_training_multi(args):
    if not os.path.exists(args.input_dir):
        raise FileNotFoundError(args.input_dir)
    if args.output_dir is None:
        raise RuntimeError("without -o dream_tpu shows the figures in a window, which the port "
                           "has no way to do; give -o to write them")
    makedirs(args.output_dir, exist_ok=args.force_overwrite)

    dir_list = sorted(
        d for d in os.listdir(args.input_dir)
        if os.path.isdir(os.path.join(args.input_dir, d))
        and os.path.exists(os.path.join(args.input_dir, d, "training_log.pkl")))
    if not dir_list:
        raise FileNotFoundError("No training instance directories with training_log.pkl found.")

    all_losses_list, all_validation_losses, train_epochs = [], [], None
    for d in dir_list:
        with open(os.path.join(args.input_dir, d, "training_log.pkl"), "rb") as f:
            log = pickle.load(f)
        train_epochs = log["epochs"]
        all_losses_list.append(log["losses"])
        all_validation_losses.append(log["validation_losses"])
        print(f"{d}: Random seed: {log['random_seed']}")

    all_losses = np.array(all_losses_list)
    all_validation_losses = np.array(all_validation_losses)
    n_traces = len(all_losses_list)
    n_epochs = len(train_epochs)

    lasthalf_sum = np.sum(all_losses[:, n_epochs // 2:], axis=1)
    x_worst = int(np.argmax(lasthalf_sum))
    x_best = int(np.argmin(lasthalf_sum))
    x_median = int(np.argsort(lasthalf_sum)[n_traces // 2])

    print("Training Loss Performance")
    print("~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~")
    print(f"Best instance for training loss: {dir_list[x_best]}")
    print(f"Median instance for training loss: {dir_list[x_median]}")
    print(f"Worst instance for training loss: {dir_list[x_worst]}")
    print("")

    figures = {}
    fig = Plot()
    fig.plot(train_epochs, np.transpose(all_losses), ".-")
    for x_sel, lbl in [(x_worst, "Worst training result"), (x_best, "Best training result"),
                       (x_median, "Median training result")]:
        fig.plot(train_epochs, all_losses[x_sel], "-", linewidth=8, alpha=0.667, label=lbl)
    fig.grid()
    fig.set_xlabel("Training epoch")
    fig.set_ylabel("Training loss")
    fig.set_xlim((train_epochs[0], train_epochs[-1]))
    fig.set_title(f"All training results ({n_traces} instances)")
    fig.legend(loc="best")
    figures["instances"] = fig
    fig.savefig(os.path.join(args.output_dir, "training_results_instances.png"))

    mean, std = np.mean(all_losses, axis=0), np.std(all_losses, axis=0)
    fig = Plot()
    fig.fill_between(train_epochs, mean - std, mean + std, alpha=0.333,
                     label="Aggregate mean +- 1 std dev")
    fig.plot(train_epochs, mean, ".-", label="Aggregate mean")
    fig.plot(train_epochs, np.median(all_losses, axis=0), ".-", label="Aggregate median")
    fig.plot(train_epochs, np.min(all_losses, axis=0), ".-", label="Aggregate min")
    fig.plot(train_epochs, np.max(all_losses, axis=0), ".-", label="Aggregate max")
    fig.grid()
    fig.set_xlabel("Training epoch")
    fig.set_ylabel("Training loss")
    fig.set_xlim((train_epochs[0], train_epochs[-1]))
    fig.set_title(f"Aggregate (epoch-wise) training results ({n_traces} instances)")
    fig.legend(loc="best")
    figures["aggregate"] = fig
    fig.savefig(os.path.join(args.output_dir, "training_results_aggregate.png"))

    if len(all_validation_losses) > 0:
        min_per_trace = np.min(all_validation_losses, axis=1)
        x_best_valid = int(np.argmin(min_per_trace))
        x_epoch = int(np.argmin(all_validation_losses[x_best_valid]))
        print("Validation Loss Performance:")
        print("~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~")
        print(f"Best instance for validation loss: {dir_list[x_best_valid]} "
              f"({min_per_trace[x_best_valid]} after epoch {train_epochs[x_epoch]})")
        for n in range(n_traces):
            figures[dir_list[n]] = analysis.plot_train_valid_loss(
                train_epochs, list(all_losses[n]), list(all_validation_losses[n]),
                dataset_name=dir_list[n],
                save_plot_path=os.path.join(args.output_dir, f"train_valid_loss_{dir_list[n]}"))
    return figures


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-i", "--input-dir", required=True)
    parser.add_argument("-o", "--output-dir", default=None)
    parser.add_argument("-f", "--force-overwrite", action="store_true", default=False)
    return parser


if __name__ == "__main__":
    analyze_training_multi(make_parser().parse_args())
