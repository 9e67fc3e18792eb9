#!/usr/bin/env python3
"""PCK accuracy-vs-threshold curves from keypoints.csv files.

Port of ``dream_tpu/oks_plots.py``: the same flags, metrics and printed
lines, the ``666`` legend spacer, and the figure drawn by the port's own
renderer (:mod:`dream_tpu_torch.utils.plot`; the default ``output.pdf``
is a vector PDF).  ``--show`` opens a window in ``dream_tpu``; the port
has none to open and raises.

    python3 -m dream_tpu_torch.oks_plots --data run/keypoints.csv --labels vgg-Q
"""

from __future__ import annotations

import argparse

import numpy as np

from dream_tpu_torch.utils.csv_table import read_columns
from dream_tpu_torch.utils.plot import Plot


def pck_curve_from_csv(csv_file: str, n_keypoints: int = 7, image_resolution=(640, 480),
                       pixel_threshold: float = 20.0):
    """Returns (pck_values, y_values, auc, distances) for one keypoints.csv."""
    df = read_columns(csv_file)
    all_dist = []
    for i in range(n_keypoints):
        gt = np.stack([df[f"kp{i}x_gt"], df[f"kp{i}y_gt"]], axis=1)
        pred = np.stack([df[f"kp{i}x"], df[f"kp{i}y"]], axis=1)
        inframe = ((gt[:, 0] > 0) & (gt[:, 0] < image_resolution[0])
                   & (gt[:, 1] > 0) & (gt[:, 1] < image_resolution[1]))
        d = np.linalg.norm(gt[inframe] - pred[inframe], axis=1)
        all_dist += d.tolist()
    all_dist = np.array(all_dist)

    pck_values = np.arange(0, int(pixel_threshold), 0.01)
    y_values = np.sum(all_dist[None, :] < pck_values[:, None], axis=1) / len(all_dist)
    auc = np.trapezoid(y_values, dx=0.01) / float(pixel_threshold)
    return pck_values, y_values, auc, all_dist


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="PCK curves for dream_tpu")
    parser.add_argument("--data", nargs="+", required=True, help="keypoints.csv files")
    parser.add_argument("--labels", nargs="+", default=None)
    parser.add_argument("--styles", nargs="+", default=None)
    parser.add_argument("--colours", nargs="+", default=None)
    parser.add_argument("--pixel", type=float, default=20)
    parser.add_argument("--keypoints", type=int, default=7)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--output", default="output.pdf")
    parser.add_argument("--show", default=False, action="store_true")
    parser.add_argument("--title", default=None)
    return parser


def main(argv=None) -> Plot:
    """Returns the figure (:class:`~dream_tpu_torch.utils.plot.Plot`)."""
    args = make_parser().parse_args(argv)
    if args.show:
        raise RuntimeError("--show opens a window, which the port has no way to do; "
                           "the figure is written to --output")
    fig = Plot()
    fig.grid(True, alpha=0.3)

    for i_csv, csv_file in enumerate(args.data):
        if csv_file == "666":  # legend spacer, reference behavior
            fig.plot([], [], " ", label=args.labels[i_csv].replace("_", " "))
            continue

        pck_values, y_values, auc, dists = pck_curve_from_csv(
            csv_file, args.keypoints, (args.width, args.height), args.pixel)
        print(csv_file)
        print("detected", len(dists))
        print("auc", auc)
        print("mean", np.mean(dists[dists < 1000]))
        print("median", np.median(dists[dists < 1000]))
        print("std", np.std(dists[dists < 1000]))

        label = (args.labels[i_csv].replace("_", " ")
                 if args.labels and i_csv < len(args.labels) else csv_file.replace(".csv", ""))
        label += f" ({auc:.3f})"
        style = args.styles[i_csv] if args.styles and i_csv < len(args.styles) else "-"
        fig.plot(pck_values, y_values, style, label=label)

    fig.set_xlabel("PCK threshold distance (pixels)")
    fig.set_ylabel("Accuracy")
    fig.set_ylim(0, 1)
    if args.title:
        fig.set_title(args.title)
    fig.legend(loc="lower right")
    fig.savefig(args.output)
    print(f"Saved plot to {args.output}")
    return fig


if __name__ == "__main__":
    main()
