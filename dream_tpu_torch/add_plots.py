#!/usr/bin/env python3
"""ADD accuracy-vs-threshold curves from pnp_results.csv files.

Port of ``dream_tpu/add_plots.py``: the same flags (``--divide`` for cm ->
m), printed lines and self-check against :func:`dream_tpu_torch.analysis.pnp_metrics`,
the ``666`` legend spacer, and the figure drawn by the port's own renderer
(:mod:`dream_tpu_torch.utils.plot`; the default ``output.pdf`` is a vector
PDF).  ``--show`` opens a window in ``dream_tpu``; the port has none to
open and raises.

    python3 -m dream_tpu_torch.add_plots --data run/pnp_results.csv --labels vgg-Q
"""

from __future__ import annotations

import argparse

import numpy as np

from dream_tpu_torch.analysis import pnp_metrics
from dream_tpu_torch.utils.csv_table import read_columns
from dream_tpu_torch.utils.plot import Plot


def add_curve_from_csv(csv_file: str, threshold: float = 0.1, divide: bool = False):
    df = read_columns(csv_file)
    add = np.asarray(df["add"], dtype=float)
    if divide:
        add = add / 100.0
    magic = -9.99 if divide else -999.0

    n_inframe = np.asarray(df["n_inframe_gt_projs"])
    n_pnp_possible = int(np.sum(n_inframe >= 4))
    add_found = add[add > magic]

    delta = 0.00001
    values = np.arange(0.0, threshold, delta)
    counts = np.sum(add_found[None, :] <= values[:, None], axis=1) / float(n_pnp_possible)
    auc = float(np.trapezoid(counts, dx=delta) / threshold)

    # Self-check vs the metrics module (reference dream/add_plots.py:88-104).
    if not divide and abs(threshold - 0.1) < 1e-12:
        m = pnp_metrics(df["add"], df["n_inframe_gt_projs"])
        if not (abs(m["add_auc"] - auc) < 1e-9 and m["num_pnp_found"] == len(add_found)
                and m["num_pnp_possible"] == n_pnp_possible):
            raise AssertionError(f"{csv_file}: the curve disagrees with pnp_metrics")

    return values, counts, auc, add_found, n_pnp_possible


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="ADD curves for dream_tpu")
    parser.add_argument("--data", nargs="+", required=True, help="pnp_results.csv files")
    parser.add_argument("--labels", nargs="+", default=None)
    parser.add_argument("--styles", nargs="+", default=None)
    parser.add_argument("--threshold", type=float, default=0.1)
    parser.add_argument("--output", default="output.pdf")
    parser.add_argument("--show", default=False, action="store_true")
    parser.add_argument("--divide", default=False, action="store_true",
                        help="Divide ADD values by 100 (cm -> m).")
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
        if csv_file == "666":
            fig.plot([], [], " ", label=args.labels[i_csv].replace("_", " "))
            continue

        values, counts, auc, add_found, n_possible = add_curve_from_csv(
            csv_file, args.threshold, args.divide)
        print(csv_file)
        print("auc", auc)
        print("found", len(add_found) / n_possible if n_possible else float("nan"))
        if len(add_found):
            print("mean", np.mean(add_found))
            print("median", np.median(add_found))
            print("std", np.std(add_found))

        label = (args.labels[i_csv].replace("_", " ")
                 if args.labels and i_csv < len(args.labels) else csv_file.replace(".csv", ""))
        label += f" ({auc:.3f})"
        style = args.styles[i_csv] if args.styles and i_csv < len(args.styles) else "-"
        fig.plot(values * 100.0, counts, style, label=label)

    fig.set_xlabel("ADD threshold distance (cm)")
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
