#!/usr/bin/env python3
"""How far float32 rounding moves ResNet-H's gradients, against float64, on the CPU.

A data-parallel step sums BatchNorm statistics and gradients in another
order than one rank does.  This script measures what that order is worth:
ResNet-H (the r4 sidecar, full depth or ``--layers``) from its seed-0
initial parameters, one unaugmented step at ``--size`` on a seeded batch,
as one rank and as two gloo ranks (data 2), each in float32 and in float64
(the model, BatchNorm's statistics and the loss in float64), and prints
each gradient's relative L2 distance from the others.  The two float64 runs
show the data-parallel step exact up to float64's rounding, so the float32
runs' distance from each other is float32's rounding alone.  Run from the
repository root:

    python3 scripts/mesh_gradient_conditioning.py [--size 128] [--layers 3 4 23 3]
"""

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dream_tpu_torch.models import layers  # noqa: E402
from dream_tpu_torch.parallel import mesh as mesh_ops  # noqa: E402
from dream_tpu_torch.parallel.dryrun import mesh_train_run, train_network_for_run, train_steps  # noqa: E402
from dream_tpu_torch.utils.config import load_yaml  # noqa: E402

SIDECAR = "trained_models/results_r4/resnet_h/dream_resnet_h_r4.yaml"


class _BatchStatsNorm64(torch.autograd.Function):
    """``layers._BatchStatsNorm`` with its statistics in float64, over the
    mesh's data group when one is given."""

    @staticmethod
    def forward(ctx, x, weight, bias, dtype, mesh=None):
        count = x.numel() // x.shape[1]
        x64 = x.double()
        sum1, sum2 = x64.sum((0, 2, 3)), (x64 * x64).sum((0, 2, 3))
        if mesh is not None:
            sum1, sum2 = layers._data_group_sums(sum1, sum2, mesh)
            count *= mesh.shape["data"]
        mean = sum1 / count
        var = torch.clamp_min(sum2 / count - mean * mean, 0.0)
        rstd = torch.rsqrt(var + layers.BN_EPSILON)
        y = (x64 - mean[:, None, None]) * (rstd * weight.double())[:, None, None] + bias.double()[:, None, None]
        ctx.save_for_backward(x64, weight, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        ctx.mesh = mesh
        return y.to(dtype), mean, var

    @staticmethod
    def backward(ctx, grad_y, _grad_mean, _grad_var):
        x, weight, mean, rstd = ctx.saved_tensors
        count = x.numel() // x.shape[1]
        g = grad_y.double()
        x_hat = (x - mean[:, None, None]) * rstd[:, None, None]
        grad_bias, grad_weight = g.sum((0, 2, 3)), (g * x_hat).sum((0, 2, 3))
        sum_g, sum_gx = grad_bias, grad_weight
        if ctx.mesh is not None:
            sum_g, sum_gx = layers._data_group_sums(grad_bias, grad_weight, ctx.mesh)
            count *= ctx.mesh.shape["data"]
        grad_x = (g - sum_g[:, None, None] / count - x_hat * sum_gx[:, None, None] / count) \
            * (weight.double() * rstd)[:, None, None]
        return grad_x.to(grad_y.dtype), grad_weight.to(weight.dtype), grad_bias.to(weight.dtype), None, None


def float64_steps(run, device, mesh=None):
    """``train_steps`` of the run's network in float64, BatchNorm's
    statistics too (on ``mesh`` when given)."""
    net = train_network_for_run(dict(run, float64=True), device, mesh)
    float32_norm = layers._BatchStatsNorm
    layers._BatchStatsNorm = _BatchStatsNorm64
    try:
        return train_steps(net, run)
    finally:
        layers._BatchStatsNorm = float32_norm


def float64_rank(rank, run, devices):
    """A rank of the two-rank float64 run (for ``spawn_local_ranks``)."""
    return float64_steps(run, devices[rank], mesh_ops.make_mesh(run["n_data"], run["n_model"], devices))


def distance(a, b):
    return math.sqrt(sum(float((a[k].double() - b[k].double()).square().sum()) for k in b)
                     / sum(float(v.double().square().sum()) for v in b.values()))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--size", type=int, default=128, help="net input side")
    parser.add_argument("--layers", type=int, nargs=4, default=[3, 4, 23, 3])
    args = parser.parse_args()
    cfg = load_yaml(SIDECAR)
    cfg["architecture"]["compute_dtype"] = "float32"
    cfg["architecture"]["layers"] = args.layers
    tcfg = cfg["training"]["config"]
    tcfg["net_input_resolution"] = [args.size, args.size]
    tcfg.pop("net_output_resolution", None)
    tcfg["image_raw_resolution"] = [160, 120]
    tcfg["optimizer"].pop("grad_clip_norm", None)  # p.grad is then the raw gradient
    rng = np.random.RandomState(1)
    batch = {"raw": rng.randint(0, 256, (4, 120, 160, 3)).astype(np.uint8),
             "kp": rng.uniform([42, 26], [100, 90], (4, 7, 2)).astype(np.float32)}
    run = {"config": cfg, "seed": 0, "steps": 1, "augment": False, "batch": batch}

    two_ranks = dict(run, n_data=2, n_model=1)
    one = train_steps(train_network_for_run(run, "cpu"), run)
    two = mesh_ops.spawn_local_ranks(mesh_train_run, 2, "gloo", ["cpu", "cpu"], [two_ranks],
                                     ["cpu", "cpu"])[0][0]
    exact = float64_steps(run, "cpu")
    two_exact = mesh_ops.spawn_local_ranks(float64_rank, 2, "gloo", ["cpu", "cpu"], two_ranks,
                                           ["cpu", "cpu"])[0]
    print(json.dumps({
        "size": args.size, "layers": args.layers, "batch": 4,
        "loss": {"one_rank_float32": one["losses"][0], "two_ranks_float32": two["losses"][0],
                 "one_rank_float64": exact["losses"][0], "two_ranks_float64": two_exact["losses"][0]},
        "gradient_relative_l2": {"one_rank_float32_vs_float64": distance(one["grads"], exact["grads"]),
                                 "two_ranks_float32_vs_float64": distance(two["grads"], exact["grads"]),
                                 "two_ranks_vs_one_rank_float32": distance(two["grads"], one["grads"]),
                                 "two_ranks_vs_one_rank_float64": distance(two_exact["grads"], exact["grads"])}}))


if __name__ == "__main__":
    main()
