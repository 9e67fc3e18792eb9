#!/usr/bin/env python3
"""Where vgg-Q's float32 gradients part between the channel-split and the whole network.

One train step of the r5 vgg-Q (augmented, as ``chip_smoke.py`` phase 32
runs it) four ways on one device: unsharded in float32 and in float64
(``parallel.dryrun.to_float64``), and on a (data 1, model 2) mesh of two
gloo ranks in float32 and in float64.  For each float32 run it prints each
parameter leaf's relative L2 gradient distance from the unsharded float64
step, layer by layer from the head back to the input, and the whole
gradient's; and, for the first ``--record-rows`` frames of the batch (in
the layers ``--record-layers`` names, default all), the
discrete decisions of the forward that differ between runs: the sign of
each conv's output (what the ReLU after it keeps) and each 2x2 max-pool's
pick (``parallel.dryrun.split_gradient_reading``).  ``--cudnn`` repeats
the four runs under other cuDNN settings (``deterministic``: cuDNN's
deterministic algorithms; ``benchmark``: algorithms chosen by timing), in
this process and in the ranks.  ``--probe-conv NAME ...`` takes convs apart:
its input and output gradient from the unsharded float64 step, then the
weight and input gradients of the whole conv and of each half of its
output channels (what a model rank computes) in float32, under cuDNN's
default and timed algorithm choice, against float64 on the same tensors,
and the kernels each choice launches for a half.  ``--replay-block NAME``
(with the block's decisions recorded on every frame, ``--record-rows``
equal to ``--batch``) asks how far the decisions alone move the weight
gradient of the block's last conv: in float64, from the unsharded float64
step's input, output and pool gradients, with the output's ReLU signs and
the 2x2 max-pool's picks taken from each float32 run's records instead.
Prints one JSON object.

    python3 scripts/split_gradient_layers.py [--device cpu] [--resolution 400] [--batch 32] \
        [--cudnn default deterministic] [--probe-conv down4.conv3 ...] \
        [--record-rows 32 --record-layers down4 --replay-block down4]

On a CPU, cut ``--resolution`` and ``--batch`` (e.g. 128 and 4: ~1 min).
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dream_tpu_torch.data.synthetic import generate_synthetic_frames  # noqa: E402
from dream_tpu_torch.parallel import mesh as mesh_ops  # noqa: E402
from dream_tpu_torch.parallel.dryrun import (  # noqa: E402
    mesh_train_run,
    split_gradient_reading,
    train_network_for_run,
    train_steps,
)
from dream_tpu_torch.utils.config import load_yaml  # noqa: E402

CONFIG = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.yaml")
CHECKPOINT = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.msgpack")


def set_cudnn(setting):
    torch.backends.cudnn.deterministic = setting == "deterministic"
    torch.backends.cudnn.benchmark = setting == "benchmark"


def rank_run(rank, runs, devices, setting):
    set_cudnn(setting)
    return mesh_train_run(rank, runs, devices)


def run_four(run, device, setting="default"):
    """The four steps of ``run`` (a ``train_steps`` run dict) on ``device``
    under the cuDNN ``setting``."""
    set_cudnn(setting)
    f64 = dict(run, float64=True)
    unsharded32 = train_steps(train_network_for_run(run, device), run)
    unsharded64 = train_steps(train_network_for_run(f64, device), f64)
    devices = mesh_ops.rank_devices(2, device, "gloo")
    ranks = mesh_ops.spawn_local_ranks(
        rank_run, 2, "gloo", devices,
        [dict(run, n_data=1, n_model=2), dict(f64, n_data=1, n_model=2)], devices, setting)
    set_cudnn("default")
    split32, split64 = ranks[0]
    return unsharded32, unsharded64, split32, split64


def probe_conv(run, device, name):
    """The named conv's gradients on their own (see the module docstring)."""
    f64 = dict(run, float64=True, record_decisions=0)
    net = train_network_for_run(f64, device)
    conv = net.model.get_submodule(name)
    kept = {}

    def keep(module, args, output):
        kept["x"] = args[0].detach()
        output.register_hook(lambda grad: kept.__setitem__("dy", grad.detach()))

    conv.register_forward_hook(keep)
    train_steps(net, f64)
    x, dy, w = kept["x"], kept["dy"], conv.weight.detach().to(torch.float64)

    def grads(x, dy, w):
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dy, x, w, None, list(conv.stride), list(conv.padding), list(conv.dilation), False, [0, 0], 1,
            [True, True, False])
        return dx, dw

    def relative(a, b):
        return float((a.double() - b).norm() / b.norm())

    def kernels(x, dy, w):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            grads(x, dy, w)
            torch.cuda.synchronize()
        return sorted({e.key for e in prof.key_averages()
                       if getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) > 0})

    out = {"conv": name, "input": list(x.shape), "output_gradient": list(dy.shape)}
    c = w.shape[0]
    for part, rows in (("whole", slice(0, c)), ("half_0", slice(0, c // 2)), ("half_1", slice(c // 2, c))):
        ref_dx, ref_dw = grads(x, dy[:, rows].contiguous(), w[rows])
        args32 = (x.float(), dy[:, rows].float().contiguous(), w[rows].float())
        out[part] = {}
        for setting in ("default", "benchmark"):
            set_cudnn(setting)
            grads(*args32)  # under benchmark, the timed choice is made on this first call
            dx, dw = grads(*args32)
            out[part][setting] = {"weight_gradient": relative(dw, ref_dw), "input_gradient": relative(dx, ref_dx)}
            if device != "cpu" and part != "half_1":
                out[part][setting]["kernels"] = kernels(*args32)
        set_cudnn("default")
    return out


def replay_decisions(run, device, block, runs):
    """The weight gradient of ``block``'s last conv in float64 with the
    decisions of each of ``runs`` (``train_steps`` records with
    ``decisions`` of every frame), against the float64 step's own."""
    f64 = dict(run, float64=True, record_decisions=0)
    net = train_network_for_run(f64, device)
    down = net.model.get_submodule(block)
    conv_name = f"{block}.conv{down.n_convs - 1}"
    conv = net.model.get_submodule(conv_name)
    kept = {}

    def keep_conv(module, args, output):
        kept["x"], kept["y"] = args[0].detach(), output.detach()

    def keep_block(module, args, output):
        output.register_hook(lambda grad: kept.__setitem__("g", grad.detach()))

    hooks = [conv.register_forward_hook(keep_conv), down.register_forward_hook(keep_block)]
    train_steps(net, f64)
    for h in hooks:
        h.remove()
    x, y, g = kept["x"], kept["y"], kept["g"]
    B, C, H, W = y.shape
    pooled = g[:, :, : H // 2 * 2, : W // 2 * 2].reshape(B, C, H // 2, 2, W // 2, 2).sum((3, 5))

    def weight_gradient(signs, picks):
        scattered = torch.zeros_like(y)
        for k in range(4):
            r, c = divmod(k, 2)
            scattered[:, :, r: H // 2 * 2: 2, c: W // 2 * 2: 2] = pooled * (picks == k)
        dy = scattered * signs
        _, dw, _ = torch.ops.aten.convolution_backward(
            dy, x, conv.weight.detach().to(torch.float64), None, list(conv.stride), list(conv.padding),
            list(conv.dilation), False, [0, 0], 1, [False, True, False])
        return dw

    def decisions(record):
        signs = np.unpackbits(record[conv_name])[: B * C * H * W].reshape(B, C, H, W)
        return (torch.from_numpy(signs).to(y.device, torch.float64),
                torch.from_numpy(record[f"{block}.pool"].astype(np.int64)).to(y.device))

    own = weight_gradient(*decisions(runs["unsharded_float64"]["decisions"]))
    g_true = torch.ops.aten.convolution_backward(
        g * (y > 0), x, conv.weight.detach().to(torch.float64), None, list(conv.stride), list(conv.padding),
        list(conv.dilation), False, [0, 0], 1, [False, True, False])[1]
    out = {"conv": conv_name, "float64_records_vs_step": float((own - g_true).norm() / g_true.norm())}
    for label, record in runs.items():
        dw = weight_gradient(*decisions(record["decisions"]))
        out[label] = {"weight_gradient_moved": float((dw - own).norm() / own.norm())}
    return out


def main():
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--resolution", type=int, default=400, help="net input side")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--record-rows", type=int, default=4)
    parser.add_argument("--record-layers", nargs="*", default=[],
                        help="record only modules whose names start so (e.g. down4 down5); default all")
    parser.add_argument("--cudnn", nargs="*", default=["default"],
                        choices=["default", "deterministic", "benchmark"])
    parser.add_argument("--probe-conv", nargs="*", default=[], help="convs' module names, e.g. down4.conv3")
    parser.add_argument("--replay-block", default=None, help="a pooled down block, e.g. down4")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = load_yaml(CONFIG)
    cfg["architecture"]["compute_dtype"] = "float32"
    tcfg = cfg["training"]["config"]
    if args.resolution != tcfg["net_input_resolution"][0]:
        tcfg["net_input_resolution"] = [args.resolution, args.resolution]
        tcfg.pop("net_output_resolution", None)
    names = [kp["name"] for kp in cfg["manipulator"]["keypoints"]]
    frames = generate_synthetic_frames(args.batch, tuple(tcfg["image_raw_resolution"]), names, seed=0)
    run = {"config": cfg, "params_path": CHECKPOINT, "steps": 1, "augment": True, "aug_seed": 32,
           "record_decisions": args.record_rows, "record_layers": args.record_layers,
           "batch": {"raw": frames["images"], "kp": frames["projections"].astype(np.float32)}}
    out = {"device": args.device, "resolution": args.resolution, "batch": args.batch}
    if args.device != "cpu":
        out["card"] = torch.cuda.get_device_name(0)
    for name in args.probe_conv:
        out[f"probe {name}"] = probe_conv(run, args.device, name)
    for setting in args.cudnn:
        four = run_four(run, args.device, setting)
        out[setting] = split_gradient_reading(*four)
        if args.replay_block:
            set_cudnn(setting)
            out[setting]["replay"] = replay_decisions(run, args.device, args.replay_block, dict(zip(
                ("unsharded_float32", "unsharded_float64", "split_float32", "split_float64"), four)))
            set_cudnn("default")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
