#!/usr/bin/env python3
"""How precise vgg-Q's channel-split convolutions are on the card, against whole ones.

For each conv of the r5 vgg-Q that ``parallel.mesh.param_shardings`` splits
over a model axis of 2 (``cout >= 256``), on the input it receives from
the network at batch ``--batch`` (seeded synthetic frames), this script
runs the whole conv and the half that one model rank holds, forward and
backward (a seeded output gradient), in float32 with TF32 off, and prints
each one's relative L2 error against the same conv in float64: the output,
the input gradient and the weight gradient, worst over the convs.  It
does so in this process and in two spawned gloo ranks on the same card
(the ranks phase 32 of ``chip_smoke.py`` runs).  Run from the repository
root on a CUDA machine:

    python3 scripts/split_conv_precision.py [--batch 16 32]
"""

import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dream_tpu_torch.network import DreamNetwork  # noqa: E402
from dream_tpu_torch.parallel import mesh as mesh_ops  # noqa: E402
from dream_tpu_torch.utils.config import load_yaml  # noqa: E402

CONFIG = "trained_models/results_r5/vggq/dream_vgg_q_r5.yaml"
CHECKPOINT = "trained_models/results_r5/vggq/dream_vgg_q_r5.msgpack"


def relative(a, b):
    return float((a.double() - b).norm() / b.norm())


def worst_errors(batch):
    """The worst relative errors, whole convs and halves, at ``batch``."""
    from dream_tpu_torch.data.synthetic import generate_synthetic_frames

    cfg = load_yaml(CONFIG)
    cfg["architecture"]["compute_dtype"] = "float32"
    net = DreamNetwork(cfg, device="cuda")
    net.load_network_params(CHECKPOINT)
    frames = generate_synthetic_frames(batch, (640, 480), net.keypoint_names, seed=0)
    x = net.preprocess(torch.from_numpy(frames["images"])).cuda().permute(0, 3, 1, 2)
    inputs = {}

    def keep(name):
        def hook(module, args, output):
            inputs[name] = (module, args[0].detach())
        return hook

    hooks = [m.register_forward_hook(keep(n)) for n, m in net.model.named_modules()
             if isinstance(m, torch.nn.Conv2d) and m.out_channels >= 256]
    with torch.no_grad():
        net.model(x.float())
    for h in hooks:
        h.remove()
    worst = {}
    generator = torch.Generator(device="cuda").manual_seed(0)
    for module, a in inputs.values():
        w, b = module.weight.detach(), module.bias.detach()
        half = w.shape[0] // 2
        out_shape = F.conv2d(a[:1], w, b, module.stride, module.padding).shape[2:]
        g = torch.randn((a.shape[0], w.shape[0]) + tuple(out_shape), device="cuda", generator=generator)

        def run(dtype, ww, bb, gg):
            aa = a.to(dtype).clone().requires_grad_(True)
            wv = ww.to(dtype).clone().requires_grad_(True)
            y = F.conv2d(aa, wv, bb.to(dtype), module.stride, module.padding)
            y.backward(gg.to(dtype))
            return y.detach(), aa.grad, wv.grad

        for part, ww, bb, gg in (("whole", w, b, g), ("half", w[:half], b[:half], g[:, :half])):
            got, exact = run(torch.float32, ww, bb, gg), run(torch.float64, ww, bb, gg)
            for kind, u, v in zip(("y", "dx", "dw"), got, exact):
                key = f"{part} {kind}"
                worst[key] = max(worst.get(key, 0.0), relative(u, v))
    return {"batch": batch, "convs": len(inputs), "worst_relative_l2": worst}


def rank_errors(rank, batches):
    return [worst_errors(b) for b in batches]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, nargs="+", default=[16, 32])
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    here = [worst_errors(b) for b in args.batch]
    ranks = mesh_ops.spawn_local_ranks(rank_errors, 2, "gloo", ["cuda:0", "cuda:0"], args.batch)
    print(json.dumps({"card": torch.cuda.get_device_name(0), "this_process": here,
                      "spawned_ranks": ranks}))


if __name__ == "__main__":
    main()
