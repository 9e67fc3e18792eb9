#!/usr/bin/env python3
"""Time the int8 conv kernel against other builds of the same C interface,
link by link over vgg-Q's int8 chain, on one NVIDIA GPU.

Each ``--source LABEL=PATH`` is a CUDA file that exports
``conv3x3_int8_launch`` as ``dream_tpu_torch/csrc/conv_int8_kernel.cu``
does: an earlier version of the kernel, or a copy with a part taken out to
see what that part costs.  For example, against the kernel of an earlier
commit:

    git show <commit>:dream_tpu_torch/csrc/conv_int8_kernel.cu > _scratch/old.cu
    python3 scripts/compare_conv_int8.py --source old=_scratch/old.cu

Every build is compiled with the package's nvcc flags, one nvcc each, all at
once.  At each of the 19 links at ``--batch`` (16, the main path's batch),
the inputs are drawn once (int8 activations and OHWI weights, and k and b
that spread the outputs over the int8 range); the current kernel must equal
``conv3x3_int8_plain`` bit for bit, and each other build's equality is
reported.  The builds then run in turns, forward and back (current, the
others, the others again, current), each timed with CUDA events over
``--iters`` back-to-back wrapper calls after a warm-up; the lesser of its two
times counts.  Prints the card's name and power limit, one JSON line a link
and one for the chain.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dream_tpu_torch.models.vgg_int8_deploy import chain_shapes  # noqa: E402
from dream_tpu_torch.ops import conv_int8, cuda_build  # noqa: E402


def build(sources, out_dir):
    """{label: ConvInt8Kernel} of each extra source, built in parallel."""
    jobs = {}
    for label, path in sources.items():
        lib = os.path.join(out_dir, f"lib{label}.so")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, path]
        jobs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), lib)
    kernels = {}
    for label, (proc, lib) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {label}:\n{err}")
        kernel = conv_int8.ConvInt8Kernel()
        cdll = ctypes.CDLL(lib)
        cdll.conv3x3_int8_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        cdll.conv3x3_int8_launch.restype = ctypes.c_int
        kernel._lib = cdll
        kernels[label] = kernel
    return kernels


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", action="append", default=[], metavar="LABEL=PATH",
                        help="another build of the kernel's C interface (repeatable)")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("compare_conv_int8: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sources = dict(item.split("=", 1) for item in args.source)
    if "current" in sources:
        parser.error("the label 'current' is the package's own kernel")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        kernels = {"current": conv_int8.conv3x3_int8_kernel, **build(sources, tmp)}
        conv_int8.conv3x3_int8_kernel.load()
        order = list(kernels) + list(kernels)[::-1]
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        totals = dict.fromkeys(kernels, 0.0)
        total_ops = 0
        for b, h, w, ci, co, relu in chain_shapes(args.batch):
            x_q = torch.randint(-127, 128, (b, h, w, ci), generator=gen, device="cuda", dtype=torch.int8)
            w_q = torch.randint(-127, 128, (co, 3, 3, ci), generator=gen, device="cuda", dtype=torch.int8)
            k = (torch.rand(co, generator=gen, device="cuda") + 0.5) / (80.0 * (9 * ci) ** 0.5)
            bias = torch.rand(co, generator=gen, device="cuda") * 60.0 - 30.0
            ref = conv_int8.conv3x3_int8_plain(x_q, w_q, k, bias, relu)
            equal = {}
            for label, kernel in kernels.items():
                equal[label] = bool(torch.equal(kernel(x_q, w_q, k, bias, relu), ref))
            if not equal["current"]:
                raise AssertionError(f"the kernel differs from plain at {(b, h, w, ci, co)}")
            times = {label: [] for label in kernels}
            for label in order:
                kernel = kernels[label]
                times[label].append(cuda_ms(lambda: kernel(x_q, w_q, k, bias, relu), args.iters))
            ops = 2 * 9 * b * h * w * ci * co
            total_ops += ops
            ms = {label: min(t) for label, t in times.items()}
            for label in kernels:
                totals[label] += ms[label]
            print(json.dumps({"link": [b, h, w, ci, co, relu], "ms": ms,
                              "tops": {label: ops / t / 1e9 for label, t in ms.items()},
                              "equal_to_plain": equal}), flush=True)
        print(json.dumps({"chain_ms": totals, "chain_tops": {label: total_ops / t / 1e9
                                                              for label, t in totals.items()},
                          "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
