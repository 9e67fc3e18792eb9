#!/usr/bin/env python3
"""Time the score and warp kernels against earlier builds of them, and the
score kernel's cuts against each other, on one NVIDIA GPU.

``--score-source PATH`` is a CUDA file with the C interface of the score
kernel's first version (``score_kernel_launch(maps, band_h, band_wt,
scored, count, n, H, W, rows_per_block, threshold, stream)``, adding into
zeroed counts); ``--warp-source PATH`` one of the warp kernel, whose C
interface has not changed (``warp_kernel_launch(images, inverse, out, B, H,
W, C, stream)``).  ``--variant KIND:LABEL=PATH`` (KIND ``score`` or ``warp``,
repeatable) is another build of the package's current C interface: a draft
of the same design, or a copy with a part changed; a label that starts with
``x-`` marks a copy with a part taken out, timed but not held to the plain
version; ``score:LABEL=PATH@C`` times a score build with C blocks a map.
For example, against the kernels of an earlier commit:

    git show <commit>:dream_tpu_torch/csrc/score_kernel.cu > _scratch/score_old.cu
    git show <commit>:dream_tpu_torch/csrc/warp_kernel.cu > _scratch/warp_old.cu
    python3 scripts/compare_score_warp.py --score-source _scratch/score_old.cu \\
        --warp-source _scratch/warp_old.cu

Each build is compiled with the package's nvcc flags, one nvcc each, all at
once.  Score: belief maps (Gaussian blobs plus noise, as ``chip_smoke.py``
makes them) at [112, 100, 100] (vgg-Q's batch of 16) and [14, 400, 400];
the package's kernel under its default cut and under other clusters, the
variants under the default cut, and the earlier build; each must give
counts and scored maps equal to ``score_maps_plain``.  Warp: 0-255 images
at [32, 400, 400, 3] under in-range random affines and under an affine that
folds several times, on a given inverse; the package's kernel, the
variants and the earlier build, each equal to ``warp_batch_plain``.  Every candidate
is timed in turns, forward and back: its device time (a CUDA graph of
launches, ``chip_smoke.graph_ms``: the wrapper's device work, the earlier
score wrapper's memset of the counts included) and its time a call by CUDA
events over back-to-back calls (host dispatch included); the lesser of the
two rounds counts.  Then one torch.profiler pass a candidate gives the mean
device time of each kernel it launches.  Prints the card's name and power
limit and one JSON line a shape.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (cuda_ms, graph_ms, kernel_bound_ms, random_maps,  # noqa: E402
                        warp_bound_ms, warp_inputs)
from dream_tpu_torch.ops import cuda_build, score_kernel, warp  # noqa: E402


def build(sources, out_dir):
    """{label: ctypes.CDLL} of each extra source, built in parallel."""
    jobs = {}
    for label, path in sources.items():
        lib = os.path.join(out_dir, f"lib{label}.so")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, path]
        jobs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), lib)
    libs = {}
    for label, (proc, lib) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {label}:\n{err}")
        libs[label] = ctypes.CDLL(lib)
    return libs


class FirstScoreKernel:
    """The score kernel's first interface: banded weights, the first
    wrapper's rows_per_block, counts zeroed by the wrapper and added to."""

    def __init__(self, lib):
        lib.score_kernel_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.score_kernel_launch.restype = ctypes.c_int
        self.lib, self.bands = lib, {}

    def __call__(self, maps):
        n, h, w = maps.shape
        if (h, w) not in self.bands:
            band = lambda k: torch.from_numpy(score_kernel._blur_band(k, 3.0)).to(maps.device)
            self.bands[h, w] = (band(h).contiguous(), band(w).T.contiguous())
        band_h, band_wt = self.bands[h, w]
        rows = max(1, min(h, 25, (96 * 1024 // (4 * w) - 28) // 2))
        scored = torch.empty_like(maps)
        count = torch.zeros(n, dtype=torch.int32, device=maps.device)
        err = self.lib.score_kernel_launch(
            maps.data_ptr(), band_h.data_ptr(), band_wt.data_ptr(), scored.data_ptr(),
            count.data_ptr(), n, h, w, rows, score_kernel.PEAK_THRESHOLD,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"earlier score kernel launch failed: CUDA error {err}")
        return scored, count


class ScoreBuild(score_kernel.ScoreKernel):
    """The package's score wrapper on another build of its current C
    interface; its launches are counted apart from the package's."""

    def __init__(self, lib):
        super().__init__()
        lib.score_kernel_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.score_kernel_launch.restype = ctypes.c_int
        self._lib = lib


class WarpBuild:
    """A build of the warp kernel's C interface (the same in every version)."""

    def __init__(self, lib):
        lib.warp_kernel_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.warp_kernel_launch.restype = ctypes.c_int
        self.lib = lib

    def launch(self, images, inverse):
        b, h, w, c = images.shape
        out = torch.empty_like(images)
        err = self.lib.warp_kernel_launch(images.data_ptr(), inverse.data_ptr(), out.data_ptr(),
                                          b, h, w, c, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"warp kernel build's launch failed: CUDA error {err}")
        return out


def kernel_device_ms(fn, calls=20):
    """Mean device ms of each kernel ``fn()`` launches, by torch.profiler."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))
            out[e.key[:70]] = us / e.count / 1e3
    return out


def time_in_turns(candidates, iters):
    """{label: {"device_ms", "call_ms", "kernels_ms"}} of each fn, in turns
    forward and back, the lesser of the two rounds."""
    order = list(candidates) + list(candidates)[::-1]
    device, call = {k: [] for k in candidates}, {k: [] for k in candidates}
    for label in order:
        device[label].append(graph_ms(candidates[label], launches=iters))
        call[label].append(cuda_ms(candidates[label], iters))
    return {label: {"device_ms": min(device[label]), "call_ms": min(call[label]),
                    "kernels_ms": kernel_device_ms(candidates[label])} for label in candidates}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--score-source", help="an earlier score kernel (first C interface)")
    parser.add_argument("--warp-source", help="an earlier warp kernel (first C interface)")
    parser.add_argument("--variant", action="append", default=[], metavar="KIND:LABEL=PATH",
                        help="another build of a current C interface (KIND score or warp)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("compare_score_warp: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    sources = {k: v for k, v in (("score", args.score_source), ("warp", args.warp_source)) if v}
    variants = {"score": {}, "warp": {}}
    for item in args.variant:
        kind, rest = item.split(":", 1)
        label, path = rest.split("=", 1)
        path, _, cluster = path.partition("@")
        variants[kind][label] = int(cluster) if cluster else None
        sources[f"{kind}_{label}"] = path
    cuda_build.build_all(["score_kernel", "warp_kernel"])
    kernel = score_kernel.score_maps_kernel
    rng = np.random.RandomState(args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, tmp)
        first_score = FirstScoreKernel(libs["score"]) if "score" in libs else None
        first_warp = WarpBuild(libs["warp"]) if "warp" in libs else None
        score_variants = {label: (ScoreBuild(libs[f"score_{label}"]), cluster)
                          for label, cluster in variants["score"].items()}
        warp_variants = {label: WarpBuild(libs[f"warp_{label}"]) for label in variants["warp"]}

        for (n, h, w), clusters in (((112, 100, 100), (2, 4)), ((14, 400, 400), (1, 2, 4))):
            maps = random_maps(rng, n, h, w)
            plans = {"current": score_kernel.score_plan(h, w)}
            plans.update({f"cluster {c}": score_kernel.score_plan(h, w, cluster=c) for c in clusters})
            candidates = {label: (lambda p=p: kernel(maps, p)) for label, p in plans.items()}
            for label, (variant, cluster) in score_variants.items():
                plan = score_kernel.score_plan(h, w, cluster=cluster)
                candidates[label] = lambda v=variant, p=plan: v(maps, p)
            if first_score is not None:
                candidates["earlier"] = lambda: first_score(maps)
            ref_scored, ref_count = score_kernel.score_maps_plain(maps)
            for label, fn in candidates.items():
                if label.startswith("x-"):
                    continue
                scored, count = fn()
                if not (torch.equal(count, ref_count) and torch.equal(scored, ref_scored)):
                    raise AssertionError(f"score {label} differs from plain at {(n, h, w)}")
            bound, bound_by = kernel_bound_ms(n, h, w)
            times = time_in_turns(candidates, 50)
            print(json.dumps({"kernel": "score", "shape": [n, h, w], "bound_ms": bound,
                              "bound_by": bound_by,
                              "plans": {k: p.__dict__ for k, p in plans.items()},
                              "times": times,
                              "share_of_bound": {k: bound / t["device_ms"] for k, t in times.items()},
                              "peaks": int(ref_count.sum()), "card": smi}), flush=True)

        for kind in ("random", "multifold"):
            images, affines = warp_inputs(32, 400, 400, kind, seed=args.seed)
            inverse = warp.inverse_affines(affines)
            candidates = {"current": lambda: warp.warp_batch_kernel.launch(images, inverse)}
            for label, variant in warp_variants.items():
                candidates[label] = lambda v=variant: v.launch(images, inverse)
            if first_warp is not None:
                candidates["earlier"] = lambda: first_warp.launch(images, inverse)
            ref = warp.warp_batch_plain(images, affines)
            for label, fn in candidates.items():
                if not label.startswith("x-") and not torch.equal(fn(), ref):
                    raise AssertionError(f"warp {label} differs from plain ({kind})")
            bound, bound_by = warp_bound_ms(32, 400, 400, 3)
            times = time_in_turns(candidates, 20)
            print(json.dumps({"kernel": "warp", "shape": [32, 400, 400, 3], "affines": kind,
                              "bound_ms": bound, "bound_by": bound_by, "times": times,
                              "share_of_bound": {k: bound / t["device_ms"] for k, t in times.items()},
                              "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
