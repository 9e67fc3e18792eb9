#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each ending with one JSON progress line on stdout:

1. the card's name and power limit, as nvidia-smi reports them;
2. build the CUDA score kernel (dream_tpu_torch/csrc/score_kernel.cu) with
   nvcc for sm_90a, and time the build;
3. hold the kernel against its plain torch version on the card: f32 belief
   maps (Gaussian blobs plus noise) at 100x100 (N=448), at the vgg-Q batch
   shape (N=112), at 400x400 (N=14) and at an odd 37x53; peak counts must be
   equal, and on valid peaks coords agree to 1e-4 and scores to 1e-5;
4. the main path: load the vgg-Q r5 checkpoint and its YAML sidecar through
   the port, render the seed-99 64-frame 640x480 panda holdout in memory,
   and run evaluate_frames in float32 (TF32 off for matmuls and cuDNN); the
   kernel's launch counter must have gone up, and the metrics must meet
   bounds around trained_models/results_r5/eval_vggq_r5/analysis_results.txt
   (a bf16 TPU run, so exact equality is not expected);
5. timings with CUDA events after warm-up: the kernel and its plain version
   at the vgg-Q shape, the model forward at B=16, and frames/s of the whole
   evaluation loop.

Then a line listing the kernels with their measurements, and as the last
line {"ok": true, "device": {...}}.  Any failure raises and exits non-zero
before that line.  Without CUDA the script exits non-zero at once.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.msgpack")
CONFIG = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.yaml")
REFERENCE = os.path.join(ROOT, "trained_models/results_r5/eval_vggq_r5/analysis_results.txt")

# H100 SXM peaks (NVIDIA data sheet): HBM rate, float32 off the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def progress(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters, warmup=3):
    """Mean milliseconds of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_maps(rng, n, h, w):
    """f32 [n, h, w] maps: 1-3 Gaussian blobs of random height plus noise."""
    from dream_tpu_torch.ops.belief_maps import create_belief_maps

    maps = np.zeros((n, h, w), np.float32)
    for blob in range(3):
        kp = rng.uniform([0, 0], [w, h], size=(n, 2)).astype(np.float32)
        amp = rng.uniform(0.2, 1.0, size=(n, 1, 1)).astype(np.float32)
        amp[rng.rand(n) < 0.4 * blob] = 0.0
        maps += amp * create_belief_maps(torch.from_numpy(kp)[:, None], (w, h))[:, 0].numpy()
    maps += rng.rand(n, h, w).astype(np.float32) * 0.004
    return torch.from_numpy(maps).cuda()


def compare_kernel(maps):
    """Kernel vs plain on the card; returns the largest error it saw."""
    from dream_tpu_torch.ops.belief_maps import _subpixel_refine
    from dream_tpu_torch.ops.score_kernel import score_maps_kernel, score_maps_plain

    scored_k, count_k = score_maps_kernel(maps)
    scored_p, count_p = score_maps_plain(maps)
    torch.cuda.synchronize()
    if not torch.equal(count_k, count_p):
        bad = int((count_k != count_p).sum())
        raise AssertionError(f"peak counts differ on {bad} of {maps.shape[0]} maps")
    if not torch.equal(torch.isinf(scored_k), torch.isinf(scored_p)):
        raise AssertionError("peak masks differ")
    coords_k, scores_k = _subpixel_refine(maps, scored_k, 0.4395, 8)
    coords_p, scores_p = _subpixel_refine(maps, scored_p, 0.4395, 8)
    valid = torch.arange(8, device=maps.device)[None, :] < count_p[:, None]
    coord_err = float((coords_k - coords_p)[valid].abs().max()) if valid.any() else 0.0
    score_err = float((scores_k - scores_p)[valid].abs().max()) if valid.any() else 0.0
    if coord_err > 1e-4 or score_err > 1e-5:
        raise AssertionError(f"coords err {coord_err} (bound 1e-4), scores err {score_err} (bound 1e-5)")
    return max(coord_err, score_err), int(count_p.sum())


def reference_metrics(path):
    text = open(path).read()

    def frac(label):
        m = re.search(re.escape(label) + r"[^(]*\((\d+)/(\d+)\)", text)
        if m is None:
            raise ValueError(f"{label!r} not found in {path}")
        return int(m.group(1)), int(m.group(2))

    aucs = [float(x) for x in re.findall(r"^\s*AUC: ([0-9.]+)", text, flags=re.M)]
    return {
        "outframe_found": frac("out-of-frame gt keypoints found (incorrect)"),
        "inframe_found": frac("in-frame gt keypoints found (correct)"),
        "pnp_success": frac("PNP was successful when viable (correct)"),
        "pck_auc": aucs[0],
        "add_auc": aucs[1],
    }


def kernel_bound_ms(n, h, w):
    """Least time for the score kernel's work on an H100: read each map once,
    write the scored map and the count once; 2 flops per blur tap taken."""
    from dream_tpu_torch.ops.score_kernel import PEAK_BLUR_SIGMA, _blur_band

    taps_h = int(np.count_nonzero(_blur_band(h, float(PEAK_BLUR_SIGMA))))
    taps_w = int(np.count_nonzero(_blur_band(w, float(PEAK_BLUR_SIGMA))))
    bytes_moved = n * h * w * 4 * 2 + n * 4 + (h + w) * 25 * 4
    flops = n * 2 * (taps_h * w + taps_w * h)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from dream_tpu_torch.analysis import evaluate_frames
    from dream_tpu_torch.data.synthetic import generate_synthetic_frames
    from dream_tpu_torch.network import create_network_from_config_file
    from dream_tpu_torch.ops import score_kernel
    from dream_tpu_torch.ops.score_kernel import score_maps_kernel, score_maps_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    progress("card", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
             device=torch.cuda.get_device_name(0))

    # 2. Build.
    t0 = time.perf_counter()
    lib = score_kernel.build(verbose=True)
    build_s = time.perf_counter() - t0
    score_maps_kernel.load()
    progress("build", seconds=round(build_s, 3), library=os.path.relpath(str(lib), ROOT))

    # 3. Kernel vs plain on the card.
    rng = np.random.RandomState(0)
    errors = {}
    for n, h, w in ((448, 100, 100), (112, 100, 100), (14, 400, 400), (21, 37, 53)):
        err, peaks = compare_kernel(random_maps(rng, n, h, w))
        errors[f"{n}x{h}x{w}"] = {"max_abs_err": err, "peaks": peaks}
    max_abs_err = max(e["max_abs_err"] for e in errors.values())
    progress("kernel_vs_plain", shapes=errors)

    # 4. The main path.
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    network = create_network_from_config_file(CONFIG, CHECKPOINT, device="cuda")
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    holdout = generate_synthetic_frames(64, (640, 480), network.keypoint_names, seed=99)
    render_s = time.perf_counter() - t0
    gt = {"projections": holdout["projections"], "positions": holdout["positions"]}

    score_maps_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = evaluate_frames(network, holdout["images"], gt, holdout["camera_K"], batch_size=16)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = score_maps_kernel.launches
    if launches <= 0:
        raise AssertionError("the main path did not launch the score kernel")

    kp, pnp = result["keypoints"], result["pnp"]
    ref = reference_metrics(REFERENCE)
    measured = {
        "inframe_found": [kp["num_found_gt_inframe"], kp["num_gt_inframe"]],
        "outframe_found": [kp["num_found_gt_outframe"], kp["num_gt_outframe"]],
        "pck_auc": kp["l2_error_auc"],
        "pnp_success": [pnp["num_pnp_found"], pnp["num_pnp_possible"]],
        "add_auc": pnp["add_auc"],
        "add_auc_transposed": result["pnp_transposed"]["add_auc"],
        "l2_error_mean_px": kp["l2_error_mean_px"],
        "add_mean": pnp["add_mean"],
    }
    progress("main_path", seconds=round(eval_s, 3), load_s=round(load_s, 3),
             render_s=round(render_s, 3), launches=launches, measured=measured,
             reference={k: list(v) if isinstance(v, tuple) else v for k, v in ref.items()})
    failures = []
    if kp["num_gt_inframe"] != ref["inframe_found"][1] or kp["num_gt_outframe"] != ref["outframe_found"][1]:
        failures.append("the rendered holdout's ground truth differs from the reference run's")
    if abs(kp["num_found_gt_inframe"] - ref["inframe_found"][0]) > 6:
        failures.append(f"in-frame found {kp['num_found_gt_inframe']} not within 6 of {ref['inframe_found'][0]}")
    if kp["num_found_gt_outframe"] != ref["outframe_found"][0]:
        failures.append(f"out-of-frame found {kp['num_found_gt_outframe']} != {ref['outframe_found'][0]}")
    if kp["l2_error_auc"] is None or abs(kp["l2_error_auc"] - ref["pck_auc"]) > 0.01:
        failures.append(f"PCK AUC {kp['l2_error_auc']} not within 0.01 of {ref['pck_auc']}")
    if pnp["num_pnp_possible"] != ref["pnp_success"][1] or pnp["num_pnp_found"] < 56:
        failures.append(f"PnP {pnp['num_pnp_found']}/{pnp['num_pnp_possible']} below 56/{ref['pnp_success'][1]}")
    if not np.isfinite(pnp["add_auc"]) or abs(pnp["add_auc"] - ref["add_auc"]) > 0.03:
        failures.append(f"ADD AUC {pnp['add_auc']} not within 0.03 of {ref['add_auc']}")
    if failures:
        raise AssertionError("main path misses its bounds: " + "; ".join(failures))

    # 5. Timings at the vgg-Q main-path shapes.
    maps = random_maps(rng, 112, 100, 100)
    kernel_ms = cuda_ms(lambda: score_maps_kernel(maps), 50)
    plain_ms = cuda_ms(lambda: score_maps_plain(maps), 50)
    kernel_ms_2 = cuda_ms(lambda: score_maps_kernel(maps), 50)
    plain_ms_2 = cuda_ms(lambda: score_maps_plain(maps), 50)
    bound_ms, bound_by = kernel_bound_ms(112, 100, 100)
    x = network.preprocess(torch.from_numpy(holdout["images"][:16]))
    x = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        forward_ms = cuda_ms(lambda: network.model(x), 5, warmup=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate_frames(network, holdout["images"], gt, holdout["camera_K"], batch_size=16)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    timings = {
        "score_kernel_ms": [kernel_ms, kernel_ms_2],
        "score_plain_ms": [plain_ms, plain_ms_2],
        "score_bound_ms": bound_ms,
        "model_forward_b16_ms": forward_ms,
        "eval_loop_frames_per_s": 64 / loop_s,
        "eval_loop_s": loop_s,
    }
    progress("timings", **timings)

    kernels = [{
        "name": "score_kernel",
        "route": "cuda",
        "source": "dream_tpu_torch/csrc/score_kernel.cu",
        "replaces": "dream_tpu/ops/pallas_kernels.py:41",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": min(kernel_ms, kernel_ms_2),
        "plain_ms": min(plain_ms, plain_ms_2),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
