#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each ending with one JSON progress line on stdout:

1. the card's name and power limit, as nvidia-smi reports them;
2. build the three CUDA kernels (dream_tpu_torch/csrc/score_kernel.cu,
   warp_kernel.cu and conv_int8_kernel.cu) with nvcc for sm_90a, one nvcc
   each, started together; the build time and ptxas's registers and spills;
3. hold the score kernel against its plain torch version on the card: f32
   belief maps (Gaussian blobs plus noise) at 100x100 (N=448), at the vgg-Q
   batch shape (N=112), at 400x400 (N=14) and at an odd 37x53; peak counts
   must be equal, and on valid peaks coords agree to 1e-4 and scores to 1e-5;
4. hold the warp kernel against its plain torch version on the card: 0-255
   f32 images at the training shape [32, 400, 400, 3] under in-range random
   affines, the extreme in-range affine, an out-of-range affine that folds
   more than once and the identity, and at an odd [3, 37, 53, 3]; the max
   abs error must be <= 2e-3 and the identity exact;
5. the evaluation path: load the vgg-Q r5 checkpoint and its YAML sidecar
   through the port, render the seed-99 64-frame 640x480 panda holdout in
   memory, and run evaluate_frames in float32 (TF32 off for matmuls and
   cuDNN); the score kernel's launch counter must have gone up, and the
   metrics must meet bounds around
   trained_models/results_r5/eval_vggq_r5/analysis_results.txt (a bf16 TPU
   run, so exact equality is not expected);
6. the training path: a vgg-Q network from the r5 sidecar with the port's
   initial parameters (seed 0), 32 frames rendered at 640x480 (seed 0, not
   the holdout), train_raw steps at batch 32 with augmentation and EMA on
   (the warp kernel must launch once a step, every loss be finite); then a
   short run on one fixed batch with augmentation off must end below its
   first loss; the same augmented step from the same state and seeds through
   the kernel and through the plain warp must give losses within 1e-5
   relative (cuDNN deterministic); and a save to a temporary directory,
   reloaded through the port, must give bit-equal parameters and identical
   belief maps;
7. timings with CUDA events after warm-up: the score kernel's device time
   (a CUDA graph of 50 launches, so no host dispatch) at the vgg-Q shape
   [112, 100, 100] and at [14, 400, 400], its wrapper's time a call and its
   plain version's (back-to-back calls) at the vgg-Q shape, the model
   forward at B=16 and frames/s of the evaluation loop; the warp kernel on a
   given inverse (what F.grid_sample is given too) by device time and a
   call, the wrapper with its inverse, the plain version and F.grid_sample
   (device time and a call) at [32, 400, 400, 3]; the train step at
   B=32, split into the batch processor, forward, forward+backward and
   forward+backward+optimizer; peak device memory of training; and one
   step under torch.profiler: the device's busy share and longest kernels.

8. hold the int8 conv kernel (dream_tpu_torch/csrc/conv_int8_kernel.cu)
   against its plain torch version on the card, bit for bit: the 19 links
   of vgg-Q's int8 chain at B=2, each also without its ReLU where it has
   one, a two-link chain, and odd shapes ([1, 25, 50, 64] -> 64, H and W
   that are not multiples of the 5x25 tile, Co that ends inside a 64- or
   128-channel tile, a partial third channel tile)
   (phase 11 adds the 19 links at B=16, the main path's batch);
9. the int8 evaluation path on the phase-5 holdout, against three bf16 TPU
   reports with phase 5's bounds: the float r4 vgg-Q
   (trained_models/results_r4/eval_vggq_plain), the same checkpoint with
   int8_calibration_frames=32 (results_r5/eval_vggq_ptq), and the QAT
   checkpoint (its sidecar says quant_mode: qat) calibrated the same way
   (results_r5/eval_vggq_qat_int8); each int8 run must launch the conv
   kernel 19 times a batch of 16 and the score kernel, and the PTQ belief
   maps of one batch must correlate with the float maps at >= 0.99;
10. two augmented train_raw steps of the QAT network at batch 32 from its
   checkpoint: finite losses, one warp launch a step;
11. at each of the 19 links at B=16, the main path's shapes: the kernel
   against its plain version bit for bit, and torch._int_mm on the link's
   im2col matrix against the exact accumulator; then, with CUDA events
   after warm-up, the kernel, its plain version and torch._int_mm (the
   im2col built beforehand, outside the timing), per link and summed over
   the chain; the int8 forward against the float forward at B=16, and its
   longest kernels under torch.profiler; frames/s of the int8 evaluation
   loop; then a line with the conv kernel's limits at each link: its tile
   plan, ring stages, tiles and blocks launched, registers, spills and
   shared memory, and the share of the link's bound it reaches, and the
   chain's TOP/s per map size (25, 50, 100, 200).

Then a line listing the kernels with their measurements (each row's ms and
library_ms time the same work; the score and warp rows' ms is device time
from a CUDA graph, and the warp's library_ms too; redesigned_in names the
design the kernel now has), and as the last line
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero
before that line.  Without CUDA the script exits non-zero at once.
"""

import copy
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.msgpack")
CONFIG = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.yaml")
REFERENCE = os.path.join(ROOT, "trained_models/results_r5/eval_vggq_r5/analysis_results.txt")
R4_CHECKPOINT = os.path.join(ROOT, "trained_models/results_r4/vggq/dream_vgg_q_r4.msgpack")
R4_CONFIG = os.path.join(ROOT, "trained_models/results_r4/vggq/dream_vgg_q_r4.yaml")
QAT_CHECKPOINT = os.path.join(ROOT, "trained_models/results_r5/vggq_qat/dream_vgg_q_qat_r5.msgpack")
QAT_CONFIG = os.path.join(ROOT, "trained_models/results_r5/vggq_qat/dream_vgg_q_qat_r5.yaml")
INT8_REFERENCES = {
    "float_r4": "trained_models/results_r4/eval_vggq_plain/analysis_results.txt",
    "ptq_r4": "trained_models/results_r5/eval_vggq_ptq/analysis_results.txt",
    "ptq_qat": "trained_models/results_r5/eval_vggq_qat_int8/analysis_results.txt",
}

# H100 SXM peaks (NVIDIA data sheet): HBM rate, float32 off the tensor
# cores, dense int8 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
CALIBRATION_FRAMES = 32
QAT_STEPS = 2
TRAIN_BATCH = 32
AUGMENTED_STEPS = 3
FIXED_BATCH_STEPS = 6
WARP_ATOL = 2e-3
STEP_LOSS_RTOL = 1e-5


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


def graph_ms(fn, launches=50, reps=5):
    """Device milliseconds a call of ``fn()``, without host dispatch: CUDA
    events around the replay of a CUDA graph of ``launches`` calls,
    captured after a warm-up on a side stream; the least of ``reps``
    replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return min(times)


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


def warp_inputs(n, h, w, kind, seed):
    """0-255 f32 images and [n, 2, 3] forward affines on the card."""
    from dream_tpu_torch.data.augment import DEFAULT_AUGMENT, affine_matrices, sample_augment_params

    g = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.rand((n, h, w, 3), generator=g, device="cuda") * 255.0
    ones = torch.ones(n, device="cuda")
    apply = ones > 0
    if kind == "random":
        cfg = DEFAULT_AUGMENT._replace(p_shift_scale_rotate=1.0)
        affines = sample_augment_params(g, n, h, w, cfg).affines
    elif kind == "extreme":  # the TPU kernel's worst case: folds on every side
        affines = affine_matrices(apply, 15 * ones, 0.9 * ones, 0.0625 * w * ones,
                                  -0.0625 * h * ones, h, w)
    elif kind == "multifold":  # outside the augmentation's range, folds twice or more
        affines = affine_matrices(apply, 70 * ones, 0.3 * ones, 1.7 * w * ones,
                                  -2.3 * h * ones, h, w)
    else:
        affines = torch.tensor([[1.0, 0, 0], [0, 1.0, 0]], device="cuda").expand(n, 2, 3)
    return images, affines


def compare_warp(images, affines, identity):
    """Warp kernel vs plain on the card; returns the largest error."""
    from dream_tpu_torch.ops.warp import warp_batch_kernel, warp_batch_plain

    out = warp_batch_kernel(images, affines)
    ref = warp_batch_plain(images, affines)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if identity and not torch.equal(out, images):
        raise AssertionError("the warp kernel changed an image under the identity affine")
    if not err <= WARP_ATOL:
        raise AssertionError(f"warp kernel differs from plain by {err} (bound {WARP_ATOL})")
    return err


def warp_bound_ms(n, h, w, c):
    """Least time for the warp's work on an H100: read each image value once,
    write each output value once, read the [n, 6] inverse; ~30 flops a pixel
    for the coordinates, fold and weights, 11 a channel for the taps."""
    bytes_moved = 2 * n * h * w * c * 4 + n * 6 * 4
    flops = n * h * w * (30 + 11 * c)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def grid_sample_warp(images_nchw, inverse):
    """The yardstick: F.grid_sample with reflection padding and
    align_corners=True (reflect-101 about the border pixels' centres) on the
    inverse-affine grid."""
    import torch.nn.functional as F

    n, _, h, w = images_nchw.shape
    ys, xs = torch.meshgrid(torch.arange(h, device="cuda", dtype=torch.float32),
                            torch.arange(w, device="cuda", dtype=torch.float32), indexing="ij")
    i = inverse[:, :, None, None]
    src_x = i[:, 0] * xs + i[:, 1] * ys + i[:, 2]
    src_y = i[:, 3] * xs + i[:, 4] * ys + i[:, 5]
    grid = torch.stack([src_x / (w - 1) * 2 - 1, src_y / (h - 1) * 2 - 1], dim=-1)

    def run():
        return F.grid_sample(images_nchw, grid, mode="bilinear", padding_mode="reflection",
                             align_corners=True)

    return run


def profile_busy(fn, top=5):
    """Wall ms of ``fn()`` unprofiled and under torch.profiler, the device's
    busy ms in the profiled run (the sum of device-side events, which counts
    overlapping kernels twice), launches and the ``top`` longest kernels."""
    from torch.autograd import DeviceType

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall_ms = timed()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_ms_profiled = timed()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def device_us(e):
        return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))

    busy_ms = sum(device_us(e) for e in events) / 1e3
    longest = sorted(events, key=device_us, reverse=True)[:top]
    return {"wall_ms": wall_ms, "wall_ms_profiled": wall_ms_profiled, "device_busy_ms": busy_ms,
            "device_idle_share_profiled": 1 - busy_ms / wall_ms_profiled,
            "device_launches": sum(e.count for e in events),
            "top_kernels": [{"name": e.key[:80], "count": e.count, "ms": device_us(e) / 1e3}
                            for e in longest]}


def eval_bounds(result, ref):
    """The measured metrics of an evaluate_frames result and the bounds they
    miss around a bf16 TPU reference report (empty when they meet them)."""
    kp, pnp = result["keypoints"], result["pnp"]
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
    return measured, failures


def int8_case(gen, b, h, w, ci, co):
    """Random int8 activations and OHWI weights on the card, with k and b
    that spread the outputs over the whole int8 range."""
    x_q = torch.randint(-127, 128, (b, h, w, ci), generator=gen, device="cuda", dtype=torch.int8)
    w_q = torch.randint(-127, 128, (co, 3, 3, ci), generator=gen, device="cuda", dtype=torch.int8)
    k = (torch.rand(co, generator=gen, device="cuda") + 0.5) / (80.0 * (9 * ci) ** 0.5)
    bias = torch.rand(co, generator=gen, device="cuda") * 60.0 - 30.0
    return x_q, w_q, k, bias


def compare_conv_int8(x_q, w_q, k, bias, relu):
    """int8 conv kernel vs plain on the card; raises unless bit-equal.
    Returns the kernel's output and the largest difference (0)."""
    from dream_tpu_torch.ops.conv_int8 import conv3x3_int8_kernel, conv3x3_int8_plain

    out = conv3x3_int8_kernel(x_q, w_q, k, bias, relu)
    ref = conv3x3_int8_plain(x_q, w_q, k, bias, relu)
    torch.cuda.synchronize()
    diff = int((out.to(torch.int32) - ref.to(torch.int32)).abs().max())
    if diff != 0:
        raise AssertionError(f"int8 conv kernel differs from plain at {tuple(x_q.shape)} -> "
                             f"{w_q.shape[0]} relu={relu} on {int((out != ref).sum())} outputs")
    return out, diff


def conv_int8_bound_ms(shapes):
    """Least time for the chain's int8 convs on an H100: 2*9*Ci*Co operations
    an output pixel at the dense int8 tensor-core rate, against reading each
    input and weight once and writing each output once."""
    ops = sum(2 * 9 * b * h * w * ci * co for b, h, w, ci, co, _ in shapes)
    bytes_moved = sum(b * h * w * (ci + co) + 9 * ci * co + 8 * co for b, h, w, ci, co, _ in shapes)
    t_ops = ops / INT8_OPS_PER_S * 1e3
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), ops


def im2col_int8(x_q):
    """NHWC int8 -> [B*H*W, 9*Ci] int8, taps in the order of an OHWI
    weight's [Co, 9*Ci] rows."""
    b, h, w, ci = x_q.shape
    xp = torch.nn.functional.pad(x_q, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)]
    return torch.cat(cols, dim=-1).reshape(b * h * w, 9 * ci)


def snapshot(network):
    return {
        "model": copy.deepcopy(network.model.state_dict()),
        "optimizer": copy.deepcopy(network.optimizer.state_dict()),
        "scheduler": network.scheduler.state_dict(),
        "ema": {k: v.clone() for k, v in network.ema_params.items()},
    }


def restore(network, snap):
    """Back to ``snap``; the optimizer adopts the tensors of a state dict it
    loads, so it gets a copy and the snapshot stays as it was."""
    network.model.load_state_dict(snap["model"])
    network.optimizer.load_state_dict(copy.deepcopy(snap["optimizer"]))
    network.scheduler.load_state_dict(snap["scheduler"])
    for k, v in snap["ema"].items():
        network.ema_params[k].copy_(v)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from dream_tpu_torch.analysis import evaluate_frames
    from dream_tpu_torch.data.dataset import make_batch_processor
    from dream_tpu_torch.data.synthetic import generate_synthetic_frames
    from dream_tpu_torch.network import DreamNetwork, create_network_from_config_file
    from dream_tpu_torch.models.vgg_int8_deploy import chain_shapes, run_int8_chain
    from dream_tpu_torch.ops import cuda_build
    from dream_tpu_torch.ops.conv_int8 import conv3x3_int8_kernel, conv3x3_int8_plain, conv3x3_int32_plain
    from dream_tpu_torch.ops.score_kernel import score_maps_kernel, score_maps_plain
    from dream_tpu_torch.ops.warp import inverse_affines, warp_batch_kernel, warp_batch_plain
    from dream_tpu_torch.utils.config import load_yaml

    kernels_of_port = {"score_kernel": score_maps_kernel, "warp_kernel": warp_batch_kernel,
                       "conv_int8_kernel": conv3x3_int8_kernel}

    def reset_counts():
        for kernel in kernels_of_port.values():
            kernel.launches = 0

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

    # 2. Build the kernels, one nvcc each, in parallel.
    t0 = time.perf_counter()
    libs = cuda_build.build_all(list(kernels_of_port), verbose=True)
    build_s = time.perf_counter() - t0
    for kernel in kernels_of_port.values():
        kernel.load()
    progress("build", seconds=round(build_s, 3),
             libraries={k: os.path.relpath(str(v), ROOT) for k, v in libs.items()},
             ptxas={k: list(cuda_build.ptxas_report(k).values()) for k in libs})

    # 3. Score kernel vs plain on the card.
    rng = np.random.RandomState(0)
    errors = {}
    for n, h, w in ((448, 100, 100), (112, 100, 100), (14, 400, 400), (21, 37, 53)):
        err, peaks = compare_kernel(random_maps(rng, n, h, w))
        errors[f"{n}x{h}x{w}"] = {"max_abs_err": err, "peaks": peaks}
    score_err = max(e["max_abs_err"] for e in errors.values())
    progress("score_kernel_vs_plain", shapes=errors)

    # 4. Warp kernel vs plain on the card.
    warp_errors = {}
    for (n, h, w), kind in [((TRAIN_BATCH, 400, 400), "random"), ((TRAIN_BATCH, 400, 400), "extreme"),
                            ((TRAIN_BATCH, 400, 400), "multifold"), ((TRAIN_BATCH, 400, 400), "identity"),
                            ((3, 37, 53), "random"), ((3, 37, 53), "multifold")]:
        images, affines = warp_inputs(n, h, w, kind, seed=len(warp_errors))
        warp_errors[f"{n}x{h}x{w}x3 {kind}"] = compare_warp(images, affines, kind == "identity")
    warp_err = max(warp_errors.values())
    progress("warp_kernel_vs_plain", max_abs_err=warp_errors, bound=WARP_ATOL)

    # 5. The evaluation path.
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    network = create_network_from_config_file(CONFIG, CHECKPOINT, device="cuda")
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    holdout = generate_synthetic_frames(64, (640, 480), network.keypoint_names, seed=99)
    render_s = time.perf_counter() - t0
    gt = {"projections": holdout["projections"], "positions": holdout["positions"]}

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = evaluate_frames(network, holdout["images"], gt, holdout["camera_K"], batch_size=16)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = {k: v.launches for k, v in kernels_of_port.items()}
    if eval_launches["score_kernel"] <= 0:
        raise AssertionError("the evaluation path did not launch the score kernel")

    ref = reference_metrics(REFERENCE)
    measured, failures = eval_bounds(result, ref)
    progress("evaluation_path", seconds=round(eval_s, 3), load_s=round(load_s, 3),
             render_s=round(render_s, 3), launches=eval_launches, measured=measured,
             reference={k: list(v) if isinstance(v, tuple) else v for k, v in ref.items()})
    if failures:
        raise AssertionError("evaluation path misses its bounds: " + "; ".join(failures))

    # 6. The training path, at full width and batch 32.
    t0 = time.perf_counter()
    frames = generate_synthetic_frames(TRAIN_BATCH, (640, 480), network.keypoint_names, seed=0)
    train_render_s = time.perf_counter() - t0
    raw = torch.from_numpy(frames["images"]).cuda()
    kp_raw = torch.from_numpy(frames["projections"]).float().cuda()
    trainer = DreamNetwork(load_yaml(CONFIG), device="cuda", seed=0)
    tcfg = trainer.network_config["training"]["config"]
    processor_args = (tuple(tcfg["image_raw_resolution"]), trainer.trained_net_input_resolution(),
                      trainer.trained_net_output_resolution(), trainer.image_preprocessing(),
                      trainer.image_normalization)
    augmenting = make_batch_processor(*processor_args, augment=True)
    trainer.enable_ema(0.999)
    trainer.enable_fused_training(augmenting)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generator = torch.Generator(device="cuda").manual_seed(0)
    losses = [trainer.train_raw(generator, raw, kp_raw) for _ in range(AUGMENTED_STEPS)]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = {k: v.launches for k, v in kernels_of_port.items()}
    losses = [float(x) for x in losses]
    if train_launches["warp_kernel"] != AUGMENTED_STEPS:
        raise AssertionError(f"the warp kernel launched {train_launches['warp_kernel']} times "
                             f"in {AUGMENTED_STEPS} augmented steps")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")

    fixed = make_batch_processor(*processor_args, augment=False)
    trainer.enable_fused_training(fixed)
    fixed_losses = [float(trainer.train_raw(None, raw, kp_raw)) for _ in range(FIXED_BATCH_STEPS)]
    if not fixed_losses[-1] < fixed_losses[0]:
        raise AssertionError(f"the fixed-batch run did not lower the loss: {fixed_losses}")

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    snap = snapshot(trainer)
    step_results = {}
    for backend in ("auto", "plain"):
        restore(trainer, snap)
        trainer.enable_fused_training(make_batch_processor(*processor_args, augment=True,
                                                           warp_backend=backend))
        g = torch.Generator(device="cuda").manual_seed(7)
        step_results[backend] = (float(trainer.train_raw(g, raw, kp_raw)),
                                 copy.deepcopy(trainer.model.state_dict()))
    (loss_k, state_k), (loss_p, state_p) = step_results["auto"], step_results["plain"]
    step_param_diff = max(float((state_k[n] - state_p[n]).abs().max()) for n in state_k)
    if not abs(loss_k - loss_p) <= STEP_LOSS_RTOL * abs(loss_p):
        raise AssertionError(f"kernel step loss {loss_k} vs plain step loss {loss_p}")

    with tempfile.TemporaryDirectory() as tmp:
        trainer.save_network(tmp, "smoke")
        reloaded = create_network_from_config_file(
            os.path.join(tmp, "smoke.yaml"), os.path.join(tmp, "smoke.msgpack"), device="cuda")
    saved_state, reloaded_state = trainer.model.state_dict(), reloaded.model.state_dict()
    if set(saved_state) != set(reloaded_state) or not all(
            torch.equal(saved_state[k], reloaded_state[k]) for k in saved_state):
        raise AssertionError("the reloaded checkpoint's parameters differ from the saved ones")
    x = trainer.preprocess(raw[:4])
    if not torch.equal(trainer.inference(x)[0], reloaded.inference(x)[0]):
        raise AssertionError("the reloaded network's belief maps differ")
    torch.backends.cudnn.deterministic = False
    progress("training_path", seconds=round(train_s, 3), render_s=round(train_render_s, 3),
             launches=train_launches, augmented_losses=losses, fixed_batch_losses=fixed_losses,
             kernel_vs_plain_step={"loss_kernel": loss_k, "loss_plain": loss_p,
                                   "max_param_diff": step_param_diff},
             checkpoint_round_trip="bit-equal")

    # 7. Timings.
    maps = random_maps(rng, 112, 100, 100)
    maps_f = random_maps(rng, 14, 400, 400)
    score_ms = [cuda_ms(lambda: score_maps_kernel(maps), 50) for _ in range(2)]
    score_plain_ms = [cuda_ms(lambda: score_maps_plain(maps), 50) for _ in range(2)]
    score_device_ms = [graph_ms(lambda: score_maps_kernel(maps)) for _ in range(2)]
    score_f_device_ms = [graph_ms(lambda: score_maps_kernel(maps_f)) for _ in range(2)]
    score_bound, score_bound_by = kernel_bound_ms(112, 100, 100)
    score_f_bound, _ = kernel_bound_ms(14, 400, 400)
    x = network.preprocess(torch.from_numpy(holdout["images"][:16]))
    x = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        forward_ms = cuda_ms(lambda: network.model(x), 5, warmup=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate_frames(network, holdout["images"], gt, holdout["camera_K"], batch_size=16)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0

    images, affines = warp_inputs(TRAIN_BATCH, 400, 400, "random", seed=99)
    inverse = inverse_affines(affines)
    nchw = images.permute(0, 3, 1, 2).contiguous()
    grid_sample = grid_sample_warp(nchw, inverse)
    grid_diff = float((grid_sample().permute(0, 2, 3, 1) - warp_batch_kernel(images, affines)).abs().max())
    # The kernel on a given inverse is what F.grid_sample is timed on (and
    # what the TPU kernel is handed); the wrapper adds the batched inverse.
    warp_ms, warp_launch_ms, warp_plain_ms, grid_ms = [], [], [], []
    warp_device_ms, grid_device_ms = [], []
    for _ in range(2):  # wrapper, kernel, plain, library, in turns
        warp_ms.append(cuda_ms(lambda: warp_batch_kernel(images, affines), 20))
        warp_launch_ms.append(cuda_ms(lambda: warp_batch_kernel.launch(images, inverse), 20))
        warp_device_ms.append(graph_ms(lambda: warp_batch_kernel.launch(images, inverse), 20))
        warp_plain_ms.append(cuda_ms(lambda: warp_batch_plain(images, affines), 10))
        grid_ms.append(cuda_ms(grid_sample, 20))
        grid_device_ms.append(graph_ms(grid_sample, 20))
    warp_bound, warp_bound_by = warp_bound_ms(TRAIN_BATCH, 400, 400, 3)

    trainer.enable_fused_training(augmenting)
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: trainer.train_raw(generator, raw, kp_raw), 3, warmup=1)
    peak_bytes = torch.cuda.max_memory_allocated()
    processor_ms = cuda_ms(lambda: augmenting(generator, raw, kp_raw), 5, warmup=1)
    batch = augmenting(generator, raw, kp_raw)
    update_ms = cuda_ms(lambda: trainer.train([batch["image_rgb_input"]], batch["belief_maps"]),
                        3, warmup=1)
    x32, target = batch["image_rgb_input"].permute(0, 3, 1, 2), batch["belief_maps"]
    with torch.no_grad():
        forward_b32_ms = cuda_ms(lambda: trainer.model(x32), 3, warmup=1)

    def forward_backward():
        trainer.model.zero_grad(set_to_none=True)
        trainer.criterion(trainer.model(x32), target).backward()

    forward_backward_ms = cuda_ms(forward_backward, 3, warmup=1)
    step_profile = profile_busy(lambda: trainer.train_raw(generator, raw, kp_raw))
    timings = {
        "card": smi,
        "score_kernel_device_ms": score_device_ms,
        "score_kernel_ms": score_ms,
        "score_plain_ms": score_plain_ms,
        "score_bound_ms": score_bound,
        "score_share_of_bound": score_bound / min(score_device_ms),
        "score_kernel_14x400x400_device_ms": score_f_device_ms,
        "score_14x400x400_bound_ms": score_f_bound,
        "score_14x400x400_share_of_bound": score_f_bound / min(score_f_device_ms),
        "model_forward_b16_ms": forward_ms,
        "eval_loop_frames_per_s": 64 / loop_s,
        "eval_loop_s": loop_s,
        "warp_wrapper_with_inverse_ms": warp_ms,
        "warp_kernel_device_ms": warp_device_ms,
        "warp_kernel_launch_only_ms": warp_launch_ms,
        "warp_plain_ms": warp_plain_ms,
        "warp_grid_sample_ms": grid_ms,
        "warp_grid_sample_device_ms": grid_device_ms,
        "warp_grid_sample_max_abs_diff": grid_diff,
        "warp_bound_ms": warp_bound,
        "warp_share_of_bound": warp_bound / min(warp_device_ms),
        "train_step_ms": step_ms,
        "train_images_per_s": TRAIN_BATCH / step_ms * 1e3,
        "train_batch_processor_ms": processor_ms,
        "train_forward_backward_optimizer_ms": update_ms,
        "train_forward_b32_no_grad_ms": forward_b32_ms,
        "train_forward_backward_ms": forward_backward_ms,
        "train_peak_memory_gib": peak_bytes / 2**30,
        "train_step_profile": step_profile,
    }
    progress("timings", **timings)

    # 8. int8 conv kernel vs plain on the card, bit for bit.
    gen = torch.Generator(device="cuda").manual_seed(8)
    conv_cases = {}
    for b, h, w, ci, co, relu in chain_shapes(2):
        for r in sorted({relu, False}, reverse=True):
            conv_cases[f"{b}x{h}x{w}x{ci}->{co} relu={r}"] = compare_conv_int8(
                *int8_case(gen, b, h, w, ci, co), r)[1]
    for b, h, w, ci, co, relu in [(1, 25, 50, 64, 64, True), (3, 7, 9, 32, 8, False),
                                  (2, 33, 17, 96, 200, True), (1, 1, 1, 32, 8, False),
                                  (1, 26, 51, 64, 264, True), (4, 50, 50, 64, 200, False)]:
        conv_cases[f"{b}x{h}x{w}x{ci}->{co} relu={relu}"] = compare_conv_int8(
            *int8_case(gen, b, h, w, ci, co), relu)[1]
    x_q, w1, k1, b1 = int8_case(gen, 2, 50, 50, 256, 512)
    _, w2, k2, b2 = int8_case(gen, 2, 50, 50, 512, 256)
    mid = compare_conv_int8(x_q, w1, k1, b1, True)[0]
    out = compare_conv_int8(mid, w2, k2, b2, False)[0]
    want = conv3x3_int8_plain(conv3x3_int8_plain(x_q, w1, k1, b1), w2, k2, b2, False)
    chain_diff = int((out.to(torch.int32) - want.to(torch.int32)).abs().max())
    if chain_diff != 0:
        raise AssertionError("the two-link int8 chain differs from two plain convs")
    conv_cases["two-link chain 2x50x50x256->512->256"] = chain_diff
    progress("conv_int8_kernel_vs_plain", max_abs_err=conv_cases)

    # 9. The int8 evaluation path on the phase-5 holdout.
    def evaluate(net, name, calibration_frames):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate_frames(net, holdout["images"], gt, holdout["camera_K"], batch_size=16,
                              int8_calibration_frames=calibration_frames)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v.launches for k, v in kernels_of_port.items()}
        ref = reference_metrics(os.path.join(ROOT, INT8_REFERENCES[name]))
        measured, failures = eval_bounds(res, ref)
        progress("int8_evaluation", run=name, seconds=round(seconds, 3), launches=launches,
                 measured=measured,
                 reference={k: list(v) if isinstance(v, tuple) else v for k, v in ref.items()})
        n_batches = -(-len(holdout["images"]) // 16)
        if calibration_frames and launches["conv_int8_kernel"] != 19 * n_batches:
            failures.append(f"the conv kernel launched {launches['conv_int8_kernel']} times, "
                            f"not 19 for each of {n_batches} batches")
        if not calibration_frames and launches["conv_int8_kernel"] != 0:
            failures.append("the float evaluation launched the int8 conv kernel")
        if launches["score_kernel"] <= 0:
            failures.append("the evaluation did not launch the score kernel")
        if failures:
            raise AssertionError(f"{name} evaluation misses its bounds: " + "; ".join(failures))
        return launches

    r4 = create_network_from_config_file(R4_CONFIG, R4_CHECKPOINT, device="cuda")
    evaluate(r4, "float_r4", 0)
    int8_launches = evaluate(r4, "ptq_r4", CALIBRATION_FRAMES)
    x16 = r4.preprocess(torch.from_numpy(holdout["images"][:16]))
    with torch.no_grad():
        float_maps = r4.model(x16.permute(0, 3, 1, 2))
    int8_maps = r4.inference(x16)[0]
    corr = float(np.corrcoef(int8_maps.double().cpu().numpy().ravel(),
                             float_maps.double().cpu().numpy().ravel())[0, 1])
    if not corr >= 0.99:
        raise AssertionError(f"PTQ belief maps correlate with the float maps at {corr} (< 0.99)")
    progress("int8_fidelity", belief_map_correlation=corr)
    qat = create_network_from_config_file(QAT_CONFIG, QAT_CHECKPOINT, device="cuda")
    if qat.quant_mode != "qat":
        raise AssertionError("the QAT sidecar did not build a QAT network")
    evaluate(qat, "ptq_qat", CALIBRATION_FRAMES)

    # 10. QAT training steps from the QAT checkpoint.
    qat.enable_fused_training(augmenting)
    reset_counts()
    qat_generator = torch.Generator(device="cuda").manual_seed(10)
    qat_losses = [float(qat.train_raw(qat_generator, raw, kp_raw)) for _ in range(QAT_STEPS)]
    qat_launches = {k: v.launches for k, v in kernels_of_port.items()}
    if not all(np.isfinite(qat_losses)):
        raise AssertionError(f"non-finite QAT loss: {qat_losses}")
    if qat_launches["warp_kernel"] != QAT_STEPS:
        raise AssertionError(f"the warp kernel launched {qat_launches['warp_kernel']} times "
                             f"in {QAT_STEPS} QAT steps")
    progress("qat_training", losses=qat_losses, launches=qat_launches)

    # 11. The kernel at the main path's shapes (B=16), bit for bit, and
    # int8 timings there.
    shapes16 = chain_shapes(16)
    link_ms, link_plain_ms, link_library_ms = [], [], []
    library_note = "torch._int_mm on [B*H*W, 9*Ci] x [9*Ci, Co]; im2col built beforehand, not timed"
    for b, h, w, ci, co, relu in shapes16:
        x_q, w_q, k, bias = int8_case(gen, b, h, w, ci, co)
        conv_cases[f"{b}x{h}x{w}x{ci}->{co} relu={relu}"] = compare_conv_int8(x_q, w_q, k, bias, relu)[1]
        link_ms.append(min(cuda_ms(lambda: conv3x3_int8_kernel(x_q, w_q, k, bias, relu), 10)
                           for _ in range(2)))
        link_plain_ms.append(cuda_ms(lambda: conv3x3_int8_plain(x_q, w_q, k, bias, relu), 2, warmup=1))
        # The yardstick, which the port never calls: one int8 GEMM.
        cols = im2col_int8(x_q)
        w_kn = w_q.reshape(co, 9 * ci).t()  # column-major [9*Ci, Co]
        if not torch.equal(torch._int_mm(cols, w_kn), conv3x3_int32_plain(x_q, w_q).reshape(-1, co)):
            raise AssertionError(f"torch._int_mm differs from the exact accumulator at {b}x{h}x{w}x{ci}->{co}")
        link_library_ms.append(cuda_ms(lambda: torch._int_mm(cols, w_kn), 10))
        del cols
    progress("conv_int8_kernel_vs_plain_b16", max_abs_err={k: v for k, v in conv_cases.items()
                                                           if k.startswith("16x")})
    conv_bound, conv_bound_by, chain_ops = conv_int8_bound_ms(shapes16)
    chain_ms, chain_plain_ms, chain_library_ms = sum(link_ms), sum(link_plain_ms), sum(link_library_ms)
    with torch.no_grad():
        int8_forward_ms = [cuda_ms(lambda: run_int8_chain(r4.int8_chain, x16), 5, warmup=2)
                           for _ in range(2)]
        float_forward_ms = [cuda_ms(lambda: r4.model(x16.permute(0, 3, 1, 2)), 5, warmup=2)
                            for _ in range(2)]
        int8_forward_profile = profile_busy(lambda: run_int8_chain(r4.int8_chain, x16), top=8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate_frames(r4, holdout["images"], gt, holdout["camera_K"], batch_size=16)
    torch.cuda.synchronize()
    int8_loop_s = time.perf_counter() - t0
    progress("int8_timings", link_ms=link_ms, link_plain_ms=link_plain_ms,
             link_library_ms=link_library_ms, library=library_note,
             chain_ms=chain_ms, chain_plain_ms=chain_plain_ms, chain_library_ms=chain_library_ms,
             chain_bound_ms=conv_bound, chain_bound_by=conv_bound_by, chain_gop=chain_ops / 1e9,
             chain_tops=chain_ops / chain_ms / 1e9,
             link_shapes=[list(shape) for shape in shapes16],
             link_tops=[2 * 9 * b * h * w * ci * co / ms / 1e9
                        for (b, h, w, ci, co, _), ms in zip(shapes16, link_ms)],
             int8_forward_b16_ms=int8_forward_ms, float_forward_b16_ms=float_forward_ms,
             int8_forward_b16_profile=int8_forward_profile,
             int8_eval_loop_s=int8_loop_s, int8_eval_loop_frames_per_s=64 / int8_loop_s)

    # The conv kernel's limits at the main path's shapes.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ptxas = cuda_build.ptxas_report("conv_int8_kernel")
    link_limits, by_map = [], {}
    for (b, h, w, ci, co, relu), ms in zip(shapes16, link_ms):
        plan = conv3x3_int8_kernel.plan(b, h, w, ci, co, sms)
        built = next(v for k, v in ptxas.items() if f"wgmmaILi{plan.bn}ELi{plan.bk}EE" in k)
        link_bound = conv_int8_bound_ms([(b, h, w, ci, co, relu)])[0]
        link_limits.append({"link": [b, h, w, ci, co], "tile_th_tw_bn_bk": [plan.th, plan.tw, plan.bn, plan.bk],
                            "stages": plan.stages, "tiles": plan.tiles, "blocks": plan.blocks,
                            "dynamic_smem": plan.smem, **built, "ms": ms, "bound_ms": link_bound,
                            "share_of_bound": link_bound / ms})
        ops, t = by_map.get(h, (0, 0.0))
        by_map[h] = (ops + 2 * 9 * b * h * w * ci * co, t + ms)
    progress("conv_int8_limits", card=smi, sms=sms, links=link_limits,
             chain_share_of_bound=conv_bound / chain_ms,
             tops_by_map={f"{h}x{h}": ops / t / 1e9 for h, (ops, t) in sorted(by_map.items())},
             ms_by_map={f"{h}x{h}": t for h, (_, t) in sorted(by_map.items())})

    kernels = [{
        "name": "score_kernel",
        "route": "cuda",
        "source": "dream_tpu_torch/csrc/score_kernel.cu",
        "replaces": "dream_tpu/ops/pallas_kernels.py:40",
        "launches": eval_launches["score_kernel"],
        "max_abs_err": score_err,
        "ms": min(score_device_ms),
        "plain_ms": min(score_plain_ms),
        "bound_ms": score_bound,
        "bound_by": score_bound_by,
        "library_ms": None,
        "redesigned_in": "second design: banded blur in registers fused with the peak test",
    }, {
        "name": "warp_kernel",
        "route": "cuda",
        "source": "dream_tpu_torch/csrc/warp_kernel.cu",
        "replaces": "dream_tpu/ops/pallas_warp.py:74",
        "launches": train_launches["warp_kernel"],
        "max_abs_err": warp_err,
        "ms": min(warp_device_ms),
        "plain_ms": min(warp_plain_ms),
        "bound_ms": warp_bound,
        "bound_by": warp_bound_by,
        "library_ms": min(grid_device_ms),
        "redesigned_in": "second design: 32x32-pixel tiles, fmodf only beyond the range",
    }, {
        "name": "conv_int8_kernel",
        "route": "cuda",
        "source": "dream_tpu_torch/csrc/conv_int8_kernel.cu",
        "replaces": "dream_tpu/ops/pallas_conv.py:98",
        "launches": int8_launches["conv_int8_kernel"],
        "max_abs_err": max(conv_cases.values()),
        "ms": chain_ms,
        "plain_ms": chain_plain_ms,
        "bound_ms": conv_bound,
        "bound_by": conv_bound_by,
        "library_ms": chain_library_ms,
        "redesigned_in": "second design: wgmma on TMA-fed tiles",
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
