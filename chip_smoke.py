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
   memory, and run evaluate_frames in float32 (set in the loaded config
   dict; the sidecar says bfloat16; TF32 off for matmuls and cuDNN); the
   score kernel's launch counter must have gone up, and the
   metrics must meet bounds around
   trained_models/results_r5/eval_vggq_r5/analysis_results.txt (a bf16 TPU
   run, so exact equality is not expected);
6. the training path: a float32 vgg-Q network from the r5 sidecar with the
   port's initial parameters (seed 0), 32 frames rendered at 640x480 (seed 0, not
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
9. the int8 evaluation path on the phase-5 holdout, in the sidecars'
   bf16, against three bf16 TPU reports with phase 5's bounds: the float
   r4 vgg-Q
   (trained_models/results_r4/eval_vggq_plain), the same checkpoint with
   int8_calibration_frames=32 (results_r5/eval_vggq_ptq), and the QAT
   checkpoint (its sidecar says quant_mode: qat) calibrated the same way
   (results_r5/eval_vggq_qat_int8); each int8 run must launch the conv
   kernel 19 times a batch of 16 and the score kernel once, and the PTQ belief
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
   chain's TOP/s per map size (25, 50, 100, 200);
12. vgg-Q r5 in its sidecar's bf16 on the holdout, against the r5 report
   with phase 5's bounds;
13. vgg-F r5 (trained_models/results_r5/vggf) on the holdout in bf16 and in
   float32, each against results_r5/eval_vggf: in-frame found within 6,
   out-of-frame found within 2, PCK AUC within 0.01, PnP at least 57/60,
   ADD AUC within 0.03, the score kernel once a batch of 16 (its 400x400
   maps); frames/s of a second evaluation loop; then three augmented
   train_raw steps at batch 32 from the vgg-F sidecar in bf16 (port initial
   parameters, seed 0): finite losses, one warp launch a step;
14. ResNet-H and ResNet-F (ResNet-101, 400x400) from their committed
   sidecars in bf16 with the port's initial parameters (`.chiprunignore`
   leaves their checkpoints out of remote runs): from those, a fixed-batch run of six steps
   ending below its first loss; then three augmented train_raw steps at
   batch 32 (finite losses, one warp launch a step), every BatchNorm running
   statistic moved by them and none by loss or inference, a save and reload through a
   temporary directory giving bit-equal parameters and buffers and
   identical maps, inference at batch 16 launching the score kernel once on
   208x208 or 416x416 maps, and float32 maps of the same state correlating
   with the bf16 maps at >= 0.99;
15. the score kernel against its plain version at [112, 400, 400], [112,
   208, 208] and [112, 416, 416] (phase 3's checks), and its device time
   there (CUDA graph) against its bound;
16. with CUDA events after warm-up, for vgg-Q, vgg-F, ResNet-H and ResNet-F
   in float32 and bf16 (port initial parameters): the forward at B=16, the
   augmented train_raw step at B=32 and its peak memory, and for bf16 one
   step under torch.profiler (busy share, longest kernels).

17. datasets on disk through the dataset CLI in a temporary directory: the
   seed-99 64-frame 640x480 panda holdout, which must decode bit for bit to
   phase 5's frames with keypoints equal in float32, and a 128-frame seed-11
   training set; ms a frame to write and to decode;
18. the evaluation CLI on the holdout (batch 16, no mosaics): vgg-Q r5 in
   its sidecar's bf16 under phase 5's bounds around the r5 report, with the
   report's lines, paths and numbers masked, equal to the committed
   report's, the committed CSV headers and row names, the score kernel
   once a batch, and its keypoints against the committed keypoints.csv
   (printed, not gated); vgg-F r5 under phase 13's bounds; the r4
   checkpoint with --int8-calibration-frames 32 under results_r5/eval_vggq_ptq's
   bounds, the conv kernel 19 times a batch; vgg-Q r5 with --ransac, with
   --pnp-weight-by-score --pnp-reject-outliers-px 10 and with
   --pnp-soft-detections --pnp-reject-outliers-px 5, each keeping PnP
   successes at or above the plain run's and ADD AUC in [0, 1];
19. the training CLI on the 128 frames with the r5 recipe's flags (batch
   32, bf16, clipping, --cache-device, EMA): vgg-Q for 2 epochs, then -r to
   3 (the checkpoint layout, one warp launch a step, finite losses, the
   optimizer's count equal to the steps taken, the log's epochs and
   resume, best_network through the evaluation CLI); one epoch of vgg-F
   grafted from the r5 vgg-Q checkpoint (--init-encoder, --loss-pos-weight
   800); one QAT epoch from the r4 checkpoint;
20. timings: the evaluation CLI's frames/s against evaluate_frames in
   memory in the same dtype, the CLI's stages (decode, preprocess, model,
   peak decode, PnP), each PnP mode over the 64 frames, the training
   CLI's epochs in images/s against train_raw (phases 7 and 16), and an
   epoch checkpoint's host snapshot and file writes.

Then a line listing the kernels with their measurements (each row's ms and
library_ms time the same work; the score and warp rows' ms is device time
from a CUDA graph, and the warp's library_ms too; the score row adds its
device time at phase 15's shapes; redesigned_in names the design the kernel
now has; launches are counted on the CLI runs of phases 18-19), and as the
last line
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero
before that line.  Without CUDA the script exits non-zero at once.
"""

import contextlib
import copy
import csv
import io
import json
import os
import pickle
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
VGGF_CHECKPOINT = os.path.join(ROOT, "trained_models/results_r5/vggf/dream_vgg_f_r5.msgpack")
VGGF_CONFIG = os.path.join(ROOT, "trained_models/results_r5/vggf/dream_vgg_f_r5.yaml")
VGGF_REFERENCE = "trained_models/results_r5/eval_vggf/analysis_results.txt"
# The ResNets' sidecars and map sizes; `.chiprunignore` leaves their
# checkpoints out of remote runs, so they start from initial parameters.
RESNETS = {
    "resnet-H": (os.path.join(ROOT, "trained_models/results_r4/resnet_h/dream_resnet_h_r4.yaml"), 208),
    "resnet-F": (os.path.join(ROOT, "trained_models/results_r5/resnetf/dream_resnet_f_r5.yaml"), 416),
}
PANDA = os.path.join(ROOT, "manip_configs/panda.yaml")
VGGQ_ARCH = os.path.join(ROOT, "arch_configs/dream_vgg_q.yaml")
VGGF_ARCH = os.path.join(ROOT, "arch_configs/dream_vgg_f.yaml")
REFERENCE_DIR = os.path.join(ROOT, "trained_models/results_r5/eval_vggq_r5")
# The r5 training recipe's flags (scripts/r5_artifact_queue.sh:52-54), and
# the sizes of the sets the workflow phases write.
R5_TRAIN_FLAGS = ["-b", "32", "-lr", "2e-4", "--grad-clip-norm", "1.0", "--cache-device",
                  "--compute-dtype", "bfloat16", "-s", "42", "-w", "8"]
HOLDOUT_FRAMES = 64
TRAIN_SET_FRAMES = 128
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


def eval_bounds(result, ref, outframe_tol=0, min_pnp=56):
    """The measured metrics of an evaluate_frames result and the bounds they
    miss around a bf16 TPU reference report (empty when they meet them):
    in-frame found within 6, out-of-frame found within ``outframe_tol``,
    PCK AUC within 0.01, at least ``min_pnp`` PnP successes, ADD AUC within
    0.03."""
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
    if abs(kp["num_found_gt_outframe"] - ref["outframe_found"][0]) > outframe_tol:
        failures.append(f"out-of-frame found {kp['num_found_gt_outframe']} not within "
                        f"{outframe_tol} of {ref['outframe_found'][0]}")
    if kp["l2_error_auc"] is None or abs(kp["l2_error_auc"] - ref["pck_auc"]) > 0.01:
        failures.append(f"PCK AUC {kp['l2_error_auc']} not within 0.01 of {ref['pck_auc']}")
    if pnp["num_pnp_possible"] != ref["pnp_success"][1] or pnp["num_pnp_found"] < min_pnp:
        failures.append(f"PnP {pnp['num_pnp_found']}/{pnp['num_pnp_possible']} below "
                        f"{min_pnp}/{ref['pnp_success'][1]}")
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


def config_in(config_path, compute_dtype=None):
    """A sidecar's config, with ``compute_dtype`` set in the loaded dict
    when given (the file's otherwise)."""
    from dream_tpu_torch.utils.config import load_yaml

    cfg = load_yaml(config_path)
    if compute_dtype is not None:
        cfg["architecture"]["compute_dtype"] = compute_dtype
    return cfg


def load_network(config_path, params_path=None, compute_dtype=None, seed=0):
    """A network on the card from a sidecar (``compute_dtype`` as in
    :func:`config_in`), with the committed weights when ``params_path`` is
    given and the port's initial parameters from ``seed`` otherwise."""
    from dream_tpu_torch.network import DreamNetwork

    network = DreamNetwork(config_in(config_path, compute_dtype), device="cuda", seed=seed)
    if params_path is not None:
        network.load_network_params(params_path)
    return network


def processor_for(network, augment):
    """The batch processor of ``network``'s sidecar (640x480 raw frames)."""
    from dream_tpu_torch.data.dataset import make_batch_processor

    tcfg = network.network_config["training"]["config"]
    return make_batch_processor(
        tuple(tcfg["image_raw_resolution"]), network.trained_net_input_resolution(),
        network.trained_net_output_resolution(), network.image_preprocessing(),
        network.image_normalization, augment=augment)


def map_correlation(a, b):
    return float(np.corrcoef(a.double().cpu().numpy().ravel(), b.double().cpu().numpy().ravel())[0, 1])


def quiet(fn, *args):
    """``fn(*args)`` with its standard output kept in memory (the CLIs print
    whole configs); returns ``(result, text)``.  On an error the text's
    tail is printed before the error propagates."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args), buf.getvalue()
    except BaseException:
        sys.stdout.write(buf.getvalue()[-4000:])
        raise


NUMBER = re.compile(r"-?\d+(?:\.\d+)?")


def masked_report(path):
    """A report's lines with paths and numbers masked: its layout."""
    with open(path) as f:
        lines = f.read().splitlines()
    return [NUMBER.sub("#", " ".join("<path>" if "/" in w else w for w in line.split(" ")))
            for line in lines]


def csv_layout(path):
    """A CSV's header and its row names."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]]


def keypoint_agreement(ours_csv, ref_csv):
    """How two keypoints.csv files agree: the share of keypoints with the
    same found state, and the median and largest px distance where both
    found it."""
    def detections(path):
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        n_kp = (len(rows[0]) - 1) // 4
        return np.array([r[1:1 + 2 * n_kp] for r in rows[1:]], float).reshape(len(rows) - 1, n_kp, 2)

    a, b = detections(ours_csv), detections(ref_csv)
    found_a, found_b = a[..., 0] > -999.0, b[..., 0] > -999.0
    both = found_a & found_b
    dist = np.linalg.norm(a - b, axis=-1)[both]
    return {"same_found_state_share": float(np.mean(found_a == found_b)),
            "both_found": int(both.sum()), "median_px": float(np.median(dist)),
            "max_px": float(dist.max())}


def alternate_add_auc(text):
    m = re.search(r"rotation convention: ([0-9.]+) / ", text)
    return float(m.group(1)) if m else float("nan")


def workflow_phases(kernels_of_port, reset_counts, smi, holdout):
    """Phases 17-20: the command-line workflow on disk at full width, in a
    temporary directory: datasets written and read through the port's CLI
    and PNG codec, the evaluation CLI on four checkpoints and in every PnP
    mode, the training CLI with resume, an encoder graft and QAT, and their
    timings.  Returns the CLI runs' kernel launches and the timings."""
    from dream_tpu_torch import analysis
    from dream_tpu_torch.checkpoint import load_flax_checkpoint, state_to_flax
    from dream_tpu_torch.cli import make_synthetic_dataset as dataset_cli
    from dream_tpu_torch.cli import network_inference_dataset as eval_cli
    from dream_tpu_torch.cli import train_network as train_cli
    from dream_tpu_torch.data.dataset import ManipulatorNDDSDataset, make_batch_processor
    from dream_tpu_torch.network import create_network_from_config_file, dtype_name
    from dream_tpu_torch.ops import coords as coord_ops
    from dream_tpu_torch.utils.config import load_yaml
    from dream_tpu_torch.utils.png import read_png

    def launches():
        return {k: v.launches for k, v in kernels_of_port.items()}

    def timed(fn, *args):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result, text = quiet(fn, *args)
        torch.cuda.synchronize()
        return result, text, time.perf_counter() - t0, launches()

    out = {"launches": {}, "timings": {"card": smi}}
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name

    # 17. Datasets on disk through the dataset CLI.
    hold = os.path.join(tmp, "hold64")
    _, _, write_s, _ = timed(dataset_cli.main, dataset_cli.make_parser().parse_args(
        ["-m", PANDA, "-o", hold, "-n", str(HOLDOUT_FRAMES), "--seed", "99", "--holdout"]))
    names = [kp["name"] for kp in load_yaml(PANDA)["manipulator"]["keypoints"]]
    disk = ManipulatorNDDSDataset(hold, "panda", names, (400, 400), (100, 100), n_decode_threads=8)
    t0 = time.perf_counter()
    images = disk.load_images(range(HOLDOUT_FRAMES))
    decode_threaded_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(8):
        read_png(disk.ndds_dataset_data[i]["image_paths"]["rgb"])
    decode_one_ms = (time.perf_counter() - t0) / 8 * 1e3
    if not np.array_equal(images, holdout["images"]):
        raise AssertionError("the holdout written to disk does not decode to the in-memory frames")
    if not (np.array_equal(disk.kp_projs_raw, holdout["projections"].astype(np.float32))
            and np.array_equal(disk.kp_positions, holdout["positions"].astype(np.float32))):
        raise AssertionError("the holdout's keypoints on disk differ from the in-memory ones")
    train_set = os.path.join(tmp, "train128")
    _, _, train_write_s, _ = timed(dataset_cli.main, dataset_cli.make_parser().parse_args(
        ["-m", PANDA, "-o", train_set, "-n", str(TRAIN_SET_FRAMES), "--seed", "11"]))
    out["timings"]["dataset"] = {
        "write_ms_per_frame": write_s / HOLDOUT_FRAMES * 1e3,
        "write_train_set_ms_per_frame": train_write_s / TRAIN_SET_FRAMES * 1e3,
        "decode_ms_per_frame_8_threads": decode_threaded_s / HOLDOUT_FRAMES * 1e3,
        "decode_ms_per_frame_one_thread": decode_one_ms}
    progress("datasets_on_disk", holdout="equal to the in-memory frames, bit for bit",
             keypoints="equal in float32", **out["timings"]["dataset"])

    # 18. The evaluation CLI on the card.
    def evaluate_cli(name, argv, reference, outframe_tol=0, min_pnp=56):
        out_dir = os.path.join(tmp, "eval_" + re.sub(r"\W+", "_", name))
        args = eval_cli.make_parser().parse_args(
            argv + ["-d", hold, "-o", out_dir, "--no-visualization", "-b", "16", "-w", "8"])
        (kp, pnp), text, seconds, counts = timed(eval_cli.network_inference_dataset, args)
        result = {"keypoints": kp, "pnp": pnp, "pnp_transposed": {"add_auc": alternate_add_auc(text)}}
        ref = reference_metrics(os.path.join(ROOT, reference))
        measured, failures = eval_bounds(result, ref, outframe_tol, min_pnp)
        if counts["score_kernel"] != HOLDOUT_FRAMES // 16:
            failures.append(f"the score kernel launched {counts['score_kernel']} times, not once a batch")
        if failures:
            raise AssertionError(f"{name}: " + "; ".join(failures))
        progress("evaluation_cli", run=name, seconds=seconds,
                 frames_per_s=HOLDOUT_FRAMES / seconds, launches=counts, measured=measured)
        return out_dir, result, seconds, counts

    vggq_dir, plain, plain_s, vggq_counts = evaluate_cli(
        "vgg-Q r5 bf16", ["-i", CHECKPOINT], REFERENCE)
    out["launches"]["score_kernel"] = vggq_counts["score_kernel"]
    if masked_report(os.path.join(vggq_dir, "analysis_results.txt")) != masked_report(REFERENCE):
        raise AssertionError("the report's lines differ from the committed report's")
    for f in ("keypoints.csv", "pnp_results.csv"):
        if csv_layout(os.path.join(vggq_dir, f)) != csv_layout(os.path.join(REFERENCE_DIR, f)):
            raise AssertionError(f"{f}: header or row names differ from the committed file's")
    agreement = keypoint_agreement(os.path.join(vggq_dir, "keypoints.csv"),
                                   os.path.join(REFERENCE_DIR, "keypoints.csv"))
    progress("evaluation_cli_layout", report="the committed report's lines, paths and numbers masked",
             csv="the committed headers and row names", keypoints_vs_committed=agreement)
    evaluate_cli("vgg-F r5 bf16", ["-i", VGGF_CHECKPOINT], VGGF_REFERENCE, outframe_tol=2, min_pnp=57)
    _, _, _, ptq_counts = evaluate_cli(
        "vgg-Q r4 PTQ", ["-i", R4_CHECKPOINT, "--int8-calibration-frames", str(CALIBRATION_FRAMES)],
        INT8_REFERENCES["ptq_r4"])
    if ptq_counts["conv_int8_kernel"] != 19 * (HOLDOUT_FRAMES // 16):
        raise AssertionError(f"the PTQ run launched the conv kernel {ptq_counts['conv_int8_kernel']} "
                             "times, not 19 a batch")
    out["launches"]["conv_int8_kernel"] = ptq_counts["conv_int8_kernel"]
    modes = {"ransac": ["--ransac"],
             "weighted+reject10": ["--pnp-weight-by-score", "--pnp-reject-outliers-px", "10"],
             "soft+reject5": ["--pnp-soft-detections", "--pnp-reject-outliers-px", "5"]}
    robust = {}
    for mode, flags in modes.items():
        out_dir = os.path.join(tmp, "eval_" + mode.replace("+", "_"))
        args = eval_cli.make_parser().parse_args(
            ["-i", CHECKPOINT, "-d", hold, "-o", out_dir, "--no-visualization", "-b", "16"] + flags)
        (kp, pnp), _, seconds, _ = timed(eval_cli.network_inference_dataset, args)
        robust[mode] = {"pnp_success": [pnp["num_pnp_found"], pnp["num_pnp_possible"]],
                        "add_auc": pnp["add_auc"], "add_mean": pnp["add_mean"],
                        "pck_auc": kp["l2_error_auc"], "seconds": seconds}
        if pnp["num_pnp_found"] < plain["pnp"]["num_pnp_found"] or not 0.0 <= pnp["add_auc"] <= 1.0:
            raise AssertionError(f"{mode}: PnP {pnp['num_pnp_found']} (plain "
                                 f"{plain['pnp']['num_pnp_found']}), ADD AUC {pnp['add_auc']}")
    progress("evaluation_cli_pnp_modes", plain={"pnp_success": [plain["pnp"]["num_pnp_found"],
                                                              plain["pnp"]["num_pnp_possible"]],
                                                "add_auc": plain["pnp"]["add_auc"], "seconds": plain_s},
             modes=robust)

    # 19. The training CLI on the card: vgg-Q with the r5 recipe, then a
    # resume; vgg-F from the r5 vgg-Q encoder; a QAT epoch.
    def train(argv):
        return timed(train_cli.train_network, train_cli.make_parser().parse_args(argv))

    vggq_out = os.path.join(tmp, "train_vggq")
    argv = (["-i", train_set, "-m", PANDA, "-ar", VGGQ_ARCH, "-o", vggq_out, "--loss-pos-weight", "50",
             "--ema-decay", "0.999"] + R5_TRAIN_FLAGS)
    steps_per_epoch = int(round(TRAIN_SET_FRAMES * 0.8)) // TRAIN_BATCH
    _, _, first_s, first_counts = train(argv + ["-e", "2"])
    files = set(os.listdir(vggq_out))
    layout = {"epoch_2.yaml", "epoch_2.msgpack", "epoch_2.opt.msgpack", "epoch_2.ema.msgpack",
              "best_network.yaml", "best_network.msgpack", "best_network_ema.yaml",
              "best_network_ema.msgpack", "training_log.pkl"}
    if not layout <= files or "epoch_1.msgpack" in files:
        raise AssertionError(f"checkpoint layout after two epochs: {sorted(files)}")
    trainer, _, resume_s, resume_counts = train(argv + ["-e", "3", "-r"])
    out["launches"]["warp_kernel"] = first_counts["warp_kernel"]
    if (first_counts["warp_kernel"] != 2 * steps_per_epoch
            or resume_counts["warp_kernel"] != steps_per_epoch):
        raise AssertionError(f"warp launches {first_counts['warp_kernel']} and "
                             f"{resume_counts['warp_kernel']}, not one a step ({steps_per_epoch} an epoch)")
    with open(os.path.join(vggq_out, "training_log.pkl"), "rb") as f:
        log = pickle.load(f)
    losses = [x for epoch in log["batch_training_losses"] for x in epoch]
    if log["epochs"] != [1, 2, 3] or log["epochs_resumed"] != [3] or not np.all(np.isfinite(losses)):
        raise AssertionError(f"training log: epochs {log['epochs']}, resumed "
                             f"{log.get('epochs_resumed')}, losses {losses}")
    opt = load_flax_checkpoint(os.path.join(vggq_out, "epoch_3.opt.msgpack"))
    count = int(opt["1"]["0"]["count"])
    if count != 3 * steps_per_epoch or trainer.steps != count:
        raise AssertionError(f"optimizer count {count}, steps {trainer.steps}, expected {3 * steps_per_epoch}")
    (kp, _), _, _, _ = timed(eval_cli.network_inference_dataset, eval_cli.make_parser().parse_args(
        ["-i", os.path.join(vggq_out, "best_network.msgpack"), "-d", hold, "-o",
         os.path.join(tmp, "eval_trained"), "--no-visualization", "-b", "16"]))
    # Epoch seconds from the log (timestamps count from each run's start,
    # so the first and the resumed epoch include the run's set-up).
    ts = log["timestamps"]
    epoch_s = [ts[0], ts[1] - ts[0], ts[2]]
    # The epoch checkpoint's two halves: the host snapshot, then the files.
    t0 = time.perf_counter()
    snapshot = (copy.deepcopy(trainer.network_config), state_to_flax(trainer.model.state_dict()),
                trainer.optimizer_state(), None, state_to_flax(trainer.ema_variables()))
    snapshot_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_cli._write_checkpoint(tmp, "timed", *snapshot)
    write_files_s = time.perf_counter() - t0
    progress("training_cli", arch="vgg-Q", flags=R5_TRAIN_FLAGS, seconds=[first_s, resume_s],
             launches=[first_counts, resume_counts], epochs=log["epochs"],
             epochs_resumed=log["epochs_resumed"], optimizer_count=count, losses=log["losses"],
             validation_losses=log["validation_losses"], layout=sorted(files),
             best_network_evaluated={"inframe_found": kp["num_found_gt_inframe"]})
    del trainer

    vggf_out = os.path.join(tmp, "train_vggf")
    _, text, vggf_s, vggf_counts = train(
        ["-i", train_set, "-m", PANDA, "-ar", VGGF_ARCH, "-o", vggf_out, "-e", "1",
         "--loss-pos-weight", "800", "--init-encoder", CHECKPOINT] + R5_TRAIN_FLAGS)
    grafted = re.search(r"\((\d+) leaves grafted, (\d+) shape-skipped\)", text)
    if grafted is None or int(grafted.group(1)) == 0 or vggf_counts["warp_kernel"] != steps_per_epoch:
        raise AssertionError(f"vgg-F: graft {grafted and grafted.group(0)}, launches {vggf_counts}")
    qat_out = os.path.join(tmp, "train_qat")
    qat, _, qat_s, qat_counts = train(
        ["-i", train_set, "-m", PANDA, "-ar", VGGQ_ARCH, "-o", qat_out, "-e", "1", "--quant-mode", "qat",
         "--init-params", R4_CHECKPOINT, "--loss-pos-weight", "50"] + R5_TRAIN_FLAGS + ["-lr", "5e-5"])
    with open(os.path.join(qat_out, "training_log.pkl"), "rb") as f:
        qat_losses = pickle.load(f)["batch_training_losses"][0]
    if qat.quant_mode != "qat" or qat_counts["warp_kernel"] != steps_per_epoch or not np.all(
            np.isfinite(qat_losses)):
        raise AssertionError(f"QAT: mode {qat.quant_mode}, launches {qat_counts}, losses {qat_losses}")
    progress("training_cli_graft_qat", vggf={"n_grafted": int(grafted.group(1)),
                                              "n_skipped": int(grafted.group(2)), "seconds": vggf_s,
                                              "launches": vggf_counts},
             qat={"seconds": qat_s, "launches": qat_counts, "losses": qat_losses})
    del qat

    # 20. Timings: the evaluation CLI's stages, each PnP mode over the 64
    # frames, the training CLI's epochs and its checkpoint writes.
    network = create_network_from_config_file(CONFIG, CHECKPOINT, device="cuda")
    raw_res = (640, 480)
    netin, netout = network.net_resolutions_from_image_raw_resolution(raw_res)
    process = make_batch_processor(raw_res, netin, netout, network.image_preprocessing(),
                                   network.image_normalization, include_belief_maps=False)
    kp_to_raw = coord_ops.affine_raw_from_netin(netin, raw_res, network.image_preprocessing()).compose(
        coord_ops.affine_netin_from_netout(netout, netin))
    stages = dict.fromkeys(("decode", "preprocess", "model", "peak_decode"), 0.0)
    detected, scores, best = [], [], []

    def clock(stage, t0):
        torch.cuda.synchronize()
        stages[stage] += time.perf_counter() - t0
        return time.perf_counter()

    for start in range(0, HOLDOUT_FRAMES, 16):
        t0 = time.perf_counter()
        batch = disk.host_batch(list(range(start, start + 16)))
        t0 = clock("decode", t0)
        x = process(None, torch.from_numpy(batch["image_rgb_raw"]).cuda(),
                    torch.from_numpy(batch["keypoint_projections_raw"]).cuda())["image_rgb_input"]
        t0 = clock("preprocess", t0)
        with torch.no_grad():
            belief = network._belief_maps(x)
        t0 = clock("model", t0)
        kp_netout, peaks = network._keypoints(belief)
        detected.append(kp_to_raw(kp_netout))
        scores.append(peaks["scores"][..., 0])
        best.append(kp_to_raw(peaks["coords"][..., 0, :]))
        clock("peak_decode", t0)
    positions = torch.from_numpy(disk.kp_positions).cuda()
    K = holdout["camera_K"]
    n_inframe = analysis._inframe_counts(disk.kp_projs_raw.astype(float), raw_res)
    detected, soft = torch.cat(detected), torch.cat(best)
    scores = torch.cat(scores).cpu().numpy()
    weighted = torch.from_numpy(analysis._pnp_weights(scores, True, False, 0.05)).cuda()
    soft_w = torch.from_numpy(analysis._pnp_weights(scores, False, True, 0.05)).cuda()
    pnp_cases = {
        "plain": dict(pnp_input_raw=detected),
        "ransac": dict(pnp_input_raw=detected, ransac=True),
        "weighted+reject10": dict(pnp_input_raw=detected, weights=weighted, reject_outliers_px=10.0),
        "soft+reject5": dict(pnp_input_raw=soft, weights=soft_w, reject_outliers_px=5.0,
                             detect_mask=(soft[..., 0] > -999.0) & (soft_w > 0)),
    }
    pnp_s = {}
    for mode, kwargs in pnp_cases.items():
        pnp_s[mode] = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            analysis._pnp_and_add(positions, camera_K=K, n_inframe=n_inframe, **kwargs)
            torch.cuda.synchronize()
            pnp_s[mode].append(time.perf_counter() - t0)
    gt = {"projections": holdout["projections"], "positions": holdout["positions"]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    analysis.evaluate_frames(network, holdout["images"], gt, K, batch_size=16)
    torch.cuda.synchronize()
    in_memory_s = time.perf_counter() - t0
    images_per_epoch = steps_per_epoch * TRAIN_BATCH
    out["timings"].update({
        "eval_cli_frames_per_s": HOLDOUT_FRAMES / plain_s,
        "eval_in_memory_frames_per_s": HOLDOUT_FRAMES / in_memory_s,
        "eval_stages_s": {**stages, "pnp": pnp_s["plain"][-1]},
        "pnp_modes_s_64_frames": pnp_s,
        "train_cli_epoch_s": epoch_s,
        "train_cli_images_per_s": [images_per_epoch / s for s in epoch_s],
        "train_cli_epoch_note": "epochs 1 and 3 (resumed) include set-up; each includes validation",
        "checkpoint_snapshot_s": snapshot_s,
        "checkpoint_write_files_s": write_files_s,
        "dtype": dtype_name(network.compute_dtype),
    })
    progress("workflow_timings", **out["timings"])
    tmp_dir.cleanup()
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from dream_tpu_torch.analysis import evaluate_frames
    from dream_tpu_torch.data.dataset import make_batch_processor
    from dream_tpu_torch.data.synthetic import generate_synthetic_frames
    from dream_tpu_torch.network import DreamNetwork, create_network_from_config_file, dtype_name
    from dream_tpu_torch.models.vgg_int8_deploy import chain_shapes, run_int8_chain
    from dream_tpu_torch.ops import cuda_build
    from dream_tpu_torch.ops.conv_int8 import conv3x3_int8_kernel, conv3x3_int8_plain, conv3x3_int32_plain
    from dream_tpu_torch.ops.score_kernel import score_maps_kernel, score_maps_plain
    from dream_tpu_torch.ops.warp import inverse_affines, warp_batch_kernel, warp_batch_plain

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
    network = load_network(CONFIG, CHECKPOINT, "float32")
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
    trainer = DreamNetwork(config_in(CONFIG, "float32"), device="cuda", seed=0)
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

    # 9. The int8 evaluation path on the phase-5 holdout, in the sidecars'
    # bf16 (the int8 chain's head and down1 prologue).
    def evaluate(net, name, calibration_frames, reference=None, phase="int8_evaluation",
                 outframe_tol=0, min_pnp=56):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate_frames(net, holdout["images"], gt, holdout["camera_K"], batch_size=16,
                              int8_calibration_frames=calibration_frames)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v.launches for k, v in kernels_of_port.items()}
        ref = reference_metrics(os.path.join(ROOT, reference or INT8_REFERENCES[name]))
        measured, failures = eval_bounds(res, ref, outframe_tol, min_pnp)
        progress(phase, run=name, compute_dtype=dtype_name(net.compute_dtype),
                 seconds=round(seconds, 3), launches=launches, measured=measured,
                 reference={k: list(v) if isinstance(v, tuple) else v for k, v in ref.items()})
        n_batches = -(-len(holdout["images"]) // 16)
        if calibration_frames and launches["conv_int8_kernel"] != 19 * n_batches:
            failures.append(f"the conv kernel launched {launches['conv_int8_kernel']} times, "
                            f"not 19 for each of {n_batches} batches")
        if not calibration_frames and launches["conv_int8_kernel"] != 0:
            failures.append("the float evaluation launched the int8 conv kernel")
        if launches["score_kernel"] != n_batches:
            failures.append(f"the score kernel launched {launches['score_kernel']} times, "
                            f"not once for each of {n_batches} batches")
        if failures:
            raise AssertionError(f"{name} evaluation misses its bounds: " + "; ".join(failures))
        return launches

    r4 = create_network_from_config_file(R4_CONFIG, R4_CHECKPOINT, device="cuda")
    if r4.compute_dtype != torch.bfloat16:
        raise AssertionError("the r4 sidecar's bfloat16 did not reach the network")
    evaluate(r4, "float_r4", 0)
    evaluate(r4, "ptq_r4", CALIBRATION_FRAMES)
    x16 = r4.preprocess(torch.from_numpy(holdout["images"][:16]))
    with torch.no_grad():
        float_maps = r4.model(x16.permute(0, 3, 1, 2))
    int8_maps = r4.inference(x16)[0]
    corr = map_correlation(int8_maps, float_maps)
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
    link_ms, link_plain_ms, link_library_ms, link_library_im2col_ms = [], [], [], []
    library_note = ("torch._int_mm on [B*H*W, 9*Ci] x [9*Ci, Co]; link_library_ms: im2col built "
                    "beforehand, not timed; link_library_im2col_ms: im2col built in the timing")
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
        link_library_im2col_ms.append(cuda_ms(lambda: torch._int_mm(im2col_int8(x_q), w_kn), 10))
    progress("conv_int8_kernel_vs_plain_b16", max_abs_err={k: v for k, v in conv_cases.items()
                                                           if k.startswith("16x")})
    conv_bound, conv_bound_by, chain_ops = conv_int8_bound_ms(shapes16)
    chain_ms, chain_plain_ms, chain_library_ms = sum(link_ms), sum(link_plain_ms), sum(link_library_ms)
    chain_library_im2col_ms = sum(link_library_im2col_ms)
    with torch.no_grad():
        int8_forward_ms = [cuda_ms(lambda: run_int8_chain(r4.int8_chain, x16), 5, warmup=2)
                           for _ in range(2)]
        # The float model, in the sidecar's compute dtype.
        float_forward_ms = [cuda_ms(lambda: r4.model(x16.permute(0, 3, 1, 2)), 5, warmup=2)
                            for _ in range(2)]
        int8_forward_profile = profile_busy(lambda: run_int8_chain(r4.int8_chain, x16), top=8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate_frames(r4, holdout["images"], gt, holdout["camera_K"], batch_size=16)
    torch.cuda.synchronize()
    int8_loop_s = time.perf_counter() - t0
    progress("int8_timings", link_ms=link_ms, link_plain_ms=link_plain_ms,
             link_library_ms=link_library_ms, link_library_im2col_ms=link_library_im2col_ms,
             library=library_note, chain_ms=chain_ms, chain_plain_ms=chain_plain_ms,
             chain_library_ms=chain_library_ms, chain_library_im2col_ms=chain_library_im2col_ms,
             chain_bound_ms=conv_bound, chain_bound_by=conv_bound_by, chain_gop=chain_ops / 1e9,
             chain_tops=chain_ops / chain_ms / 1e9,
             link_shapes=[list(shape) for shape in shapes16],
             link_tops=[2 * 9 * b * h * w * ci * co / ms / 1e9
                        for (b, h, w, ci, co, _), ms in zip(shapes16, link_ms)],
             int8_forward_b16_ms=int8_forward_ms, float_forward_b16_ms=float_forward_ms,
             float_forward_dtype=dtype_name(r4.compute_dtype),
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

    # 12. vgg-Q r5 in its sidecar's bf16 on the phase-5 holdout.
    vggq16 = create_network_from_config_file(CONFIG, CHECKPOINT, device="cuda")
    if vggq16.compute_dtype != torch.bfloat16:
        raise AssertionError("the r5 sidecar's bfloat16 did not reach the network")
    evaluate(vggq16, "vgg-Q r5", 0, REFERENCE, phase="bf16_evaluation")
    del vggq16

    # 13. vgg-F r5 in bf16 and float32 against its report, then augmented
    # train steps from its sidecar with the port's initial parameters.
    vggf_loop_s = {}
    for dtype in ("bfloat16", "float32"):
        vggf = load_network(VGGF_CONFIG, VGGF_CHECKPOINT, dtype)
        evaluate(vggf, f"vgg-F r5 {dtype}", 0, VGGF_REFERENCE, phase="vggf_evaluation",
                 outframe_tol=2, min_pnp=57)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate_frames(vggf, holdout["images"], gt, holdout["camera_K"], batch_size=16)
        torch.cuda.synchronize()
        vggf_loop_s[dtype] = time.perf_counter() - t0
        del vggf
    vggf_trainer = load_network(VGGF_CONFIG, seed=0)
    vggf_trainer.enable_fused_training(processor_for(vggf_trainer, augment=True))
    reset_counts()
    g = torch.Generator(device="cuda").manual_seed(13)
    vggf_losses = [float(vggf_trainer.train_raw(g, raw, kp_raw)) for _ in range(AUGMENTED_STEPS)]
    vggf_launches = {k: v.launches for k, v in kernels_of_port.items()}
    if not all(np.isfinite(vggf_losses)):
        raise AssertionError(f"non-finite vgg-F training loss: {vggf_losses}")
    if vggf_launches["warp_kernel"] != AUGMENTED_STEPS:
        raise AssertionError(f"the warp kernel launched {vggf_launches['warp_kernel']} times in "
                             f"{AUGMENTED_STEPS} vgg-F steps")
    progress("vggf_training", compute_dtype=dtype_name(vggf_trainer.compute_dtype),
             losses=vggf_losses, launches=vggf_launches,
             eval_loop_frames_per_s={k: 64 / v for k, v in vggf_loop_s.items()})
    del vggf_trainer

    # 14. ResNet-H and ResNet-F at full width from their sidecars (bf16),
    # with the port's initial parameters.
    x16_raw = torch.from_numpy(holdout["images"][:16])
    for arch, (config, side) in RESNETS.items():
        net = load_network(config, seed=0)
        if net.compute_dtype != torch.bfloat16 or net.trained_net_output_resolution() != (side, side):
            raise AssertionError(f"{arch}: {net.compute_dtype}, {net.trained_net_output_resolution()}")

        def running():
            return {k: v.clone() for k, v in net.model.state_dict().items() if "running_" in k}

        # The fixed-batch run starts from the initial parameters: after a few
        # augmented steps, the r5 recipe (Adam at 2e-4, no warmup) lifts
        # ResNet-F's loss on a fixed batch for several steps before it
        # falls, in float32 as in bf16, and in dream_tpu as in the port
        # (tests/test_torch_arch_network.py, slow).
        fixed = processor_for(net, augment=False)
        net.enable_fused_training(fixed)
        fixed_losses = [float(net.train_raw(None, raw, kp_raw)) for _ in range(FIXED_BATCH_STEPS)]
        if not fixed_losses[-1] < fixed_losses[0]:
            raise AssertionError(f"{arch}: the fixed-batch run did not lower the loss: {fixed_losses}")
        net.enable_fused_training(processor_for(net, augment=True))
        start = running()
        reset_counts()
        g = torch.Generator(device="cuda").manual_seed(14)
        losses = [float(net.train_raw(g, raw, kp_raw)) for _ in range(AUGMENTED_STEPS)]
        launches = {k: v.launches for k, v in kernels_of_port.items()}
        if not all(np.isfinite(losses)) or launches["warp_kernel"] != AUGMENTED_STEPS:
            raise AssertionError(f"{arch}: losses {losses}, launches {launches}")
        trained = running()
        unmoved = [k for k in start if torch.equal(start[k], trained[k])]
        if unmoved:
            raise AssertionError(f"{arch}: train steps left {len(unmoved)} running statistics as they were")
        batch = fixed(None, raw[:16], kp_raw[:16])
        eval_loss = float(net.loss([batch["image_rgb_input"]], batch["belief_maps"]))
        x16 = net.preprocess(x16_raw)
        net.inference(x16)
        if any(not torch.equal(v, trained[k]) for k, v in running().items()):
            raise AssertionError(f"{arch}: loss or inference moved the running statistics")

        torch.backends.cudnn.deterministic = True
        with tempfile.TemporaryDirectory() as tmp:
            net.save_network(tmp, "smoke")
            reloaded = create_network_from_config_file(
                os.path.join(tmp, "smoke.yaml"), os.path.join(tmp, "smoke.msgpack"), device="cuda")
        saved, back = net.model.state_dict(), reloaded.model.state_dict()
        if set(saved) != set(back) or not all(torch.equal(saved[k], back[k]) for k in saved):
            raise AssertionError(f"{arch}: the reloaded parameters or buffers differ")
        if reloaded.compute_dtype != torch.bfloat16:
            raise AssertionError(f"{arch}: the saved sidecar lost the compute dtype")
        reset_counts()
        belief, keypoints = net.inference(x16)
        infer_launches = {k: v.launches for k, v in kernels_of_port.items()}
        if not torch.equal(belief, reloaded.inference(x16)[0]):
            raise AssertionError(f"{arch}: the reloaded network's belief maps differ")
        torch.backends.cudnn.deterministic = False
        del reloaded
        if tuple(belief.shape) != (16, 7, side, side) or infer_launches["score_kernel"] != 1:
            raise AssertionError(f"{arch}: maps {tuple(belief.shape)}, launches {infer_launches}")
        net32 = DreamNetwork(config_in(config, "float32"), device="cuda")
        net32.model.load_state_dict(saved, strict=True)
        belief32, _ = net32.inference(x16)
        corr = map_correlation(belief32, belief)
        if not corr >= 0.99:
            raise AssertionError(f"{arch}: float32 and bf16 maps correlate at {corr} (< 0.99)")
        progress("resnet", arch=arch, compute_dtype=dtype_name(net.compute_dtype),
                 augmented_losses=losses, launches=launches, eval_loss=eval_loss,
                 running_statistics=len(start), fixed_batch_losses=fixed_losses,
                 checkpoint_round_trip="bit-equal, parameters and buffers",
                 inference_maps=list(belief.shape), inference_launches=infer_launches,
                 keypoints_found=int((keypoints[..., 0] > -999).sum()),
                 float32_vs_bf16_map_correlation=corr)
        del net, net32, belief, belief32
        torch.cuda.empty_cache()

    # 15. The score kernel at this slice's map sizes: held against its plain
    # version, and its device time against its bound.
    score_shapes = {}
    for n, h, w in ((112, 400, 400), (112, 208, 208), (112, 416, 416)):
        shape_maps = random_maps(rng, n, h, w)
        err, peaks = compare_kernel(shape_maps)
        device_ms = [graph_ms(lambda: score_maps_kernel(shape_maps), 20) for _ in range(2)]
        bound, bound_by = kernel_bound_ms(n, h, w)
        score_shapes[f"{n}x{h}x{w}"] = {"max_abs_err": err, "peaks": peaks, "device_ms": device_ms,
                                        "bound_ms": bound, "bound_by": bound_by,
                                        "share_of_bound": bound / min(device_ms)}
        score_err = max(score_err, err)
        del shape_maps
    progress("score_kernel_new_shapes", card=smi, shapes=score_shapes)

    # 16. Forward and train-step times of the four networks in float32 and
    # bf16 (port initial parameters), peak memory, and one bf16 step under
    # torch.profiler.
    arch_timings = {}
    for arch, config in (("vgg-Q", CONFIG), ("vgg-F", VGGF_CONFIG), ("resnet-H", RESNETS["resnet-H"][0]),
                         ("resnet-F", RESNETS["resnet-F"][0])):
        for dtype in ("float32", "bfloat16"):
            net = load_network(config, compute_dtype=dtype, seed=0)
            x = net.preprocess(x16_raw).permute(0, 3, 1, 2)
            with torch.no_grad():
                forward_ms = cuda_ms(lambda: net.model(x), 3, warmup=2)
            net.enable_fused_training(processor_for(net, augment=True))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step_ms = cuda_ms(lambda: net.train_raw(generator, raw, kp_raw), 3, warmup=1)
            row = {"forward_b16_ms": forward_ms, "train_step_b32_ms": step_ms,
                   "train_images_per_s": TRAIN_BATCH / step_ms * 1e3,
                   "train_peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
            if dtype == "bfloat16":
                row["train_step_profile"] = profile_busy(
                    lambda: net.train_raw(generator, raw, kp_raw), top=6)
            arch_timings[f"{arch} {dtype}"] = row
            del net, x
            torch.cuda.empty_cache()
    progress("architecture_timings", card=smi, batch_forward=16, batch_train=TRAIN_BATCH,
             timings=arch_timings)

    # 17-20. The command-line workflow on disk.
    workflow = workflow_phases(kernels_of_port, reset_counts, smi, holdout)
    progress("workflow_vs_in_memory", card=smi,
             train_cli_steady_images_per_s=workflow["timings"]["train_cli_images_per_s"][1],
             train_raw_bf16_images_per_s=arch_timings["vgg-Q bfloat16"]["train_images_per_s"],
             train_raw_f32_images_per_s=TRAIN_BATCH / step_ms * 1e3,
             eval_cli_frames_per_s=workflow["timings"]["eval_cli_frames_per_s"],
             eval_in_memory_frames_per_s=workflow["timings"]["eval_in_memory_frames_per_s"])

    kernels = [{
        "name": "score_kernel",
        "route": "cuda",
        "source": "dream_tpu_torch/csrc/score_kernel.cu",
        "replaces": "dream_tpu/ops/pallas_kernels.py:40",
        "launches": workflow["launches"]["score_kernel"],
        "max_abs_err": score_err,
        "ms": min(score_device_ms),
        "plain_ms": min(score_plain_ms),
        "bound_ms": score_bound,
        "bound_by": score_bound_by,
        "library_ms": None,
        "device_ms_by_shape": {k: min(v["device_ms"]) for k, v in score_shapes.items()},
        "redesigned_in": "second design: banded blur in registers fused with the peak test",
    }, {
        "name": "warp_kernel",
        "route": "cuda",
        "source": "dream_tpu_torch/csrc/warp_kernel.cu",
        "replaces": "dream_tpu/ops/pallas_warp.py:74",
        "launches": workflow["launches"]["warp_kernel"],
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
        "launches": workflow["launches"]["conv_int8_kernel"],
        "max_abs_err": max(conv_cases.values()),
        "ms": chain_ms,
        "plain_ms": chain_plain_ms,
        "bound_ms": conv_bound,
        "bound_by": conv_bound_by,
        "library_ms": chain_library_ms,
        "library_ms_with_im2col": chain_library_im2col_ms,
        "redesigned_in": "second design: wgmma on TMA-fed tiles",
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
