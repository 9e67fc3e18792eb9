#!/usr/bin/env python3
"""Profile the PyTorch port's evaluation loop and its score kernel on one GPU.

    python3 scripts/profile_torch_eval.py

Runs the main path of chip_smoke.py (vgg-Q r5, seed-99 64-frame holdout,
batch 16, float32 set in the loaded config (the sidecar says bfloat16),
TF32 off) and prints JSON lines on stdout:

- ``stages``: host-clock milliseconds (each stage ends in a synchronize) of
  preprocessing, the model forward, the peak decode and the coordinate map
  per batch, and of PnP + ADD over all frames;
- ``profile``: one ``evaluate_frames`` timed, then one under
  ``torch.profiler``: the summed device time of all device-side events,
  the device's idle share against the unprofiled wall time, the number of
  device launches, and the kernels that take the most device time;
- ``score_device_us``: device time per call at the vgg-Q shape (112 maps
  of 100x100) of the score kernel and of its plain version, three readings
  of 20 calls each, the plain version's split into kernels and copies.

Needs CUDA; exits 1 without it.
"""

import json
import os
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CHECKPOINT = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.msgpack")
CONFIG = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.yaml")
FRAMES = 64
BATCH_SIZE = 16


def self_device_us(event):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def profile(fn):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def main():
    if not torch.cuda.is_available():
        print("profile_torch_eval: CUDA is not available", file=sys.stderr)
        return 1

    from dream_tpu_torch.analysis import evaluate_frames
    from dream_tpu_torch.data.synthetic import generate_synthetic_frames
    from dream_tpu_torch.network import DreamNetwork
    from dream_tpu_torch.ops import belief_maps as bm
    from dream_tpu_torch.ops import coords
    from dream_tpu_torch.ops import geometric_vision as gv
    from dream_tpu_torch.ops import score_kernel
    from dream_tpu_torch.utils.config import load_yaml

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"device": torch.cuda.get_device_name(0), "torch": torch.__version__}), flush=True)

    cfg = load_yaml(CONFIG)
    cfg["architecture"]["compute_dtype"] = "float32"  # the sidecar says bfloat16
    net = DreamNetwork(cfg, device="cuda")
    net.load_network_params(CHECKPOINT)
    data = generate_synthetic_frames(FRAMES, (640, 480), net.keypoint_names, seed=99)
    gt = {"projections": data["projections"], "positions": data["positions"]}
    run = lambda: evaluate_frames(net, data["images"], gt, data["camera_K"], BATCH_SIZE)
    run()  # warm-up: kernel build, cuDNN plans, allocator

    # Stages, host clock around synchronized work.
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    raw_res = (640, 480)
    netin, netout = net.net_resolutions_from_image_raw_resolution(raw_res)
    to_raw = coords.affine_raw_from_netin(netin, raw_res, net.image_preprocessing()).compose(
        coords.affine_netin_from_netout(netout, netin))
    stages = {"preprocess_ms": [], "model_ms": [], "decode_ms": [], "to_raw_ms": []}
    detected = []
    with torch.no_grad():
        for start in range(0, FRAMES, BATCH_SIZE):
            batch = torch.from_numpy(data["images"][start : start + BATCH_SIZE])
            x, ms = timed(lambda: net.preprocess(batch))
            stages["preprocess_ms"].append(ms)
            belief, ms = timed(lambda: net.model(x.permute(0, 3, 1, 2)))
            stages["model_ms"].append(ms)
            (kp, _), ms = timed(lambda: bm.keypoints_from_belief_maps(belief, net.peak_offset_due_to_upsampling()))
            stages["decode_ms"].append(ms)
            kp_raw, ms = timed(lambda: to_raw(kp))
            stages["to_raw_ms"].append(ms)
            detected.append(kp_raw)
    positions = torch.as_tensor(gt["positions"], dtype=torch.float32, device="cuda")
    K = torch.as_tensor(data["camera_K"], dtype=torch.float32, device="cuda")
    det = torch.cat(detected)
    result, pnp_ms = timed(lambda: gv.solve_pnp(positions, det, K))
    _, add_ms = timed(lambda: gv.add_from_pose(result.translation, result.quaternion, positions))
    summary = {k: float(np.mean(v)) for k, v in stages.items()}
    summary.update(pnp_all_frames_ms=pnp_ms, add_all_frames_ms=add_ms, frames=FRAMES,
                   batch_size=BATCH_SIZE)
    print(json.dumps({"stages": summary}), flush=True)

    # One evaluation loop unprofiled, then one under the profiler.  Device
    # busy time sums the device-side events (kernels, copies, memsets) only:
    # an operator's self device time repeats its kernels'.
    _, wall_ms = timed(run)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof = profile(run)
    wall_ms_profiled = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        ({"name": e.key, "count": e.count, "self_device_us": self_device_us(e)}
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda r: -r["self_device_us"],
    )
    busy_ms = sum(r["self_device_us"] for r in kernels) / 1e3
    print(json.dumps({"profile": {
        "wall_ms": wall_ms, "wall_ms_profiled": wall_ms_profiled, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_launches": sum(r["count"] for r in kernels),
        "top_kernels": kernels[:8],
    }}), flush=True)

    # Score kernel and plain version, device time per call at the vgg-Q shape.
    # Copies (the plain version moves its blur operators to the card on every
    # call) are reported apart from kernels.
    rng = np.random.RandomState(0)
    maps = torch.from_numpy(rng.rand(112, 100, 100).astype(np.float32) * 0.02).cuda()

    def per_call_us(fn, calls=20):
        fn()
        prof = profile(lambda: [fn() for _ in range(calls)])
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        copies = sum(self_device_us(e) for e in events if "memcpy" in e.key.lower())
        total = sum(self_device_us(e) for e in events)
        return {"all": total / calls, "kernels": (total - copies) / calls, "copies": copies / calls}

    readings = {"kernel": [], "plain": []}
    for _ in range(3):
        readings["kernel"].append(per_call_us(lambda: score_kernel.score_maps_kernel(maps)))
        readings["plain"].append(per_call_us(lambda: score_kernel.score_maps_plain(maps)))
    print(json.dumps({"score_device_us": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
