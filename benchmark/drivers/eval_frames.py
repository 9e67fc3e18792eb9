"""Whole-test-set evaluation jobs through ``analysis.evaluate_frames``.

Set-up renders a pool of frames from the seed and builds, in host memory, an
array of ``job_frames + job_offsets`` frames: each drawn by the seed from the
pool, with seeded pixel noise of up to ``pixel_noise`` grey levels (made on
the device), so that no two frames are alike.  Job ``j`` evaluates the
``job_frames`` frames from offset ``(j * 61) % job_offsets``: a forward at
``batch_size`` and then one PnP over the whole job.  The network loads the
configuration's checkpoint.  The warm-up runs each shape of a job once, and
no job: the forward at the full and at the last, shorter batch, and a PnP
over as many frames as a job holds.  The window runs jobs back to back while
time is left; its rate counts whole jobs.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from benchmark.harness import checks, program, render
from benchmark.reference import decode, models, msgpack, pnp, train as ref_train

JOB_STRIDE = 61


def set_up(ctx) -> dict:
    cfg, mix, device = ctx.config, ctx.traffic, ctx.device
    net_config = program.network_config(cfg)
    n_kp = len(net_config["manipulator"]["keypoints"])
    raw_res = tuple(mix["image_raw_resolution"])
    pool = render.render_pool(program.derive(ctx.seed, 1), mix["pool_frames"], n_kp, raw_res,
                              mix["out_of_frame_fraction"], workers=ctx.workers)
    ctx.mark("render the pool")
    n_host = int(mix["job_frames"]) + int(mix["job_offsets"])
    which = np.random.RandomState(program.derive(ctx.seed, 2)).randint(0, len(pool["images"]), n_host)
    frames = np.empty((n_host,) + pool["images"].shape[1:], np.uint8)
    pool_dev = torch.from_numpy(pool["images"]).to(device).to(torch.int16)
    which_dev = torch.from_numpy(which).to(device)
    g = torch.Generator(device=device).manual_seed(program.derive(ctx.seed, 3))
    noise = int(mix["pixel_noise"])
    for s in range(0, n_host, 256):
        idx = which_dev[s:s + 256]
        jitter = torch.randint(-noise, noise + 1, (len(idx),) + tuple(pool_dev.shape[1:]), generator=g,
                               device=device, dtype=torch.int16)
        torch.from_numpy(frames[s:s + len(idx)]).copy_((pool_dev[idx] + jitter).clamp_(0, 255).to(torch.uint8))
    del pool_dev
    ctx.mark("the job frames in host memory")
    net = program.from_checkpoint(net_config, str(ctx.root / cfg["checkpoint"]), device)
    ctx.mark("the network from its checkpoint")
    st = {"net": net, "frames": frames, "which": which, "pool": pool, "raw_res": raw_res,
          "net_config": net_config, "n_kp": n_kp}
    warm_up(ctx, st)
    ctx.mark("the warm-up at a job's shapes")
    return st


def warm_up(ctx, st: dict) -> None:
    """Each shape a job runs, once: ``evaluate_frames`` over one full batch and
    the job's last, shorter one, then the PnP over a job's count of frames."""
    from dream_tpu_torch import analysis

    n, b = int(ctx.traffic["job_frames"]), int(ctx.traffic["batch_size"])
    k = n if n <= b else b + (n % b or b)
    which = st["which"][:k]
    gt = {"projections": st["pool"]["projections"][which], "positions": st["pool"]["positions"][which]}
    analysis.evaluate_frames(st["net"], st["frames"][:k], gt, st["pool"]["camera_K"], batch_size=b)
    which = st["which"][:n]
    device = st["net"].device
    positions = torch.as_tensor(st["pool"]["positions"][which], dtype=torch.float32, device=device)
    projections = torch.as_tensor(st["pool"]["projections"][which], dtype=torch.float32, device=device)
    K = torch.as_tensor(st["pool"]["camera_K"], dtype=torch.float32, device=device)
    analysis.gv.solve_pnp(positions, projections, K).valid.cpu()


def job(ctx, st: dict, j: int) -> dict:
    """Job ``j``: its offset into the frames and what ``evaluate_frames`` returned."""
    from dream_tpu_torch import analysis

    mix = ctx.traffic
    offset = (j * JOB_STRIDE) % int(mix["job_offsets"])
    rows = slice(offset, offset + int(mix["job_frames"]))
    which = st["which"][rows]
    gt = {"projections": st["pool"]["projections"][which], "positions": st["pool"]["positions"][which]}
    result = analysis.evaluate_frames(st["net"], st["frames"][rows], gt, st["pool"]["camera_K"],
                                      batch_size=int(mix["batch_size"]))
    return {"offset": offset, "result": result}


def window(ctx, st: dict, seconds: float) -> dict:
    net = st["net"]
    if ctx.tracer.enabled:
        traced = ctx.tracer
        inference, pnp_solve = net.inference, _solve_pnp()

        def inference_span(x):
            with traced.span("inference"):
                return inference(x)

        def pnp_span(*args, **kwargs):
            with traced.span("pnp", sync=True):
                return pnp_solve(*args, **kwargs)

        net.inference = inference_span
        _solve_pnp(pnp_span)
    jobs, ends = 0, []
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < seconds:
            st["last"] = job(ctx, st, jobs + 1)
            jobs += 1
            ends.append(time.perf_counter() - t0)
    finally:
        if ctx.tracer.enabled:
            net.inference = inference
            _solve_pnp(pnp_solve)
    elapsed = time.perf_counter() - t0
    print("job s: " + " ".join(f"{b - a:.3f}" for a, b in zip([0.0] + ends, ends)), file=sys.stderr)
    frames = jobs * int(ctx.traffic["job_frames"])
    from benchmark.harness.yardstick import forward_flops

    netin = net.trained_net_input_resolution()
    return {"attempted": frames, "failed": 0, "window_s": elapsed, "jobs": jobs, "frames": frames,
            "eval_frames_per_s": frames / elapsed,
            "frame_flops": forward_flops(net.architecture_type, st["n_kp"], netin),
            "decode_maps": _decode_maps(ctx, st, net, netin)}


def _decode_maps(ctx, st: dict, net, netin) -> list:
    """``[maps, h, w]`` of each peak decode in a job: one a batch."""
    w, h = net.net_output_resolution_from_input_resolution(netin)
    n, b = int(ctx.traffic["job_frames"]), int(ctx.traffic["batch_size"])
    return [[min(b, n - s) * st["n_kp"], h, w] for s in range(0, n, b)]


def _solve_pnp(replacement=None):
    """The PnP entry ``evaluate_frames`` calls; with ``replacement``, set it."""
    from dream_tpu_torch import analysis

    if replacement is not None:
        analysis.gv.solve_pnp = replacement
    return analysis.gv.solve_pnp


def sample(ctx, st: dict) -> np.ndarray:
    """The frames of the window's last job that the check compares, drawn by the seed."""
    n = int(ctx.traffic["job_frames"])
    k = min(int(ctx.traffic["check_frames"]), n)
    return np.sort(np.random.RandomState(program.derive(ctx.seed, 4)).choice(n, k, replace=False))


def reference(ctx, st: dict, picks: np.ndarray, precision: str = "float32") -> dict:
    """The reference on the sampled frames: its keypoints, its PnP and ADD on
    them, and its PnP and ADD on the program's own detections (the PnP stage
    alone)."""
    device = ctx.device
    cfg = ctx.config
    tc = st["net_config"]["training"]["config"]
    net_res = tuple(tc["net_input_resolution"])
    arch = st["net_config"]["architecture"]
    params = {k: v.to(device) for k, v in msgpack.torch_layout(
        msgpack.read_checkpoint(str(ctx.root / cfg["checkpoint"]))).items()}
    net = models.Net(arch["type"], params, precision)
    out_res = models.output_resolution(arch["type"], net_res)
    crop = ref_train.crop_box(st["raw_res"], net_res)
    rows = st["last"]["offset"] + picks
    kps = []
    batch = int(ctx.traffic["batch_size"])
    with torch.no_grad():
        for s in range(0, len(rows), batch):
            x = ref_train.preprocess(torch.from_numpy(st["frames"][rows[s:s + batch]]).to(device), net_res)
            x = ref_train.normalize(x, arch["image_normalization"]["mean"], arch["image_normalization"]["stdev"])
            maps = net(x.permute(0, 3, 1, 2))
            kps.append(decode.raw_from_netout(decode.keypoints(maps), out_res, net_res, crop).cpu())
    positions = torch.from_numpy(st["pool"]["positions"][st["which"][rows]])
    K = torch.from_numpy(st["pool"]["camera_K"])
    out = {"kp": torch.cat(kps).double().numpy()}
    for key, detected in (("", out["kp"]), ("stage_", st["last"]["result"]["detected_raw"][picks])):
        detected = torch.from_numpy(np.asarray(detected, np.float64))
        valid, R, t = pnp.solve(positions, detected, K)
        out[key + "valid"] = valid.numpy()
        out[key + "add"] = pnp.add(R, t, positions, (detected > -999.0).all(-1)).numpy()
    return out


def check(ctx, st: dict) -> dict:
    n = int(ctx.traffic["job_frames"])
    result = st["last"]["result"]
    got = {len(result[key]) for key in ("detected_raw", "add", "pnp_valid")}
    if got != {n}:
        return {"answers": (math.inf, f"{sorted(got)} answers for a job of {n} frames")}
    picks = sample(ctx, st)
    st["net"] = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    with models.exact_float32():
        ref = reference(ctx, st, picks)
    return checks.eval_numbers(result["detected_raw"][picks], result["add"][picks],
                               result["pnp_valid"][picks], ref)
