"""Export the inference pipeline as a deployable ``torch.export`` artifact:
the port's ``scripts/export_inference.py``.

One ``.pt2`` file: raw uint8 frames in, raw-frame keypoints out, with the
trained weights (and, with ``--int8-calibration-dir``, vgg-Q's int8 chain)
carried in the program, plus a ``<artifact>.meta.json`` sidecar; a
consumer loads it with ``torch.export.load`` and calls it, with no
``dream_tpu_torch`` and no checkpoint (see :mod:`dream_tpu_torch.export`).
The program is traced on ``--device`` and runs there.

Example:
  python3 -m dream_tpu_torch.cli.export_inference \\
      -i trained_models/results_r5/vggq/dream_vgg_q_r5.msgpack -o vggq_r5.pt2 -b 1 \\
      --raw-resolution 640x480 [--int8-calibration-dir /path/to/ndds --int8-calibration-frames 32]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from dream_tpu_torch.data.dataset import (
    ManipulatorNDDSDataset,
    collect_calibration_batches,
    make_batch_processor,
)
from dream_tpu_torch.export import artifact_metadata, export_inference, load_inference
from dream_tpu_torch.network import create_network_from_config_file
from dream_tpu_torch.utils.ndds import find_ndds_data_in_dir, load_image_resolution


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-i", "--input-params-path", required=True)
    parser.add_argument("-c", "--network-config", default=None,
                        help="Defaults to the params path with .yaml.")
    parser.add_argument("-o", "--output-path", required=True, help="Artifact file to write (.pt2).")
    parser.add_argument("-b", "--batch-size", type=int, default=32)
    parser.add_argument("--raw-resolution", default="640x480",
                        help="WxH of the raw frames the artifact accepts.")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu: where the artifact is traced and runs.")
    parser.add_argument("--int8-calibration-dir", default=None,
                        help="NDDS dataset to calibrate int8 quantization on; omit for float "
                             "inference.")
    parser.add_argument("--int8-calibration-frames", type=int, default=32)
    parser.add_argument("--self-test", action="store_true", default=False,
                        help="Load the artifact and compare it against the live network: on "
                             "frames of --int8-calibration-dir where given at --raw-resolution, "
                             "else on random frames.")
    parser.add_argument("--bench-trials", type=int, default=0,
                        help="If >0, time the loaded artifact (median of N trials of 8 calls each) "
                             "and report frames/s beside the live pipeline's for the same batch.")
    return parser


def _frames_per_s(fn, frames, batch_size, trials, device):
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn(frames)  # warm-up
    sync()
    n_calls, rates = 8, []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn(frames)
        sync()
        rates.append(batch_size * n_calls / (time.perf_counter() - t0))
    return rates


def export_inference_cli(args: argparse.Namespace):
    """Export, write the artifact and its sidecar, and run the optional
    self-test and timing; returns ``(network, artifact bytes)``."""
    network_config_path = args.network_config or os.path.splitext(args.input_params_path)[0] + ".yaml"
    net = create_network_from_config_file(network_config_path, args.input_params_path,
                                          device=args.device)
    net.enable_evaluation()
    w, h = (int(v) for v in args.raw_resolution.lower().split("x"))
    test_frames = None  # the self-test's frames; random unless calibration frames fit

    if args.int8_calibration_dir:
        found = find_ndds_data_in_dir(args.int8_calibration_dir)
        raw_res = load_image_resolution(found[1]["camera"])
        netin_res, netout_res = net.net_resolutions_from_image_raw_resolution(raw_res)
        dataset = ManipulatorNDDSDataset(
            found, net.manipulator_name, net.keypoint_names, netin_res, netout_res,
            net.image_normalization, net.image_preprocessing(), augment_data=False,
            include_ground_truth=False, include_belief_maps=False,
        )
        process = make_batch_processor(raw_res, netin_res, netout_res, net.image_preprocessing(),
                                       net.image_normalization, include_belief_maps=False)
        net.enable_int8_inference(collect_calibration_batches(
            dataset, lambda g, images, kp: process(g, images.to(net.device), kp.to(net.device)),
            args.int8_calibration_frames,
        ))
        print(f"int8 calibrated on {args.int8_calibration_frames} frames from "
              f"{args.int8_calibration_dir}")
        if tuple(raw_res) == (w, h):
            test_frames = dataset.load_images([i % len(dataset) for i in range(args.batch_size)])

    t0 = time.perf_counter()
    data = export_inference(net, (w, h), args.batch_size)
    export_s = time.perf_counter() - t0
    with open(args.output_path, "wb") as f:
        f.write(data)
    meta_path = args.output_path + ".meta.json"
    with open(meta_path, "w") as f:
        json.dump(artifact_metadata(net, (w, h), args.batch_size), f, indent=2)
    print(f"wrote {args.output_path}: {len(data) / 1e6:.1f} MB, input uint8[{args.batch_size},{h},{w},3], "
          f"device {net.device.type}, exported in {export_s:.1f} s; sidecar {meta_path}", flush=True)

    if args.self_test:
        call = load_inference(data)
        frames = test_frames
        if frames is None:
            rng = np.random.RandomState(0)
            frames = rng.randint(0, 255, size=(args.batch_size, h, w, 3), dtype=np.uint8)
        with torch.no_grad():
            _, kps = call(torch.from_numpy(frames).to(net.device))
        # The artifact returns raw-frame coords: the live per-frame
        # pipeline's contract.
        # The found state must agree, and the found keypoints are compared
        # alone: the -999.999 sentinel, mapped to the raw frame by two
        # routes, differs only in its float rounding.
        ref0 = net.keypoints_from_image(frames[0])["detected_keypoints"]
        art0 = kps[0].cpu().numpy()
        found = ref0[:, 0] > -999.0
        same_found = bool(np.array_equal(found, art0[:, 0] > -999.0))
        kp_delta = float(np.max(np.abs(art0[found] - ref0[found]), initial=0.0))
        print(f"self-test on {'a calibration' if test_frames is not None else 'a random'} frame "
              f"({int(found.sum())} keypoints found, found state {'equal' if same_found else 'different'}): "
              f"max raw-frame delta of the found keypoints vs live network = {kp_delta:.2e}")
        if not (same_found and kp_delta < 1e-2):
            raise AssertionError(f"self-test failed: found state equal {same_found}, the found keypoints "
                                 f"{kp_delta} px from the live network")
        print("self-test OK", flush=True)

    if args.bench_trials > 0:
        call = load_inference(data)
        rng = np.random.RandomState(1)
        frames = torch.from_numpy(
            rng.randint(0, 255, size=(args.batch_size, h, w, 3), dtype=np.uint8)).to(net.device)
        with torch.no_grad():
            artifact = _frames_per_s(call, frames, args.batch_size, args.bench_trials, net.device)
            live = _frames_per_s(lambda x: net.inference(net.preprocess(x)), frames,
                                 args.batch_size, args.bench_trials, net.device)
        print(f"artifact bench ({net.device.type}, b={args.batch_size}, {args.bench_trials} trials "
              f"x 8 calls): median {np.median(artifact):.1f} frames/s "
              f"(trials: {[round(r, 1) for r in artifact]}); live network: median "
              f"{np.median(live):.1f} frames/s", flush=True)
    return net, data


def main(argv=None) -> None:
    export_inference_cli(make_parser().parse_args(argv))


if __name__ == "__main__":
    main()
