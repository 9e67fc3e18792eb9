"""Example robot-side client of the pose server: the port's
``scripts/dream_client_example.py``.

It plays the part the ROS graph plays for the reference node: it posts the
camera intrinsics, each frame's keypoint positions (the "forward
kinematics") and the frame's PNG bytes from disk to a running
``dream_tpu_torch.cli.serve_dream``, then reads back the robot-from-camera
pose.  With an NDDS dataset (read through
:mod:`dream_tpu_torch.utils.ndds`) it replays the frames and takes each
frame's ground-truth camera-frame keypoints as the FK source, so it doubles
as an end-to-end smoke test of a live deployment.  It needs the standard
library and the dataset reader only, no device.  After the frames it
prints one line with the frames/s it sustained and the latency of its
``POST /image`` requests.

Usage:
  python3 -m dream_tpu_torch.cli.dream_client_example --server http://localhost:8080 \\
      --dataset /path/to/ndds_dir [--rate 10]
"""

from __future__ import annotations

import argparse
import json
import time
import urllib.request

import numpy as np

from dream_tpu_torch.utils.ndds import find_ndds_data_in_dir, load_camera_intrinsics, load_keypoints


def _post(server, path, data):
    req = urllib.request.Request(server + path, data=data)
    with urllib.request.urlopen(req) as resp:
        return json.loads(resp.read())


def _get(server, path):
    with urllib.request.urlopen(server + path) as resp:
        return json.loads(resp.read())


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--server", default="http://localhost:8080")
    parser.add_argument("--dataset", required=True, help="NDDS dataset dir.")
    parser.add_argument("--rate", type=float, default=10.0, help="Frames/sec.")
    parser.add_argument("--max-frames", type=int, default=None)
    return parser


def main(argv=None) -> None:
    args = make_parser().parse_args(argv)
    status = _get(args.server, "/status")
    keypoint_names = status["keypoint_names"]
    print(f"Server ready; manipulator keypoints: {keypoint_names}")

    found_data, found_configs = find_ndds_data_in_dir(args.dataset)
    K = load_camera_intrinsics(found_configs["camera"])
    _post(args.server, "/camera_info", json.dumps(
        {"fx": K[0, 0], "fy": K[1, 1], "cx": K[0, 2], "cy": K[1, 2]}
    ).encode())

    frames = found_data[: args.max_frames] if args.max_frames else found_data
    period = 1.0 / args.rate
    image_s = []
    start = time.perf_counter()
    for datum in frames:
        t0 = time.perf_counter()
        # "FK": the frame's ground-truth 3D keypoints; on a robot they come
        # from the robot's forward kinematics.  The server's manipulator
        # config fixes the keypoint count and order.
        data_kp = load_keypoints(datum["data_path"], _first_object_class(datum["data_path"]),
                                 _dataset_names(datum, status))
        _post(args.server, "/keypoint_positions", json.dumps(data_kp["positions_wrt_cam"]).encode())

        with open(datum["image_paths"]["rgb"], "rb") as f:
            body = f.read()
        t_image = time.perf_counter()
        result = _post(args.server, "/image", body)
        image_s.append(time.perf_counter() - t_image)

        pose = _get(args.server, "/pose")
        if pose.get("ok"):
            t = [round(v, 4) for v in pose["translation"]]
            print(f"{datum['name']}: detected {result['n_detected']} kps, "
                  f"pose t={t} reproj={pose['reprojection_error_px']:.2f}px")
        else:
            print(f"{datum['name']}: no pose ({result})")

        dt = time.perf_counter() - t0
        if dt < period:
            time.sleep(period - dt)
    seconds = time.perf_counter() - start
    if image_s:
        ms = np.asarray(image_s) * 1e3
        print(f"{len(image_s)} frames in {seconds:.3f} s: {len(image_s) / seconds:.2f} frames/s; "
              f"POST /image ms p50 {np.percentile(ms, 50):.2f} p90 {np.percentile(ms, 90):.2f} "
              f"max {ms.max():.2f}", flush=True)


def _first_object_keypoints(data_path):
    with open(data_path) as f:
        data = json.load(f)
    return [kp["name"] for kp in data["objects"][0]["keypoints"]]


def _first_object_class(data_path):
    with open(data_path) as f:
        return json.load(f)["objects"][0]["class"]


def _dataset_names(datum, status):
    names = _first_object_keypoints(datum["data_path"])
    # The server's order where every one of its names is in the data file.
    if all(n in names for n in status["keypoint_names"]):
        return status["keypoint_names"]
    return names


if __name__ == "__main__":
    main()
