"""Online pose serving over HTTP/JSON: the port of ``dream_tpu/serve.py``.

The reference serves poses from a ROS node (reference
scripts/launch_dream_ros.py:60-719); ``dream_tpu`` maps that node onto
HTTP/JSON on the standard library, and this module keeps its endpoints and
its JSON:

| reference ROS surface                      | HTTP surface                    |
|--------------------------------------------|---------------------------------|
| image topic subscription                   | POST /image (PNG or JPEG bytes) |
| camera_info topic                          | POST /camera_info               |
| TF lookups of keypoint frames (FK)         | POST /keypoint_positions        |
| /dream/capture_frame service               | POST /capture_frame             |
| /dream/clear_buffer service                | POST /clear_buffer              |
| TF broadcast base->dream/camera_rgb_frame  | GET /pose                       |
| debug image topics                         | GET /debug/<stream>.png         |

- :class:`DreamInferenceServer`: the transport-free state machine of
  ``dream_tpu/serve.py:101-365``: single-frame and multi-frame
  correspondence buffers, the reprojection-error gate, leave-one-out
  outlier rejection, soft detections and online int8 calibration.  PnP runs
  through :func:`dream_tpu_torch.ops.geometric_vision.solve_pnp` with a
  batch of one on the network's device.
- :func:`make_http_server`: the endpoints on ``ThreadingHTTPServer``, bound
  to loopback by default.  ``POST /image`` decodes PNG or JPEG with
  :func:`dream_tpu_torch.utils.png.decode_image` (the host loader); any
  other body gets a 400 JSON error naming the format.  ``GET /debug/<stream>.png``
  renders one of the five debug streams of the latest frame
  (:meth:`DreamInferenceServer.render_debug`, through
  :mod:`dream_tpu_torch.visualize`) as ``image/png``; an unknown stream,
  or one with nothing to show yet, is a 404.
- :class:`ArtifactInference`: serves a ``torch.export`` artifact of
  :mod:`dream_tpu_torch.export` in place of the network.

Threads: each request runs on a thread of its own, so what a request needs
(``torch.no_grad``, the current stream) it sets itself
(:meth:`dream_tpu_torch.network.DreamNetwork.inference` is ``no_grad``).
Shared state is read and written under the server's lock, and online int8
calibration runs on a copy of the model
(:meth:`~dream_tpu_torch.network.DreamNetwork.enable_int8_inference`), so
frames served meanwhile run the float model and leave the amax alone.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from dream_tpu_torch import visualize as viz
from dream_tpu_torch.ops import geometric_vision as gv
from dream_tpu_torch.utils.png import decode_image, encode_png

# The debug renders of dream_tpu/serve.py:366-416.
DEBUG_STREAMS = (
    "net_input_image",
    "keypoint_overlay",
    "belief_maps",
    "keypoint_belief_overlay",
    "keypoint_frame_overlay",
)


def _found(keypoints: np.ndarray) -> np.ndarray:
    return (keypoints[:, 0] > -999.0) & (keypoints[:, 1] > -999.0)


class ArtifactInference:
    """A network-like adapter over a ``torch.export`` artifact
    (:func:`dream_tpu_torch.export.export_inference`): the program and the
    keypoint names of its ``<artifact>.meta.json`` sidecar are all it
    needs, no checkpoint and no model code.  It zero-pads a frame to the
    artifact's batch; the artifact returns raw-frame keypoints, so the
    server's PnP and pose path is unchanged.  Soft-detection PnP and online
    int8 calibration need the full network (``dream_tpu/serve.py:41-98``).
    """

    def __init__(self, artifact_path: str, keypoint_names=None, friendly_names=None,
                 device=None):
        program = torch.export.load(artifact_path)
        user_inputs = set(program.graph_signature.user_inputs)
        (frames,) = [node for node in program.graph.nodes
                     if node.op == "placeholder" and node.name in user_inputs]
        self._batch, self._h, self._w = (int(d) for d in frames.meta["val"].shape[:3])
        # The program runs where it was traced; a caller that names a
        # device is held to it rather than moved.
        self.device = frames.meta["val"].device
        if device is not None and torch.device(device).type != self.device.type:
            raise ValueError(f"{artifact_path} was exported for {self.device.type}, "
                             f"not {torch.device(device).type}: export it on that device")
        self._module = program.module()
        if keypoint_names is None:
            meta_path = artifact_path + ".meta.json"
            if not os.path.exists(meta_path):
                raise FileNotFoundError(
                    f"keypoint_names not given and no metadata sidecar found at {meta_path}")
            with open(meta_path) as f:
                meta = json.load(f)
            keypoint_names = meta["keypoint_names"]
            friendly_names = friendly_names or meta.get("friendly_keypoint_names")
        self.keypoint_names = list(keypoint_names)
        self.friendly_keypoint_names = list(friendly_names or keypoint_names)
        self.n_keypoints = len(self.keypoint_names)

    def enable_evaluation(self) -> None:
        pass

    def keypoints_from_image(self, image, image_preprocessing_override=None, debug=False,
                             detailed=False):
        # Checks that raise under -O too, as AssertionError like dream_tpu's.
        if detailed:
            raise AssertionError("soft-detection PnP needs the full network; the artifact "
                                 "exports the disambiguated detections only.")
        if image_preprocessing_override is not None:
            raise AssertionError("the artifact bakes its preprocessing in")
        arr = np.asarray(image, dtype=np.uint8)
        if arr.shape != (self._h, self._w, 3):
            raise AssertionError(f"artifact expects {self._h}x{self._w} RGB frames, got {arr.shape}")
        batch = np.zeros((self._batch, self._h, self._w, 3), np.uint8)
        batch[0] = arr
        with torch.no_grad():
            belief, kps = self._module(torch.from_numpy(batch).to(self.device))
        result = {"detected_keypoints": kps[0].cpu().numpy().astype(float)}
        if debug:
            result["belief_maps"] = belief[0]
        return result


class DreamInferenceServer:
    """The serving node's state machine, without a transport
    (``dream_tpu/serve.py:101-365``, reference
    scripts/launch_dream_ros.py:60-626)."""

    def __init__(
        self,
        dream_network,
        base_frame: str = "base_link",
        single_frame_mode: bool = True,
        verbose: bool = False,
        max_reproj_err_px: Optional[float] = None,
        pnp_reject_outliers_px: Optional[float] = None,
        pnp_soft_detections: bool = False,
        pnp_soft_min_score: float = 0.05,
        int8_calibration_frames: int = 0,
    ):
        self.network = dream_network
        self.network.enable_evaluation()
        self.base_frame = base_frame
        self.single_frame_mode = single_frame_mode
        self.verbose = verbose
        # A solution whose mean reprojection error exceeds this is rejected
        # (not published, the buffer not grown); None publishes every valid
        # solution, as the reference does.
        self.max_reproj_err_px = max_reproj_err_px
        # The offline analysis's robust-PnP options: leave-one-out rejection
        # beyond this many px, and soft detections (every best peak above the
        # score floor, even those the score-gap disambiguation rejects).
        self.pnp_reject_outliers_px = pnp_reject_outliers_px
        self.pnp_soft_detections = pnp_soft_detections
        self.pnp_soft_min_score = pnp_soft_min_score
        # Online int8: the first N frames run in float and their net inputs
        # are kept; then the network calibrates on them and serves int8.
        self.int8_calibration_frames = int(int8_calibration_frames)
        self._int8_calib_inputs: Optional[list] = []
        self._int8_active = False

        self.camera_K: Optional[np.ndarray] = None
        self.keypoint_positions: Optional[np.ndarray] = None  # FK-provided [n_kp, 3]
        self.capture_requested = single_frame_mode

        self.kp_projs_raw_buffer = np.empty((0, 2))
        self.kp_positions_buffer = np.empty((0, 3))

        self.pnp_solution_found = False
        self.latest_pose = None  # dict, robot_from_cam
        self.latest_detection = None
        self.latest_image = None
        self.frames_processed = 0
        self._lock = threading.Lock()

    # -- input channels ------------------------------------------------

    def on_camera_info(self, fx, fy, cx, cy):
        """Parity: reference :215-221 (builds K from camera_info)."""
        with self._lock:
            self.camera_K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])

    def on_keypoint_positions(self, positions):
        """FK-provided 3D keypoint positions in the base frame, in place of
        the reference's TF lookups (:383-406)."""
        positions = np.asarray(positions, dtype=float)
        if positions.shape != (self.network.n_keypoints, 3):  # outside input: no bare assert
            raise AssertionError(
                f"Expected [{self.network.n_keypoints}, 3] keypoint positions, got {positions.shape}.")
        with self._lock:
            self.keypoint_positions = positions

    def capture_frame(self):
        """The next processed frame's correspondences join the PnP buffer
        (reference :72-77)."""
        with self._lock:
            self.capture_requested = True
        return {"ok": True}

    def clear_buffer(self):
        with self._lock:
            self.kp_projs_raw_buffer = np.empty((0, 2))
            self.kp_positions_buffer = np.empty((0, 3))
            self.pnp_solution_found = False
        return {"ok": True}

    # -- processing ----------------------------------------------------

    def process_image(self, image):
        """Detect, correspond, solve and publish for one uint8 ``[H, W, 3]``
        frame; returns a status dict (reference :694-719)."""
        detection = self.network.keypoints_from_image(
            image, debug=True, detailed=self.pnp_soft_detections
        )
        detected = detection["detected_keypoints"]

        if self.int8_calibration_frames and not self._int8_active:
            calib = None
            with self._lock:
                # Checked again under the lock: another thread may have
                # claimed or finished calibration while this frame ran.
                if not self._int8_active and self._int8_calib_inputs is not None:
                    self._int8_calib_inputs.append(detection["image_rgb_net_input"])
                    if len(self._int8_calib_inputs) >= self.int8_calibration_frames:
                        calib = torch.stack(self._int8_calib_inputs)
                        # None marks calibration as claimed: later frames
                        # neither buffer nor calibrate again.
                        self._int8_calib_inputs = None
            if calib is not None:
                # Outside the lock, so that status and pose stay answered.
                # The network swaps its int8 chain in with one attribute
                # store.
                self.network.enable_int8_inference([calib])
                with self._lock:
                    self._int8_active = True
                if self.verbose:
                    print(f"[serve] int8 inference active (calibrated on {calib.shape[0]} frames)")

        with self._lock:
            self.latest_detection = detection
            self.latest_image = np.asarray(image)
            self.frames_processed += 1
            frame = self.frames_processed  # read under the lock: other frames count too
            keypoint_positions = self.keypoint_positions
            camera_K = self.camera_K
            capture = self.capture_requested or self.single_frame_mode
            if not self.single_frame_mode:
                self.capture_requested = False

        status = {
            "frame": frame,
            "n_detected": int(np.sum(_found(detected))),
            "pnp": False,
        }
        if keypoint_positions is None or camera_K is None or not capture:
            return status

        # In-frame detections (reference :409-427); in soft mode, every
        # best peak above the score floor (the published detections are
        # unaffected).
        if self.pnp_soft_detections:
            good = detection["peak_scores"] > self.pnp_soft_min_score
            kp_projs = detection["best_peak_keypoints"][good]
        else:
            good = _found(detected)
            kp_projs = detected[good]
        status["pnp"] = self._solve_pnp_buffer(kp_projs, keypoint_positions[good], camera_K)
        return status

    def _solve_pnp_buffer(self, candidate_projs, candidate_positions, camera_K):
        """Buffer, solve, invert (reference :429-496)."""
        # A snapshot under the lock: /clear_buffer or another /image may run
        # on another thread meanwhile.
        with self._lock:
            projs = np.concatenate([self.kp_projs_raw_buffer, candidate_projs])
            positions = np.concatenate([self.kp_positions_buffer, candidate_positions])
        if len(projs) < 4:
            with self._lock:
                self.pnp_solution_found = False
            return False

        device = getattr(self.network, "device", torch.device("cpu"))

        def batch_of_one(a):
            return torch.as_tensor(np.asarray(a, np.float32)[None], device=device)

        result = gv.solve_pnp(batch_of_one(positions), batch_of_one(projs), batch_of_one(camera_K),
                              reject_outliers_px=self.pnp_reject_outliers_px)
        reproj_error = float(result.reproj_error[0])
        gated = self.max_reproj_err_px is not None and reproj_error > self.max_reproj_err_px
        if not bool(result.valid[0]) or gated:
            with self._lock:
                self.pnp_solution_found = False
            return False

        # camera-from-robot -> robot-from-camera (reference :463-482).
        R = result.rotation[0].cpu().numpy()
        t = result.translation[0].cpu().numpy()
        R_inv = R.T
        t_inv = -R_inv @ t
        quat_inv = gv.quaternion_from_rotation_matrix(torch.from_numpy(np.ascontiguousarray(R_inv)))

        with self._lock:
            self.pnp_solution_found = True
            self.latest_pose = {
                "parent_frame": self.base_frame,
                "child_frame": "dream/camera_rgb_frame",
                "translation": t_inv.tolist(),
                "quaternion_xyzw": quat_inv.numpy().tolist(),
                "camera_from_robot": {
                    "translation": t.tolist(),
                    "quaternion_xyzw": result.quaternion[0].cpu().numpy().tolist(),
                },
                "reprojection_error_px": reproj_error,
                "n_correspondences": int(len(projs)),
                "stamp": time.time(),
            }
            if not self.single_frame_mode:
                self.kp_projs_raw_buffer = projs
                self.kp_positions_buffer = positions
        return True

    # -- output channels ----------------------------------------------

    def get_pose(self):
        with self._lock:
            if self.latest_pose is None:
                return {"ok": False, "error": "no pose solution yet"}
            return dict(self.latest_pose, ok=True)

    def get_status(self):
        with self._lock:
            return {
                "ok": True,
                "frames_processed": self.frames_processed,
                "camera_info_received": self.camera_K is not None,
                "keypoint_positions_received": self.keypoint_positions is not None,
                "pnp_solution_found": self.pnp_solution_found,
                "buffer_size": int(self.kp_projs_raw_buffer.shape[0]),
                "single_frame_mode": self.single_frame_mode,
                "keypoint_names": self.network.friendly_keypoint_names,
                "int8": (
                    "active" if self._int8_active
                    else "calibrating" if self.int8_calibration_frames
                    else "off"
                ),
            }

    def render_debug(self, stream: str):
        """One debug render of the latest frame as a uint8 image, or None
        (reference topics :143-157, ``dream_tpu/serve.py:366-416``), made on
        demand as the reference publishes only to subscribers (:237-252):

        - ``net_input_image``: the net input, its normalization undone (None
          when serving an artifact, whose net input stays inside its graph);
        - ``keypoint_overlay``: the detections and their names on the frame;
        - ``belief_maps``: the belief maps in a row;
        - ``keypoint_belief_overlay``: the maps' maximum blended over the
          frame, with the detections;
        - ``keypoint_frame_overlay``: the robot base's triad through the
          latest pose (None before a pose and camera intrinsics).

        None before the first frame and for an unknown stream."""
        with self._lock:
            detection = self.latest_detection
            image = self.latest_image
            pose = self.latest_pose
            camera_K = self.camera_K
        if detection is None or stream not in DEBUG_STREAMS:
            return None
        if stream == "net_input_image":
            if detection.get("image_rgb_net_input") is None:
                return None
            return viz.image_from_tensor(detection["image_rgb_net_input"],
                                         self.network.image_normalization)
        if stream == "keypoint_overlay":
            return viz.overlay_points_on_image(image, detection["detected_keypoints"],
                                               self.network.friendly_keypoint_names)
        belief_maps = torch.as_tensor(detection["belief_maps"]).float().cpu().numpy()
        if stream == "belief_maps":
            return viz.mosaic_images(viz.images_from_belief_maps(belief_maps), rows=1,
                                     cols=self.network.n_keypoints)
        if stream == "keypoint_belief_overlay":
            blend = viz.blend_belief_overlay(image, np.max(belief_maps, axis=0))
            return viz.overlay_points_on_image(blend, detection["detected_keypoints"])
        if pose is None or camera_K is None:
            return None
        cam_from_robot = pose["camera_from_robot"]
        return viz.overlay_pose_triad(image, camera_K, cam_from_robot["translation"],
                                      cam_from_robot["quaternion_xyzw"])


# ---------------------------------------------------------------------------
# HTTP transport
# ---------------------------------------------------------------------------


def make_http_server(server: DreamInferenceServer, host: str = "127.0.0.1", port: int = 8080):
    """Wrap a :class:`DreamInferenceServer` in a threaded standard-library
    HTTP server (``dream_tpu/serve.py:424-502``).

    Binds loopback by default: the endpoints are unauthenticated and include
    state-mutating POSTs.  Pass ``host="0.0.0.0"`` to expose the node on
    the network deliberately.  ``port=0`` binds a free port
    (``server_address[1]`` names it).
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            if server.verbose:
                super().log_message(fmt, *args)

        def _send_json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_png(self, image):
            body = encode_png(image)
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self):
            length = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(length)

        def do_GET(self):
            if self.path == "/pose":
                self._send_json(server.get_pose())
            elif self.path == "/status":
                self._send_json(server.get_status())
            elif self.path.startswith("/debug/"):
                stream = self.path[len("/debug/"):].removesuffix(".png")
                img = server.render_debug(stream)
                if img is None:
                    self._send_json({"ok": False, "error": "no frame yet or unknown stream"}, 404)
                else:
                    self._send_png(img)
            else:
                self._send_json({"ok": False, "error": "unknown endpoint"}, 404)

        def do_POST(self):
            try:
                if self.path == "/image":
                    image = decode_image(self._read_body(), "POST /image body")
                    self._send_json({"ok": True, **server.process_image(image)})
                elif self.path == "/camera_info":
                    info = json.loads(self._read_body())
                    server.on_camera_info(info["fx"], info["fy"], info["cx"], info["cy"])
                    self._send_json({"ok": True})
                elif self.path == "/keypoint_positions":
                    server.on_keypoint_positions(json.loads(self._read_body()))
                    self._send_json({"ok": True})
                elif self.path == "/capture_frame":
                    self._send_json(server.capture_frame())
                elif self.path == "/clear_buffer":
                    self._send_json(server.clear_buffer())
                else:
                    self._send_json({"ok": False, "error": "unknown endpoint"}, 404)
            except Exception as exc:  # report errors to the client, keep serving
                self._send_json({"ok": False, "error": str(exc)}, 400)

    return ThreadingHTTPServer((host, port), Handler)
