"""The port's pose server against dream_tpu's, on the CPU in float32.

- The eleven tests of ``tests/test_serve.py``, each through the port: an
  ``_OracleNetwork`` (the port's ``DreamNetwork`` on
  ``tests/test_network.py::_vgg_config``, 64x64, 4 keypoints) plants its
  detections, so the state machine, the multi-frame buffer, the keypoint
  positions' check, sentinel detections, the reprojection gate, soft
  detections and outlier rejection are held to the same outcomes and the
  same poses (1e-3, 5e-3 under rejection) as there.  The HTTP round trip
  posts a PNG body.  Online int8 runs on that small vgg-Q with the port's
  initial parameters, and serving from an artifact on a ``torch.export``
  artifact of it.  The pose-triad stream test becomes the test of the five
  debug renders: on a planted detection state (a random frame, net input
  and belief maps, the planted detections and the solved pose) each
  stream equals dream_tpu's ``render_debug`` of the same state pixel for
  pixel, but ``keypoint_overlay``'s names, held to
  ``tests/test_torch_visualize.py``'s loose text bound; over HTTP a stream
  is a PNG; from an artifact ``net_input_image`` is None.
- Parity: the r5 vgg-Q checkpoint's float32 parameters at a 96x96 net input
  and 160x120 synthetic frames (seeded parameters find almost no keypoint,
  the r5 ones most) go through ``dream_tpu.serve``'s server and the
  port's, each over HTTP.  The JSON of ``/status``, ``/image`` and
  ``/pose`` is equal apart from ``stamp``; pose numbers agree to 1e-3 and
  the reprojection error to a relative 1e-3, the tolerances of
  ``tests/test_torch_pnp_metrics.py``.  The dream_tpu network is built
  once for the module.
- A JPEG body gets what dream_tpu's server answers on the same bytes, the
  frame decoded as PIL decodes it; a GIF body gets the 400 JSON error,
  naming the format.
- The calibration hazard: calibration is held halfway through its frames
  (an event in the batch iterator), a second thread posts a frame
  meanwhile, and that frame must run through no calibrating conv and leave
  the amax as a separate ``calibrate`` over exactly the buffered frames
  gives it (to 1e-5 relative: the calibration thread sums its float32
  convs with another count of threads), where the posted frame would have
  moved some amax by more than 1%.
- Threads: twice as many handlers as cores, switching every microsecond,
  each capturing and serving frames in multi-frame mode: every frame is
  counted once, and the buffer holds whole frames (PnP's ``jvp`` is not
  thread-safe in torch, so the solves take a lock).
"""

import copy
import io
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dream_tpu import network as jax_network
from dream_tpu import serve as jax_serve

from dream_tpu_torch.checkpoint import state_to_flax
from dream_tpu_torch.data.synthetic import generate_synthetic_frames
from dream_tpu_torch.export import export_inference
from dream_tpu_torch.models.quant import QuantConv2d, calibrate
from dream_tpu_torch.network import DreamNetwork
from dream_tpu_torch.serve import (
    DEBUG_STREAMS,
    ArtifactInference,
    DreamInferenceServer,
    make_http_server,
)
from dream_tpu_torch.utils.config import load_yaml
from dream_tpu_torch.utils.png import decode_png
from tests.test_network import _vgg_config
from tests.test_torch_visualize import assert_equal_but_names

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R5_PARAMS = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.msgpack")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors in Python loops, where torch's idle intra-op threads
    spin for nothing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


_BASE = {}


def _base_network():
    """One port vgg-Q on the small config, built once (about a second on
    the CPU): the oracles share its attributes and never run its model."""
    if "net" not in _BASE:
        _BASE["net"] = DreamNetwork(_vgg_config(), device="cpu")
    return _BASE["net"]


class _OracleNetwork(DreamNetwork):
    """A port DreamNetwork whose keypoints_from_image returns planted
    projections (isolates the serving logic from the model)."""

    def __init__(self, planted_projs, planted_best_peaks=None, planted_scores=None):
        self.__dict__.update(_base_network().__dict__)
        self._planted = np.asarray(planted_projs, dtype=float)
        self._best_peaks = (self._planted if planted_best_peaks is None
                            else np.asarray(planted_best_peaks, dtype=float))
        self._scores = (np.ones(len(self._planted)) if planted_scores is None
                        else np.asarray(planted_scores, dtype=float))

    def keypoints_from_image(self, image, image_preprocessing_override=None, debug=False,
                             detailed=False):
        result = {"detected_keypoints": self._planted.copy()}
        if detailed:
            result["peak_scores"] = self._scores.copy()
            result["best_peak_keypoints"] = self._best_peaks.copy()
        if debug:
            result["image_rgb_net_input"] = torch.zeros((64, 64, 3))
            result["belief_maps"] = torch.zeros((4, 16, 16))
            result["detected_keypoints_net_output"] = self._planted / 4.0
            result["detected_keypoints_net_input"] = self._planted.copy()
        return result


def _make_scene():
    """``tests/test_serve.py``'s GT pose, keypoints and projections."""
    rng = np.random.RandomState(0)
    K = np.array([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1.0]])
    X = rng.uniform(-0.3, 0.3, (4, 3))
    t = np.array([0.0, 0.0, 1.5])
    uv = (X + t) @ K.T
    uv = uv[:, :2] / uv[:, 2:]
    return K, X, uv, t


def _ready(server, K, X):
    server.on_camera_info(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    server.on_keypoint_positions(X)
    return server


IMAGE = np.zeros((240, 320, 3), np.uint8)


class _Http:
    """A server's HTTP transport on a free loopback port, in a thread."""

    def __init__(self, server, make=make_http_server):
        self.httpd = make(server, "127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def post(self, path, data):
        req = urllib.request.Request(self.url + path, data=data)
        with urllib.request.urlopen(req) as resp:
            return json.loads(resp.read())

    def get(self, path):
        with urllib.request.urlopen(self.url + path) as resp:
            return json.loads(resp.read())

    def error(self, method, path, data=None):
        """(HTTP code, JSON body) of a request that must fail."""
        with pytest.raises(urllib.error.HTTPError) as info:
            if method == "GET":
                urllib.request.urlopen(self.url + path)
            else:
                urllib.request.urlopen(urllib.request.Request(self.url + path, data=data))
        return info.value.code, json.loads(info.value.read())

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _png(image):
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return buf.getvalue()


def test_serve_state_machine_single_frame():
    K, X, uv, t_gt = _make_scene()
    server = DreamInferenceServer(_OracleNetwork(uv), base_frame="base", single_frame_mode=True)
    status = server.process_image(IMAGE)
    assert status["pnp"] is False
    assert server.get_pose()["ok"] is False

    _ready(server, K, X)
    assert server.process_image(IMAGE)["pnp"] is True
    pose = server.get_pose()
    assert pose["ok"]
    np.testing.assert_allclose(pose["camera_from_robot"]["translation"], t_gt, atol=1e-3)
    np.testing.assert_allclose(pose["translation"], -t_gt, atol=1e-3)
    assert server.get_status()["buffer_size"] == 0


def test_serve_multi_frame_buffer():
    K, X, uv, _ = _make_scene()
    server = _ready(DreamInferenceServer(_OracleNetwork(uv), base_frame="base",
                                         single_frame_mode=False), K, X)
    assert server.process_image(IMAGE)["pnp"] is False
    assert server.get_status()["buffer_size"] == 0
    server.capture_frame()
    assert server.process_image(IMAGE)["pnp"] is True
    assert server.get_status()["buffer_size"] == 4
    server.capture_frame()
    server.process_image(IMAGE)
    assert server.get_status()["buffer_size"] == 8
    server.clear_buffer()
    assert server.get_status()["buffer_size"] == 0


def test_concurrent_frames_keep_the_counts():
    """More handler threads than cores, switching often: every frame is
    counted once, under its own number, and the buffer holds whole frames."""
    import sys

    K, X, uv, _ = _make_scene()
    server = _ready(DreamInferenceServer(_OracleNetwork(uv), base_frame="base",
                                         single_frame_mode=False), K, X)
    n_threads, frames = 2 * (os.cpu_count() or 4), 2
    results = []

    def serve():
        for _ in range(frames):
            server.capture_frame()
            results.append(server.process_image(IMAGE))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=serve) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    status = server.get_status()
    assert status["frames_processed"] == n_threads * frames == len(results)
    assert sorted(r["frame"] for r in results) == list(range(1, n_threads * frames + 1))
    # A frame may find another's capture taken, and two solves may read the
    # same snapshot; the buffer only ever holds whole frames of 4.
    assert status["buffer_size"] % 4 == 0 and 0 < status["buffer_size"] <= 4 * sum(
        r["pnp"] for r in results)


def test_serve_rejects_bad_keypoint_positions():
    _, _, uv, _ = _make_scene()
    server = DreamInferenceServer(_OracleNetwork(uv), base_frame="base")
    with pytest.raises(AssertionError):
        server.on_keypoint_positions(np.zeros((3, 3)))


def test_serve_sentinel_detections_skipped():
    K, X, uv, _ = _make_scene()
    uv_partial = uv.copy()
    uv_partial[0] = [-999.999, -999.999]
    server = _ready(DreamInferenceServer(_OracleNetwork(uv_partial), base_frame="base"), K, X)
    status = server.process_image(IMAGE)
    assert status["pnp"] is False and status["n_detected"] == 3


def test_http_transport_round_trip():
    K, X, uv, t_gt = _make_scene()
    server = DreamInferenceServer(_OracleNetwork(uv), base_frame="base")
    http = _Http(server)
    try:
        assert http.post("/camera_info", json.dumps(
            {"fx": K[0, 0], "fy": K[1, 1], "cx": K[0, 2], "cy": K[1, 2]}).encode())["ok"]
        assert http.post("/keypoint_positions", json.dumps(X.tolist()).encode())["ok"]
        result = http.post("/image", _png(IMAGE))
        assert result["ok"] and result["pnp"]
        pose = http.get("/pose")
        assert pose["ok"]
        np.testing.assert_allclose(pose["camera_from_robot"]["translation"], t_gt, atol=1e-3)
        assert http.get("/status")["frames_processed"] == 1
        # A known debug stream: its render as a PNG; unknown streams and
        # endpoints: 404.
        with urllib.request.urlopen(http.url + "/debug/keypoint_overlay.png") as resp:
            assert resp.status == 200 and resp.headers["Content-Type"] == "image/png"
            png = resp.read()
        np.testing.assert_array_equal(decode_png(png), server.render_debug("keypoint_overlay"))
        assert http.error("GET", "/debug/nonsense.png")[0] == 404
        assert http.error("GET", "/nonsense")[0] == 404
        assert http.error("POST", "/nonsense", b"")[0] == 404
    finally:
        http.close()


class _DebugOracle(_OracleNetwork):
    """Planted detections with a random net input and belief maps."""

    def keypoints_from_image(self, image, image_preprocessing_override=None, debug=False,
                             detailed=False):
        result = super().keypoints_from_image(image, image_preprocessing_override, debug, detailed)
        if debug:
            rng = np.random.RandomState(5)
            result["image_rgb_net_input"] = torch.from_numpy(rng.normal(0, 1, (64, 64, 3)).astype(np.float32))
            result["belief_maps"] = torch.from_numpy(rng.uniform(-0.1, 1.1, (4, 16, 16)).astype(np.float32))
        return result


def test_debug_streams_are_refused_by_name():
    """The five debug renders (formerly refused by name) against
    dream_tpu's render of the same detection state."""
    K, X, uv, _ = _make_scene()
    server = _ready(DreamInferenceServer(_DebugOracle(uv), base_frame="base"), K, X)
    assert all(server.render_debug(stream) is None for stream in DEBUG_STREAMS)
    image = np.random.RandomState(4).randint(0, 256, (240, 320, 3)).astype(np.uint8)
    server.process_image(image)
    assert server.get_pose()["ok"]
    assert len(DEBUG_STREAMS) == 5
    ref = jax_serve.DreamInferenceServer(_OracleNetwork(uv), base_frame="base")
    ref.latest_detection = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                            for k, v in server.latest_detection.items()}
    ref.latest_image, ref.latest_pose, ref.camera_K = image, server.latest_pose, server.camera_K
    shapes = {"net_input_image": (64, 64, 3), "keypoint_overlay": (240, 320, 3),
              "belief_maps": (16, 64, 3), "keypoint_belief_overlay": (240, 320, 3),
              "keypoint_frame_overlay": (240, 320, 3)}
    for stream in DEBUG_STREAMS:
        ours, theirs = server.render_debug(stream), np.asarray(ref.render_debug(stream))
        assert ours.shape == theirs.shape == shapes[stream], stream
        if stream != "keypoint_overlay":
            np.testing.assert_array_equal(ours, theirs, err_msg=stream)
            continue
        assert assert_equal_but_names(ours, theirs, image, uv, server.network.friendly_keypoint_names) > 100
    assert not np.array_equal(server.render_debug("keypoint_frame_overlay"), image)
    assert server.render_debug("nonsense") is None


def test_serve_reproj_error_gate():
    K, X, uv, _ = _make_scene()
    uv_bad = uv.copy()
    uv_bad[1] += [60.0, -45.0]
    gated = _ready(DreamInferenceServer(_OracleNetwork(uv_bad), base_frame="base",
                                        max_reproj_err_px=3.0), K, X)
    assert gated.process_image(IMAGE)["pnp"] is False
    assert gated.get_pose()["ok"] is False
    ungated = _ready(DreamInferenceServer(_OracleNetwork(uv_bad), base_frame="base"), K, X)
    assert ungated.process_image(IMAGE)["pnp"] is True
    clean = _ready(DreamInferenceServer(_OracleNetwork(uv), base_frame="base",
                                        max_reproj_err_px=3.0), K, X)
    assert clean.process_image(IMAGE)["pnp"] is True
    assert clean.get_pose()["ok"] is True


def test_serve_soft_detections_recover_below_floor_frames():
    K, X, uv, t_gt = _make_scene()
    uv_partial = uv.copy()
    uv_partial[0] = [-999.999, -999.999]
    canonical = _ready(DreamInferenceServer(_OracleNetwork(uv_partial), base_frame="base"), K, X)
    assert canonical.process_image(IMAGE)["pnp"] is False
    soft = _ready(DreamInferenceServer(
        _OracleNetwork(uv_partial, planted_best_peaks=uv, planted_scores=[0.5, 0.9, 0.9, 0.9]),
        base_frame="base", pnp_soft_detections=True), K, X)
    assert soft.process_image(IMAGE)["pnp"] is True
    np.testing.assert_allclose(soft.get_pose()["camera_from_robot"]["translation"], t_gt, atol=1e-3)
    floor = _ready(DreamInferenceServer(
        _OracleNetwork(uv_partial, planted_best_peaks=uv, planted_scores=[0.01, 0.9, 0.9, 0.9]),
        base_frame="base", pnp_soft_detections=True), K, X)
    assert floor.process_image(IMAGE)["pnp"] is False


def test_serve_outlier_rejection():
    rng = np.random.RandomState(1)
    K = np.array([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1.0]])
    X = rng.uniform(-0.3, 0.3, (5, 3))
    t_gt = np.array([0.0, 0.0, 1.5])
    uv = (X + t_gt) @ K.T
    uv = uv[:, :2] / uv[:, 2:]
    uv_bad = uv.copy()
    uv_bad[2] += [55.0, -40.0]
    robust = _OracleNetwork(uv_bad)
    robust.n_keypoints = 5
    server = _ready(DreamInferenceServer(robust, base_frame="base", pnp_reject_outliers_px=5.0), K, X)
    assert server.process_image(IMAGE)["pnp"] is True
    np.testing.assert_allclose(server.get_pose()["camera_from_robot"]["translation"], t_gt, atol=5e-3)


def test_serve_online_int8_calibration():
    net = DreamNetwork(_vgg_config(), device="cpu")
    server = DreamInferenceServer(net, base_frame="base", int8_calibration_frames=2)
    image = np.zeros((96, 128, 3), np.uint8)
    assert server.get_status()["int8"] == "calibrating"
    server.process_image(image)
    assert server.get_status()["int8"] == "calibrating" and net.int8_chain is None
    server.process_image(image)  # the second frame completes calibration
    assert server.get_status()["int8"] == "active" and net.int8_chain is not None
    status = server.process_image(image)  # served through the int8 chain
    assert status["frame"] == 3
    assert server.latest_detection["detected_keypoints"].shape == (4, 2)
    off = DreamInferenceServer(net, base_frame="base")
    assert off.get_status()["int8"] == "off"


def test_serve_from_export_artifact(tmp_path):
    net = DreamNetwork(_vgg_config(), device="cpu")
    artifact = tmp_path / "net.pt2"
    artifact.write_bytes(export_inference(net, raw_resolution=(128, 96), batch_size=1))
    adapter = ArtifactInference(str(artifact), [f"kp{i}" for i in range(4)])
    assert adapter.n_keypoints == 4 and adapter.device == torch.device("cpu")
    server = DreamInferenceServer(adapter, base_frame="base")
    rng = np.random.RandomState(3)
    image = rng.randint(0, 255, (96, 128, 3)).astype(np.uint8)
    status = server.process_image(image)
    assert status["frame"] == 1 and status["pnp"] is False
    live = net.keypoints_from_image(image)["detected_keypoints"]
    art = server.latest_detection["detected_keypoints"]
    detected = live > -999.0
    np.testing.assert_array_equal(art > -999.0, detected)
    np.testing.assert_allclose(art[detected], live[detected], atol=1e-3)
    assert tuple(server.latest_detection["belief_maps"].shape) == (4, 16, 16)
    # The net input stays inside the artifact's graph; no pose yet, so no
    # triad; the other streams render.
    assert server.render_debug("net_input_image") is None
    assert server.render_debug("keypoint_frame_overlay") is None
    assert server.render_debug("keypoint_overlay").shape == (96, 128, 3)
    assert server.render_debug("belief_maps").shape == (16, 64, 3)
    assert server.render_debug("keypoint_belief_overlay").shape == (96, 128, 3)
    with pytest.raises(AssertionError):
        server.process_image(np.zeros((64, 64, 3), np.uint8))
    with pytest.raises(AssertionError):
        adapter.keypoints_from_image(image, detailed=True)
    with pytest.raises(ValueError, match="exported for cpu"):
        ArtifactInference(str(artifact), [f"kp{i}" for i in range(4)], device="cuda")


def test_jpeg_body_gets_the_400_json_error():
    """A JPEG body, formerly a 400, now gets what dream_tpu's server
    answers on the same bytes (the same status and JSON, the pose to
    1e-3), and the network receives the frame PIL decodes, bit for bit.  A
    body that is neither PNG nor JPEG (``GIF89a``) still gets the 400 JSON
    error, naming its format (dream_tpu's PIL would read a GIF)."""
    K, X, uv, _ = _make_scene()
    seen = {}

    class _Recording(_OracleNetwork):
        def __init__(self, key):
            super().__init__(uv)
            self._key = key

        def keypoints_from_image(self, image, *args, **kwargs):
            seen[self._key] = np.asarray(image)
            return super().keypoints_from_image(image, *args, **kwargs)

    ours = _Http(_ready(DreamInferenceServer(_Recording("port"), base_frame="base"), K, X))
    ref = _Http(_ready(jax_serve.DreamInferenceServer(_Recording("jax"), base_frame="base"), K, X),
                jax_serve.make_http_server)
    try:
        rng = np.random.RandomState(6)
        frame = np.clip(rng.normal(128, 40, (240, 320, 3)), 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, format="JPEG", quality=90)
        got, want = ours.post("/image", buf.getvalue()), ref.post("/image", buf.getvalue())
        assert got == want and got["ok"] and got["pnp"]
        np.testing.assert_array_equal(seen["port"], seen["jax"])
        pose_a, pose_b = ours.get("/pose"), ref.get("/pose")
        assert pose_a["ok"] and pose_b["ok"]
        for key in ("translation", "quaternion_xyzw"):
            np.testing.assert_allclose(pose_a[key], pose_b[key], atol=1e-3, rtol=0)
        code, body = ours.error("POST", "/image", b"GIF89a")
        assert code == 400 and body["ok"] is False and "GIF format" in body["error"]
        assert ours.get("/status")["frames_processed"] == 1
    finally:
        ours.close()
        ref.close()


def test_calibration_holds_no_concurrent_frame():
    """A frame served while calibration runs goes through the float convs
    and adds nothing to the amax."""
    net = DreamNetwork(_vgg_config(), device="cpu")
    server = DreamInferenceServer(net, base_frame="base", int8_calibration_frames=4)
    rng = np.random.RandomState(5)
    frames = [rng.randint(0, 96, (96, 128, 3)).astype(np.uint8) for _ in range(4)]
    bright = np.full((96, 128, 3), 255, np.uint8)  # would raise every amax

    held, release, calibrated = threading.Event(), threading.Event(), {}
    enable = net.enable_int8_inference

    def held_halfway(batches):
        (batch,) = batches

        def frames_one_by_one():
            for i, frame in enumerate(batch.split(1)):
                if i == 2:
                    held.set()
                    assert release.wait(60)
                yield frame

        calibrated["qvars"] = enable(frames_one_by_one())
        return calibrated["qvars"]

    net.enable_int8_inference = held_halfway
    # The calibration's copy of the model inherits these hooks: only the
    # live model's convs are recorded.
    live = {id(m) for m in net.model.modules() if isinstance(m, QuantConv2d)}
    modes_seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: modes_seen.append(m.mode) if id(m) in live else None)
        for m in net.model.modules() if isinstance(m, QuantConv2d)]
    for frame in frames[:3]:
        server.process_image(frame)
    buffered = [net.preprocess(torch.from_numpy(f)[None]) for f in frames]
    modes_seen.clear()

    http = _Http(server)
    try:
        calibrating = threading.Thread(target=server.process_image, args=(frames[3],))
        calibrating.start()
        assert held.wait(60)
        during = http.post("/image", _png(bright))
        assert during["ok"] and server.get_status()["int8"] == "calibrating"
        release.set()
        calibrating.join(60)
    finally:
        http.close()
        for hook in hooks:
            hook.remove()
    assert not calibrating.is_alive()
    assert server.get_status()["int8"] == "active" and server.frames_processed == 5
    assert modes_seen and set(modes_seen) == {"float"}
    batches = [x.permute(0, 3, 1, 2) for x in buffered]
    want = calibrate(copy.deepcopy(net.model), batches)
    got = calibrated["qvars"]
    assert set(got) == set(want)
    for name in want:
        # float32 convs summed by another count of threads: a few ulps.
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5, err_msg=name)
    # The bright frame, had it been calibrated on, moves the amax by far more.
    bright_in = net.preprocess(torch.from_numpy(bright)[None]).permute(0, 3, 1, 2)
    with_bright = calibrate(copy.deepcopy(net.model), batches + [bright_in])
    assert max(abs(float(with_bright[n]) / float(want[n]) - 1.0) for n in want) > 0.01


# --- Parity with dream_tpu's server, over HTTP -------------------------------


@pytest.fixture(scope="module")
def r5_servers():
    """The r5 parameters at a 96x96 net input in both packages, float32."""
    cfg = {
        "manipulator": load_yaml(os.path.join(ROOT, "manip_configs", "panda.yaml"))["manipulator"],
        "architecture": {"type": "vgg", "target": "belief_maps", "input_heads": ["image_rgb"],
                         "output_heads": ["belief_maps"],
                         "image_normalization": {"mean": [0.5] * 3, "stdev": [0.5] * 3},
                         "loss": {"type": "mse"}, "image_preprocessing": "shrink-and-crop",
                         "compute_dtype": "float32"},
        "training": {"config": {"net_input_resolution": [96, 96],
                                "optimizer": {"type": "adam", "learning_rate": 1e-4}}},
    }
    torch_net = DreamNetwork(copy.deepcopy(cfg), device="cpu")
    torch_net.load_network_params(R5_PARAMS)
    jax_net = jax_network.create_network_from_config_data(copy.deepcopy(cfg))
    jax_net.variables = jax.tree_util.tree_map(jnp.asarray, state_to_flax(torch_net.model.state_dict()))
    return torch_net, jax_net


def test_http_json_matches_dream_tpu(r5_servers):
    torch_net, jax_net = r5_servers
    frames = generate_synthetic_frames(3, (160, 120), torch_net.keypoint_names, seed=21,
                                       out_of_frame_fraction=0.0)
    K = frames["camera_K"]
    ours = _Http(DreamInferenceServer(torch_net, base_frame="base"))
    ref = _Http(DreamInferenceServer(jax_net, base_frame="base"), jax_serve.make_http_server)
    published = 0
    try:
        for http in (ours, ref):
            http.post("/camera_info", json.dumps(
                {"fx": K[0, 0], "fy": K[1, 1], "cx": K[0, 2], "cy": K[1, 2]}).encode())
        assert ours.get("/status") == ref.get("/status")
        for image, positions in zip(frames["images"], frames["positions"]):
            body = _png(image)
            results = []
            for http in (ours, ref):
                http.post("/keypoint_positions", json.dumps(positions.tolist()).encode())
                results.append((http.post("/image", body), http.get("/pose"), http.get("/status")))
            (image_a, pose_a, status_a), (image_b, pose_b, status_b) = results
            assert image_a == image_b and status_a == status_b
            assert image_a["n_detected"] >= 4
            published += image_a["pnp"]
            assert pose_a.keys() == pose_b.keys()
            if not pose_b["ok"]:
                assert pose_a == pose_b
                continue
            for key in ("parent_frame", "child_frame", "n_correspondences", "ok"):
                assert pose_a[key] == pose_b[key], key
            for key in ("translation", "quaternion_xyzw"):
                np.testing.assert_allclose(pose_a[key], pose_b[key], atol=1e-3, rtol=0)
                np.testing.assert_allclose(pose_a["camera_from_robot"][key],
                                           pose_b["camera_from_robot"][key], atol=1e-3, rtol=0)
            np.testing.assert_allclose(pose_a["reprojection_error_px"],
                                       pose_b["reprojection_error_px"], rtol=1e-3)
    finally:
        ours.close()
        ref.close()
    assert published >= 2
