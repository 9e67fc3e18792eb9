"""The port's single-image and video CLIs against dream_tpu's, on the CPU.

The r5 vgg-Q parameters at a 96x96 net input in float32 (seeded parameters
find almost no keypoint) on 160x120 synthetic NDDS frames that dream_tpu
wrote.  dream_tpu's scripts run on a network built from the same
parameters (``tests/test_torch_cli.py``'s ``jax_net_with``: no flax init).

- ``network_inference``: the same five files, of the same sizes; each of
  the port's files equals dream_tpu's drawing of the port's own detection
  (``keypoints_raw.png`` but for the keypoint names, held to
  ``tests/test_torch_visualize.py``'s text bound); the two packages'
  detections agree within 1e-3 px, on the PNG frame and on a JPEG copy of
  it; a truncated JPEG raises.
- ``visualize_network_inference``, NDDS path (as
  ``tests/test_cli_tools.py``'s video test: frames 1-4 of 5, batch 2, all
  four types, no ffmpeg here): the same frame files as dream_tpu's script,
  of the same sizes; each frame equal to dream_tpu's ``_save_frame`` fed
  the port's inputs (no text is drawn); green ground truth on the raw
  overlay; with ``--int8-calibration-frames 2`` too (the port only).
  The image-directory path writes its frames; a JPEG among them gives
  dream_tpu's frame and detections, and a truncated one raises.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from dream_tpu import visualize as jviz
from dream_tpu.data.synthetic import generate_synthetic_ndds as jax_generate_synthetic_ndds

from dream_tpu_torch.checkpoint import load_flax_checkpoint
from dream_tpu_torch.cli import network_inference as ni
from dream_tpu_torch.cli import visualize_network_inference as vni
from dream_tpu_torch.network import DreamNetwork
from dream_tpu_torch.utils.png import read_png, write_png
from tests.test_torch_cli import R5_PARAMS, jax_net_with, network_config
from tests.test_torch_visualize import assert_equal_but_names

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import network_inference as jax_ni  # noqa: E402  (scripts/network_inference.py)
import visualize_network_inference as jax_vni  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("viz_cli")
    data = str(root / "data")
    jax_generate_synthetic_ndds(data, n_frames=5, image_resolution=(160, 120), seed=4,
                                out_of_frame_fraction=0.0)
    net = DreamNetwork(network_config(), device="cpu")
    net.load_network_params(R5_PARAMS)
    net.save_network(str(root), "net")
    params = str(root / "net.msgpack")
    jax_net = jax_net_with(network_config(), load_flax_checkpoint(params))
    return {"root": root, "data": data, "params": params, "jax_net": jax_net}


def _png(path):
    return np.asarray(Image.open(path).convert("RGB"))


def test_network_inference_matches_jax(env, monkeypatch):
    frame = os.path.join(env["data"], "000002.rgb.png")
    ours_dir, ref_dir = str(env["root"] / "ni_port"), str(env["root"] / "ni_jax")
    ours = ni.network_inference(ni.make_parser().parse_args(
        ["-i", env["params"], "-m", frame, "-o", ours_dir, "--device", "cpu"]))
    monkeypatch.setattr(jax_ni, "create_network_from_config_file", lambda *a: env["jax_net"])
    ref = jax_ni.network_inference(type("Args", (), dict(
        input_params_path=env["params"], network_config=None, image_path=frame, output_dir=ref_dir)))

    files = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(ours_dir)) == files and len(files) == 5
    sizes = {"keypoints_raw.png": (120, 160), "keypoints_net_input.png": (96, 96),
             "belief_maps.png": (24, 7 * 24 + 6 * 10), "belief_blends.png": (96, 7 * 96),
             "keypoints_vs_gt.png": (120, 160)}
    for f in files:
        assert read_png(os.path.join(ours_dir, f)).shape == _png(os.path.join(ref_dir, f)).shape \
            == sizes[f] + (3,), f

    kp_raw = ours["detected_keypoints"]
    found = kp_raw[:, 0] > -999.0
    assert found.sum() >= 4
    np.testing.assert_array_equal(np.asarray(ref["detected_keypoints"])[:, 0] > -999.0, found)
    np.testing.assert_allclose(kp_raw[found], np.asarray(ref["detected_keypoints"])[found], atol=1e-3)

    # dream_tpu's drawing of the port's own detection.
    image = _png(frame)
    names = env["jax_net"].friendly_keypoint_names
    net_in = jviz.image_from_tensor(ours["image_rgb_net_input"].numpy(), env["jax_net"].image_normalization)
    maps = ours["belief_maps"].numpy()
    gt = np.asarray(jax_ni.load_keypoints(os.path.join(env["data"], "000002.json"), "panda",
                                          env["jax_net"].keypoint_names)["projections"])
    expected = {
        "keypoints_net_input.png": jviz.overlay_points_on_image(
            net_in, ours["detected_keypoints_net_input"], annotation_color_dot="red"),
        "belief_maps.png": jax_ni.generate_belief_map_visualizations(
            maps, ours["detected_keypoints_net_output"]),
        "belief_blends.png": jviz.mosaic_images([jviz.blend_belief_overlay(net_in, m) for m in maps],
                                                rows=1, cols=len(maps)),
        "keypoints_vs_gt.png": jviz.overlay_points_on_image(
            jviz.overlay_points_on_image(image, gt, annotation_color_dot="green"), kp_raw,
            annotation_color_dot="red"),
    }
    for f, want in expected.items():
        np.testing.assert_array_equal(read_png(os.path.join(ours_dir, f)), np.asarray(want), err_msg=f)
    assert_equal_but_names(read_png(os.path.join(ours_dir, "keypoints_raw.png")),
                           np.asarray(jviz.overlay_points_on_image(image, kp_raw, names)),
                           image, kp_raw, names)

    # A real JPEG frame (formerly NotImplementedError): the two packages'
    # detections agree as on the PNG; a truncated JPEG still raises.
    jpeg = str(env["root"] / "frame.jpg")
    Image.open(frame).save(jpeg, quality=90)
    ours = ni.network_inference(ni.make_parser().parse_args(["-i", env["params"], "-m", jpeg,
                                                             "--device", "cpu"]))
    ref = jax_ni.network_inference(type("Args", (), dict(
        input_params_path=env["params"], network_config=None, image_path=jpeg, output_dir=None)))
    kp_raw, ref_kp = ours["detected_keypoints"], np.asarray(ref["detected_keypoints"])
    found = kp_raw[:, 0] > -999.0
    assert found.sum() >= 4
    np.testing.assert_array_equal(ref_kp[:, 0] > -999.0, found)
    np.testing.assert_allclose(kp_raw[found], ref_kp[found], atol=1e-3)
    truncated = str(env["root"] / "truncated.jpg")
    with open(truncated, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0" + bytes(64))
    with pytest.raises(ValueError, match="JPEG"):
        ni.network_inference(ni.make_parser().parse_args(["-i", env["params"], "-m", truncated,
                                                          "--device", "cpu"]))


def _video_args(env, out_dir, int8_frames=0, dataset=None, types=None):
    return vni.make_parser().parse_args(
        ["-i", env["params"], "-d", dataset or env["data"], "-o", out_dir, "-f", "-b", "2", "-w", "2",
         "-s", "1", "--int8-calibration-frames", str(int8_frames), "--device", "cpu",
         "-t"] + (types or list(vni.ALL_VIZ_TYPES)))


@pytest.mark.parametrize("int8_frames", [0, 2])
def test_visualize_network_inference_ndds_matches_jax(env, monkeypatch, int8_frames):
    ours_dir = str(env["root"] / f"vni_port_{int8_frames}")
    summary = vni.visualize_network_inference(_video_args(env, ours_dir, int8_frames))
    assert summary["frames"] == 4 and set(summary["seconds_by_type"]) == set(vni.ALL_VIZ_TYPES)
    if shutil.which("ffmpeg") is None:
        assert not any(summary["videos"].values())
    for vt in vni.ALL_VIZ_TYPES:
        assert sorted(os.listdir(os.path.join(ours_dir, vt + "_frames"))) == [
            f"{i:06d}.png" for i in range(4)], vt
    raw0 = read_png(os.path.join(ours_dir, "kp_overlay_raw_frames", "000000.png"))
    assert ((raw0[..., 0] == 0) & (raw0[..., 1] == 128) & (raw0[..., 2] == 0)).any()
    if int8_frames:
        return

    ref_dir = str(env["root"] / "vni_jax")
    monkeypatch.setattr(jax_vni, "create_network_from_config_file", lambda *a: env["jax_net"])
    jax_vni.visualize_network_inference(type("Args", (), dict(
        input_params_path=env["params"], network_config=None, dataset_dir=env["data"],
        output_dir=ref_dir, force_overwrite=True, visualization_types=list(vni.ALL_VIZ_TYPES),
        batch_size=2, num_workers=2, fps=30.0, start_frame=1, end_frame=None,
        int8_calibration_frames=0)))
    # dream_tpu's _save_frame fed the port's inputs, frame by frame.
    drawn_dir = env["root"] / "vni_jax_drawn"
    dirs = {vt: str(drawn_dir / vt) for vt in vni.ALL_VIZ_TYPES}
    for d in dirs.values():
        os.makedirs(d)
    net = DreamNetwork(network_config(), device="cpu")
    net.load_network_params(env["params"])
    for idx, frame in enumerate(vni._ndds_frames(net, env["data"], 1, None, 2, 2)):
        frame["raw_image"] = Image.fromarray(frame["raw_image"])
        frame["net_in_img"] = Image.fromarray(frame["net_in_img"])
        jax_vni._save_frame(vni.ALL_VIZ_TYPES, dirs, f"{idx:06d}.png", **frame)
    for vt in vni.ALL_VIZ_TYPES:
        names = sorted(os.listdir(os.path.join(ref_dir, vt + "_frames")))
        assert sorted(os.listdir(os.path.join(ours_dir, vt + "_frames"))) == names
        for name in names:
            ours = read_png(os.path.join(ours_dir, vt + "_frames", name))
            assert ours.shape == _png(os.path.join(ref_dir, vt + "_frames", name)).shape
            np.testing.assert_array_equal(ours, _png(os.path.join(dirs[vt], name)), err_msg=f"{vt} {name}")


def test_visualize_network_inference_image_dir(env):
    frames_dir = env["root"] / "frames"
    frames_dir.mkdir()
    for i in range(3):
        write_png(str(frames_dir / f"f{i}.png"), read_png(os.path.join(env["data"], f"00000{i}.rgb.png")))
    out = str(env["root"] / "vni_dir")
    summary = vni.visualize_network_inference(_video_args(
        env, out, dataset=str(frames_dir), types=["kp_overlay_net_input", "belief_overlay_raw"]))
    assert summary["frames"] == 2
    assert sorted(os.listdir(os.path.join(out, "belief_overlay_raw_frames"))) == ["000000.png", "000001.png"]
    assert read_png(os.path.join(out, "kp_overlay_net_input_frames", "000001.png")).shape == (96, 96, 3)
    # A real JPEG among the frames (formerly NotImplementedError): its
    # frame and detections as dream_tpu's image-directory path gives them;
    # a truncated JPEG still raises.
    Image.open(os.path.join(env["data"], "000003.rgb.png")).save(frames_dir / "f3.jpg", quality=90)
    net = DreamNetwork(network_config(), device="cpu")
    net.load_network_params(env["params"])
    ours = list(vni._image_dir_frames(net, str(frames_dir), 3, None))
    ref = list(jax_vni._image_dir_frames(env["jax_net"], str(frames_dir), 3, None))
    assert len(ours) == len(ref) == 1
    np.testing.assert_array_equal(ours[0]["raw_image"], np.asarray(ref[0]["raw_image"]))
    found = ours[0]["kp_raw"][:, 0] > -999.0
    assert found.sum() >= 4
    np.testing.assert_array_equal(np.asarray(ref[0]["kp_raw"])[:, 0] > -999.0, found)
    np.testing.assert_allclose(ours[0]["kp_raw"][found], np.asarray(ref[0]["kp_raw"])[found], atol=1e-3)
    summary = vni.visualize_network_inference(_video_args(
        env, out, dataset=str(frames_dir), types=["kp_overlay_raw"]))
    assert summary["frames"] == 3
    with open(frames_dir / "f4.jpg", "wb") as f:
        f.write(b"\xff\xd8\xff\xe0" + bytes(64))
    with pytest.raises(ValueError, match="JPEG"):
        vni.visualize_network_inference(_video_args(env, out, dataset=str(frames_dir)))
