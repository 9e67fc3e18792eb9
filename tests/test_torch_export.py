"""The port's ``torch.export`` inference artifacts against dream_tpu's, on
the CPU in float32.

- The four tests of ``tests/test_export.py`` through the port, on
  ``tests/test_network.py::_vgg_config`` (64x64, 4 keypoints, the port's
  initial parameters): the round trip against the live network (found
  state equal, found keypoints within 1e-3 px), the int8 pipeline against
  the live int8 chain (the same), an explicit CPU device (through the
  export CLI with ``--device cpu --self-test``) and the metadata sidecar
  (``dream_tpu``'s keys and values but ``format``); with
  ``--int8-calibration-dir``, the CLI's self-test runs on a calibration
  frame, not on noise.
- Parity: the r5 vgg-Q checkpoint's float32 parameters at a 96x96 net input,
  exported by ``dream_tpu.export`` and by the port for 160x120 frames, agree
  on synthetic frames in found state exactly and on found keypoints to
  1e-3 px.
- The artifact loads and runs in a subprocess that imports torch alone, and
  ``dream_tpu_torch`` never enters its ``sys.modules``.
"""

import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dream_tpu import export as jax_export
from dream_tpu import network as jax_network

from dream_tpu_torch.checkpoint import save_flax_checkpoint, state_to_flax
from dream_tpu_torch.cli import export_inference as export_cli
from dream_tpu_torch.data.synthetic import generate_synthetic_frames, generate_synthetic_ndds
from dream_tpu_torch.export import artifact_metadata, export_inference, load_inference
from dream_tpu_torch.network import DreamNetwork
from dream_tpu_torch.serve import ArtifactInference
from dream_tpu_torch.utils.config import load_yaml, save_yaml
from tests.test_network import _vgg_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R5_PARAMS = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.msgpack")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def initial_network():
    """``_vgg_config``'s network with its initial parameters (seed 0), built
    once: the draws take seconds.  Each test takes a copy."""
    return DreamNetwork(_vgg_config(), device="cpu")


def _live_raw_keypoints(net, frames):
    """The per-frame live pipeline: the contract the artifact reproduces."""
    return np.stack([net.keypoints_from_image(f)["detected_keypoints"] for f in frames])


def _assert_same_detections(got, want):
    got = np.asarray(got, dtype=float)
    detected = want > -999.0
    np.testing.assert_array_equal(got > -999.0, detected)
    np.testing.assert_allclose(got[detected], want[detected], atol=1e-3, rtol=0)


def test_export_roundtrip_matches_live_network(initial_network):
    net = copy.deepcopy(initial_network)
    data = export_inference(net, raw_resolution=(128, 96), batch_size=2)
    assert isinstance(data, bytes) and len(data) > 1000
    call = load_inference(data)
    frames = np.random.RandomState(0).randint(0, 255, size=(2, 96, 128, 3)).astype(np.uint8)
    with torch.no_grad():
        belief, kps = call(torch.from_numpy(frames))
    assert tuple(belief.shape) == (2, 4, 16, 16) and belief.dtype == torch.float32
    _assert_same_detections(kps.numpy(), _live_raw_keypoints(net, frames))


def test_export_int8_pipeline(initial_network):
    net = copy.deepcopy(initial_network)
    rng = np.random.RandomState(1)
    net.enable_int8_inference([torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))])
    data = export_inference(net, raw_resolution=(128, 96), batch_size=1)
    call = load_inference(data)
    frames = rng.randint(0, 255, size=(1, 96, 128, 3)).astype(np.uint8)
    with torch.no_grad():
        belief, kps = call(torch.from_numpy(frames))
    # The live int8 chain (plain convs on the CPU, the kernel on the card).
    live_belief = net.inference(net.preprocess(torch.from_numpy(frames)))[0]
    assert torch.equal(belief, live_belief)
    _assert_same_detections(kps.numpy(), _live_raw_keypoints(net, frames))


def test_export_cpu_device_explicit(initial_network, tmp_path, capsys):
    """The export CLI on ``--device cpu``: a loadable CPU artifact, its
    sidecar, and the self-test against the live network."""
    cfg = _vgg_config()
    cfg["architecture"]["compute_dtype"] = "float32"
    net = initial_network  # its parameters; float32, as the config says
    params, config = str(tmp_path / "net.msgpack"), str(tmp_path / "net.yaml")
    save_flax_checkpoint(params, state_to_flax(net.model.state_dict()))
    save_yaml(cfg, config)
    out = str(tmp_path / "net.pt2")
    export_cli.main(["-i", params, "-o", out, "-b", "1", "--raw-resolution", "64x64",
                     "--device", "cpu", "--self-test"])
    assert "self-test OK" in capsys.readouterr().out
    adapter = ArtifactInference(out, device="cpu")
    assert adapter.device == torch.device("cpu") and adapter.keypoint_names == net.keypoint_names
    with open(out, "rb") as f:
        call = load_inference(f.read())
    with torch.no_grad():
        _, kps = call(torch.zeros((1, 64, 64, 3), dtype=torch.uint8))
    assert tuple(kps.shape) == (1, 4, 2) and kps.device == torch.device("cpu")
    if not torch.cuda.is_available():  # the default device is the card: no fallback
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            export_cli.main(["-i", params, "-o", out, "-b", "1", "--raw-resolution", "64x64"])


def test_export_cli_int8_self_test_on_calibration_frames(initial_network, tmp_path, capsys):
    """With ``--int8-calibration-dir`` at the artifact's resolution, the
    self-test holds the int8 artifact against the live int8 network on a
    frame of that dataset."""
    cfg = _vgg_config()
    cfg["architecture"]["compute_dtype"] = "float32"
    net = initial_network  # its parameters; float32, as the config says
    params, config = str(tmp_path / "net.msgpack"), str(tmp_path / "net.yaml")
    save_flax_checkpoint(params, state_to_flax(net.model.state_dict()))
    save_yaml(cfg, config)
    data_dir = generate_synthetic_ndds(str(tmp_path / "ndds"), n_frames=3, image_resolution=(64, 64),
                                       keypoint_names=net.keypoint_names, seed=3)
    out = str(tmp_path / "net_int8.pt2")
    export_cli.main(["-i", params, "-o", out, "-b", "2", "--raw-resolution", "64x64", "--device", "cpu",
                     "--int8-calibration-dir", data_dir, "--int8-calibration-frames", "2",
                     "--self-test"])
    text = capsys.readouterr().out
    assert "self-test on a calibration frame" in text and "self-test OK" in text
    with open(out + ".meta.json") as f:
        assert json.load(f)["int8"] is True


def test_artifact_metadata_sidecar(initial_network, tmp_path):
    cfg = _vgg_config()
    net = copy.deepcopy(initial_network)
    meta = artifact_metadata(net, (128, 96), 1)
    ref = jax_export.artifact_metadata(jax_network.DreamNetwork(copy.deepcopy(cfg)), (128, 96), 1)
    assert meta.keys() == ref.keys()
    assert meta["format"] == "dream_tpu_torch.export.v1" and ref["format"] == "dream_tpu.jaxexport.v1"
    assert {k: v for k, v in meta.items() if k != "format"} == {
        k: v for k, v in ref.items() if k != "format"}
    assert meta["keypoint_names"] == [f"kp{i}" for i in range(4)]
    assert meta["input"]["shape"] == [1, 96, 128, 3] and meta["int8"] is False
    assert meta["int8_impl"] is None

    artifact = tmp_path / "net.pt2"
    artifact.write_bytes(export_inference(net, raw_resolution=(128, 96), batch_size=1))
    (tmp_path / "net.pt2.meta.json").write_text(json.dumps(meta))
    adapter = ArtifactInference(str(artifact))  # names from the sidecar
    assert adapter.keypoint_names == meta["keypoint_names"]
    assert adapter.friendly_keypoint_names == ["KP0", "KP1", "KP2", "KP3"]
    net.enable_int8_inference([torch.zeros((1, 64, 64, 3))])
    int8_meta = artifact_metadata(net, (128, 96), 1)
    assert int8_meta["int8"] is True and int8_meta["int8_impl"] == "xla_chain"


@pytest.fixture(scope="module")
def r5_artifacts(tmp_path_factory):
    """The r5 parameters at a 96x96 net input, exported by both packages for
    160x120 frames at batch 2, and frames the r5 parameters find keypoints on."""
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
    net = DreamNetwork.from_checkpoint(copy.deepcopy(cfg), R5_PARAMS, device="cpu")
    jax_net = jax_network.create_network_from_config_data(copy.deepcopy(cfg))
    jax_net.variables = jax.tree_util.tree_map(jnp.asarray, state_to_flax(net.model.state_dict()))
    path = tmp_path_factory.mktemp("export") / "r5.pt2"
    path.write_bytes(export_inference(net, raw_resolution=(160, 120), batch_size=2))
    frames = generate_synthetic_frames(2, (160, 120), net.keypoint_names, seed=23,
                                       out_of_frame_fraction=0.0)["images"]
    return {"net": net, "path": str(path),
            "jax_call": jax_export.load_inference(jax_export.export_inference(
                jax_net, raw_resolution=(160, 120), batch_size=2)),
            "frames": frames}


def test_export_matches_dream_tpu_artifact(r5_artifacts):
    frames = r5_artifacts["frames"]
    with open(r5_artifacts["path"], "rb") as f:
        call = load_inference(f.read())
    with torch.no_grad():
        belief, kps = call(torch.from_numpy(frames))
    ref_belief, ref_kps = r5_artifacts["jax_call"](frames)
    ref_kps = np.asarray(ref_kps, dtype=float)
    assert (ref_kps > -999.0).all(-1).sum() >= 8  # most of the 14 keypoints found
    _assert_same_detections(kps.numpy(), ref_kps)
    np.testing.assert_allclose(belief.numpy(), np.asarray(ref_belief), atol=1e-4, rtol=0)


def test_artifact_runs_where_only_torch_is_imported(r5_artifacts, tmp_path):
    frames_path = str(tmp_path / "frames.npy")
    np.save(frames_path, r5_artifacts["frames"])
    script = (
        "import json, sys\n"
        "import numpy as np\n"
        "import torch\n"
        f"program = torch.export.load({r5_artifacts['path']!r})\n"
        "with torch.no_grad():\n"
        f"    belief, kps = program.module()(torch.from_numpy(np.load({frames_path!r})))\n"
        "assert not any(m.split('.')[0] in ('dream_tpu_torch', 'dream_tpu', 'jax') "
        "for m in sys.modules), sorted(sys.modules)\n"
        "print(json.dumps(kps.tolist()))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path), env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    kps = np.asarray(json.loads(out.stdout.strip().splitlines()[-1]))
    _assert_same_detections(kps, _live_raw_keypoints(r5_artifacts["net"], r5_artifacts["frames"]))
