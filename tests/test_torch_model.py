"""The port's vgg-Q model and inference facade against dream_tpu on the CPU.

Both packages load the committed flagship checkpoint
(trained_models/results_r5/vggq) at full width and run float32 (both
sides set compute_dtype to float32 in the loaded config dict; the sidecar
says bfloat16).  The input is 128x128, so the belief maps
are 32x32.  The two differ only in convolution summation order: belief
values agree to 1e-4 (they range over about [-0.1, 1]) and keypoints, decoded
from those maps, to 1e-3 px in the net-output frame.  ``keypoints_from_image``
runs both on one rendered 640x480 frame and holds the raw-frame keypoints to
0.01 px.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from dream_tpu.network import create_network_from_config_data
from dream_tpu.utils.config import load_yaml as jax_load_yaml

from dream_tpu_torch.data.synthetic import generate_synthetic_frames
from dream_tpu_torch.network import DreamNetwork
from dream_tpu_torch.utils.config import load_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.yaml")
PARAMS = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.msgpack")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing
    and slow the other test workers: two threads take less CPU time than
    the machine's count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def jax_network():
    """dream_tpu's float32 vgg-Q network with the committed weights, cast to
    float32 as ``load_network_params`` casts them, without that method's
    full-size ``init`` trace (the restored tree is the same)."""
    cfg = jax_load_yaml(CONFIG)
    cfg["architecture"]["compute_dtype"] = "float32"
    net = create_network_from_config_data(cfg)
    with open(PARAMS, "rb") as f:
        restored = serialization.msgpack_restore(f.read())
    net.variables = jax.tree_util.tree_map(lambda leaf: jnp.asarray(leaf, jnp.float32), restored)
    return net


def torch_network():
    """The port's float32 vgg-Q network with the committed weights."""
    cfg = load_yaml(CONFIG)
    cfg["architecture"]["compute_dtype"] = "float32"
    net = DreamNetwork(cfg, device="cpu")
    net.load_network_params(PARAMS)
    return net


@pytest.fixture(scope="module")
def networks():
    return jax_network(), torch_network()


def test_model_and_inference_match_jax(networks):
    jax_net, torch_net = networks
    x = np.random.RandomState(0).uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    ref_belief, ref_kp = jax_net.inference(x)
    belief, kp = torch_net.inference(torch.from_numpy(x))
    assert belief.shape == (2, 7, 32, 32) and kp.shape == (2, 7, 2)
    np.testing.assert_allclose(belief.numpy(), np.asarray(ref_belief), atol=1e-4, rtol=0)
    np.testing.assert_allclose(kp.numpy(), np.asarray(ref_kp), atol=1e-3, rtol=0)


def test_keypoints_from_image_matches_jax(networks):
    jax_net, torch_net = networks
    frames = generate_synthetic_frames(1, (640, 480), seed=7)
    ref = jax_net.keypoints_from_image(frames["images"][0], debug=True)
    ours = torch_net.keypoints_from_image(frames["images"][0], debug=True)
    np.testing.assert_allclose(ours["detected_keypoints"], ref["detected_keypoints"], atol=1e-2)
    np.testing.assert_allclose(
        ours["detected_keypoints_net_output"], ref["detected_keypoints_net_output"], atol=2e-3
    )
    np.testing.assert_allclose(
        ours["belief_maps"].numpy(), np.asarray(ref["belief_maps"]), atol=1e-4
    )
    assert isinstance(ours["image_rgb_net_input"], torch.Tensor)


def test_network_config_and_geometry(networks):
    jax_net, torch_net = networks
    assert torch_net.keypoint_names == jax_net.keypoint_names
    assert torch_net.trained_net_output_resolution() == jax_net.trained_net_output_resolution()
    assert torch_net.peak_offset_due_to_upsampling() == jax_net.peak_offset_due_to_upsampling()
    for raw in [(640, 480), (1280, 720)]:
        assert torch_net.net_resolutions_from_image_raw_resolution(raw) == \
            jax_net.net_resolutions_from_image_raw_resolution(raw)


def test_entry_points_need_cuda_unless_cpu_is_asked():
    cfg = load_yaml(CONFIG)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal applies where it has none")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DreamNetwork(cfg)


@pytest.mark.parametrize(
    "override",
    [{"spatial_softmax": {"learned_beta": True, "initial_beta": 1.0}}, "int8 of vgg-F",
     {"quant_mode": "int8"}],
)
def test_unported_architectures_are_refused(override, monkeypatch):
    """What the port refuses: ``quant_mode: int8`` in a config (as
    dream_tpu); a ``spatial_softmax`` block without the ``keypoints`` output
    head (dream_tpu asserts it); vgg-Q's int8 chain asked for by name on
    vgg-F, which the chain cannot take (dream_tpu falls back to its
    quantconv graph; the port raises, and takes vgg-F's int8 through the
    quantconv graph when not asked for the chain)."""
    cfg = load_yaml(CONFIG)
    if override == "int8 of vgg-F":
        cfg["architecture"]["deconv_decoder"] = True
        cfg["training"]["config"]["net_input_resolution"] = [64, 64]
        del cfg["training"]["config"]["net_output_resolution"]
        net = DreamNetwork(cfg, device="cpu")
        monkeypatch.setenv("DREAM_INT8_IMPL", "xla_chain")
        with pytest.raises(ValueError, match="cannot take"):
            net.enable_int8_inference([torch.zeros(1, 64, 64, 3)])
        monkeypatch.delenv("DREAM_INT8_IMPL")
        net.enable_int8_inference([torch.zeros(1, 64, 64, 3)])
        assert net.int8_impl == "quantconv"
        return
    cfg["architecture"].update(override)
    with pytest.raises(ValueError if "spatial_softmax" in override else NotImplementedError):
        DreamNetwork(cfg, device="cpu")
