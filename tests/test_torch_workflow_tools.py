"""The port's remaining workflow tools against dream_tpu's scripts, on the CPU.

- ``resolve_pnp``: a ``keypoints.csv`` (ground truth of 8 synthetic
  160x120 frames dream_tpu wrote, with 1.5 px noise and missing keypoints
  in three frames, four in one, which PnP cannot solve) re-solved by the
  port's CLI and by ``scripts/resolve_pnp.py``, plain, and the same with a
  60 px outlier in two frames with ``--pnp-reject-outliers-px 10`` (the
  plain solve of an outlier frame has near-equal minima the two packages
  may choose between, as ``tests/test_torch_pnp_modes.py`` says):
  ``pnp_results.csv``
  equal in names, successes and in-frame counts, poses within 1e-3 (the
  tolerance of ``tests/test_torch_pnp_metrics.py``) and ADD within 1e-4;
  ``pnp_resolve_results.txt`` equal line for line, its numbers within
  1e-3.  Every valid frame keeps six good points, where neither package's
  PnP starts decide the pose (ROADMAP.md section 3).
- ``compress_checkpoint``: the port's file equals ``scripts/
  compress_checkpoint.py``'s byte for byte (flax's writer keeps the sorted
  key order it read, which is the port's), and its sidecar is copied.
- ``convert_torch_weights``: the trees ``scripts/convert_torch_weights.py``
  builds from state dicts of ``tests/test_weight_conversion.py``'s torch
  twins (a single-stage hourglass, the same with the ``module.`` prefix, a
  two-stage one, ResnetSimple half and full) equal leaf for leaf; the
  port's hourglass and ResnetSimple load them and reproduce the twins'
  outputs; the CLI writes a file the port's reader restores to that tree.
- ``train_network_multi -n 2``: ``train_0`` and ``train_1``, each with
  ``best_network`` and its training log, on a 16-frame 96x96 set (net
  input 32x32).
- ``create_network_from_config_data`` builds what the file route builds
  from the same config.
"""

import copy
import csv
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from dream_tpu.data.synthetic import generate_synthetic_ndds as jax_generate_synthetic_ndds

from dream_tpu_torch.analysis import write_keypoint_csv
from dream_tpu_torch.checkpoint import load_flax_checkpoint, msgpack_restore, params_from_flax, state_from_flax
from dream_tpu_torch.cli import compress_checkpoint as compress_cli
from dream_tpu_torch.cli import convert_torch_weights as convert_cli
from dream_tpu_torch.cli import resolve_pnp as resolve_cli
from dream_tpu_torch.cli import train_network_multi as multi_cli
from dream_tpu_torch.models import DreamHourglass, DreamHourglassMultiStage, ResnetSimple
from dream_tpu_torch.network import (
    DreamNetwork,
    create_network_from_config_data,
    create_network_from_config_file,
)
from dream_tpu_torch.utils import ndds
from dream_tpu_torch.utils.config import load_yaml, save_yaml
from tests.test_torch_cli import ARCH, MANIP, network_config
from tests.test_weight_conversion import _add_full_decoder, _torch_hourglass, _torch_resnet_simple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import compress_checkpoint as jax_compress  # noqa: E402  (scripts/compress_checkpoint.py)
import convert_torch_weights as jax_convert  # noqa: E402
import resolve_pnp as jax_resolve  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    root = tmp_path_factory.mktemp("resolve")
    data = str(root / "data")
    jax_generate_synthetic_ndds(data, n_frames=8, image_resolution=(160, 120), seed=31,
                                out_of_frame_fraction=0.0)
    names = [kp["name"] for kp in load_yaml(MANIP)["manipulator"]["keypoints"]]
    frames, _ = ndds.find_ndds_data_in_dir(data)
    gt = np.stack([np.asarray(ndds.load_keypoints(f["data_path"], "panda", names)["projections"])
                   for f in frames]).astype(np.float32)
    rng = np.random.RandomState(2)
    detected = gt + rng.normal(0, 1.5, gt.shape).astype(np.float32)
    detected[1, 2] = detected[4, [0, 3, 5, 6]] = detected[6, 4] = -999.99
    with_outliers = detected.copy()
    with_outliers[3, 5] += 60.0
    with_outliers[7, 1] -= 60.0
    out = {}
    for mode, reject, kp in (("plain", None, detected), ("reject10", 10.0, with_outliers)):
        csv_path = str(root / f"keypoints_{mode}.csv")
        write_keypoint_csv(csv_path, [f["name"] for f in frames], kp, gt)
        common = dict(keypoints_csv=csv_path, dataset_dir=data, manipulator_config=MANIP,
                      ransac=False, pnp_reject_outliers_px=reject, rotation_convention="standard")
        ours_dir, ref_dir = str(root / f"port_{mode}"), str(root / f"jax_{mode}")
        resolve_cli.resolve_pnp(type("Args", (), dict(common, output_dir=ours_dir, device="cpu")))
        jax_resolve.resolve_pnp(type("Args", (), dict(common, output_dir=ref_dir)))
        out[mode] = (ours_dir, ref_dir)
    return out


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _numbers(line):
    words = line.replace("(", " ").replace(")", " ").replace("/", " ").replace("%", " ").split()
    return [w for w in words if not _is_number(w)], [float(w) for w in words if _is_number(w)]


def _is_number(word):
    try:
        float(word)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("mode", ["plain", "reject10"])
def test_resolve_pnp_matches_the_script(solved, mode):
    ours_dir, ref_dir = solved[mode]
    ours, ref = (_csv_rows(os.path.join(d, "pnp_results.csv")) for d in (ours_dir, ref_dir))
    assert ours[0] == ref[0] and len(ours) == len(ref) == 9
    valid = 0
    for a, b in zip(ours[1:], ref[1:]):
        assert a[0] == b[0] and a[1] == b[1] and a[-1] == b[-1], (a, b)
        valid += a[1] == "True"
        np.testing.assert_allclose(np.float64(a[2:9]), np.float64(b[2:9]), atol=1e-3, rtol=0, err_msg=a[0])
        np.testing.assert_allclose(float(a[9]), float(b[9]), atol=1e-4, rtol=0, err_msg=a[0])
    assert valid == 7
    with open(os.path.join(ours_dir, "pnp_resolve_results.txt")) as f:
        ours_lines = f.read().splitlines()
    with open(os.path.join(ref_dir, "pnp_resolve_results.txt")) as f:
        ref_lines = f.read().splitlines()
    assert len(ours_lines) == len(ref_lines) == 13
    for a, b in zip(ours_lines[2:], ref_lines[2:]):
        (words_a, nums_a), (words_b, nums_b) = _numbers(a), _numbers(b)
        assert words_a == words_b, (a, b)
        np.testing.assert_allclose(nums_a, nums_b, atol=1e-3, rtol=0, err_msg=a)


def test_compress_checkpoint_matches_the_script(tmp_path, monkeypatch):
    net = DreamNetwork(network_config(net_in=64), device="cpu")
    net.save_network(str(tmp_path), "net")
    src = str(tmp_path / "net.msgpack")
    ours, ref = str(tmp_path / "port16.msgpack"), str(tmp_path / "jax16.msgpack")
    compress_cli.main([src, ours])
    monkeypatch.setattr(sys, "argv", ["compress_checkpoint.py", src, ref])
    jax_compress.main()
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    with open(tmp_path / "port16.yaml") as a, open(tmp_path / "net.yaml") as b:
        assert a.read() == b.read()
    tree = load_flax_checkpoint(ours)
    assert tree["params"]["down1"]["conv0"]["kernel"].dtype == np.float16
    reloaded = DreamNetwork(network_config(net_in=64), device="cpu")
    reloaded.load_network_params(ours)
    for name, t in reloaded.model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), net.model.state_dict()[name].numpy().astype(np.float16)
                                      .astype(np.float32), err_msg=name)


def _assert_same_tree(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for key in a:
            _assert_same_tree(a[key], b[key], f"{path}/{key}")
        return
    assert np.asarray(a).dtype == np.asarray(b).dtype, path
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


@pytest.mark.parametrize("case", ["hourglass", "module_prefix", "multistage", "resnet_half", "resnet_full"])
def test_convert_torch_weights_matches_the_script(case, tmp_path):
    torch.manual_seed(3)
    layers = (1, 1, 1, 1)
    size = 64 if case.startswith("resnet") else 32
    x = np.random.RandomState(4).rand(1, 3, size, size).astype(np.float32)
    if case.startswith("resnet"):
        twin = _torch_resnet_simple(n_keypoints=2, layers=layers)
        if case == "resnet_full":
            twin = _add_full_decoder(twin, n_keypoints=2)
        twin.eval()
        ours, ref = (f(twin.state_dict(), layers=layers) for f in (convert_cli.convert_resnet,
                                                                      jax_convert.convert_resnet))
        port = ResnetSimple(n_keypoints=2, layers=layers, full=case == "resnet_full")
        port.load_state_dict(state_from_flax(ours), strict=True)
    elif case == "multistage":
        stages = [_torch_hourglass(n_keypoints=3), _torch_hourglass(n_keypoints=3, in_channels=6)]
        sd = {f"stage{i + 1}.{k}": v for i, s in enumerate(stages) for k, v in s.state_dict().items()}
        ours, ref = convert_cli.convert_vgg(sd), jax_convert.convert_vgg(sd)
        port = DreamHourglassMultiStage(n_keypoints=3, n_stages=2)
        port.load_state_dict(params_from_flax(ours), strict=True)
        twin = None
    else:
        twin = _torch_hourglass(n_keypoints=3)
        sd = twin.state_dict()
        if case == "module_prefix":
            sd = {"module." + k: v for k, v in sd.items()}
        ours, ref = convert_cli.convert_vgg(sd), jax_convert.convert_vgg(sd)
        port = DreamHourglass(n_keypoints=3)
        port.load_state_dict(params_from_flax(ours), strict=True)
    _assert_same_tree(ours, ref)
    if twin is not None:
        port.eval()
        with torch.no_grad():
            want = twin(torch.from_numpy(x)).numpy()
            got = port(torch.from_numpy(x))
        got = (got[0] if isinstance(got, list) else got).numpy()
        np.testing.assert_allclose(got, want, atol=3e-4, rtol=0)
    if case == "module_prefix":
        pth, out = str(tmp_path / "net.pth"), str(tmp_path / "net.msgpack")
        torch.save(sd, pth)
        convert_cli.main(["-i", pth, "-a", "vgg", "-o", out])
        with open(out, "rb") as f:
            _assert_same_tree(msgpack_restore(f.read()), ref)


def test_train_network_multi_writes_each_instance(tmp_path, monkeypatch):
    data = str(tmp_path / "data")
    jax_generate_synthetic_ndds(data, n_frames=16, image_resolution=(96, 96), seed=11,
                                out_of_frame_fraction=0.0)
    arch = str(tmp_path / "arch.yaml")
    save_yaml({"architecture": ARCH, "training": {"config": {
        "image_preprocessing": "shrink-and-crop", "net_input_resolution": [32, 32]}}}, arch)
    # The instances are processes of their own: two torch threads each.
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    out = str(tmp_path / "multi")
    args = multi_cli.make_parser().parse_args(
        ["-n", "2", "-o", out, "-c", f"-i {data} -m {MANIP} -ar {arch} -e 1 -b 8 -s 5 -not-a "
                                     "-w 0 --device cpu"])
    assert multi_cli.train_network_multi(args) == [os.path.join(out, "train_0"), os.path.join(out, "train_1")]
    for n in range(2):
        files = set(os.listdir(os.path.join(out, f"train_{n}")))
        assert {"best_network.msgpack", "best_network.yaml", "training_log.pkl"} <= files, files
    shutil.rmtree(out)  # ~0.7 GB of checkpoints pytest would keep


def test_create_network_from_config_data_equals_the_file_route(tmp_path):
    cfg = network_config(net_in=64)
    save_yaml(cfg, str(tmp_path / "net.yaml"))
    from_data = create_network_from_config_data(copy.deepcopy(cfg), device="cpu")
    from_file = create_network_from_config_file(str(tmp_path / "net.yaml"), device="cpu")
    assert from_data.network_config == from_file.network_config
    a, b = from_data.model.state_dict(), from_file.model.state_dict()
    assert a.keys() == b.keys()
    for name in a:
        torch.testing.assert_close(a[name], b[name], rtol=0, atol=0)
