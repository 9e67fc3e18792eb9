"""The port's YAML reader, flax msgpack reader and weight mapping, and the
rule that the port imports nothing outside torch, numpy, scipy and the
standard library.

The YAML reader is held against ``yaml.safe_load`` on every YAML file the
repository tracks; the msgpack reader against
``flax.serialization.msgpack_restore`` bit for bit.
"""

import ast
import glob
import os

import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from dream_tpu_torch import checkpoint
from dream_tpu_torch.models import DreamHourglass
from dream_tpu_torch.utils.config import load_yaml, load_yaml_str

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML_FILES = sorted(
    os.path.relpath(p, ROOT)
    for pattern in ("arch_configs/*.yaml", "manip_configs/*.yaml", "trained_models/**/*.yaml")
    for p in glob.glob(os.path.join(ROOT, pattern), recursive=True)
)
VGGQ_R5 = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.msgpack")


def test_yaml_file_list_is_complete():
    # arch_configs (4) + manip_configs (3) + checkpoint sidecars (7).
    assert len(YAML_FILES) == 14, YAML_FILES


@pytest.mark.parametrize("relpath", YAML_FILES)
def test_yaml_reader_matches_pyyaml(relpath):
    path = os.path.join(ROOT, relpath)
    with open(path) as f:
        expected = yaml.safe_load(f)
    assert load_yaml(path) == expected


@pytest.mark.parametrize(
    "text",
    [
        "a: 1e-05\nb: 1.0e-05\nc: -.inf\nd: 0\ne: +12\nf: 3.\n",
        "a: ~\nb: null\nc:\nd: yes\ne: Off\nf: 'it''s'\ng: \"q:z # x\"  # c\n",
        "k: [1, 'x y', \"q:z\", {k: v, n: [2, 3]}, []]\nm: {}\n",
        "top:\n- x\n- y: 1\n  z: [a, b]\n- - 3\n  - 4\n-\n  w: 5\n",
        "top:\n  nested:\n    - {name: a, friendly_name: \"A:0\"}\n  after: 2\nlast: end value\n",
    ],
)
def test_yaml_subset_cases_match_pyyaml(text):
    assert load_yaml_str(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: &x 1\n", "a: !!str 1\n", "a: |\n  b\n", "---\na: 1\n"])
def test_yaml_reader_rejects_features_outside_the_subset(text):
    with pytest.raises(ValueError):
        load_yaml_str(text)


def _assert_trees_bit_equal(ours, ref, path=""):
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and ours.keys() == ref.keys(), path
        for k in ref:
            _assert_trees_bit_equal(ours[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, np.ndarray):
        assert isinstance(ours, np.ndarray), path
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, path
        assert ours.tobytes() == ref.tobytes(), path
    else:
        assert type(ours) is type(ref) and ours == ref, path


def test_checkpoint_leaves_bit_equal_to_flax():
    with open(VGGQ_R5, "rb") as f:
        raw = f.read()
    _assert_trees_bit_equal(checkpoint.msgpack_restore(raw), serialization.msgpack_restore(raw))


def test_msgpack_reader_covers_flax_types():
    tree = {
        "ints": [0, 5, 127, 128, 300, 70000, 2**40, -1, -31, -33, -200, -40000, -(2**40)],
        "floats": [1.5, -2.25e-8, 0.0],
        "misc": [None, True, False, "x" * 40, "y" * 300, b"raw"],
        "arrays": {
            "f16": np.arange(6, dtype=np.float16).reshape(2, 3),
            "f32": np.linspace(0, 1, 300, dtype=np.float32).reshape(3, 4, 25),
            "i64": np.array([-3, 2**40], dtype=np.int64),
            "empty": np.zeros((0, 3), np.float32),
            "u8": np.arange(112, dtype=np.uint8),
        },
        "nested": {str(i): {"v": np.full((i + 1,), i, np.int32)} for i in range(20)},
    }
    raw = serialization.msgpack_serialize(tree)
    _assert_trees_bit_equal(checkpoint.msgpack_restore(raw), serialization.msgpack_restore(raw))


@pytest.mark.parametrize("leaf", [np.float32(3.25), 1.0 + 2.0j])
def test_msgpack_reader_refuses_non_array_extensions(leaf):
    with pytest.raises(ValueError):
        checkpoint.msgpack_restore(serialization.msgpack_serialize({"leaf": leaf}))


def test_params_from_flax_layout_and_dtype():
    tree = checkpoint.load_flax_checkpoint(VGGQ_R5)
    state = checkpoint.params_from_flax(tree)
    kernel = tree["params"]["down3"]["conv2"]["kernel"]  # HWIO float16
    weight = state["down3.conv2.weight"]  # OIHW float32
    assert weight.dtype == torch.float32 and weight.is_contiguous()
    assert tuple(weight.shape) == (kernel.shape[3], kernel.shape[2], kernel.shape[0], kernel.shape[1])
    np.testing.assert_array_equal(
        weight.numpy(), kernel.astype(np.float32).transpose(3, 2, 0, 1)
    )
    np.testing.assert_array_equal(
        state["head.conv2.bias"].numpy(), tree["params"]["head"]["conv2"]["bias"].astype(np.float32)
    )
    model = DreamHourglass(n_keypoints=7)
    model.load_state_dict(state, strict=True)


def test_params_from_flax_rejects_unknown_leaves():
    with pytest.raises(ValueError):
        checkpoint.params_from_flax({"params": {"bn": {"scale": np.ones(3, np.float32)}}})


FORBIDDEN_IMPORTS = {
    "jax", "jaxlib", "flax", "optax", "dream_tpu", "yaml", "msgpack", "PIL", "cv2", "torchvision",
}
PORT_SOURCES = sorted(
    glob.glob(os.path.join(ROOT, "dream_tpu_torch", "**", "*.py"), recursive=True)
) + [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "scripts", "profile_torch_eval.py")]


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_nothing_forbidden(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN_IMPORTS, f"{path}: import {name}"


def test_port_sources_found():
    names = {os.path.relpath(p, ROOT) for p in PORT_SOURCES}
    assert "chip_smoke.py" in names and "dream_tpu_torch/ops/score_kernel.py" in names
