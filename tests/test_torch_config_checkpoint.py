"""The port's YAML reader and writer, flax msgpack reader and writer and
weight mapping, and the rule that the port imports nothing outside torch,
numpy, scipy and the standard library.

The YAML reader is held against ``yaml.safe_load`` on every YAML file the
repository tracks, and what the writer writes reads back the same through
both; the msgpack reader against ``flax.serialization.msgpack_restore`` bit
for bit, and the writer's encoding against the ``msgpack`` package's.
"""

import ast
import glob
import os

import msgpack
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from dream_tpu_torch import checkpoint
from dream_tpu_torch.models import DreamHourglass
from dream_tpu_torch.utils.config import dump_yaml_str, load_yaml, load_yaml_str

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML_FILES = sorted(
    os.path.relpath(p, ROOT)
    for pattern in ("arch_configs/*.yaml", "manip_configs/*.yaml", "trained_models/**/*.yaml")
    for p in glob.glob(os.path.join(ROOT, pattern), recursive=True)
)
VGGQ_R5 = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.msgpack")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing
    and slow the other test workers: two threads take less CPU time than
    the machine's count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


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


@pytest.mark.parametrize("relpath", YAML_FILES)
def test_yaml_writer_round_trips_the_repo_files(relpath):
    data = load_yaml(os.path.join(ROOT, relpath))
    text = dump_yaml_str(data)
    assert load_yaml_str(text) == data == yaml.safe_load(text)


def test_yaml_writer_quotes_what_would_read_back_otherwise():
    data = {
        "floats": [1e-05, 0.0001, 1e20, -0.0, float("inf"), float("-inf")],
        "strings": ["null", "1.0", "", "a: b", "x#y", "a #b", "- a", "yes", "Yes", "~", "0x10",
                    "1_000", "2001-12-14", "1:20", "=", "<<", "  lead", "it's", "tab\there",
                    "panda_link0", "shrink-and-crop", "_scratch/r4/mix4096"],
        "nested": [{"name": "x", "v": [1, 2.5]}, {"name": "y"}, [[1, 2], [3]], {}, []],
        7: {"flags": [True, False, None]},
    }
    text = dump_yaml_str(data)
    assert load_yaml_str(text) == data == yaml.safe_load(text)
    assert "panda_link0\n" in text and "'null'" in text


@pytest.mark.parametrize(
    "value",
    [0, 127, 128, 255, 256, 65535, 65536, 2**32, "x" * 31, "x" * 32, "x" * 300, "x" * 70000,
     b"", b"x" * 300, b"x" * 70000, [1] * 15, [1] * 16, [1] * 70000,
     {f"k{i}": i for i in range(16)}],
    ids=lambda v: f"{type(v).__name__}{len(v) if hasattr(v, '__len__') else v}",
)
def test_msgpack_writer_encodes_as_msgpack(value):
    out = bytearray()
    checkpoint._pack(out, value)
    if isinstance(value, dict):  # the writer sorts map keys, as jax's trees are sorted
        value = dict(sorted(value.items()))
    assert bytes(out) == msgpack.packb(value, use_bin_type=True)


def test_params_to_flax_inverts_params_from_flax():
    with open(VGGQ_R5, "rb") as f:
        data = f.read()
    state = checkpoint.params_from_flax(checkpoint.msgpack_restore(data))
    tree = checkpoint.params_to_flax(state)
    back = checkpoint.params_from_flax(tree)
    assert set(back) == set(state)
    for name, leaf in state.items():
        assert torch.equal(back[name], leaf), name
    # The committed checkpoint is float16; written as float32, flax reads
    # back the same values.
    restored = serialization.msgpack_restore(checkpoint.msgpack_serialize(tree))
    kernel = restored["params"]["down1"]["conv0"]["kernel"]
    assert kernel.dtype == np.float32 and kernel.shape == (3, 3, 3, 64)
    with pytest.raises(ValueError):
        checkpoint.params_to_flax({"bn.running_mean": torch.zeros(3)})


def test_params_from_flax_rejects_unknown_leaves():
    # A running statistic belongs to batch_stats, not to params.
    with pytest.raises(ValueError):
        checkpoint.params_from_flax({"params": {"bn": {"mean": np.ones(3, np.float32)}}})


def test_compute_dtype_is_the_one_that_runs(tmp_path):
    """A bfloat16 sidecar runs bfloat16 with no warning: the convs' outputs
    are bfloat16, the belief maps float32, and a saved sidecar says
    bfloat16; a float32 config runs and saves float32."""
    import warnings

    from dream_tpu_torch.network import DreamNetwork

    cfg = load_yaml(os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.yaml"))
    assert cfg["architecture"]["compute_dtype"] == "bfloat16"
    cfg["training"]["config"]["net_input_resolution"] = [64, 64]
    cfg["training"]["config"]["net_output_resolution"] = [16, 16]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        net = DreamNetwork(cfg, device="cpu")
    assert not [w for w in caught if "compute_dtype" in str(w.message)]
    assert net.compute_dtype == torch.bfloat16
    seen = []
    net.model.down3.conv1.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    belief, _ = net.inference(torch.zeros(1, 64, 64, 3))
    assert seen == [torch.bfloat16] and belief.dtype == torch.float32
    path = str(tmp_path / "net.yaml")
    net.save_network_config(path)
    saved = load_yaml(path)
    assert saved["architecture"]["compute_dtype"] == "bfloat16"
    saved["architecture"]["compute_dtype"] = "float32"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        net32 = DreamNetwork(saved, device="cpu")
    assert not [w for w in caught if "compute_dtype" in str(w.message)]
    assert net32.compute_dtype == torch.float32
    net32.save_network_config(path, overwrite=True)
    assert load_yaml(path)["architecture"]["compute_dtype"] == "float32"


def test_checkpoint_load_draws_no_initial_parameters(tmp_path, monkeypatch):
    """A network built to load a checkpoint (``create_network_from_config_file``
    with parameters, ``DreamNetwork.from_checkpoint``) draws no initial
    values: it is built on the meta device.  Once loaded it holds the
    checkpoint's state whole, its non-persistent buffers (a fixed
    soft-argmax ``beta``, the QAT convs' ``act_amax``) as built, and
    infers as the network that was saved."""
    from dream_tpu_torch.models.quant import quant_convs
    from dream_tpu_torch.network import DreamNetwork, create_network_from_config_file

    cfg = load_yaml(os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.yaml"))
    cfg["architecture"].update(compute_dtype="float32", quant_mode="qat",
                               output_heads=["belief_maps", "keypoints"],
                               spatial_softmax={"learned_beta": False, "initial_beta": 3.0})
    cfg["training"]["config"]["net_input_resolution"] = [64, 64]
    cfg["training"]["config"]["net_output_resolution"] = [16, 16]
    net = DreamNetwork(cfg, device="cpu", seed=3)
    net.save_network(str(tmp_path), "net")

    def no_draws(*args, **kwargs):
        raise AssertionError("an initial value was drawn")

    monkeypatch.setattr(torch.nn.init, "trunc_normal_", no_draws)
    loaded = create_network_from_config_file(str(tmp_path / "net.yaml"), str(tmp_path / "net.msgpack"),
                                             device="cpu")
    saved, state = net.model.state_dict(), loaded.model.state_dict()
    assert set(state) == set(saved) and all(torch.equal(state[k], v) for k, v in saved.items())
    assert torch.equal(loaded.model.beta, torch.full((7,), 3.0))
    assert [float(c.act_amax) for c in quant_convs(loaded.model).values()] == [0.0] * len(quant_convs(net.model))
    x = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32))
    for ours, theirs in zip(loaded.inference(x), net.inference(x)):
        assert torch.equal(ours, theirs)
    with pytest.raises(AssertionError, match="drawn"):
        DreamNetwork(cfg, device="cpu")


FORBIDDEN_IMPORTS = {
    "jax", "jaxlib", "flax", "optax", "dream_tpu", "yaml", "msgpack", "PIL", "cv2", "torchvision",
    "matplotlib", "webcolors", "pandas",
}
PORT_SOURCES = sorted(
    glob.glob(os.path.join(ROOT, "dream_tpu_torch", "**", "*.py"), recursive=True)
) + [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "scripts", "profile_torch_eval.py"),
     os.path.join(ROOT, "scripts", "compare_conv_int8.py"),
     os.path.join(ROOT, "scripts", "compare_score_warp.py")]


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
