"""The port's int8 graphs for every architecture against dream_tpu, on the CPU.

- The exact route (``ops/conv_int32.py``): ``conv2d_int32`` and
  ``conv_transpose2d_int32`` (``torch._int_mm`` on im2col matrices, the
  transposed conv by phases) against their float64 plain versions and
  against ``jax.lax.conv_general_dilated`` with int32 accumulation, the
  contraction ``QuantConv`` runs, on random int8 operands at odd shapes,
  also with the im2col cut into many chunks: bit-equal.
- One conv: ``QuantConv2d`` and ``QuantConvTranspose2d`` in ``int8`` mode
  against ``QuantConv`` and ``QuantConvTranspose`` on the same float input,
  parameters and amax: the int8 weights and activations equal, their
  scales equal, the outputs within 1e-6 of the largest output magnitude
  (float32 rounding of ``acc * (s_x * s_w) + bias``; the accumulators are
  exact on both sides).
- The hourglasses: the port's quantizable convs are dream_tpu's ``quant``
  leaves (vgg-Q 22, vgg-F 18: the encoder and ``head.conv0/conv1``, the
  full-output hourglass 26, a 2-stage vgg-Q 44); vgg-F's int8 graph on a
  [2, 64, 64, 3] input against JAX's fed the same amax: the float convs of
  its deconv decoder sum in other orders and may move an int8 step of
  ``head.conv0``'s input, so it is held to the gate JAX's own int8 graphs
  meet (``tests/test_vgg_int8_deploy.py``): the difference over the largest
  output magnitude has a 99th percentile under 0.02 and a maximum under
  0.05.  ``quant_from_flax``/``quant_to_flax`` round-trip the hourglass
  and ResNet deploy trees.
- The ResNets (``layers=(1, 1, 1, 1)``, 64x64, as ``tests/test_quant.py:
  228-259``): the port's fold of the port's state equals
  ``fold_batchnorm_resnet`` of the same flax variables bit for bit; the
  deploy graph in ``float`` mode against JAX's to 1e-5 absolute and the
  BatchNorm model's eval maps to 1e-4 of their largest magnitude (float32
  rounding, as ``test_resnet_bn_fold_exact``); in ``int8`` mode on JAX's
  amax against JAX's int8 deploy graph under the same 0.02/0.05 gate, and
  correlating with the float maps at >= 0.98 (``test_resnet_deploy_int8_
  tracks_float``).
- The network: ``enable_int8_inference`` on a ResNet (its folded deploy
  graph, a snapshot); ``DREAM_INT8_IMPL`` validation, with the port raising
  where dream_tpu warns and falls back.  vgg-Q's quantconv graph against
  dream_tpu's default CPU int8, unpinned, is in ``tests/test_torch_int8.py``,
  beside the JAX network it shares.
- ``slow``: vgg-F r5 int8 at full width (400x400) on 2 holdout frames
  against dream_tpu's quantconv graph fed the same amax, under the same gate.
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dream_tpu import network as jax_network
from dream_tpu.models import DreamHourglass as JaxHourglass
from dream_tpu.models import DreamHourglassMultiStage as JaxMultiStage
from dream_tpu.models.quant import QuantConv as JaxQuantConv
from dream_tpu.models.quant import QuantConvTranspose as JaxQuantConvTranspose
from dream_tpu.models.quant import _quantize_activations, _quantize_weights
from dream_tpu.models.resnet_deploy import ResnetSimpleDeploy as JaxResnetDeploy
from dream_tpu.models.resnet_deploy import fold_batchnorm_resnet as jax_fold
from dream_tpu.models.resnet_simple import ResnetSimple as JaxResnet
from dream_tpu.utils.config import load_yaml as jax_load_yaml

from dream_tpu_torch import checkpoint
from dream_tpu_torch.models import (
    DreamHourglass,
    DreamHourglassMultiStage,
    ResnetSimple,
    ResnetSimpleDeploy,
    fold_batchnorm_resnet,
)
from dream_tpu_torch.models.quant import (
    QuantConv2d,
    QuantConvTranspose2d,
    calibrate,
    quant_convs,
    quantize_activations,
    quantize_weights,
    set_int8,
)
from dream_tpu_torch.network import DreamNetwork
from dream_tpu_torch.ops import conv_int8, conv_int32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VGGQ_CONFIG = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.yaml")
VGGF_CONFIG = os.path.join(ROOT, "trained_models/results_r5/vggf/dream_vgg_f_r5.yaml")
VGGF_CHECKPOINT = os.path.join(ROOT, "trained_models/results_r5/vggf/dream_vgg_f_r5.msgpack")
RESNET_H_CONFIG = os.path.join(ROOT, "trained_models/results_r4/resnet_h/dream_resnet_h_r4.yaml")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing
    and slow the other test workers: two threads take less CPU time than
    the machine's count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def draw_variables(jax_model, seed, shape=(1, 64, 64, 3), **kwargs):
    """numpy draws of the JAX model's variables (``jax.eval_shape``, no
    flax ``init``): kernels of standard deviation 1/sqrt(fan_in), BatchNorm
    scales in [0.5, 1.5], running variances in [0.5, 2], the rest normal
    with standard deviation 0.1."""
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros(shape), **kwargs))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if len(leaf.shape) == 4:
            return rng.normal(0, np.prod(leaf.shape[:3]) ** -0.5, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if name == "act_amax":
            return np.float32(rng.uniform(0.5, 4.0))
        return rng.normal(0, 0.1, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def net_input(seed=0, batch=2, side=64):
    return np.random.RandomState(seed).uniform(-1, 1, (batch, side, side, 3)).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def assert_int8_gate(got, want):
    """The xla-vs-pallas gate of tests/test_vgg_int8_deploy.py."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    delta = np.abs(got - want) / (np.abs(want).max() + 1e-9)
    assert np.quantile(delta, 0.99) < 0.02, np.quantile(delta, 0.99)
    assert delta.max() < 0.05, delta.max()


def jax_quant_tree(jax_model, shape=(1, 64, 64, 3), **kwargs):
    """The ``quant`` collection's structure, with no flax ``init``."""
    return jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros(shape),
                                                 **kwargs))["quant"]


# --- the exact route ---------------------------------------------------------

CONV_CASES = [  # (b, ci, h, w, co, k, stride, pad)
    (2, 3, 37, 29, 64, 7, 2, 3),    # the ResNet stem at an odd size
    (2, 40, 13, 11, 24, 1, 2, 0),   # a strided 1x1 projection
    (1, 24, 15, 9, 16, 3, 2, 1),    # a strided 3x3
    (3, 20, 7, 10, 12, 3, 1, 1),    # K and N off multiples of 8
    (1, 5, 4, 3, 3, 1, 1, 0),       # M below 17
]
TRANSPOSED_CASES = [  # (b, ci, h, w, co, k, stride, pad, output_padding)
    (2, 24, 7, 5, 16, 4, 2, 1, 0),  # the ResNet upsampler
    (1, 16, 6, 9, 8, 3, 2, 1, 1),   # vgg-F's deconv geometry
    (2, 8, 4, 5, 8, 5, 3, 2, 0),
    (1, 8, 3, 3, 8, 2, 3, 0, 1),    # phases no tap reaches
]


def _int8(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


def _jax_int32(x, kernel_hwio, **conv_kwargs):
    out = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(kernel_hwio),
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                       preferred_element_type=jnp.int32, **conv_kwargs)
    return np.asarray(out).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("budget", [conv_int32.IM2COL_BUDGET, 700])
def test_exact_route_equals_float64_and_jax(budget, monkeypatch):
    monkeypatch.setattr(conv_int32, "IM2COL_BUDGET", budget)
    rng = np.random.RandomState(0)
    for b, ci, h, w, co, k, s, p in CONV_CASES:
        x, wq = _int8(rng, b, h, w, ci), _int8(rng, co, ci, k, k)
        got = conv_int32.conv2d_int32(nchw(x), torch.from_numpy(wq), s, p)
        assert got.dtype == torch.int32
        assert torch.equal(got, conv_int32.conv2d_int32_plain(nchw(x), torch.from_numpy(wq), s, p))
        ref = _jax_int32(x, wq.transpose(2, 3, 1, 0), window_strides=(s, s), padding=((p, p),) * 2)
        np.testing.assert_array_equal(got.numpy(), ref)
    for b, ci, h, w, co, k, s, p, op in TRANSPOSED_CASES:
        x, wq = _int8(rng, b, h, w, ci), _int8(rng, ci, co, k, k)
        got = conv_int32.conv_transpose2d_int32(nchw(x), torch.from_numpy(wq), s, p, op)
        plain = conv_int32.conv_transpose2d_int32_plain(nchw(x), torch.from_numpy(wq), s, p, op)
        assert torch.equal(got, plain)
        # dream_tpu's formulation: the HWIO kernel on the dilated input.
        kernel = wq[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        ref = _jax_int32(x, kernel, window_strides=(1, 1), lhs_dilation=(s, s),
                         padding=((k - 1 - p, k - 1 - p + op),) * 2)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_exact_route_refusals():
    x = torch.zeros((1, 4, 5, 5), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        conv_int32.conv2d_int32(x.float(), torch.zeros((8, 4, 3, 3), dtype=torch.int8))
    with pytest.raises(ValueError, match="input channels"):
        conv_int32.conv2d_int32(x, torch.zeros((8, 3, 3, 3), dtype=torch.int8))
    with pytest.raises(ValueError, match="input channels"):
        conv_int32.conv_transpose2d_int32(x, torch.zeros((3, 8, 4, 4), dtype=torch.int8))


# --- one conv ----------------------------------------------------------------

@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (7, 2, 3), (1, 2, 0), (3, 2, 1)])
def test_quant_conv_int8_matches_jax(k, stride, pad):
    rng = np.random.RandomState(k + stride)
    x = rng.uniform(-2, 2, (2, 15, 13, 16)).astype(np.float32)
    kernel = rng.normal(0, 0.2, (k, k, 16, 24)).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, 24).astype(np.float32)
    amax = np.float32(1.7)
    want = JaxQuantConv(24, kernel_size=k, padding=pad, stride=stride, mode="int8").apply(
        {"params": {"kernel": kernel, "bias": bias}, "quant": {"act_amax": amax}}, x)
    conv = QuantConv2d(16, 24, k, stride=stride, padding=pad, mode="int8")
    conv.load_state_dict(checkpoint.params_from_flax({"kernel": kernel, "bias": bias}))
    conv.act_amax.fill_(float(amax))
    got = conv(nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    # The int8 operands themselves.
    w_q, s_w = quantize_weights(conv.weight.detach())
    ref_w_q, ref_s_w = _quantize_weights(jnp.asarray(kernel))
    np.testing.assert_array_equal(w_q.permute(2, 3, 1, 0).numpy(), np.asarray(ref_w_q))
    np.testing.assert_array_equal(s_w.numpy(), np.asarray(ref_s_w))
    x_q, s_x = quantize_activations(nchw(x), torch.tensor(amax))
    ref_x_q, ref_s_x = _quantize_activations(jnp.asarray(x), jnp.float32(amax))
    np.testing.assert_array_equal(x_q.permute(0, 2, 3, 1).numpy(), np.asarray(ref_x_q))
    assert float(s_x) == float(ref_s_x)


def test_quant_conv_transpose_int8_and_calibrate_match_jax():
    rng = np.random.RandomState(3)
    x = rng.uniform(-2, 2, (2, 7, 6, 32)).astype(np.float32)
    kernel = rng.normal(0, 0.1, (4, 4, 32, 16)).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, 16).astype(np.float32)
    jax_conv = JaxQuantConvTranspose(16, kernel_size=4, stride=2, padding=1, mode="int8")
    want = np.asarray(jax_conv.apply(
        {"params": {"kernel": kernel, "bias": bias}, "quant": {"act_amax": np.float32(1.3)}}, x))
    conv = QuantConvTranspose2d(32, 16, 4, stride=2, padding=1, mode="int8")
    state = checkpoint.params_from_flax({"up0_deconv": {"kernel": kernel, "bias": bias}})
    conv.load_state_dict({k.removeprefix("up0_deconv."): v for k, v in state.items()})
    conv.act_amax.fill_(1.3)
    got = conv(nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == (2, 14, 12, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    w_q, s_w = quantize_weights(conv.weight.detach(), out_dim=1)
    ref_w_q, ref_s_w = _quantize_weights(jnp.asarray(kernel))
    np.testing.assert_array_equal(w_q.permute(2, 3, 0, 1).flip(0, 1).numpy(), np.asarray(ref_w_q))
    np.testing.assert_array_equal(s_w.numpy(), np.asarray(ref_s_w))
    # calibrate records max|x| over batches and restores the mode; float is
    # the plain transposed conv.
    qvars = calibrate(conv, [nchw(x[:1]), nchw(x[1:])])
    assert conv.mode == "int8" and float(qvars[""]) == float(np.abs(x).max())
    conv.mode = "float"
    float_want = jax_conv.clone(mode="float").apply({"params": {"kernel": kernel, "bias": bias}}, x)
    np.testing.assert_allclose(conv(nchw(x)).permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(float_want), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="quant mode"):
        conv.mode = "qat"
        conv(nchw(x))


# --- the hourglasses ---------------------------------------------------------

HOURGLASS_TREES = {
    "vgg-Q": (lambda q: JaxHourglass(7, quant_mode=q), lambda q: DreamHourglass(7, quant_mode=q), 22),
    "vgg-F": (lambda q: JaxHourglass(7, deconv_decoder=True, quant_mode=q),
              lambda q: DreamHourglass(7, deconv_decoder=True, quant_mode=q), 18),
    "full-output": (lambda q: JaxHourglass(7, full_output=True, quant_mode=q),
                    lambda q: DreamHourglass(7, full_output=True, quant_mode=q), 26),
    "2-stage": (lambda q: JaxMultiStage(7, n_stages=2, quant_mode=q),
                lambda q: DreamHourglassMultiStage(7, n_stages=2, quant_mode=q), 44),
}


@pytest.mark.parametrize("variant", list(HOURGLASS_TREES))
def test_hourglass_quant_leaves_match_jax(variant):
    make_jax, make_torch, count = HOURGLASS_TREES[variant]
    with torch.device("meta"):
        model = make_torch("int8")
    names = set(quant_convs(model))
    ref = set(checkpoint.quant_from_flax(jax.tree_util.tree_map(
        lambda leaf: np.zeros(leaf.shape, np.float32), jax_quant_tree(make_jax("calibrate")))))
    assert names == ref and len(ref) == count
    assert all(m.mode == "int8" for m in quant_convs(model).values())
    assert not any(n.endswith("head.conv2") or "deconv" in n for n in names)


@pytest.fixture(scope="module")
def vggf_case():
    """vgg-F at full width with drawn parameters and amax, a [2, 64, 64, 3]
    input, and JAX's int8 graph's maps."""
    jax_model = JaxHourglass(7, deconv_decoder=True, quant_mode="int8")
    variables = draw_variables(jax_model, 4)
    x = net_input(5)
    want = np.asarray(jax.jit(jax_model.apply)(variables, x)[0])
    return variables, x, want


def test_vggf_int8_graph_matches_jax_on_shared_amax(vggf_case):
    variables, x, want = vggf_case
    model = DreamHourglass(7, deconv_decoder=True)
    model.load_state_dict(checkpoint.params_from_flax(variables), strict=True)
    set_int8(model, checkpoint.quant_from_flax(variables["quant"]))
    with torch.no_grad():
        got = model(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 64, 64, 7)
    assert_int8_gate(got, want)


def test_quant_flax_round_trip_hourglass_and_resnet_deploy(vggf_case):
    tree = vggf_case[0]["quant"]
    deploy_tree = draw_variables(JaxResnetDeploy(7, layers=(1, 1, 1, 1), mode="calibrate"), 6)["quant"]
    for t in (tree, deploy_tree):
        back = checkpoint.quant_to_flax(checkpoint.quant_from_flax(t))
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(t)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(t)):
            assert a.dtype == np.float32 and a.shape == () and a == b
    with torch.device("meta"):
        deploy = ResnetSimpleDeploy(7, layers=(1, 1, 1, 1), mode="int8")
    assert set(checkpoint.quant_from_flax(deploy_tree)) == set(quant_convs(deploy))
    assert len(quant_convs(deploy)) == 21  # stem, 4 x (3 + projection), 4 upsamplers


# --- the ResNets -------------------------------------------------------------

@pytest.fixture(scope="module")
def resnet_case():
    """ResNet-H with layers (1, 1, 1, 1), drawn parameters and BatchNorm
    statistics, dream_tpu's fold of them, and a [2, 64, 64, 3] input."""
    model = JaxResnet(7, layers=(1, 1, 1, 1))
    variables = draw_variables(model, 7, train=False)
    x = net_input(8)
    folded = jax_fold(variables)
    deploy = JaxResnetDeploy(7, layers=(1, 1, 1, 1), mode="float")
    return {"model": model, "variables": variables, "x": x, "folded": folded,
            "bn_maps": np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x)[0]),
            "deploy_maps": np.asarray(jax.jit(deploy.apply)(folded, x)[0])}


def test_resnet_fold_is_bit_equal(resnet_case):
    state = checkpoint.state_from_flax(resnet_case["variables"])
    folded = fold_batchnorm_resnet(state)
    ours = checkpoint.params_to_flax(folded)["params"]
    ref = jax.tree_util.tree_map(np.asarray, resnet_case["folded"]["params"])
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(ref)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours), jax.tree_util.tree_leaves(ref)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_resnet_deploy_float_tracks_bn_model(resnet_case):
    state = checkpoint.state_from_flax(resnet_case["variables"])
    bn_model = ResnetSimple(7, layers=(1, 1, 1, 1))
    bn_model.load_state_dict(state, strict=True)
    deploy = ResnetSimpleDeploy(7, layers=(1, 1, 1, 1))
    deploy.load_state_dict(fold_batchnorm_resnet(state), strict=True)
    x = nchw(resnet_case["x"])
    with torch.no_grad():
        got = deploy(x)
        bn_maps = bn_model.eval()(x)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), resnet_case["deploy_maps"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), bn_maps.numpy(), rtol=0,
                               atol=1e-4 * float(bn_maps.abs().max()))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), resnet_case["bn_maps"], rtol=0,
                               atol=1e-4 * np.abs(resnet_case["bn_maps"]).max())


def test_resnet_deploy_int8_matches_jax_and_tracks_float(resnet_case):
    folded, x = resnet_case["folded"], resnet_case["x"]
    jax_calib = JaxResnetDeploy(7, layers=(1, 1, 1, 1), mode="calibrate")
    qinit = jax.tree_util.tree_map(lambda leaf: jnp.zeros(leaf.shape, leaf.dtype),
                                   jax_quant_tree(jax_calib))
    _, mut = jax.jit(lambda p, q, v: jax_calib.apply({"params": p, "quant": q}, v, mutable=["quant"]))(
        folded["params"], qinit, x)
    jax_int8 = JaxResnetDeploy(7, layers=(1, 1, 1, 1), mode="int8")
    want = np.asarray(jax.jit(jax_int8.apply)({"params": folded["params"], "quant": mut["quant"]}, x)[0])

    deploy = ResnetSimpleDeploy(7, layers=(1, 1, 1, 1))
    deploy.load_state_dict(fold_batchnorm_resnet(checkpoint.state_from_flax(resnet_case["variables"])))
    qvars = calibrate(deploy, [nchw(x)])
    ref = checkpoint.quant_from_flax(jax.tree_util.tree_map(np.asarray, mut["quant"]))
    assert set(qvars) == set(ref)
    for name in ref:
        np.testing.assert_allclose(float(qvars[name]), float(ref[name]), rtol=1e-5, err_msg=name)
    set_int8(deploy, ref)
    with torch.no_grad():
        got = deploy(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert_int8_gate(got, want)
    assert np.corrcoef(got.ravel(), resnet_case["deploy_maps"].ravel())[0, 1] > 0.98


# --- the network -------------------------------------------------------------

def _small_config(path, **arch):
    cfg = jax_load_yaml(path)
    cfg["architecture"]["compute_dtype"] = "float32"
    cfg["architecture"].update(arch)
    cfg["training"]["config"]["net_input_resolution"] = [64, 64]
    cfg["training"]["config"].pop("net_output_resolution", None)
    return cfg


def _calibration(seed):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32) for _ in range(2)]


def test_network_enable_int8_inference_resnet(monkeypatch):
    """As ``tests/test_quant.py::test_network_enable_int8_inference_resnet``:
    a ResNet goes through its folded deploy graph."""
    monkeypatch.delenv("DREAM_INT8_IMPL", raising=False)
    net = DreamNetwork(_small_config(RESNET_H_CONFIG, layers=[1, 1, 1, 1]), device="cpu")
    x = torch.zeros((1, 64, 64, 3))
    float_belief, float_kps = net.inference(x)
    before = conv_int8.conv3x3_int8_kernel.launches
    qvars = net.enable_int8_inference([torch.from_numpy(b) for b in _calibration(1)])
    assert net.int8_impl == "quantconv" and net.int8_chain is None
    assert isinstance(net.int8_model, ResnetSimpleDeploy) and len(qvars) == 21
    belief, kps = net.inference(x)
    assert belief.shape == float_belief.shape and kps.shape == float_kps.shape
    _, _, scores, best = net.inference_detailed(x)
    assert scores.shape == (1, 7) and best.shape == (1, 7, 2)
    assert conv_int8.conv3x3_int8_kernel.launches == before
    # A snapshot: the model's later changes do not reach the int8 graph.
    with torch.no_grad():
        for p in net.model.parameters():
            p.add_(1.0)
    assert torch.equal(net.inference(x)[0], belief)


def test_int8_impl_env_validation(monkeypatch):
    """As ``tests/test_quant.py::test_int8_impl_env_validation``, with a raise
    where dream_tpu warns and falls back: an explicit chain request on a
    network the chain cannot take."""
    calib = [torch.from_numpy(_calibration(3)[0])]
    cfg = _small_config(VGGF_CONFIG)
    monkeypatch.setenv("DREAM_INT8_IMPL", "bogus")
    net = DreamNetwork(copy.deepcopy(cfg), device="cpu")
    with pytest.raises(ValueError, match="DREAM_INT8_IMPL"):
        net.enable_int8_inference(calib)
    for impl in ("xla_chain", "pallas"):
        monkeypatch.setenv("DREAM_INT8_IMPL", impl)
        with pytest.raises(ValueError, match="cannot take"):
            net.enable_int8_inference(calib)
        assert net.int8_impl is None and net.int8_model is None
    monkeypatch.setenv("DREAM_INT8_IMPL", "quantconv")
    vggq = DreamNetwork(_small_config(VGGQ_CONFIG), device="cpu")
    vggq.enable_int8_inference(calib)
    assert vggq.int8_impl == "quantconv" and vggq.int8_chain is None
    monkeypatch.delenv("DREAM_INT8_IMPL")
    vggq.enable_int8_inference(calib)
    assert vggq.int8_impl == "xla_chain" and vggq.int8_model is None and vggq.int8_chain is not None


@pytest.mark.slow
def test_vggf_r5_int8_full_width_matches_dream_tpu(monkeypatch):
    """vgg-F r5 int8 at 400x400 on 2 holdout frames: the port's quantconv
    graph against dream_tpu's fed the port's amax."""
    from flax import serialization

    from dream_tpu_torch.data.dataset import make_batch_processor
    from dream_tpu_torch.data.synthetic import generate_synthetic_frames

    monkeypatch.delenv("DREAM_INT8_IMPL", raising=False)
    cfg = jax_load_yaml(VGGF_CONFIG)
    cfg["architecture"]["compute_dtype"] = "float32"
    net = DreamNetwork.from_checkpoint(copy.deepcopy(cfg), VGGF_CHECKPOINT, device="cpu")
    frames = generate_synthetic_frames(2, (640, 480), net.keypoint_names, seed=99)
    process = make_batch_processor((640, 480), (400, 400), (400, 400), net.image_preprocessing(),
                                   net.image_normalization, include_belief_maps=False)
    x = process(None, torch.from_numpy(frames["images"]),
                torch.from_numpy(frames["projections"]).float())["image_rgb_input"]
    qvars = net.enable_int8_inference([x])
    belief, _ = net.inference(x)

    with open(VGGF_CHECKPOINT, "rb") as f:
        params = serialization.msgpack_restore(f.read())["params"]
    jax_model = dataclasses.replace(jax_network.create_network_from_config_data(cfg).model,
                                    quant_mode="int8")
    want = jax.jit(jax_model.apply)({"params": params, "quant": checkpoint.quant_to_flax(qvars)},
                                    jnp.asarray(x.numpy()))[0]
    assert_int8_gate(belief.permute(0, 2, 3, 1).numpy(), np.asarray(want))
