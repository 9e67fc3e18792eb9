"""The port's int8 slice against dream_tpu, on the CPU.

- int8 conv: ``conv3x3_int8`` on CPU tensors (the plain version) against
  ``dream_tpu.ops.pallas_conv.conv3x3_int8_reference`` at the shapes and
  ReLU modes of ``tests/test_pallas_conv.py``, against the Pallas kernel in
  interpret mode at one small shape, and as a two-link chain: bit-equal.
- Quantization: ``quantize_weights``/``quantize_activations`` against
  ``_quantize_weights``/``_quantize_activations``: int8 values equal,
  scales to rtol 1e-7.  Calibration: every conv's ``act_amax`` against
  the JAX ``calibrate`` apply to rtol 5e-6: the two libraries' float32
  convolutions sum in other orders, and the amax of down3.conv1's input
  differs by 1.14e-6 relative (about 11 float32 ulps).  ``quant_from_flax`` and
  ``quant_to_flax`` round-trip.
- The int8 graph: ``vgg_q_int8_infer`` against JAX's
  ``vgg_q_int8_infer(..., dtype=float32, backend="xla")`` fed the same
  amax, vgg-Q at full width with a [2, 64, 64, 3] input and random
  parameters from a numpy seed.  Stated before the first run: the
  difference, over the output's largest magnitude, has a 99th percentile
  under 0.02 and a maximum under 0.05 (the gate that
  ``tests/test_vgg_int8_deploy.py`` holds JAX's own xla and Pallas chains
  to): the bf16 prologues of the two libraries round a few values apart,
  and one int8 step moved early travels down the chain.
- QAT, one conv: ``QuantConv2d`` in ``qat`` mode against ``QuantConv``
  in ``qat`` mode, on a signed and on a non-negative input: the output
  and the gradients with respect to the input, the weight and the bias
  agree to 1e-5 of each one's largest magnitude (both round the same
  float32 quotients; the convolutions sum in other orders).
- QAT, the model: the ``quant_mode="qat"`` forward, the weighted-MSE loss
  and every parameter's gradient against the JAX model's, same parameters
  and input, with JAX compiled to round as its code is written.  Each
  fake-quantized conv contracts integers (exact in float32 in both
  libraries) and rounds the same float32 quotients, so the two forwards
  agree up to ``head.conv2``, the one float conv, and the gradients to
  float32 summation order.  A default ``jax.jit`` does not round as
  written: XLA's algebraic simplifier turns ``(amax_x / 127) * (amax_w /
  127)`` into one division and the CPU backend's optimizations move more
  last bits (24 of down1.conv0's 64 scales, half its outputs, move by an
  ulp); a value on a half-integer then rounds to the other int8 step, and
  through the max-pools' ties that moves the down1 gradients by ~40%.  So
  the JAX side compiles with ``algsimp`` off and backend optimization
  level 0, which gives what running it op by op gives.  Measured on the CPU: belief maps 3.7e-7 of their largest magnitude,
  every leaf's gradient within 3.1e-6 in L2 relative to its norm.  Held
  to: belief maps 1e-5 of their largest magnitude, the loss to rtol 1e-5,
  each leaf's gradient 1e-4 in L2 relative to its norm (a zero or
  sign-flipped gradient is 1 or 2).
- The network: a vgg-Q network with a ``quant_mode: qat`` sidecar at a
  64x64 input; ``evaluate_frames(int8_calibration_frames=3)`` calibrates
  on the first frames and evaluates through the int8 chain; JAX's
  ``enable_int8_inference`` fed the same calibration batches gives the
  same amax (rtol 1e-5: twenty-odd float32 convs deep) and the port's
  int8 belief maps agree with JAX's ``vgg_q_int8_infer`` on those amax
  under the same 0.02/0.05 gate.
"""

import copy
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dream_tpu import network as jax_network
from dream_tpu.models import DreamHourglass as JaxHourglass
from dream_tpu.models.quant import QuantConv as JaxQuantConv
from dream_tpu.models.quant import _quantize_activations, _quantize_weights
from dream_tpu.models.vgg_int8_deploy import vgg_q_int8_infer as jax_vgg_q_int8_infer
from dream_tpu.ops import pallas_conv as pc
from dream_tpu.utils.config import load_yaml as jax_load_yaml

from dream_tpu_torch.analysis import evaluate_frames
from dream_tpu_torch.checkpoint import params_from_flax, quant_from_flax, quant_to_flax
from dream_tpu_torch.data.dataset import collect_calibration_batches, make_batch_processor
from dream_tpu_torch.data.synthetic import generate_synthetic_frames
from dream_tpu_torch.models import DreamHourglass
from dream_tpu_torch.models.quant import (
    QuantConv2d,
    calibrate,
    quantize_activations,
    quantize_weights,
)
from dream_tpu_torch.models.vgg_int8_deploy import CHAIN, vgg_q_int8_infer
from dream_tpu_torch.network import DreamNetwork, weighted_mse_loss
from dream_tpu_torch.ops import conv_int8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QAT_CONFIG = os.path.join(ROOT, "trained_models/results_r5/vggq_qat/dream_vgg_q_qat_r5.yaml")
RAW, NET_IN, NET_OUT = (128, 96), (64, 64), (16, 16)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing
    and slow the other test workers: two threads take less CPU time than
    the machine's count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _rand_case(rng, b, h, w, ci, co):
    """``tests/test_pallas_conv.py``'s inputs, as numpy."""
    x_q = rng.randint(-127, 128, (b, h, w, ci)).astype(np.int8)
    w_q = rng.randint(-127, 128, (3, 3, ci, co)).astype(np.int8)
    k = rng.uniform(1e-4, 5e-4, (co,)).astype(np.float32)
    bias = rng.uniform(-3, 3, (co,)).astype(np.float32)
    return x_q, w_q, k, bias


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize(
    "shape,relu",
    [((2, 16, 24, 32), True), ((1, 8, 8, 64), True), ((2, 16, 24, 32), False), ((1, 25, 50, 64), True)],
)
def test_conv3x3_int8_matches_reference(shape, relu):
    rng = np.random.RandomState(sum(shape) + relu)
    case = _rand_case(rng, *shape, 64)
    want = np.asarray(pc.conv3x3_int8_reference(*map(jnp.asarray, case), relu=relu))
    before = conv_int8.conv3x3_int8_kernel.launches
    got = conv_int8.conv3x3_int8(*_torch(*case), relu=relu)
    assert conv_int8.conv3x3_int8_kernel.launches == before  # CPU tensors: the plain version
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_conv3x3_int8_matches_pallas_interpret():
    b, h, w, ci, co = 1, 8, 8, 64, 64
    x_q, w_q, k, bias = _rand_case(np.random.RandomState(11), b, h, w, ci, co)
    out = pc.conv3x3_int8(pc.pad_activation(jnp.asarray(x_q)), pc.pack_weights(jnp.asarray(w_q)),
                          jnp.asarray(k), jnp.asarray(bias), h=h, w=w, relu=False, interpret=True)
    want = np.asarray(pc.unpad_activation(out, h, w))
    got = conv_int8.conv3x3_int8(*_torch(x_q, w_q, k, bias), relu=False)
    np.testing.assert_array_equal(got.numpy(), want)


def test_two_link_chain_matches_reference():
    rng = np.random.RandomState(3)
    x_q, w1, k1, b1 = _rand_case(rng, 1, 16, 16, 32, 64)
    _, w2, k2, b2 = _rand_case(rng, 1, 16, 16, 64, 32)
    mid = pc.conv3x3_int8_reference(*map(jnp.asarray, (x_q, w1, k1, b1)))
    want = np.asarray(pc.conv3x3_int8_reference(mid, *map(jnp.asarray, (w2, k2, b2))))
    got = conv_int8.conv3x3_int8(conv_int8.conv3x3_int8(*_torch(x_q, w1, k1, b1)), *_torch(w2, k2, b2))
    np.testing.assert_array_equal(got.numpy(), want)


def test_conv3x3_int8_refusals_on_the_cpu():
    x_q, w_q, k, bias = _torch(*_rand_case(np.random.RandomState(5), 1, 4, 4, 32, 8))
    with pytest.raises(ValueError):  # the kernel takes CUDA tensors only
        conv_int8.conv3x3_int8_kernel(x_q, conv_int8.ohwi(w_q), k, bias)
    with pytest.raises(ValueError):
        conv_int8.conv3x3_int8(x_q.to(torch.int32), w_q, k, bias)
    with pytest.raises(ValueError):
        conv_int8.conv3x3_int8(x_q, w_q[:, :, :16], k, bias)
    with pytest.raises(ValueError):
        conv_int8.conv3x3_int8(x_q, w_q, k.double(), bias)
    with pytest.raises(ValueError):  # not a 4-d HWIO weight
        conv_int8.conv3x3_int8(x_q, w_q[0], k, bias)


def test_quantize_weights_and_activations_match_jax():
    rng = np.random.RandomState(4)
    kernel = rng.normal(0, 0.05, (3, 3, 32, 16)).astype(np.float32)
    kernel[..., 3] = 0.0  # an all-zero channel takes the 1e-12 floor
    w_q, s_w = quantize_weights(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
    ref_w_q, ref_s_w = _quantize_weights(jnp.asarray(kernel))
    np.testing.assert_array_equal(w_q.numpy().transpose(2, 3, 1, 0), np.asarray(ref_w_q))
    np.testing.assert_allclose(s_w.numpy(), np.asarray(ref_s_w), rtol=1e-7, atol=0)

    x = rng.normal(0, 2.0, (2, 5, 6, 7)).astype(np.float32)
    for amax in (1.5, 4.0, 0.0):
        x_q, s_x = quantize_activations(torch.from_numpy(x), torch.tensor(amax))
        ref_x_q, ref_s_x = _quantize_activations(jnp.asarray(x), jnp.float32(amax))
        assert x_q.dtype == torch.int8
        np.testing.assert_array_equal(x_q.numpy(), np.asarray(ref_x_q))
        np.testing.assert_allclose(float(s_x), float(ref_s_x), rtol=1e-7, atol=0)


def _random_params(model, shape, seed):
    """Parameters of the JAX model's shapes: normal draws of standard
    deviation 1/sqrt(fan_in) and small random biases, from a numpy seed
    (flax's own ``init`` trace takes ~12 s here)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32))
    rng = np.random.RandomState(seed)

    def draw(leaf):
        if len(leaf.shape) == 4:
            return rng.normal(0, np.prod(leaf.shape[:3]) ** -0.5, leaf.shape).astype(np.float32)
        return rng.uniform(-0.05, 0.05, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)["params"]


@pytest.fixture(scope="module")
def calibrated():
    """vgg-Q at full width, random parameters, a [2, 64, 64, 3] input, and
    JAX's calibrated amax over it."""
    x = np.random.RandomState(1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    model = JaxHourglass(n_keypoints=7, dtype=jnp.float32)
    params = _random_params(model, x.shape, seed=0)
    calib = dataclasses.replace(model, quant_mode="calibrate")
    qinit = jax.tree_util.tree_map(
        lambda leaf: jnp.zeros(leaf.shape, leaf.dtype),
        jax.eval_shape(calib.init, jax.random.PRNGKey(0), jnp.zeros(x.shape)),
    )["quant"]
    _, mut = jax.jit(lambda p, q, v: calib.apply({"params": p, "quant": q}, v, mutable=["quant"]))(
        params, qinit, x)
    return {"model": model, "params": params, "x": x,
            "qvars": jax.tree_util.tree_map(np.asarray, mut["quant"])}


def test_calibration_matches_jax(calibrated):
    model = DreamHourglass(7)
    model.load_state_dict(params_from_flax(calibrated["params"]), strict=True)
    x = torch.from_numpy(calibrated["x"]).permute(0, 3, 1, 2)
    qvars = calibrate(model, [x[:1], x[1:]])  # the max over batches is the max over frames
    ref = quant_from_flax(calibrated["qvars"])
    assert set(qvars) == set(ref) and len(ref) == 22  # every conv but head.conv2
    for name in ref:
        np.testing.assert_allclose(float(qvars[name]), float(ref[name]), rtol=5e-6, err_msg=name)
    assert all(m.mode == "float" for m in model.modules() if hasattr(m, "mode"))


def test_quant_flax_round_trip(calibrated):
    tree = calibrated["qvars"]
    back = quant_to_flax(quant_from_flax(tree))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == np.float32 and a.shape == () and a == b
    assert quant_from_flax({"quant": tree}).keys() == quant_from_flax(tree).keys()
    with pytest.raises(ValueError):
        quant_from_flax({"down1": {"conv0": {"kernel": np.zeros(3)}}})


# Jitted, as the JAX package runs it (op by op it takes 15 s here).
_jax_int8_xla = jax.jit(functools.partial(jax_vgg_q_int8_infer, dtype=jnp.float32, backend="xla"))


def _assert_int8_gate(got, want):
    """The xla-vs-pallas gate of tests/test_vgg_int8_deploy.py."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    delta = np.abs(got - want) / (np.abs(want).max() + 1e-9)
    assert np.quantile(delta, 0.99) < 0.02, np.quantile(delta, 0.99)
    assert delta.max() < 0.05, delta.max()


def test_vgg_q_int8_infer_matches_jax_xla_chain(calibrated):
    params, x = calibrated["params"], calibrated["x"]
    want = _jax_int8_xla(params, calibrated["qvars"], jnp.asarray(x))
    state = params_from_flax(params)
    before = conv_int8.conv3x3_int8_kernel.launches
    got = vgg_q_int8_infer(state, quant_from_flax(calibrated["qvars"]), torch.from_numpy(x))
    assert conv_int8.conv3x3_int8_kernel.launches == before
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, 7)
    _assert_int8_gate(got.numpy(), want)
    # And against the float model, the fidelity gate JAX's chains meet.
    ref_float = np.asarray(jax.jit(calibrated["model"].apply)({"params": params}, x)[-1], np.float64)
    assert np.corrcoef(got.numpy().ravel(), ref_float.ravel())[0, 1] > 0.99
    assert len(CHAIN) == 19


@pytest.mark.parametrize("signed", [True, False])
def test_qat_conv_matches_jax(signed):
    rng = np.random.RandomState(6 + signed)
    x = rng.uniform(-1 if signed else 0, 1, (2, 12, 12, 32)).astype(np.float32)
    kernel = rng.normal(0, 0.1, (3, 3, 32, 16)).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, 16).astype(np.float32)
    upstream = rng.normal(0, 1, (2, 12, 12, 16)).astype(np.float32)
    conv = JaxQuantConv(16, mode="qat")

    def jax_fn(p, v):
        y = conv.apply({"params": p}, v)
        return jnp.sum(y * upstream), y

    (_, want), (grad_p, grad_x) = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        {"kernel": kernel, "bias": bias}, x)
    module = QuantConv2d(32, 16, mode="qat")
    module.load_state_dict(params_from_flax({"kernel": kernel, "bias": bias}))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = module(xt)
    (y * torch.from_numpy(upstream).permute(0, 3, 1, 2)).sum().backward()
    for got, ref in [(y.detach().permute(0, 2, 3, 1), want), (xt.grad.permute(0, 2, 3, 1), grad_x),
                     (module.weight.grad.permute(2, 3, 1, 0), grad_p["kernel"]),
                     (module.bias.grad, grad_p["bias"])]:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_qat_forward_loss_and_gradients_match_jax(calibrated):
    params, x = calibrated["params"], calibrated["x"]
    target = np.random.RandomState(2).uniform(0, 1, (2, 16, 16, 7)).astype(np.float32) ** 8
    jax_model = JaxHourglass(n_keypoints=7, dtype=jnp.float32, quant_mode="qat")
    jax_criterion = jax_network._weighted_mse_loss(50.0)

    def jax_loss(p):
        pred = jax_model.apply({"params": p}, x)[0]
        return jax_criterion(pred, target), pred

    # Rounding as written (see the module's note on jit).
    as_written = {"xla_disable_hlo_passes": "algsimp", "xla_backend_optimization_level": 0}
    value_and_grad = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))
    (ref_loss, ref_pred), ref_grads = value_and_grad.lower(params).compile(compiler_options=as_written)(params)
    ref_grads = params_from_flax(jax.tree_util.tree_map(np.asarray, ref_grads))

    model = DreamHourglass(7, quant_mode="qat")
    model.load_state_dict(params_from_flax(params), strict=True)
    pred = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    loss = weighted_mse_loss(50.0)(pred, torch.from_numpy(target).permute(0, 3, 1, 2))
    loss.backward()

    got, want = pred.detach().permute(0, 2, 3, 1).numpy(), np.asarray(ref_pred)
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(ref_grads)
    for name, grad in grads.items():
        ref = ref_grads[name]
        assert float(torch.linalg.norm(ref)) > 0, name
        err = float(torch.linalg.norm(grad - ref) / torch.linalg.norm(ref))
        assert err < 1e-4, (name, err)


def _small_qat_config():
    cfg = jax_load_yaml(QAT_CONFIG)
    cfg["architecture"]["compute_dtype"] = "float32"
    cfg["training"]["config"]["net_input_resolution"] = list(NET_IN)
    cfg["training"]["config"]["net_output_resolution"] = list(NET_OUT)
    cfg["training"]["config"]["image_raw_resolution"] = list(RAW)
    return cfg


def test_enable_int8_inference_through_evaluate_frames_matches_jax():
    cfg = _small_qat_config()
    torch_net = DreamNetwork(copy.deepcopy(cfg), device="cpu")
    assert torch_net.quant_mode == "qat"
    jax_net = jax_network.create_network_from_config_data(copy.deepcopy(cfg))
    jax_net.variables = {"params": _random_params(jax_net.model, (1, 64, 64, 3), seed=7)}
    torch_net.model.load_state_dict(params_from_flax(jax_net.variables), strict=True)

    frames = generate_synthetic_frames(5, RAW, torch_net.keypoint_names, seed=5)
    gt = {"projections": frames["projections"], "positions": frames["positions"]}
    before = conv_int8.conv3x3_int8_kernel.launches
    result = evaluate_frames(torch_net, frames["images"], gt, frames["camera_K"], batch_size=2,
                             int8_calibration_frames=3)
    assert conv_int8.conv3x3_int8_kernel.launches == before
    assert torch_net.int8_chain is not None and result["detected_raw"].shape == (5, 7, 2)
    # The QAT model itself is untouched: its convs went back to "qat".
    assert all(m.mode == "qat" for m in torch_net.model.modules() if hasattr(m, "mode"))

    process = make_batch_processor(RAW, NET_IN, NET_OUT, "shrink-and-crop",
                                   cfg["architecture"]["image_normalization"],
                                   include_belief_maps=False)
    batches = collect_calibration_batches(frames["images"], process, 3, batch_size=2)
    assert [b.shape[0] for b in batches] == [2, 2]  # the first 4 frames, to reach 3
    ref_qvars = jax_net.enable_int8_inference([b.numpy() for b in batches])
    ref = quant_from_flax(jax.tree_util.tree_map(np.asarray, ref_qvars))
    qvars = torch_net.enable_int8_inference(batches)
    for name in ref:
        np.testing.assert_allclose(float(qvars[name]), float(ref[name]), rtol=1e-5, err_msg=name)

    x = batches[0]
    belief, keypoints = torch_net.inference(x)
    assert belief.shape == (2, 7, 16, 16) and keypoints.shape == (2, 7, 2)
    want = _jax_int8_xla(jax_net.variables["params"], ref_qvars, jnp.asarray(x.numpy()))
    _assert_int8_gate(belief.permute(0, 2, 3, 1).numpy(), want)
    # The chain is a snapshot of the parameters: changing the model after
    # enable_int8_inference changes nothing it computes.
    with torch.no_grad():
        for p in torch_net.model.parameters():
            p.add_(1.0)
    assert torch.equal(torch_net.inference(x)[0], belief)
