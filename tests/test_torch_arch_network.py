"""The port's DreamNetwork on the new architectures against dream_tpu, on the CPU.

Networks come from the committed sidecars cut to size: ResNet-H
(``results_r4/resnet_h``) with ``layers: [1, 1, 1, 1]``, vgg-F
(``results_r5/vggf``), and the vgg-Q sidecar with ``n_stages: 2``, at a
64x64 net input, float32 (set in the loaded config dict) unless a test says
otherwise, without gradient clipping so that ``p.grad`` after a step is the
raw gradient.  Parameters are numpy draws of the JAX network's shapes.

- ``loss`` (BatchNorm on its running statistics) agrees to rtol 1e-5; one
  ``train`` step's loss to rtol 1e-5 and its gradients leaf by leaf to 1e-4
  of the leaf's largest entry (the convolution libraries sum in other
  orders), 2e-3 for the ResNet: BatchNorm over a batch of 2 amplifies the
  summation orders until the train-mode forward agrees to ~1e-5, which
  flips the ReLU mask at the few activations that close to zero, and the
  gradients behind them move by up to 8e-4 of their largest entry (seen;
  both packages' float32 gradients of the first conv are 1e-3 of it from a
  float64 one, so the JAX side is differentiated op by op, as the port
  runs, not under jit, which reorders it further).  The transposed convs'
  biases, right before a BatchNorm, have no gradient and hold noise under
  1e-6 of the largest entry on both sides.  The running statistics after
  the step agree to rtol 1e-4, atol 1e-5.  The
  multistage loss is the criterion over the stacked stage outputs.
- A saved ResNet checkpoint holds ``params`` and ``batch_stats`` and loads in
  ``dream_tpu``, whose inference agrees with the port's to 1e-5.
- Output resolutions and peak offsets of the three committed sidecars equal
  ``dream_tpu``'s.
- QAT from vgg-Q's bf16 sidecar runs in bf16 as the reference does: maps
  within a relative L2 error of 0.03 of ``dream_tpu``'s bf16 maps, correlation
  at least 0.999; its int8 chain takes the bf16 compute dtype too (the gate
  the test states).
- ``slow``: ResNet-F's fixed-batch loss trajectory against dream_tpu's.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from dream_tpu import network as jax_network
from dream_tpu.utils.config import load_yaml as jax_load_yaml

from dream_tpu_torch import checkpoint
from dream_tpu_torch.network import DreamNetwork, create_network_from_config_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDECARS = {
    "vgg-F": "trained_models/results_r5/vggf/dream_vgg_f_r5.yaml",
    "resnet-H": "trained_models/results_r4/resnet_h/dream_resnet_h_r4.yaml",
    "resnet-F": "trained_models/results_r5/resnetf/dream_resnet_f_r5.yaml",
    "vgg-Q": "trained_models/results_r5/vggq/dream_vgg_q_r5.yaml",
}
NET_IN = 64


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing
    and slow the other test workers: two threads take less CPU time than
    the machine's count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def small_config(arch, dtype="float32"):
    """A committed sidecar at a 64x64 net input, no clipping; ``2-stage`` is
    vgg-Q's with ``n_stages: 2``, the ResNet has one block a layer."""
    cfg = jax_load_yaml(os.path.join(ROOT, SIDECARS["vgg-Q" if arch == "2-stage" else arch]))
    cfg["architecture"]["compute_dtype"] = dtype
    if arch == "2-stage":
        cfg["architecture"]["n_stages"] = 2
    if arch.startswith("resnet"):
        cfg["architecture"]["layers"] = [1, 1, 1, 1]
    tcfg = cfg["training"]["config"]
    tcfg["net_input_resolution"] = [NET_IN, NET_IN]
    del tcfg["net_output_resolution"]
    del tcfg["optimizer"]["grad_clip_norm"]
    return cfg


def jax_variables(jax_net, seed):
    shapes = jax.eval_shape(lambda: jax_net.model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, NET_IN, NET_IN, 3)),
        **({"train": False} if jax_net._has_batch_stats else {})))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if len(leaf.shape) == 4:
            return jnp.asarray(rng.normal(0, np.prod(leaf.shape[:3]) ** -0.5, leaf.shape), jnp.float32)
        if name in ("scale", "var"):
            return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape), jnp.float32)
        return jnp.asarray(rng.normal(0, 0.05, leaf.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def both_networks(arch, dtype="float32", seed=0):
    cfg = small_config(arch, dtype)
    jax_net = jax_network.create_network_from_config_data(copy.deepcopy(cfg))
    jax_net.variables = jax_variables(jax_net, seed)
    torch_net = DreamNetwork(copy.deepcopy(cfg), device="cpu")
    torch_net.model.load_state_dict(
        checkpoint.state_from_flax(jax.tree_util.tree_map(np.asarray, jax_net.variables)),
        strict=True)
    return jax_net, torch_net


def batch(arch, seed):
    rng = np.random.RandomState(seed)
    out = 16 if arch == "2-stage" else 32 if arch == "resnet-H" else 64
    x = rng.uniform(-1, 1, (2, NET_IN, NET_IN, 3)).astype(np.float32)
    target = np.zeros((2, 7, out, out), np.float32)
    target[:, :, out // 4: out // 2, out // 3: out // 2] = rng.rand(2, 7, out // 4, out // 2 - out // 3)
    return x, target


@pytest.mark.parametrize("arch", ["resnet-H", "vgg-F", "2-stage"])
def test_loss_and_train_step_match_jax(arch):
    jax_net, torch_net = both_networks(arch)
    x, target = batch(arch, 1)
    ref_eval = float(jax_net.loss([x], target))
    ours_eval = float(torch_net.loss([torch.from_numpy(x)], torch.from_numpy(target)))
    np.testing.assert_allclose(ours_eval, ref_eval, rtol=1e-5)

    def compute(params):
        return jax_net.loss_fn(dict(jax_net.variables, params=params), x, target, train=True)

    grad_fn = jax.value_and_grad(compute, has_aux=True)
    if not arch.startswith("resnet"):
        # jit only where it cannot matter: normalising over a batch of 2 at
        # 2x2 (the ResNet's layer4) makes the backward ill-conditioned in
        # float32, and XLA's jit reorders it.
        grad_fn = jax.jit(grad_fn)
    (ref_loss, ref_stats), ref_grads = grad_fn(jax_net.variables["params"])
    torch_net.enable_training()
    loss = float(torch_net.train([torch.from_numpy(x)], torch.from_numpy(target)))
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
    grads = checkpoint.params_from_flax(jax.tree_util.tree_map(np.asarray, ref_grads))
    ours = {name: p.grad for name, p in torch_net.model.named_parameters()}
    assert set(grads) == set(ours)
    tol = 2e-3 if arch.startswith("resnet") else 1e-4
    largest = max(float(g.abs().max()) for g in grads.values())
    for name, g in ours.items():
        scale = float(grads[name].abs().max())
        if arch.startswith("resnet") and name.endswith("deconv.bias"):
            # A bias right before a BatchNorm has no gradient: both sides
            # hold rounding noise.
            assert max(scale, float(g.abs().max())) <= 1e-6 * largest, name
            continue
        np.testing.assert_allclose(g.numpy(), grads[name].numpy(), atol=tol * scale + 1e-12,
                                   rtol=0, err_msg=name)
    if arch == "resnet-H":
        stats = checkpoint.batch_stats_from_flax(jax.tree_util.tree_map(np.asarray, ref_stats))
        state = torch_net.model.state_dict()
        assert len(stats) == 42
        for name, value in stats.items():
            np.testing.assert_allclose(state[name].numpy(), value.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=name)


def test_multistage_loss_is_over_the_stacked_stages():
    jax_net, torch_net = both_networks("2-stage", seed=2)
    x, target = batch("2-stage", 3)
    with torch.no_grad():
        stages = torch_net._stage_outputs(torch.from_numpy(x))
    assert len(stages) == 2 and stages[0].shape == (2, 7, 16, 16)
    stacked = torch.stack(stages)
    expected = torch_net.criterion(stacked, torch.from_numpy(target).expand_as(stacked))
    ours = torch_net.loss([torch.from_numpy(x)], torch.from_numpy(target))
    assert float(ours) == float(expected)
    # Inference takes the last stage; both stages' maps agree with dream_tpu's.
    belief, keypoints = torch_net.inference(torch.from_numpy(x))
    assert torch.equal(belief, stages[1]) and keypoints.shape == (2, 7, 2)
    ref_stages = jax.jit(jax_net.model.apply)(jax_net.variables, x)
    for ours_stage, ref_stage in zip(stages, ref_stages):
        np.testing.assert_allclose(ours_stage.numpy(), np.asarray(ref_stage).transpose(0, 3, 1, 2),
                                   atol=1e-5, rtol=0)


def test_batch_stats_move_in_train_steps_only():
    _, net = both_networks("resnet-H", seed=4)
    x, target = batch("resnet-H", 5)
    xt, tt = torch.from_numpy(x), torch.from_numpy(target)

    def stats():
        return {k: v.clone() for k, v in net.model.state_dict().items() if "running" in k}

    start = stats()
    net.loss([xt], tt)
    net.inference(xt)
    assert all(torch.equal(v, start[k]) for k, v in stats().items())
    net.enable_ema(0.5)
    net.enable_training()
    net.train([xt], tt)
    moved = stats()
    assert all(not torch.equal(v, start[k]) for k, v in moved.items())
    assert not net.model.training
    # The EMA covers parameters; ema_variables carries the current statistics.
    ema = net.ema_variables()
    assert set(ema) == set(net.model.state_dict())
    assert all(torch.equal(ema[k], v) for k, v in moved.items())
    params = dict(net.model.named_parameters())
    assert any(not torch.equal(ema[k], p) for k, p in params.items())
    net.loss([xt], tt, variables=ema)
    assert all(torch.equal(v, moved[k]) for k, v in stats().items())


def test_saved_resnet_loads_in_dream_tpu(tmp_path):
    """A bf16 ResNet saves a bfloat16 sidecar and {params, batch_stats};
    the port reloads it bit for bit and dream_tpu reads it."""
    jax_net, net = both_networks("resnet-H", dtype="bfloat16", seed=6)  # statistics drawn too
    x, _ = batch("resnet-H", 7)
    net.save_network(str(tmp_path), "net")
    yaml_path, params_path = str(tmp_path / "net.yaml"), str(tmp_path / "net.msgpack")
    with open(params_path, "rb") as f:
        restored = serialization.msgpack_restore(f.read())
    assert set(restored) == {"params", "batch_stats"}
    reloaded = create_network_from_config_file(yaml_path, params_path, device="cpu")
    assert reloaded.network_config["architecture"]["compute_dtype"] == "bfloat16"
    assert reloaded.compute_dtype == torch.bfloat16
    saved, back = net.model.state_dict(), reloaded.model.state_dict()
    assert set(saved) == set(back) and all(torch.equal(saved[k], back[k]) for k in saved)
    assert torch.equal(net.inference(torch.from_numpy(x))[0], reloaded.inference(torch.from_numpy(x))[0])

    cfg = jax_load_yaml(yaml_path)
    cfg["architecture"]["compute_dtype"] = "float32"
    ref_net = jax_network.create_network_from_config_data(cfg)
    ref_net.variables = jax.eval_shape(lambda: jax_net.variables)
    ref_net.load_network_params(params_path)
    ours = checkpoint.state_to_flax(saved)
    for collection in ("params", "batch_stats"):
        leaves = dict(jax.tree_util.tree_leaves_with_path(ref_net.variables[collection]))
        for path, leaf in jax.tree_util.tree_leaves_with_path(ours[collection]):
            np.testing.assert_array_equal(np.asarray(leaves[path]), leaf)
    port32 = DreamNetwork.from_checkpoint(copy.deepcopy(cfg), params_path, device="cpu")
    belief, _ = port32.inference(torch.from_numpy(x))
    np.testing.assert_allclose(belief.numpy(), np.asarray(ref_net.inference(x)[0]), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("arch,out,offset", [("vgg-F", 400, 0.0), ("resnet-H", 208, 0.4395),
                                             ("resnet-F", 416, 0.0)])
def test_output_resolution_and_offset_match_jax(arch, out, offset):
    cfg = jax_load_yaml(os.path.join(ROOT, SIDECARS[arch]))
    ref = jax_network.create_network_from_config_data(copy.deepcopy(cfg))
    if arch.startswith("resnet"):  # resolution algebra only: a one-block trunk builds fast
        cfg["architecture"]["layers"] = [1, 1, 1, 1]
    ours = DreamNetwork(cfg, device="cpu")
    assert ours.trained_net_output_resolution() == ref.trained_net_output_resolution() == (out, out)
    assert ours.peak_offset_due_to_upsampling() == ref.peak_offset_due_to_upsampling() == offset
    for raw in [(640, 480), (1280, 720)]:
        assert ours.net_resolutions_from_image_raw_resolution(raw) == \
            ref.net_resolutions_from_image_raw_resolution(raw)


def test_unported_options_are_refused(monkeypatch):
    """QAT of a ResNet (as dream_tpu), and vgg-Q's int8 chain asked for by
    name on a ResNet, which the chain cannot take (dream_tpu falls back to
    its quantconv graph; the port raises)."""
    cfg = small_config("resnet-H")
    cfg["architecture"]["quant_mode"] = "qat"
    with pytest.raises(ValueError, match="QAT applies to vgg"):
        DreamNetwork(cfg, device="cpu")
    _, net = both_networks("resnet-H")
    monkeypatch.setenv("DREAM_INT8_IMPL", "pallas")
    with pytest.raises(ValueError, match="cannot take"):
        net.enable_int8_inference([torch.zeros(1, NET_IN, NET_IN, 3)])


def test_qat_from_bf16_sidecar_runs_bf16():
    cfg = jax_load_yaml(os.path.join(ROOT, "trained_models/results_r5/vggq_qat/dream_vgg_q_qat_r5.yaml"))
    assert cfg["architecture"]["compute_dtype"] == "bfloat16"
    assert cfg["architecture"]["quant_mode"] == "qat"
    cfg["training"]["config"]["net_input_resolution"] = [NET_IN, NET_IN]
    del cfg["training"]["config"]["net_output_resolution"]
    jax_net = jax_network.create_network_from_config_data(copy.deepcopy(cfg))
    jax_net.variables = jax_variables(jax_net, 8)
    net = DreamNetwork(copy.deepcopy(cfg), device="cpu")
    net.model.load_state_dict(checkpoint.state_from_flax(
        jax.tree_util.tree_map(np.asarray, jax_net.variables)), strict=True)
    seen = []
    net.model.down4.conv2.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    x, _ = batch("vgg-Q", 9)
    belief, _ = net.inference(torch.from_numpy(x))
    assert seen == [torch.bfloat16] and belief.dtype == torch.float32
    ref = np.asarray(jax_net.inference(x)[0], np.float32)
    ours = belief.numpy()
    rel = np.linalg.norm(ours - ref) / np.linalg.norm(ref)
    corr = np.corrcoef(ours.ravel(), ref.ravel())[0, 1]
    assert rel <= 0.03 and corr >= 0.999, (rel, corr)


@pytest.mark.slow
def test_resnet_f_fixed_batch_run_tracks_jax():
    """ResNet-F at full depth, a 128x128 input and batch 8, from the same
    initial state through the r5 recipe (Adam 2e-4, symmetric weighted MSE)
    on one fixed batch of rendered frames: the two packages' losses agree
    to 10% at each of 8 steps; both rise before they fall."""
    from dream_tpu_torch.data.dataset import make_batch_processor
    from dream_tpu_torch.data.synthetic import generate_synthetic_frames

    cfg = jax_load_yaml(os.path.join(ROOT, SIDECARS["resnet-F"]))
    cfg["architecture"]["compute_dtype"] = "float32"
    cfg["training"]["config"]["net_input_resolution"] = [128, 128]
    del cfg["training"]["config"]["net_output_resolution"]
    net = DreamNetwork(copy.deepcopy(cfg), device="cpu", seed=0)
    jax_net = jax_network.create_network_from_config_data(copy.deepcopy(cfg))
    jax_net.variables = jax.tree_util.tree_map(
        jnp.asarray, checkpoint.state_to_flax(net.model.state_dict()))
    frames = generate_synthetic_frames(8, (640, 480), seed=0)
    process = make_batch_processor((640, 480), (128, 128), net.trained_net_output_resolution(),
                                   "shrink-and-crop", net.image_normalization)
    b = process(None, torch.from_numpy(frames["images"]),
                torch.from_numpy(frames["projections"]).float())
    x, target = b["image_rgb_input"], b["belief_maps"]
    net.enable_training()
    jax_net.enable_training()
    ours, ref = [], []
    for _ in range(8):
        ours.append(float(net.train([x], target)))
        ref.append(float(jax_net.train([x.numpy()], target.numpy())))
    print("port:", ours, "dream_tpu:", ref)
    np.testing.assert_allclose(ours, ref, rtol=0.1)
    for losses in (ours, ref):
        assert max(losses[1:4]) > losses[0] and losses[-1] < losses[0]


def test_int8_chain_takes_the_sidecar_bf16(monkeypatch):
    """enable_int8_inference on vgg-Q's bf16 sidecar hands the chain the
    bf16 compute dtype (``dream_tpu/network.py:902-915``), and its maps meet
    the xla-vs-pallas gate of tests/test_vgg_int8_deploy.py against JAX's
    ``vgg_q_int8_infer(..., dtype=bfloat16, backend="xla")`` on the same
    parameters and calibration: 99% of entries within 0.02 of the largest
    map value, all within 0.05."""
    from dream_tpu.models.vgg_int8_deploy import vgg_q_int8_infer as jax_vgg_q_int8_infer

    from dream_tpu_torch.checkpoint import quant_to_flax
    from dream_tpu_torch.models import vgg_int8_deploy

    cfg = small_config("vgg-Q", dtype="bfloat16")
    jax_net = jax_network.create_network_from_config_data(copy.deepcopy(cfg))
    jax_net.variables = jax_variables(jax_net, 10)
    net = DreamNetwork(copy.deepcopy(cfg), device="cpu")
    net.model.load_state_dict(checkpoint.state_from_flax(
        jax.tree_util.tree_map(np.asarray, jax_net.variables)), strict=True)
    x, _ = batch("vgg-Q", 11)
    qvars = net.enable_int8_inference([torch.from_numpy(x)])
    seen = []
    run = vgg_int8_deploy.run_int8_chain
    monkeypatch.setattr(vgg_int8_deploy, "run_int8_chain",
                        lambda chain, net_in, dtype: seen.append(dtype) or run(chain, net_in, dtype))
    belief, _ = net.inference(torch.from_numpy(x))
    assert seen == [torch.bfloat16] and belief.dtype == torch.float32
    want = jax.jit(lambda p, q, v: jax_vgg_q_int8_infer(p, q, v, dtype=jnp.bfloat16, backend="xla"))(
        jax_net.variables["params"], quant_to_flax(qvars), jnp.asarray(x))
    got = belief.permute(0, 2, 3, 1).numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape == (2, 16, 16, 7)
    delta = np.abs(got - want) / (np.abs(want).max() + 1e-9)
    assert np.quantile(delta, 0.99) < 0.02 and delta.max() < 0.05, (np.quantile(delta, 0.99), delta.max())
