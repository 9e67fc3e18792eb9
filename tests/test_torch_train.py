"""The port's training half against dream_tpu, on the CPU in float32.

- Losses: mse, huber, weighted MSE and its symmetric form
  (``dream_tpu/network.py:70-118``), values to rtol 1e-5 and gradients with
  respect to the prediction to rtol 1e-5 / atol 1e-9 (the sums' order).
- Schedule: ``warmup_cosine_decay`` against ``optax.warmup_cosine_decay_schedule``
  (float32) to rtol 1e-6 and atol 1e-11 (float32's spacing at 1 times the
  1e-4 peak, where the cosine reaches 0); clipping: ``clip_by_global_norm_`` against
  ``optax.clip_by_global_norm`` to rtol 1e-6, above and below the norm.
- Train step: vgg-Q at full width with a 64x64 input and batch 2, float32
  on both sides, the same initial parameters (jax's, carried over with
  ``params_from_flax``), two ``train_raw`` steps with augmentation off
  (jax through ``enable_fused_training``), the r5 recipe (weighted MSE,
  Adam 1e-4, cosine schedule) with the clip norm lowered from 1.0 to 0.25
  so that clipping acts (the step's gradient norm is ~0.5), and an EMA of
  decay 0.5.  Losses
  agree to rtol 1e-5.  The clipped gradients of step 1 (jax's are Adam's
  first moment over 1 - beta1) agree leaf by leaf to 1e-4 of the leaf's
  largest entry: the two convolution libraries sum in other orders.  The
  parameters after step 2 and the EMA agree to 2e-6, a fiftieth of one
  Adam step (lr 1e-4).
- Checkpoints: a port-saved checkpoint loads in ``dream_tpu`` with leaves
  bit-equal to the port's, both through ``load_network_params`` and
  ``flax.serialization.msgpack_restore``, and has flax's own bytes; the two
  packages' inference on it agrees to 1e-4 (belief maps); the sidecar reads
  back through both YAML readers.
- Init: per layer, the weights' standard deviation is within 5% of
  ``1/sqrt(fan_in)`` and none exceeds flax's truncation, biases are zero,
  and a seed gives the same parameters.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
import yaml
from flax import serialization

from dream_tpu import network as jax_network
from dream_tpu.data.dataset import make_batch_processor as jax_make_batch_processor
from dream_tpu.utils.config import load_yaml as jax_load_yaml

from dream_tpu_torch import network
from dream_tpu_torch.checkpoint import params_from_flax, params_to_flax
from dream_tpu_torch.data.dataset import make_batch_processor
from dream_tpu_torch.network import DreamNetwork, create_network_from_config_file
from dream_tpu_torch.utils.config import load_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.yaml")
RAW, NET_IN, NET_OUT = (128, 96), (64, 64), (16, 16)
EMA_DECAY = 0.5
CLIP_NORM = 0.25


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing
    and slow the other test workers: two threads take less CPU time than
    the machine's count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def small_config():
    """The r5 vgg-Q sidecar at a 64x64 net input, float32."""
    cfg = jax_load_yaml(CONFIG)
    cfg["architecture"]["compute_dtype"] = "float32"
    cfg["training"]["config"]["net_input_resolution"] = list(NET_IN)
    cfg["training"]["config"]["net_output_resolution"] = list(NET_OUT)
    cfg["training"]["config"]["image_raw_resolution"] = list(RAW)
    return cfg


def train_config():
    cfg = small_config()
    cfg["training"]["config"]["optimizer"]["grad_clip_norm"] = CLIP_NORM
    return cfg


def jax_variables(jax_net, seed):
    """Parameters of the JAX network's shapes: lecun-normal-like draws from a
    numpy seed, zero biases (jax's own ``init`` trace takes ~12 s here)."""
    shapes = jax.eval_shape(jax_net.model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, NET_IN[1], NET_IN[0], 3)))
    rng = np.random.RandomState(seed)

    def draw(leaf):
        if len(leaf.shape) == 4:
            fan_in = int(np.prod(leaf.shape[:3]))
            return jnp.asarray(rng.normal(0, fan_in ** -0.5, leaf.shape).astype(np.float32))
        return jnp.zeros(leaf.shape, jnp.float32)

    return jax.tree_util.tree_map(draw, shapes)


def _batch(seed):
    rng = np.random.RandomState(seed)
    raw = rng.randint(0, 256, (2, RAW[1], RAW[0], 3)).astype(np.uint8)
    kps = rng.uniform([42, 26], [80, 64], (2, 7, 2)).astype(np.float32)
    return raw, kps


def _processor_args(cfg):
    return (RAW, NET_IN, NET_OUT, "shrink-and-crop", cfg["architecture"]["image_normalization"])


@pytest.fixture(scope="module")
def trained():
    """Both packages, the same start, two train_raw steps each."""
    cfg = train_config()
    jax_net = jax_network.create_network_from_config_data(copy.deepcopy(cfg))
    jax_net.variables = jax_variables(jax_net, seed=0)
    start = jax.tree_util.tree_map(np.asarray, jax_net.variables)
    jax_net.enable_ema(EMA_DECAY)
    jax_net.enable_fused_training(jax_make_batch_processor(*_processor_args(cfg), augment=False))

    torch_net = DreamNetwork(copy.deepcopy(cfg), device="cpu")
    torch_net.model.load_state_dict(params_from_flax(start), strict=True)
    torch_net.enable_ema(EMA_DECAY)
    torch_net.enable_fused_training(make_batch_processor(*_processor_args(cfg), augment=False))

    out = {"jax_net": jax_net, "torch_net": torch_net, "jax_loss": [], "torch_loss": []}
    for step, seed in enumerate((1, 2)):
        raw, kps = _batch(seed)
        out["jax_loss"].append(float(jax_net.train_raw(jax.random.PRNGKey(step), raw, kps)))
        out["torch_loss"].append(float(torch_net.train_raw(None, torch.from_numpy(raw),
                                                           torch.from_numpy(kps))))
        if step == 0:
            mu = jax_net.opt_state[1][0].mu  # chain(clip, adam): adam's first moment
            out["jax_grads"] = params_from_flax(
                jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, {"params": mu})
            )
            out["torch_grads"] = {
                name: p.grad.detach().clone() for name, p in torch_net.model.named_parameters()
            }
    return out


def test_train_raw_losses_match_jax(trained):
    assert all(np.isfinite(trained["torch_loss"]))
    np.testing.assert_allclose(trained["torch_loss"], trained["jax_loss"], rtol=1e-5)


def test_step_one_gradients_match_jax(trained):
    ref, ours = trained["jax_grads"], trained["torch_grads"]
    assert set(ref) == set(ours) and len(ours) == 46
    for name, g in ours.items():
        scale = float(ref[name].abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=1e-4 * scale, rtol=0,
                                   err_msg=name)
    # Clipping acted: the step's gradients have the clip norm.
    norm = torch.sqrt(sum((g * g).sum() for g in ours.values()))
    assert abs(float(norm) - CLIP_NORM) < 1e-6


def test_params_and_ema_after_two_steps_match_jax(trained):
    jax_net, torch_net = trained["jax_net"], trained["torch_net"]
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, jax_net.variables))
    ref_ema = params_from_flax(jax.tree_util.tree_map(np.asarray, {"params": jax_net.ema_params}))
    ours, ours_ema = torch_net.model.state_dict(), torch_net.ema_variables()
    for name in ours:
        np.testing.assert_allclose(ours[name].numpy(), ref[name].numpy(), atol=2e-6, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(ours_ema[name].numpy(), ref_ema[name].numpy(), atol=2e-6,
                                   rtol=0, err_msg=name)
    # The EMA and the parameters moved apart: the comparison is not vacuous.
    assert max(float((ours[n] - ours_ema[n]).abs().max()) for n in ours) > 1e-5


def test_eval_loss_with_ema_matches_jax(trained):
    jax_net, torch_net = trained["jax_net"], trained["torch_net"]
    raw, kps = _batch(3)
    cfg = small_config()
    batch = make_batch_processor(*_processor_args(cfg))(None, torch.from_numpy(raw), torch.from_numpy(kps))
    x, target = batch["image_rgb_input"], batch["belief_maps"]
    ref = float(jax_net.loss([x.numpy()], target.numpy(), variables=jax_net.ema_variables()))
    ours = float(torch_net.loss([x], target, variables=torch_net.ema_variables()))
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    ref_live = float(jax_net.loss([x.numpy()], target.numpy()))
    np.testing.assert_allclose(float(torch_net.loss([x], target)), ref_live, rtol=1e-5)


def test_saved_checkpoint_loads_in_dream_tpu(trained, tmp_path):
    torch_net = trained["torch_net"]
    torch_net.save_network(str(tmp_path), "net")
    with pytest.raises(FileExistsError):
        torch_net.save_network(str(tmp_path), "net")
    params_path, yaml_path = str(tmp_path / "net.msgpack"), str(tmp_path / "net.yaml")
    ours = params_to_flax(torch_net.model.state_dict())

    with open(params_path, "rb") as f:
        data = f.read()
    restored = serialization.msgpack_restore(data)
    jax_net = jax_network.create_network_from_config_data(jax_load_yaml(yaml_path))
    jax_net.variables = jax.eval_shape(lambda: trained["jax_net"].variables)
    jax_net.load_network_params(params_path)
    ref_leaves = jax.tree_util.tree_leaves_with_path(ours)
    for tree in (restored, jax_net.variables):
        leaves = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert len(leaves) == len(ref_leaves) == 46
        for path, leaf in ref_leaves:
            assert leaves[path].dtype == np.float32
            np.testing.assert_array_equal(np.asarray(leaves[path]), leaf)
    assert data == serialization.to_bytes(jax_net.variables)

    x = np.random.RandomState(4).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ref_belief, _ = jax_net.inference(x)
    reloaded = create_network_from_config_file(yaml_path, params_path, device="cpu")
    belief, _ = reloaded.inference(torch.from_numpy(x))
    np.testing.assert_allclose(belief.numpy(), np.asarray(ref_belief), atol=1e-4, rtol=0)

    with open(yaml_path) as f:
        text = f.read()
    assert load_yaml(yaml_path) == yaml.safe_load(text) == torch_net.network_config


def _pred_target(seed):
    rng = np.random.RandomState(seed)
    target = np.zeros((2, 7, 16, 16), np.float32)
    target[:, :, 4:9, 5:10] = rng.rand(2, 7, 5, 5)
    pred = (target + rng.normal(0, 0.8, target.shape)).astype(np.float32)
    return pred, target


@pytest.mark.parametrize("kind", ["mse", "huber", "weighted_mse", "weighted_mse_symmetric"])
def test_losses_and_gradients_match_jax(kind):
    pred, target = _pred_target(5)
    ref_fn, ours_fn = {
        "mse": (jax_network._mse_loss, network.mse_loss),
        "huber": (jax_network._huber_loss, network.huber_loss),
        "weighted_mse": (jax_network._weighted_mse_loss(50.0), network.weighted_mse_loss(50.0)),
        "weighted_mse_symmetric": (jax_network._weighted_mse_loss(50.0, symmetric=True),
                                   network.weighted_mse_loss(50.0, symmetric=True)),
    }[kind]
    ref, ref_grad = jax.value_and_grad(ref_fn)(jnp.asarray(pred), jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_(True)
    loss = ours_fn(p, torch.from_numpy(target))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grad), rtol=1e-5, atol=1e-9)
    if kind == "huber":
        assert (np.abs(pred - target) > 1).any() and (np.abs(pred - target) < 1).any()


def test_criterion_from_config():
    assert network.criterion_from_config({"type": "mse"}) is network.mse_loss
    pred, target = _pred_target(6)
    p, t = torch.from_numpy(pred), torch.from_numpy(target)
    sym = network.criterion_from_config({"type": "weighted_mse", "pos_weight": 50.0, "symmetric": True})
    assert float(sym(p, t)) == float(network.weighted_mse_loss(50.0, True)(p, t))
    with pytest.raises(NotImplementedError):
        network.criterion_from_config({"type": "focal"})


@pytest.mark.parametrize("warmup,decay,end", [(0, 15450, 0.0), (10, 100, 1e-6)])
def test_schedule_matches_optax(warmup, decay, end):
    ref = optax.warmup_cosine_decay_schedule(0.0, 1e-4, warmup, decay, end)
    for step in (0, 1, warmup // 2, warmup, (warmup + decay) // 2, decay - 1, decay, decay + 5):
        ours = network.warmup_cosine_decay(step, 1e-4, warmup, decay, end)
        np.testing.assert_allclose(ours, float(ref(step)), rtol=1e-6, atol=1e-11, err_msg=str(step))


def test_scheduler_steps_the_optimizer_as_optax_counts():
    cfg = small_config()
    cfg["training"]["config"]["optimizer"]["schedule"] = {"type": "cosine", "decay_steps": 20,
                                                          "warmup_steps": 4}
    net = DreamNetwork(cfg, device="cpu")
    net.enable_training()
    for p in net.model.parameters():
        p.grad = torch.zeros_like(p)
    ref = optax.warmup_cosine_decay_schedule(0.0, 1e-4, 4, 20)
    for step in range(6):
        assert int(net._count) == step
        net._apply_gradients()  # the learning rate of step ``step``, from the count
        np.testing.assert_allclose(float(net.optimizer.param_groups[0]["lr"]), float(ref(step)),
                                   rtol=1e-6, atol=1e-11)
    assert int(net._count) == 6


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_matches_optax(max_norm):
    rng = np.random.RandomState(7)
    grads = [rng.normal(0, 3, s).astype(np.float32) for s in ((4, 3), (7,), (2, 2, 5))]
    ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    ours = [torch.from_numpy(g.copy()) for g in grads]
    norm = network.clip_by_global_norm_(ours, max_norm)
    assert (float(norm) > max_norm) == (max_norm == 0.5)
    for o, r, g in zip(ours, ref, grads):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6)
        if max_norm == 50.0:
            np.testing.assert_array_equal(o.numpy(), g)


def test_init_follows_flax_defaults():
    cfg = small_config()
    net = DreamNetwork(cfg, device="cpu", seed=3)
    again = DreamNetwork(copy.deepcopy(cfg), device="cpu", seed=3)
    other = DreamNetwork(copy.deepcopy(cfg), device="cpu", seed=4)
    state, state_again, state_other = (n.model.state_dict() for n in (net, again, other))
    for name, leaf in state.items():
        assert torch.equal(leaf, state_again[name]), name
        if name.endswith("bias"):
            assert not leaf.any(), name
            continue
        assert not torch.equal(leaf, state_other[name]), name
        fan_in = leaf[0].numel()
        std = fan_in ** -0.5
        assert abs(float(leaf.std()) / std - 1) < 0.05, name
        assert float(leaf.abs().max()) <= 2 * std / 0.87962566103423978 * (1 + 1e-6), name
    before = {k: v.clone() for k, v in state.items()}
    net.init_variables(seed=4)  # idempotent without force
    assert all(torch.equal(before[k], v) for k, v in net.model.state_dict().items())
    net.init_variables(seed=4, force=True)
    assert all(torch.equal(state_other[k], v) for k, v in net.model.state_dict().items())
