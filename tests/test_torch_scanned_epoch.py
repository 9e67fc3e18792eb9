"""The port's scanned epoch against dream_tpu's, on the CPU in float32.

- Epochs: ``dream_tpu``'s ``test_scanned_epoch_training`` network (the vgg
  hourglass with 4 key points, 64x64 input, 16x16 maps), 128x96 raw frames
  held as tensors, batch 4, augmentation off, the same start (jax's
  parameters carried over with ``params_from_flax``), global-norm clipping
  at 0.25 (the steps' gradient norms lie above it), an EMA of decay 0.5 and
  SGD at 0.05 under a cosine schedule with a 2-step warmup; two epochs of
  two steps through ``enable_scanned_training`` + ``train_epoch_raw`` in
  both packages (a ``lax.scan`` in ``dream_tpu``, the eager loop of the
  step on the CPU here).  Losses agree to rtol 1e-5, and the state and the
  EMA after each epoch to 2e-6 (``tests/test_torch_train.py``'s bounds;
  this network has no BatchNorm, so the state is its parameters), and the
  optax state's counts equal the steps taken.  SGD, not Adam: Adam moves
  every weight whose gradient is float32 rounding about zero by up to its
  learning rate, so four Adam steps at 1e-4 part ``dream_tpu``'s own
  scanned and fused runs by 2e-4.  Adam's CPU step is held against optax
  in ``tests/test_torch_train.py`` and ``tests/test_torch_cli.py``; here
  a scanned Adam epoch leaves the optimizer's count equal to ``steps``.
- The device schedule: ``warmup_cosine_decay_device`` on int32 step tensors
  against ``optax.warmup_cosine_decay_schedule`` at every step of a warmup
  and a decay and past its end, to rtol 1e-6 and atol 1e-11
  (``test_schedule_matches_optax``'s bounds).
- Refusals: ``train_epoch_raw`` without ``enable_scanned_training`` (after
  ``enable_fused_training`` alone, or after it replaced the scanned
  processor), and a scanned network on a mesh.

``dream_tpu``'s scanned epoch runs ~4 s a step on a CPU (its fused step
0.25 s), so the epochs are two steps long.  The port's networks draw no
initial parameters (~2.5 s for this network): each loads its state.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dream_tpu import network as jax_network
from dream_tpu.data.dataset import make_batch_processor as jax_make_batch_processor

from dream_tpu_torch.checkpoint import params_from_flax
from dream_tpu_torch.data.dataset import make_batch_processor
from dream_tpu_torch.network import DreamNetwork, warmup_cosine_decay_device
from dream_tpu_torch.parallel.mesh import make_mesh

RAW, NET_IN, NET_OUT = (128, 96), (64, 64), (16, 16)
BATCH, STEPS, EPOCHS = 4, 2, 2
CLIP_NORM, EMA_DECAY = 0.25, 0.5
SCHEDULE = {"type": "cosine", "decay_steps": 20, "warmup_steps": 2}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing
    and slow the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def config():
    """``tests/test_network.py``'s ``_vgg_config`` with this file's optimizer."""
    return {
        "architecture": {
            "type": "vgg", "target": "belief_maps", "input_heads": ["image_rgb"],
            "output_heads": ["belief_maps"], "image_normalization": {"mean": [0.5] * 3, "stdev": [0.5] * 3},
            "loss": {"type": "mse"}, "image_preprocessing": "shrink-and-crop",
        },
        "manipulator": {"name": "panda",
                        "keypoints": [{"name": f"kp{i}", "friendly_name": f"KP{i}"} for i in range(4)]},
        "training": {"config": {
            "net_input_resolution": list(NET_IN),
            "optimizer": {"type": "sgd", "learning_rate": 0.05, "grad_clip_norm": CLIP_NORM,
                          "schedule": SCHEDULE},
        }, "platform": {}},
    }


def jax_variables(jax_net, seed):
    """Variables of the JAX network's shapes from numpy draws (flax's eager
    ``init`` of the hourglass takes ~12 s on a CPU)."""
    shapes = jax.eval_shape(jax_net.model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, NET_IN[1], NET_IN[0], 3)))
    rng = np.random.RandomState(seed)

    def draw(leaf):
        if len(leaf.shape) == 4:
            return jnp.asarray(rng.normal(0, np.prod(leaf.shape[:3]) ** -0.5, leaf.shape)
                               .astype(np.float32))
        return jnp.zeros(leaf.shape, jnp.float32)

    return jax.tree_util.tree_map(draw, shapes)


def the_set():
    rng = np.random.RandomState(1)
    images = rng.randint(0, 255, (10, RAW[1], RAW[0], 3), dtype=np.uint8)
    kps = rng.uniform(20, 90, (10, 4, 2)).astype(np.float32)
    matrices = [np.stack([rng.permutation(10)[:BATCH] for _ in range(STEPS)]) for _ in range(EPOCHS)]
    return images, kps, matrices


def processor_args(cfg):
    return RAW, NET_IN, NET_OUT, "shrink-and-crop", cfg["architecture"]["image_normalization"]


@pytest.fixture(scope="module")
def epochs():
    """Both packages from one start, two scanned epochs each; the state
    after each epoch."""
    cfg = config()
    images, kps, matrices = the_set()
    jax_net = jax_network.DreamNetwork(copy.deepcopy(cfg))
    jax_net.variables = jax_variables(jax_net, seed=5)
    start = jax.tree_util.tree_map(np.asarray, jax_net.variables)
    jax_net.enable_ema(EMA_DECAY)
    jax_net.enable_scanned_training(jax_make_batch_processor(*processor_args(cfg), augment=False))

    torch_net = DreamNetwork(copy.deepcopy(cfg), device="cpu")
    torch_net.model.load_state_dict(params_from_flax(start), strict=True)
    torch_net.enable_ema(EMA_DECAY)
    torch_net.enable_scanned_training(make_batch_processor(*processor_args(cfg), augment=False))

    out = {"jax_net": jax_net, "torch_net": torch_net, "start": params_from_flax(start), "epochs": []}
    images_j, kps_j = jnp.asarray(images), jnp.asarray(kps)
    images_t, kps_t = torch.from_numpy(images), torch.from_numpy(kps)
    for e, matrix in enumerate(matrices):
        ref = jax_net.train_epoch_raw(jax.random.PRNGKey(e), images_j, kps_j, matrix)
        ours = torch_net.train_epoch_raw(None, images_t, kps_t, matrix)
        out["epochs"].append({
            "jax_losses": np.asarray(ref), "torch_losses": ours.numpy(),
            "jax_state": params_from_flax(jax.tree_util.tree_map(np.asarray, jax_net.variables)),
            "jax_ema": params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                               {"params": jax_net.ema_params})),
            "torch_state": copy.deepcopy(torch_net.model.state_dict()),
            "torch_ema": copy.deepcopy(torch_net.ema_variables()),
            "steps": torch_net.steps, "counts": torch_net.optimizer_state(),
            "jax_counts": jax.tree_util.tree_map(np.asarray, jax_net.opt_state),
        })
    return out


def test_scanned_losses_match_jax(epochs):
    for epoch in epochs["epochs"]:
        assert epoch["torch_losses"].shape == (STEPS,) and np.isfinite(epoch["torch_losses"]).all()
        np.testing.assert_allclose(epoch["torch_losses"], epoch["jax_losses"], rtol=1e-5)


def test_scanned_state_and_ema_match_jax(epochs):
    start = epochs["start"]
    for epoch in epochs["epochs"]:
        ours, ref = epoch["torch_state"], epoch["jax_state"]
        assert set(ours) == set(ref) == set(start)
        for name in ours:
            np.testing.assert_allclose(ours[name].numpy(), ref[name].numpy(), atol=2e-6, rtol=0,
                                       err_msg=name)
            np.testing.assert_allclose(epoch["torch_ema"][name].numpy(), epoch["jax_ema"][name].numpy(),
                                       atol=2e-6, rtol=0, err_msg=name)
    # The parameters moved, and the EMA apart from them: not vacuous.
    last = epochs["epochs"][-1]
    assert max(float((last["torch_state"][n] - start[n]).abs().max()) for n in start) > 1e-4
    assert max(float((last["torch_state"][n] - last["torch_ema"][n]).abs().max()) for n in start) > 1e-5


def test_optimizer_counts_follow_the_epochs(epochs):
    for e, epoch in enumerate(epochs["epochs"], start=1):
        # chain(clip_by_global_norm, chain(sgd's identity, scale_by_schedule)).
        assert (epoch["steps"] == int(epoch["counts"]["1"]["1"]["count"])
                == int(epoch["jax_counts"][1][1].count) == e * STEPS)


@pytest.mark.parametrize("warmup,decay,end", [(4, 12, 0.0), (3, 9, 1e-6), (0, 7, 0.0)])
def test_device_schedule_matches_optax(warmup, decay, end):
    ref = optax.warmup_cosine_decay_schedule(0.0, 1e-4, warmup, decay, end)
    for step in range(decay + 3):
        ours = warmup_cosine_decay_device(torch.tensor(step, dtype=torch.int32), 1e-4, warmup, decay,
                                          end)
        assert ours.dtype == torch.float32 and ours.dim() == 0
        np.testing.assert_allclose(float(ours), float(ref(jnp.asarray(step, jnp.int32))), rtol=1e-6,
                                   atol=1e-11, err_msg=str(step))


def test_scanned_adam_counts_and_refusals(epochs):
    """A scanned Adam epoch leaves every parameter's count at ``steps``;
    ``train_epoch_raw`` refuses an unscanned network and a scanned one on a
    mesh."""
    cfg = config()
    cfg["training"]["config"]["optimizer"].update(type="adam", learning_rate=1e-4)
    images, kps, matrices = the_set()
    images_t, kps_t = torch.from_numpy(images), torch.from_numpy(kps)
    net = DreamNetwork(copy.deepcopy(cfg), device="cpu")
    net.model.load_state_dict(epochs["start"], strict=True)
    process = make_batch_processor(*processor_args(cfg), augment=False)
    net.enable_fused_training(process)
    with pytest.raises(RuntimeError, match="enable_scanned_training"):
        net.train_epoch_raw(None, images_t, kps_t, matrices[0])
    net.enable_scanned_training(process)
    net.enable_fused_training(process)  # back to step-by-step training
    with pytest.raises(RuntimeError, match="enable_scanned_training"):
        net.train_epoch_raw(None, images_t, kps_t, matrices[0])

    assert net.steps == 0
    net.enable_scanned_training(process)
    losses = net.train_epoch_raw(None, images_t, kps_t, matrices[0])
    assert losses.shape == (STEPS,) and torch.isfinite(losses).all()
    assert net.steps == STEPS
    assert all(int(state["step"]) == STEPS for state in net.optimizer.state.values())
    assert len(net.optimizer.state) == len(list(net.model.parameters()))
    tree = net.optimizer_state()
    assert int(tree["1"]["0"]["count"]) == int(tree["1"]["1"]["count"]) == STEPS

    net.shard_for_mesh(make_mesh(1, 1, ["cpu"]))  # the one-rank mesh, no process group
    with pytest.raises(ValueError, match="one device"):
        net.train_epoch_raw(None, images_t, kps_t, matrices[1])
    assert net.steps == STEPS
