"""Encoder pretraining in the port against dream_tpu, on the CPU in float32.

- ``EncoderAutoencoder``: its forward equals ``dream_tpu``'s on the same
  parameters (numpy draws in flax's tree, carried across with
  ``checkpoint.params_from_flax``) to 1e-5 of the output's scale, at
  [2, 64, 64, 3]; its state goes back to flax's tree leaf for leaf.
- One pretraining step: the draws of ``scripts/pretrain_encoder.py``'s step
  (``jax.random`` noise, brightness, contrast and channel dropout, from one
  key split four ways) fed to the port's ``pretrain_step``, against that
  step's lines run in JAX (``optax.adam``), at [2, 32, 32, 3].  In float64 (both packages,
  ``jax.enable_x64``) the loss agrees to 1e-10 relative and
  every updated parameter to 1e-12; in float32 the loss to 1e-5 relative.
  float32 cannot hold the updated parameters tightly: Adam's first step
  moves each parameter by the learning rate times ``g / (|g| + 1e-8)``,
  and the gradients of the first blocks carry float32 errors near 1e-6
  (XLA's more than the port's, both against float64), so a gradient near
  zero can change sign between the packages.
- The corruption the port draws: the noise's mean and standard deviation,
  brightness and contrast filling their ranges with uniform means, a
  channel dropout rate within four standard errors of 0.1, and the noisy
  image the formula gives.
- The graft: ``extract_encoder_params`` and the graft into single-stage
  and multistage hourglasses, mirroring ``tests/test_pretrain.py``
  (32 leaves; stage 2's ``down1.conv0`` skipped).
- The CLI: a 3-step run (``--resolution 64 --pool 4 --device cpu``) and a
  2-step streamed one write encoder files that ``dream_tpu``'s
  ``init_encoder_from`` and the port's graft, 32 leaves each.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dream_tpu.models import DreamHourglass as JaxHourglass
from dream_tpu.models import DreamHourglassMultiStage as JaxMultiStage
from dream_tpu.models.pretrain import EncoderAutoencoder as JaxAutoencoder
from dream_tpu.models.pretrain import extract_encoder_params as jax_extract

from dream_tpu_torch.checkpoint import params_from_flax, params_to_flax
from dream_tpu_torch.cli import pretrain_encoder as cli
from dream_tpu_torch.models.pretrain import (
    ENCODER_KEYS,
    EncoderAutoencoder,
    extract_encoder_params,
    graft_encoder_params,
)
from dream_tpu_torch.network import DreamNetwork
from tests.test_network import _vgg_config
from tests.test_torch_cli import jax_net_with

RES = 64
SIGMA = 0.25
LR = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _draw_params(model, seed, size=32):
    """numpy draws of a flax model's parameters: lecun-normal kernels and
    small normal biases (flax's eager init of the VGG trunk is slow here)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    rng = np.random.RandomState(seed)

    def draw(leaf):
        if len(leaf.shape) == 4:
            return rng.normal(0, np.prod(leaf.shape[:3]) ** -0.5, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.05, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map(draw, dict(shapes))["params"]


@pytest.fixture(scope="module")
def models():
    params = _draw_params(JaxAutoencoder(), seed=0)
    ours = EncoderAutoencoder()
    ours.load_state_dict(params_from_flax(params), strict=True)
    return params, ours


def _images(seed, n=2, size=RES):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3)).astype(np.uint8)


def test_forward_matches_jax(models):
    params, ours = models
    x = np.random.RandomState(1).uniform(-1, 1, (2, RES, RES, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(JaxAutoencoder().apply)({"params": params}, x)).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = ours(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == ref.shape == (2, 3, RES // 4, RES // 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    back = params_to_flax(ours.state_dict())["params"]
    assert sorted(back) == sorted(params) == sorted(ENCODER_KEYS + ("rec3", "rec4", "rec_out"))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)


def _jax_draws(key, shape_nhwc):
    """scripts/pretrain_encoder.py:67-75's draws."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    b = shape_nhwc[0]
    return (jax.random.normal(k1, shape_nhwc),
            jax.random.uniform(k2, (b, 1, 1, 1), minval=-0.2, maxval=0.2),
            jax.random.uniform(k3, (b, 1, 1, 1), minval=0.8, maxval=1.2),
            jax.random.bernoulli(k4, 0.1, (b, 1, 1, 3)))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_step_matches_jax_given_its_draws(models, dtype):
    params, _ = models
    clean_u8 = _images(2, size=32)
    draws = [np.asarray(d) for d in _jax_draws(jax.random.PRNGKey(0), clean_u8.shape)]
    assert draws[3].any()
    with jax.enable_x64(dtype == "float64"):
        noise, brightness, contrast = (jnp.asarray(d, dtype) for d in draws[:3])
        drop = jnp.asarray(draws[3])
        params = jax.tree_util.tree_map(lambda p: jnp.asarray(p, dtype), params)
        model, tx = JaxAutoencoder(dtype=jnp.dtype(dtype)), optax.adam(LR)

        # The lines of scripts/pretrain_encoder.py:65-87, the draws given.
        clean = jnp.asarray(clean_u8).astype(dtype) / 127.5 - 1.0
        noisy = clean + noise * SIGMA
        noisy = noisy * contrast + brightness
        noisy = jnp.where(drop, 0.0, noisy)
        B, H, W, C = clean.shape
        target = clean.reshape(B, H // 4, 4, W // 4, 4, C).mean(axis=(2, 4))

        def loss_fn(p):
            pred = model.apply({"params": p}, noisy)
            return jnp.mean((pred - target) ** 2)

        @jax.jit
        def step(p):
            loss, grads = jax.value_and_grad(loss_fn)(p)
            updates, _ = tx.update(grads, tx.init(p), p)
            return loss, optax.apply_updates(p, updates)

        loss, new_params = step(params)
        new_params = jax.tree_util.tree_map(np.asarray, new_params)
        draws = {"noise": np.asarray(noise), "brightness": np.asarray(brightness),
                 "contrast": np.asarray(contrast), "drop": np.asarray(drop)}

    torch_dtype = getattr(torch, dtype)
    ours = EncoderAutoencoder(dtype=torch_dtype).to(torch_dtype)
    ours.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)), strict=True)
    optimizer = torch.optim.Adam(ours.parameters(), lr=LR)
    draws = {k: torch.from_numpy(v.copy()) for k, v in draws.items()}
    for key in ("noise", "drop"):
        draws[key] = draws[key].permute(0, 3, 1, 2)
    assert draws["noise"].dtype == torch_dtype
    got = cli.pretrain_step(ours, optimizer, torch.from_numpy(clean_u8).permute(0, 3, 1, 2), draws, SIGMA)
    if dtype == "float32":
        # Adam's first step moves a parameter by the learning rate times
        # g / (|g| + 1e-8), so where float32's rounding of a near-zero
        # gradient differs between the packages the move differs by up to
        # twice the learning rate; float32 holds the loss only.
        np.testing.assert_allclose(float(got), float(loss), rtol=1e-5)
        return
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-10)
    want = {name: t.numpy() for name, t in _widened(new_params).items()}
    for name, tensor in ours.state_dict().items():
        np.testing.assert_allclose(tensor.numpy(), want[name], atol=1e-12, rtol=0, err_msg=name)


def _widened(flax_params):
    """params_from_flax's state dict, kept in float64."""
    state = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(flax_params):
        keys = [k.key for k in path]
        prefix = ".".join(keys[:-1])
        t = torch.from_numpy(np.array(leaf))
        if keys[-1] == "kernel":
            state[prefix + ".weight"] = t.permute(3, 2, 0, 1)
        else:
            state[prefix + "." + keys[-1]] = t
    return state


def test_corruption_statistics():
    generator = torch.Generator().manual_seed(3)
    shape = (4000, 3, 8, 8)
    draws = cli.draw_corruption(generator, shape)
    noise = draws["noise"]
    assert noise.shape == shape and abs(float(noise.mean())) < 0.01 and abs(float(noise.std()) - 1) < 0.01
    for key, (low, high) in (("brightness", (-0.2, 0.2)), ("contrast", (0.8, 1.2))):
        v = draws[key]
        assert v.shape == (4000, 1, 1, 1)
        assert low <= float(v.min()) < low + 0.002 and high - 0.002 < float(v.max()) < high, key
        assert abs(float(v.mean()) - (low + high) / 2) < 0.01, key
    rate = float(draws["drop"].float().mean())
    assert draws["drop"].shape == (4000, 3, 1, 1)
    assert abs(rate - 0.1) < 4 * (0.1 * 0.9 / 12000) ** 0.5
    # dream_tpu draws its mask at the same rate.
    jax_rate = float(_jax_draws(jax.random.PRNGKey(3), (4000, 8, 8, 3))[3].mean())
    assert abs(jax_rate - rate) < 8 * (0.1 * 0.9 / 12000) ** 0.5

    clean = torch.from_numpy(np.random.RandomState(4).uniform(-1, 1, shape).astype(np.float32))
    noisy = cli.corrupt(clean, draws, SIGMA)
    expected = (clean + noise * SIGMA) * draws["contrast"] + draws["brightness"]
    expected = torch.where(draws["drop"], torch.zeros(()), expected)
    torch.testing.assert_close(noisy, expected, rtol=0, atol=0)
    assert float((noisy == 0).float().mean()) == pytest.approx(rate, abs=1e-4)


def test_graft_into_single_and_multistage(models):
    params, _ = models
    enc = extract_encoder_params({"params": params})
    assert set(enc["params"]) == set(ENCODER_KEYS)
    assert jax.tree_util.tree_structure(enc) == jax.tree_util.tree_structure(
        jax_extract({"params": params}))

    hourglass = _draw_params(JaxHourglass(n_keypoints=3), seed=1)
    merged, n_grafted, n_skipped = graft_encoder_params(hourglass, enc)
    assert (n_grafted, n_skipped) == (32, 0)
    np.testing.assert_array_equal(merged["down3"]["conv1"]["kernel"], params["down3"]["conv1"]["kernel"])
    np.testing.assert_array_equal(merged["head"]["conv0"]["kernel"], hourglass["head"]["conv0"]["kernel"])

    multistage = _draw_params(JaxMultiStage(n_keypoints=3, n_stages=2), seed=2)
    merged, n_grafted, n_skipped = graft_encoder_params(multistage, enc)
    assert (n_grafted, n_skipped) == (2 * 32 - 1, 1)
    np.testing.assert_array_equal(merged["stage2"]["down2"]["conv0"]["kernel"],
                                  params["down2"]["conv0"]["kernel"])
    np.testing.assert_array_equal(merged["stage2"]["down1"]["conv0"]["kernel"],
                                  multistage["stage2"]["down1"]["conv0"]["kernel"])


@pytest.mark.parametrize("route", [["--pool", "4", "--steps", "3"], ["--steps", "2"]],
                         ids=["pool", "streamed"])
def test_cli_output_grafts_in_both_packages(route, tmp_path):
    out = str(tmp_path / "enc.msgpack")
    result = cli.pretrain_encoder(cli.make_parser().parse_args(
        ["-o", out, "-b", "2", "--resolution", str(RES), "--log-every", "1", "--device", "cpu"] + route))
    steps = int(route[route.index("--steps") + 1])
    assert result["losses"].shape == (steps,) and np.all(np.isfinite(result["losses"]))

    jax_net = jax_net_with(_vgg_config())
    before = np.asarray(jax_net.variables["params"]["down1"]["conv0"]["kernel"]).copy()
    assert jax_net.init_encoder_from(out) == (32, 0)
    after = np.asarray(jax_net.variables["params"]["down1"]["conv0"]["kernel"])
    assert not np.array_equal(before, after)

    ours = DreamNetwork(copy.deepcopy(_vgg_config()), device="cpu")
    assert ours.init_encoder_from(out) == (32, 0)
    np.testing.assert_array_equal(ours.model.down1.conv0.weight.detach().numpy(),
                                  after.transpose(3, 2, 0, 1))
