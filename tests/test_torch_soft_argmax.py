"""The soft-argmax head and DopeNetworkBelief against dream_tpu, on the CPU.

- ``soft_argmax`` and ``avg_pool_7x7_same`` (``ops/spatial_softmax.py``)
  and the ``SoftArgmax`` head, learned and fixed ``beta``, against
  dream_tpu's on random heatmaps from a numpy seed (non-square, a batch
  axis, a per-keypoint ``beta``): pooled maps to 1e-5 of their largest
  magnitude, keypoints to 1e-3 px (float32 sums over the map in another
  order: seen ~1e-5 px).
- The hourglass's internal head (``internalize_spatial_softmax``), single
  stage and a 2-stage cascade (each stage its own ``beta``, the maps alone
  passed on), with parameters (``beta`` drawn away from its initial value)
  carried across by ``checkpoint.params_from_flax``: maps to 1e-5 absolute,
  keypoints to 1e-3 px; the ``beta`` leaves round-trip.
- The network: a ``spatial_softmax`` config's inference returns the head's
  keypoints (no peak decode), its detailed inference scores of ones and
  the keypoints as best keypoints, in float and in int8 (quantconv, the
  only int8 graph that carries the head); the loss and export refuse it,
  as dream_tpu does; a multistage soft-argmax config is refused.
- DOPE: the shapes of ``tests/test_models.py:113-125`` (on the meta
  device), and a parameter-carrying parity at 64x64 with ``stage_out=2``:
  every stage's maps to 1e-5 of their largest magnitude.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dream_tpu import network as jax_network
from dream_tpu.models import DopeNetworkBelief as JaxDope
from dream_tpu.models import DreamHourglass as JaxHourglass
from dream_tpu.models import DreamHourglassMultiStage as JaxMultiStage
from dream_tpu.models.heads import SoftArgmax as JaxSoftArgmax
from dream_tpu.ops import spatial_softmax as jax_ss
from dream_tpu.utils.config import load_yaml as jax_load_yaml

from dream_tpu_torch import checkpoint, export
from dream_tpu_torch.models import DopeNetworkBelief, DreamHourglass, DreamHourglassMultiStage
from dream_tpu_torch.models.heads import SoftArgmax
from dream_tpu_torch.network import DreamNetwork
from dream_tpu_torch.ops import score_kernel, spatial_softmax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VGGQ_CONFIG = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.yaml")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing
    and slow the other test workers: two threads take less CPU time than
    the machine's count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def draw_params(jax_model, seed, shape=(1, 64, 64, 3)):
    """numpy draws of the JAX model's parameters (``jax.eval_shape``, no
    flax ``init``): kernels of standard deviation 1/sqrt(fan_in), ``beta``
    in [0.5, 3], the rest normal with standard deviation 0.05."""
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros(shape)))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if len(leaf.shape) == 4:
            return rng.normal(0, np.prod(leaf.shape[:3]) ** -0.5, leaf.shape).astype(np.float32)
        if path[-1].key == "beta":
            return rng.uniform(0.5, 3.0, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.05, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))["params"]


def heatmaps(seed, shape=(2, 5, 23, 31)):
    """Random maps with one bright blob each, so that the soft-argmax has a
    place to go."""
    rng = np.random.RandomState(seed)
    maps = rng.uniform(-0.1, 0.2, shape).astype(np.float32)
    h, w = shape[-2:]
    yy, xx = np.mgrid[:h, :w]
    for idx in np.ndindex(shape[:-2]):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        maps[idx] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0).astype(np.float32)
    return maps


def test_soft_argmax_and_pool_match_jax():
    maps = heatmaps(0)
    beta = np.random.RandomState(1).uniform(1, 30, 5).astype(np.float32)
    want_pool = np.asarray(jax_ss.avg_pool_7x7_same(maps))
    got_pool = spatial_softmax.avg_pool_7x7_same(torch.from_numpy(maps)).numpy()
    np.testing.assert_allclose(got_pool, want_pool, rtol=0, atol=1e-5 * np.abs(want_pool).max())
    for size_mult in (1.0, 4.0):
        want = np.asarray(jax_ss.soft_argmax(maps, beta, size_mult=size_mult))
        got = spatial_softmax.soft_argmax(torch.from_numpy(maps), torch.from_numpy(beta), size_mult)
        assert got.shape == (2, 5, 2) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("learned", [True, False])
def test_soft_argmax_head_matches_jax(learned):
    maps = heatmaps(2, (3, 4, 20, 20))
    head = JaxSoftArgmax(4, learned_beta=learned, initial_beta=12.0)
    variables = head.init(jax.random.PRNGKey(0), maps)
    want = np.asarray(head.apply(variables, maps))
    ours = SoftArgmax(4, learned_beta=learned, initial_beta=12.0)
    assert [n for n, _ in ours.named_parameters()] == (["beta"] if learned else [])
    assert list(ours.state_dict()) == list(checkpoint.params_from_flax(variables))
    np.testing.assert_allclose(ours(torch.from_numpy(maps)).detach().numpy(), want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("stages", [1, 2])
def test_internal_head_matches_jax(stages):
    if stages == 1:
        jax_model = JaxHourglass(7, internalize_spatial_softmax=True, learned_beta=True)
        model = DreamHourglass(7, internalize_spatial_softmax=True, learned_beta=True)
    else:
        jax_model = JaxMultiStage(7, n_stages=2, internalize_spatial_softmax=True, learned_beta=True)
        model = DreamHourglassMultiStage(7, n_stages=2, internalize_spatial_softmax=True,
                                         learned_beta=True)
    params = draw_params(jax_model, 3 + stages)
    x = np.random.RandomState(5).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jax.jit(jax_model.apply)({"params": params}, x)
    state = checkpoint.params_from_flax(params)
    betas = [k for k in state if k.endswith("beta")]
    assert betas == (["beta"] if stages == 1 else ["stage1.beta", "stage2.beta"])
    model.load_state_dict(state, strict=True)
    back = checkpoint.params_to_flax(model.state_dict())["params"]
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 2
    if stages == 1:  # [maps, keypoints]
        np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), np.asarray(want[0]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-3)
    else:  # the stages' maps
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=0, atol=1e-5)


def _soft_argmax_config(**arch):
    cfg = jax_load_yaml(VGGQ_CONFIG)
    cfg["architecture"]["compute_dtype"] = "float32"
    cfg["architecture"]["spatial_softmax"] = {"learned_beta": True, "initial_beta": 1.0}
    cfg["architecture"]["output_heads"] = ["belief_maps", "keypoints"]
    cfg["architecture"].update(arch)
    cfg["training"]["config"]["net_input_resolution"] = [64, 64]
    cfg["training"]["config"].pop("net_output_resolution", None)
    return cfg


def test_network_soft_argmax_head(monkeypatch):
    monkeypatch.delenv("DREAM_INT8_IMPL", raising=False)
    net = DreamNetwork(_soft_argmax_config(), device="cpu")
    jax_net = jax_network.create_network_from_config_data(_soft_argmax_config())
    params = draw_params(jax_net.model, 6)
    net.model.load_state_dict(checkpoint.params_from_flax(params), strict=True)
    x = np.random.RandomState(7).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jax_net.variables = {"params": params}
    want_belief, want_kp = jax_net.inference(jnp.asarray(x))
    before = score_kernel.score_maps_kernel.launches
    belief, keypoints = net.inference(torch.from_numpy(x))
    assert belief.shape == (2, 7, 16, 16) and keypoints.shape == (2, 7, 2)
    np.testing.assert_allclose(belief.numpy(), np.asarray(want_belief), rtol=0, atol=1e-5)
    np.testing.assert_allclose(keypoints.numpy(), np.asarray(want_kp), rtol=0, atol=1e-3)
    _, kp2, scores, best = net.inference_detailed(torch.from_numpy(x))
    assert torch.equal(kp2, keypoints) and torch.equal(best, keypoints)
    assert torch.equal(scores, torch.ones(2, 7))
    # int8: the quantized conv graph carries the head (the chain does not).
    net.enable_int8_inference([torch.from_numpy(x)])
    assert net.int8_impl == "quantconv"
    int8_belief, int8_kp = net.inference(torch.from_numpy(x))
    recomputed = spatial_softmax.soft_argmax(int8_belief.double(), net.model.beta.detach().double())
    np.testing.assert_allclose(int8_kp.numpy(), recomputed.numpy(), rtol=0, atol=1e-3)
    assert score_kernel.score_maps_kernel.launches == before
    monkeypatch.setenv("DREAM_INT8_IMPL", "xla_chain")
    with pytest.raises(ValueError, match="cannot take"):
        net.enable_int8_inference([torch.from_numpy(x)])
    with pytest.raises(NotImplementedError, match="belief-map head"):
        net.loss([torch.from_numpy(x)], torch.zeros(2, 7, 16, 16))
    with pytest.raises(NotImplementedError, match="belief-map head"):
        export.build_raw_inference_fn(net, (96, 96))
    with pytest.raises(NotImplementedError, match="multistage"):
        DreamNetwork(_soft_argmax_config(n_stages=2), device="cpu")
    cfg = _soft_argmax_config()
    cfg["architecture"]["output_heads"] = ["belief_maps"]
    with pytest.raises(ValueError, match="output_heads"):
        DreamNetwork(cfg, device="cpu")


def test_dope_shapes():
    """``tests/test_models.py:113-125``: six [1, 7, 50, 50] stages at
    400x400, and ``stage_out`` truncation."""
    with torch.device("meta"):
        out = DopeNetworkBelief(7, stage_out=6)(torch.empty(1, 3, 400, 400))
        assert [tuple(o.shape) for o in out] == [(1, 7, 50, 50)] * 6
        assert len(DopeNetworkBelief(4, stage_out=2)(torch.empty(1, 3, 64, 64))) == 2


def test_dope_matches_jax():
    jax_model = JaxDope(n_keypoints=4, stage_out=2)
    params = draw_params(jax_model, 8)
    x = np.random.RandomState(9).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    want = jax.jit(jax_model.apply)({"params": params}, x)
    model = DopeNetworkBelief(4, stage_out=2)
    state = checkpoint.params_from_flax(params)
    model.load_state_dict(state, strict=True)
    back = checkpoint.params_to_flax(model.state_dict())["params"]
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == (1, 4, 8, 8)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    # The initial parameters follow flax's defaults: zero biases.
    fresh = DopeNetworkBelief(4, stage_out=2, generator=torch.Generator().manual_seed(0))
    assert all(float(p.detach().abs().max()) == 0 for n, p in fresh.named_parameters() if n.endswith("bias"))
