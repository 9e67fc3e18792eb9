"""The port's hourglass variants and ResNets against dream_tpu on the CPU.

Models: vgg-F (``deconv_decoder``), the skip-connection and full-output
hourglasses at full width (the 2-stage hourglass is held as a network in
``tests/test_torch_arch_network.py``), and ``ResnetSimple`` H and F with
``layers = [1, 1, 1, 1]``, all on a 64x64 input at batch 2.  The
parameters are numpy draws from a seed of the JAX models' shapes
(``jax.eval_shape``), carried over with ``checkpoint.state_from_flax``; the
BatchNorm statistics and scales are drawn away from their initial values so
that they matter.

Tolerances (maps range over about [-0.4, 0.4] for the hourglasses and [-4,
4] for the ResNets in train mode):
- float32, eval mode: every stage's maps to 1e-5 absolute (the two
  convolution libraries sum in other orders; seen: <= 5e-7);
- float32, train mode (batch statistics): maps to 1e-4 of the largest map
  value, since normalising layer4's 2x2 maps over a batch of 2 amplifies
  the summation order (seen: 2e-5); the running statistics after the step
  to rtol 1e-4 and atol 1e-5 (seen: 3e-6);
- bfloat16 on both sides (statistical): relative L2 error of the maps at
  most 0.02 in eval mode and 0.06 in train mode, correlation at least
  0.9995 and 0.999 (seen: <= 0.005 and 0.028; >= 0.99999 and 0.9996).
The carry-across of transposed convs, BatchNorm and ``batch_stats`` is
exact both ways, and the initial values follow flax's distributions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as flax_nn

from dream_tpu.models.hourglass import DreamHourglass as JaxHourglass
from dream_tpu.models.layers import TorchConvTranspose as JaxConvTranspose
from dream_tpu.models.resnet_simple import ResnetSimple as JaxResnet

from dream_tpu_torch import checkpoint
from dream_tpu_torch.models import DreamHourglass, ResnetSimple
from dream_tpu_torch.models.layers import BatchNorm2d, TorchConvTranspose

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
HOURGLASSES = {
    "vgg-F": (lambda d: JaxHourglass(7, deconv_decoder=True, dtype=d),
              lambda d: DreamHourglass(7, deconv_decoder=True, dtype=d)),
    "skip": (lambda d: JaxHourglass(7, skip_connections=True, dtype=d),
             lambda d: DreamHourglass(7, skip_connections=True, dtype=d)),
    "full-output": (lambda d: JaxHourglass(7, full_output=True, dtype=d),
                    lambda d: DreamHourglass(7, full_output=True, dtype=d)),
}
RESNETS = {
    "H": (lambda d: JaxResnet(7, layers=(1, 1, 1, 1), dtype=d),
          lambda d: ResnetSimple(7, layers=(1, 1, 1, 1), dtype=d)),
    "F": (lambda d: JaxResnet(7, full=True, layers=(1, 1, 1, 1), dtype=d),
          lambda d: ResnetSimple(7, full=True, layers=(1, 1, 1, 1), dtype=d)),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing
    and slow the other test workers: two threads take less CPU time than
    the machine's count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def draw_variables(jax_model, seed, **kwargs):
    """numpy draws of the JAX model's variables: lecun-like kernels,
    BatchNorm scales in [0.5, 1.5], running variances in [0.5, 2], the rest
    normal with standard deviation 0.1."""
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 64, 64, 3)), **kwargs))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if len(leaf.shape) == 4:
            return rng.normal(0, np.prod(leaf.shape[:3]) ** -0.5, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.1, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def net_input(seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)


def run_both(jax_model, torch_model, variables, x, train=None):
    """Each package's stage outputs as NCHW numpy arrays (and, in train
    mode, JAX's new batch_stats)."""
    new_stats = None
    if train is None:
        out = jax.jit(jax_model.apply)(variables, x)
    elif train:
        out, mutated = jax_model.apply(variables, x, train=True, mutable=["batch_stats"])
        new_stats = jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])
    else:
        out = jax_model.apply(variables, x, train=False)
    ref = [np.asarray(o, np.float32).transpose(0, 3, 1, 2) for o in out]
    torch_model.load_state_dict(checkpoint.state_from_flax(variables), strict=True)
    torch_model.train(bool(train))
    with torch.no_grad():
        ours = torch_model(torch.from_numpy(x).permute(0, 3, 1, 2))
    ours = [o.numpy() for o in (ours if isinstance(ours, list) else [ours])]
    return ref, ours, new_stats


def rel_and_corr(ours, ref):
    return (float(np.linalg.norm(ours - ref) / np.linalg.norm(ref)),
            float(np.corrcoef(ours.ravel(), ref.ravel())[0, 1]))


@pytest.mark.parametrize("variant", ["vgg-F", "skip", "full-output"])
def test_hourglass_variants_match_jax(variant):
    make_jax, make_torch = HOURGLASSES[variant]
    jax_model, torch_model = make_jax(jnp.float32), make_torch(torch.float32)
    ref, ours, _ = run_both(jax_model, torch_model, draw_variables(jax_model, 1), net_input())
    assert len(ours) == len(ref) == 1
    side = 64 if variant in ("vgg-F", "full-output") else 16
    for o, r in zip(ours, ref):
        assert o.shape == (2, 7, side, side) and o.dtype == np.float32
        np.testing.assert_allclose(o, r, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("variant", list(RESNETS))
def test_resnet_matches_jax(variant, mode):
    make_jax, make_torch = RESNETS[variant]
    jax_model, torch_model = make_jax(jnp.float32), make_torch(torch.float32)
    variables = draw_variables(jax_model, 2, train=False)
    train = mode == "train"
    ref, ours, new_stats = run_both(jax_model, torch_model, variables, net_input(), train)
    side = 64 if variant == "F" else 32
    assert ours[0].shape == ref[0].shape == (2, 7, side, side)
    atol = 1e-4 * float(np.abs(ref[0]).max()) if train else 1e-5
    np.testing.assert_allclose(ours[0], ref[0], atol=atol, rtol=0)
    state = torch_model.state_dict()
    before = checkpoint.batch_stats_from_flax(variables["batch_stats"])
    if train:
        # The running statistics moved, and as flax moves them.
        after = checkpoint.batch_stats_from_flax(new_stats)
        # bn1, four bottlenecks' four, and one a deconv block: two statistics each.
        assert set(after) == set(before) and len(after) == 2 * (17 + (5 if variant == "F" else 4))
        for name, value in after.items():
            np.testing.assert_allclose(state[name].numpy(), value.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=name)
            assert not torch.equal(state[name], before[name]), name
    else:
        assert all(torch.equal(state[name], value) for name, value in before.items())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_follows_flax(dtype):
    """One BatchNorm in train and eval modes against flax.linen.BatchNorm
    (momentum 0.9, eps 1e-5) on a bf16 or f32 input with a large mean, where
    the biased variance and E[x^2] - E[x]^2 matter."""
    jax_dtype, torch_dtype = DTYPES[dtype]
    rng = np.random.RandomState(3)
    x = (rng.normal(3.0, 0.5, (4, 5, 6, 8))).astype(np.float32)  # NHWC, 8 channels
    x_in = jnp.asarray(x, jax_dtype)
    bn = flax_nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=jax_dtype)
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
                            "bias": rng.normal(0, 0.1, 8).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(0, 1, 8).astype(np.float32),
                                 "var": rng.uniform(0.5, 2, 8).astype(np.float32)}}
    ref_train, mutated = bn.apply(variables, x_in, use_running_average=False,
                                  mutable=["batch_stats"])
    ref_eval = bn.apply(variables, x_in, use_running_average=True)

    ours = BatchNorm2d(8, torch_dtype)
    ours.load_state_dict(checkpoint.state_from_flax(variables), strict=True)
    x_t = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch_dtype)
    with torch.no_grad():
        y_eval = ours.eval()(x_t)
        y_train = ours.train()(x_t)
    assert y_train.dtype == y_eval.dtype == torch_dtype
    # float32: the variance E[x^2] - E[x]^2 of values around 3 with spread
    # 0.5 loses ~5 bits to cancellation, so summation order shows at ~1e-5
    # relative (seen: 1.4e-5); bf16: at most one rounding (2^-8 relative).
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else dict(rtol=2 ** -7, atol=2e-2)
    for ours_y, ref_y in ((y_eval, ref_eval), (y_train, ref_train)):
        np.testing.assert_allclose(ours_y.float().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref_y, np.float32), **tol)
    for name in ("mean", "var"):
        np.testing.assert_allclose(ours.state_dict()["running_" + name].numpy(),
                                   np.asarray(mutated["batch_stats"][name]), rtol=1e-5, atol=1e-6)
    # torch's own layer, from the same running values, moves the mean the
    # same way but the variance with the unbiased estimate.
    unbiased = torch.nn.BatchNorm2d(8, momentum=0.1).train()
    unbiased.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
    unbiased.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    with torch.no_grad():
        unbiased(x_t.float())
    assert torch.allclose(unbiased.running_mean, ours.running_mean, rtol=1e-5, atol=1e-6)
    assert not torch.allclose(unbiased.running_var, ours.running_var, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_gradient_follows_flax(dtype):
    """The train-mode gradient with respect to the input, scale and bias
    against jax's of flax.linen.BatchNorm, under a random cotangent, to 1e-4
    of each gradient's largest entry in float32 and 2e-2 in bf16 (a bf16
    input gradient is rounded to 8 bits)."""
    jax_dtype, torch_dtype = DTYPES[dtype]
    rng = np.random.RandomState(4)
    x = rng.normal(1.0, 0.7, (4, 5, 6, 8)).astype(np.float32)
    cot = rng.normal(0, 1, x.shape).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 8).astype(np.float32), rng.normal(0, 0.1, 8).astype(np.float32)
    bn = flax_nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=jax_dtype)
    stats = {"mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}

    def f(x_in, s, b):
        y, _ = bn.apply({"params": {"scale": s, "bias": b}, "batch_stats": stats}, x_in,
                        use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot)

    refs = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x, jax_dtype), scale, bias)
    ours = BatchNorm2d(8, torch_dtype).train()
    ours.weight.data.copy_(torch.from_numpy(scale))
    ours.bias.data.copy_(torch.from_numpy(bias))
    x_t = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch_dtype).requires_grad_(True)
    (ours(x_t).float() * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    assert x_t.grad.dtype == torch_dtype
    rel = 1e-4 if dtype == "float32" else 2e-2
    for got, ref in ((x_t.grad.float().permute(0, 2, 3, 1), refs[0]), (ours.weight.grad, refs[1]),
                     (ours.bias.grad, refs[2])):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.numpy(), ref, atol=rel * float(np.abs(ref).max()), rtol=0)


@pytest.mark.parametrize("variant", ["vgg-F", "resnet-H-eval", "resnet-F-train"])
def test_bf16_matches_jax_bf16(variant):
    if variant.startswith("resnet"):
        _, kind, mode = variant.split("-")
        make_jax, make_torch = RESNETS[kind]
        train = mode == "train"
        kwargs = {"train": False}
    else:
        make_jax, make_torch = HOURGLASSES[variant]
        train, kwargs = None, {}
    jax_model, torch_model = make_jax(jnp.bfloat16), make_torch(torch.bfloat16)
    # The convs really run in bf16: hooks on inner layers see bf16 activations.
    inner = ([torch_model.down3.conv2, torch_model.deconv3.deconv, torch_model.deconv2.conv]
             if variant == "vgg-F" else
             [torch_model.layer2.block0.conv2, torch_model.layer3.block0.bn3, torch_model.up3.deconv])
    seen = []
    for module in inner:
        module.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    ref, ours, _ = run_both(jax_model, torch_model, draw_variables(jax_model, 4, **kwargs),
                            net_input(1), train)
    assert seen == [torch.bfloat16] * len(inner)
    assert {p.dtype for p in torch_model.parameters()} == {torch.float32}
    max_rel, min_corr = (0.06, 0.999) if train else (0.02, 0.9995)
    for o, r in zip(ours, ref):
        assert o.dtype == np.float32
        rel, corr = rel_and_corr(o, r)
        assert rel <= max_rel and corr >= min_corr, (rel, corr)


def test_conv_transpose_carry_across_both_ways():
    """flax's TorchConvTranspose and the port's on the same kernel, k3 s2 p1
    op1 (vgg-F) and k4 s2 p1 (the ResNets), and the mapping's round trip."""
    rng = np.random.RandomState(5)
    for k, p, op in ((3, 1, 1), (4, 1, 0)):
        x = rng.normal(0, 1, (2, 7, 9, 5)).astype(np.float32)
        layer = JaxConvTranspose(6, kernel_size=k, stride=2, padding=p, output_padding=op)
        tree = {"params": {"deconv": {"kernel": rng.normal(0, 0.3, (k, k, 5, 6)).astype(np.float32),
                                      "bias": rng.normal(0, 0.3, 6).astype(np.float32)}}}
        ref = np.asarray(layer.apply({"params": tree["params"]["deconv"]}, x)).transpose(0, 3, 1, 2)
        state = checkpoint.params_from_flax(tree)
        np.testing.assert_array_equal(
            state["deconv.weight"].numpy(),
            tree["params"]["deconv"]["kernel"][::-1, ::-1].transpose(2, 3, 0, 1))
        ours = TorchConvTranspose(5, 6, k, stride=2, padding=p, output_padding=op)
        ours.weight.data.copy_(state["deconv.weight"])
        ours.bias.data.copy_(state["deconv.bias"])
        y = ours(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().numpy()
        assert y.shape == ref.shape == (2, 6, 14, 18)
        np.testing.assert_allclose(y, ref, atol=1e-5, rtol=0)
        back = checkpoint.params_to_flax(state)["params"]["deconv"]
        for name, leaf in tree["params"]["deconv"].items():
            np.testing.assert_array_equal(back[name], leaf)


def test_batchnorm_and_batch_stats_carry_across_both_ways():
    rng = np.random.RandomState(6)
    tree = {
        "params": {"layer1": {"block0": {"bn1": {"scale": rng.rand(4).astype(np.float16),
                                                 "bias": rng.rand(4).astype(np.float32)}}}},
        "batch_stats": {"layer1": {"block0": {"bn1": {"mean": rng.rand(4).astype(np.float16),
                                                      "var": rng.rand(4).astype(np.float16)}}}},
    }
    state = checkpoint.state_from_flax(tree)
    assert set(state) == {"layer1.block0.bn1." + n
                          for n in ("weight", "bias", "running_mean", "running_var")}
    assert all(v.dtype == torch.float32 for v in state.values())  # float16 storage widens
    leaves = tree["batch_stats"]["layer1"]["block0"]["bn1"]
    np.testing.assert_array_equal(state["layer1.block0.bn1.running_var"].numpy(),
                                  leaves["var"].astype(np.float32))
    back = checkpoint.state_to_flax(state)
    assert set(back) == {"params", "batch_stats"}
    for collection in back:
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree[collection]):
            got = dict(jax.tree_util.tree_leaves_with_path(back[collection]))[path]
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, leaf.astype(np.float32))
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, checkpoint.batch_stats_to_flax(state), back["batch_stats"]))
    assert set(checkpoint.state_to_flax({"c.weight": torch.zeros(2, 1, 3, 3)})) == {"params"}
    with pytest.raises(ValueError):
        checkpoint.batch_stats_from_flax({"bn": {"scale": np.ones(3)}})


@pytest.mark.parametrize("variant", ["vgg-F", "resnet-F"])
def test_init_follows_flax_defaults(variant):
    """Per layer: conv weights with standard deviation within 5% of
    ``1/sqrt(fan_in)`` and inside flax's truncation, transposed-conv
    weights uniform in +-1/sqrt(fan_in) (standard deviation within 5% of
    the uniform's), zero biases, BatchNorm at scale 1 / bias 0 / mean 0 /
    var 1; a seed gives the same values and another seed others."""
    def build(seed):
        g = torch.Generator().manual_seed(seed)
        if variant == "vgg-F":
            return DreamHourglass(7, deconv_decoder=True, generator=g)
        return ResnetSimple(7, full=True, layers=(1, 1, 1, 1), generator=g)

    model, again, other = build(3), build(3), build(4)
    state, state_again, state_other = (m.state_dict() for m in (model, again, other))
    transposed = {name for name, m in model.named_modules() if isinstance(m, torch.nn.ConvTranspose2d)}
    assert transposed
    for name, leaf in state.items():
        assert torch.equal(leaf, state_again[name]), name
        module, kind = name.rsplit(".", 1)
        if leaf.ndim == 1:
            value = {"weight": 1.0, "bias": 0.0, "running_mean": 0.0, "running_var": 1.0}[kind]
            assert torch.equal(leaf, torch.full_like(leaf, value)), name
            continue
        assert not torch.equal(leaf, state_other[name]), name
        if module in transposed:
            limit = (leaf.shape[0] * leaf.shape[2] * leaf.shape[3]) ** -0.5
            assert float(leaf.abs().max()) <= limit, name
            assert abs(float(leaf.std()) / (limit / 3 ** 0.5) - 1) < 0.05, name
        else:
            std = leaf[0].numel() ** -0.5
            assert abs(float(leaf.std()) / std - 1) < 0.05, name
            assert float(leaf.abs().max()) <= 2 * std / 0.87962566103423978 * (1 + 1e-6), name
