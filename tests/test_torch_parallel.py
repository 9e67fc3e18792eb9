"""The port's multi-GPU layer against dream_tpu and against one process, on the CPU.

Ranks are processes joined in a gloo process group on the loopback
interface; the JAX side runs on the 8 virtual CPU devices of
``tests/conftest.py``.  Networks are committed sidecars cut to 64x64.

- Pipeline: the port's pipelined cascade (2 stages x 4 microbatches, 4 x 2)
  equals its sequential forward to 1e-5 (maps) and 1e-4 px (keypoints), as
  ``tests/test_pipeline.py`` holds JAX's.  Its loss and unstacked gradients
  equal ``dream_tpu``'s ``pipeline_multistage_value_and_grad`` on the same
  inputs for mse, weighted MSE and huber, with the tolerances
  ``tests/test_torch_train.py`` holds a step to (loss rtol 1e-5; gradients
  1e-4 of the leaf's largest entry), in float64 on both sides (both
  packages compute the loss terms in float32) and at a 16x16 input (XLA's
  float64 convolutions on the CPU take ~55 s a gradient at 64x64): the
  float32 gradients of a random cascade are ill-conditioned, a float32 and
  a float64 evaluation of the port's own sequential gradient differing by
  1e-3 to 1.5e-2 of a leaf's scale at 64x64.  In float64 the pipeline's
  gradients equal the sequential criterion's to 1e-6 of the leaf's scale.
- Data and model parallelism: one spawn of 2 ranks as (data 2) and one as
  (data 1, model 2), each training vgg-Q (symmetric weighted MSE, pos
  weight 800, clipping at 0.25, which acts) and ResNet-H (one block a
  layer, BatchNorm) for a step on a global batch of 4, unaugmented.  The
  loss equals the one-process run's to rtol 1e-5 and ``dream_tpu``'s after
  ``shard_for_mesh(make_mesh(...))`` to rtol 1e-5; the gradients (gathered
  whole) equal both to 1e-4 of each leaf's largest entry for vgg-Q and
  2e-3 for the ResNet, whose transposed convs' biases feed a BatchNorm and
  hold rounding noise alone (``tests/test_torch_arch_network.py``); the
  running statistics after the step equal the one-process run's to rtol
  1e-4, atol 1e-5; the evaluation loss of the batch before the step
  equals the one-process one's to rtol 1e-5.  (A second step is not
  compared: Adam moves a parameter whose gradient is rounding noise by a
  whole step either way.)  So the split convs' gradients are not scaled by
  the model axis.  A (data 2) rank given its own rows (``local=True``, as
  the training CLI's loaders give them) steps and evaluates bit for bit
  as one given the global batch.  Augmentation shards draw the global
  batch's parameters: each shard equals its rows of the whole batch's
  augmentation exactly.
- ``dryrun_multichip(2)`` and ``(4)`` on the CPU, and the training CLI with
  ``--mesh-data 2 --device cpu`` for one epoch (each rank loads half of
  each global batch and reports its kernel launches; its checkpoint loads
  in a one-rank network and equals in layout a one-rank run's).
"""

import copy
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dream_tpu import network as jax_network
from dream_tpu.data.dataset import make_batch_processor as jax_make_batch_processor
from dream_tpu.models.hourglass import DreamHourglassMultiStage as JaxMultiStage
from dream_tpu.parallel import make_mesh as jax_make_mesh
from dream_tpu.parallel import param_shardings as jax_param_shardings
from dream_tpu.parallel.pipeline import pipeline_multistage_value_and_grad as jax_pipeline_vg
from dream_tpu.parallel.pipeline import unstack_stage_params as jax_unstack
from dream_tpu.utils.config import load_yaml as jax_load_yaml

from dream_tpu_torch import checkpoint
from dream_tpu_torch.cli import train_network as train_cli
from dream_tpu_torch.data.augment import augment_batch
from dream_tpu_torch.data.synthetic import generate_synthetic_ndds
from dream_tpu_torch.models.hourglass import DreamHourglassMultiStage
from dream_tpu_torch.network import DreamNetwork, create_network_from_config_file, criterion_from_config
from dream_tpu_torch.parallel import mesh as mesh_ops
from dream_tpu_torch.parallel.dryrun import dryrun_multichip, mesh_train_run, train_network_for_run, train_steps
from dream_tpu_torch.parallel.pipeline import (
    _stack_stage_params,
    make_pipeline_mesh,
    pipeline_multistage_inference,
    pipeline_multistage_train_step,
    pipeline_multistage_value_and_grad,
    unstack_stage_params,
)
from dream_tpu_torch.utils.config import save_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDECARS = {"vgg-Q": "trained_models/results_r5/vggq/dream_vgg_q_r5.yaml",
            "resnet-H": "trained_models/results_r4/resnet_h/dream_resnet_h_r4.yaml"}
RAW, NET_IN = (128, 96), 64
MANIP = os.path.join(ROOT, "manip_configs", "panda.yaml")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def small_config(arch):
    cfg = jax_load_yaml(os.path.join(ROOT, SIDECARS[arch]))
    cfg["architecture"]["compute_dtype"] = "float32"
    tcfg = cfg["training"]["config"]
    tcfg["net_input_resolution"] = [NET_IN, NET_IN]
    tcfg.pop("net_output_resolution", None)
    tcfg["image_raw_resolution"] = list(RAW)
    tcfg["optimizer"] = {"type": "adam", "learning_rate": 1e-4}
    if arch == "resnet-H":
        cfg["architecture"]["layers"] = [1, 1, 1, 1]
    else:
        cfg["architecture"]["loss"] = {"type": "weighted_mse", "pos_weight": 800.0, "symmetric": True}
        tcfg["optimizer"]["grad_clip_norm"] = 0.25
    return cfg


def jax_variables(jax_net, seed):
    shapes = jax.eval_shape(lambda: jax_net.model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, NET_IN, NET_IN, 3)),
        **({"train": False} if jax_net._has_batch_stats else {})))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        """Kernels drawn as flax's lecun-normal draws them (untruncated);
        the rest at flax's initial values."""
        name = path[-1].key
        if len(leaf.shape) == 4:
            return jnp.asarray(rng.normal(0, np.prod(leaf.shape[:3]) ** -0.5, leaf.shape), jnp.float32)
        return jnp.ones(leaf.shape, jnp.float32) if name in ("scale", "var") else jnp.zeros(leaf.shape, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _batch():
    rng = np.random.RandomState(1)
    raw = rng.randint(0, 256, (4, RAW[1], RAW[0], 3)).astype(np.uint8)
    kps = rng.uniform([42, 26], [80, 64], (4, 7, 2)).astype(np.float32)
    return raw, kps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two networks' runs (parameters from numpy draws, saved for the
    ranks) with their JAX networks."""
    root = tmp_path_factory.mktemp("parallel")
    raw, kps = _batch()
    out = {}
    for i, arch in enumerate(SIDECARS):
        cfg = small_config(arch)
        jax_net = jax_network.create_network_from_config_data(copy.deepcopy(cfg))
        jax_net.variables = jax_variables(jax_net, seed=i)
        path = str(root / f"{arch}.msgpack")
        checkpoint.save_flax_checkpoint(path, jax.tree_util.tree_map(np.asarray, jax_net.variables))
        out[arch] = {"run": {"config": cfg, "params_path": path, "steps": 1,
                             "batch": {"raw": raw, "kp": kps}},
                     "jax_net": jax_net, "cfg": cfg}
    return out


@pytest.fixture(scope="module")
def one_rank(runs):
    return {arch: train_steps(train_network_for_run(r["run"], "cpu"), r["run"])
            for arch, r in runs.items()}


def _spawned(runs, n_data, n_model, local=()):
    """Each network's run on the mesh, then the runs of the networks named
    in ``local`` with each rank passing its own rows (``local=True``)."""
    specs = [dict(r["run"], n_data=n_data, n_model=n_model) for r in runs.values()]
    specs += [dict(runs[arch]["run"], n_data=n_data, n_model=n_model, local=True) for arch in local]
    results = mesh_ops.spawn_local_ranks(mesh_train_run, 2, "gloo", ["cpu", "cpu"], specs,
                                         ["cpu", "cpu"])
    names = list(runs) + [f"{arch} local" for arch in local]
    return dict(zip(names, results[0])), results


@pytest.fixture(scope="module")
def data2(runs):
    return _spawned(runs, 2, 1, local=["vgg-Q"])


@pytest.fixture(scope="module")
def model2(runs):
    return _spawned(runs, 1, 2)


def _jax_step(entry, n_data, n_model):
    """One dream_tpu train_raw step after shard_for_mesh: (loss, step-1
    gradients in the port's names)."""
    cfg = entry["cfg"]
    jax_net = jax_network.create_network_from_config_data(copy.deepcopy(cfg))
    # A copy: the train step donates its buffers.
    jax_net.variables = jax.tree_util.tree_map(lambda v: jnp.array(v, copy=True),
                                               entry["jax_net"].variables)
    jax_net.enable_fused_training(jax_make_batch_processor(
        RAW, (NET_IN, NET_IN), tuple(jax_net.trained_net_output_resolution()),
        jax_net.image_preprocessing(), cfg["architecture"]["image_normalization"], augment=False))
    jax_net.shard_for_mesh(jax_make_mesh(n_data, n_model, devices=jax.devices()[:2]))
    raw, kps = entry["run"]["batch"]["raw"], entry["run"]["batch"]["kp"]
    loss = float(jax_net.train_raw(jax.random.PRNGKey(0), raw, kps))
    adam = jax_net.opt_state[1][0] if cfg["training"]["config"]["optimizer"].get("grad_clip_norm") \
        else jax_net.opt_state[0]
    grads = checkpoint.params_from_flax(
        jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, {"params": adam.mu}))
    return loss, grads


def _assert_grads_close(ours, ref, arch):
    tol = 2e-3 if arch == "resnet-H" else 1e-4
    largest = max(float(g.abs().max()) for g in ref.values())
    assert set(ours) == set(ref)
    for name, g in ours.items():
        scale = float(ref[name].abs().max())
        if arch == "resnet-H" and name.endswith("deconv.bias"):
            assert max(scale, float(g.abs().max())) <= 1e-6 * largest, name
            continue
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=tol * scale + 1e-12, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("layout", ["data2", "model2"])
@pytest.mark.parametrize("arch", list(SIDECARS))
def test_mesh_step_matches_one_process(request, layout, arch, one_rank):
    spawned, ranks = request.getfixturevalue(layout)
    ours, ref = spawned[arch], one_rank[arch]
    np.testing.assert_allclose(ours["losses"], ref["losses"], rtol=1e-5)
    np.testing.assert_allclose(ours["eval_loss"], ref["eval_loss"], rtol=1e-5)
    _assert_grads_close(ours["grads"], ref["grads"], arch)
    for name, value in ref["state"].items():
        assert ours["state"][name].shape == value.shape, name
        if "running_" in name:
            np.testing.assert_allclose(ours["state"][name].numpy(), value.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=name)
    # Both ranks hold the same whole state.
    other = ranks[1][list(spawned).index(arch)]
    assert all(torch.equal(other["state"][k], v) for k, v in ours["state"].items())
    if layout == "model2":
        assert ours["split"], "no parameter was split over the model axis"
        assert all(n.split(".")[-1] in ("weight", "bias") for n in ours["split"])
    else:
        assert ours["split"] == []


def test_mesh_step_on_local_rows_equals_the_global_batch_step(data2):
    """A rank given its own rows (the training CLI's loaders) steps, and
    evaluates the loss, exactly as one given the global batch."""
    spawned, _ = data2
    ours, ref = spawned["vgg-Q local"], spawned["vgg-Q"]
    assert ours["losses"] == ref["losses"] and ours["eval_loss"] == ref["eval_loss"]
    for name, value in ref["grads"].items():
        assert torch.equal(ours["grads"][name], value), name
    for name, value in ref["state"].items():
        assert torch.equal(ours["state"][name], value), name


@pytest.mark.parametrize("layout,arch", [("data2", "vgg-Q"), ("model2", "vgg-Q"),
                                         ("data2", "resnet-H")])
def test_mesh_step_matches_dream_tpu_sharded(request, layout, arch, runs):
    spawned, _ = request.getfixturevalue(layout)
    n_data, n_model = (2, 1) if layout == "data2" else (1, 2)
    loss, grads = _jax_step(runs[arch], n_data, n_model)
    np.testing.assert_allclose(spawned[arch]["losses"][0], loss, rtol=1e-5)
    _assert_grads_close(spawned[arch]["grads"], grads, arch)


def test_param_shardings_follow_dream_tpu_rule(runs):
    """The split parameters are the leaves JAX's rule puts on the model axis."""
    jax_net = runs["vgg-Q"]["jax_net"]
    params = jax_net.variables["params"]
    shardings = jax_param_shardings(params, jax_make_mesh(1, 2, devices=jax.devices()[:2]))
    flags = jax.tree_util.tree_map(
        lambda p, s: np.full(p.shape, float("model" in tuple(s.spec)), np.float32), params, shardings)
    expected = {n for n, v in checkpoint.params_from_flax({"params": flags}).items() if v.flatten()[0] == 1}
    net = DreamNetwork(copy.deepcopy(runs["vgg-Q"]["cfg"]), device="cpu")
    fake = mesh_ops.Mesh({"data": 1, "model": 2}, 0, 0, 0, torch.device("cpu"), "gloo")
    rule = mesh_ops.param_shardings(net.model, fake)
    assert expected and {n for n, d in rule.items() if d is not None} == expected


def test_augment_shards_are_rows_of_the_global_batch():
    images = torch.from_numpy(np.random.RandomState(2).uniform(0, 255, (4, 24, 32, 3)).astype(np.float32))
    kps = torch.from_numpy(np.random.RandomState(3).uniform(4, 20, (4, 5, 2)).astype(np.float32))
    whole = augment_batch(torch.Generator().manual_seed(9), images, kps)
    for i in range(2):
        part = augment_batch(torch.Generator().manual_seed(9), images[2 * i:2 * i + 2],
                             kps[2 * i:2 * i + 2], shard=(i, 2))
        assert torch.equal(part[0], whole[0][2 * i:2 * i + 2])
        assert torch.equal(part[1], whole[1][2 * i:2 * i + 2])


# --- pipeline ---

@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 2)])
def test_pipeline_inference_matches_sequential(n_stages, n_micro):
    model = _cascade(4, n_stages, 0)
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        sequential = model(x.permute(0, 3, 1, 2))[-1]
    fn, mesh = pipeline_multistage_inference(model, None, ["cpu"] * n_stages, n_micro)
    assert mesh == [torch.device("cpu")] * n_stages
    pipelined = fn(x)
    assert pipelined.shape == sequential.shape
    np.testing.assert_allclose(pipelined.numpy(), sequential.numpy(), atol=1e-5, rtol=1e-5)


def test_network_pipeline_inference_matches_sequential():
    cfg = small_config("vgg-Q")
    cfg["architecture"]["n_stages"] = 2
    net = DreamNetwork(cfg, device="cpu", seed=3)
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 64, 64, 3).astype(np.float32))
    belief_seq, kp_seq = net.inference(x)
    assert net.enable_pipeline_inference(2, make_pipeline_mesh(2, ["cpu", "cpu"])) == \
        [torch.device("cpu")] * 2
    belief, kp = net.inference(x)
    np.testing.assert_allclose(belief.numpy(), belief_seq.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(kp.numpy(), kp_seq.numpy(), atol=1e-4)
    with pytest.raises(ValueError):
        net.enable_int8_inference([x])


@pytest.mark.parametrize("option", ["deconv_decoder", "full_output"])
def test_pipeline_rejects_what_dream_tpu_rejects(option):
    kwargs = {"deconv_decoder": True} if option == "deconv_decoder" else {"full_output": True}
    with torch.device("meta"):
        model = DreamHourglassMultiStage(4, 2, **kwargs)
    with pytest.raises(ValueError):
        pipeline_multistage_inference(model, None, ["cpu", "cpu"])
    with pytest.raises(ValueError):
        pipeline_multistage_value_and_grad(model, None, ["cpu", "cpu"])


def test_stack_unstack_round_trip():
    model = _cascade(3, 2, 0)
    state = model.state_dict()
    stacked = _stack_stage_params(state, 2, 3)
    first = stacked[0]["down1.conv0.weight"]
    assert first.shape == (64, 6, 3, 3) and torch.count_nonzero(first[:, 3:]) == 0
    assert {k: v.shape for k, v in stacked[0].items()} == {k: v.shape for k, v in stacked[1].items()}
    back = unstack_stage_params(stacked, 3)
    assert set(back) == set(state) and all(torch.equal(back[k], v) for k, v in state.items())


def _cascade(n_keypoints, n_stages, seed, dtype=torch.float32):
    """A cascade with lecun-normal-like weights and zero biases, drawn
    quickly (flax's truncated draws of 44M parameters take seconds)."""
    with torch.device("meta"):
        model = DreamHourglassMultiStage(n_keypoints, n_stages, dtype=dtype)
    model.to_empty(device="cpu")
    generator = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 4:
                p.copy_(torch.randn(p.shape, generator=generator) * p[0].numel() ** -0.5)
            else:
                p.zero_()
    return model


def _cascade_case(seed, size=16, batch=4):
    """Inputs and NHWC targets (JAX's layout), float32 values."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, size, size, 3).astype(np.float32)
    targets = (np.abs(rng.randn(batch, size // 4, size // 4, 4)) * 0.1).astype(np.float32)
    return x, targets


@pytest.mark.parametrize("loss_cfg", [{"type": "mse"},
                                      {"type": "weighted_mse", "pos_weight": 25.0},
                                      {"type": "huber"}], ids=lambda c: c["type"])
def test_pipeline_gradients_match_dream_tpu(loss_cfg):
    x, targets = _cascade_case(3)
    with jax.enable_x64(True):
        jax_model = JaxMultiStage(n_keypoints=4, n_stages=2, dtype=jnp.float64)
        shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
        rng = np.random.RandomState(0)
        # float32 draws, widened exactly on both sides.
        variables = jax.tree_util.tree_map(
            lambda leaf: rng.normal(0, np.prod(leaf.shape[:-1]) ** -0.5 if len(leaf.shape) == 4
                                    else 0.05, leaf.shape).astype(np.float32), shapes)
        vg, stacked, _ = jax_pipeline_vg(
            jax_model, jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float64), variables),
            n_microbatches=2, loss_config=loss_cfg)
        ref_loss, ref_stacked = vg(stacked, jnp.asarray(x, jnp.float64),
                                   jnp.asarray(targets, jnp.float64))
        grads = jax.tree_util.tree_map(lambda g: np.asarray(g, np.float64), jax_unstack(ref_stacked, 4))
    ref = _flax_to_port_names(grads)
    with torch.device("meta"):
        model = DreamHourglassMultiStage(4, 2, dtype=torch.float64)
    model.to_empty(device="cpu")
    model.load_state_dict(checkpoint.params_from_flax(variables), strict=True)
    model.double()
    x_t = torch.from_numpy(x)
    t_t = torch.from_numpy(targets).permute(0, 3, 1, 2)
    ours_vg, ours_stacked, mesh = pipeline_multistage_value_and_grad(
        model, None, ["cpu", "cpu"], 2, loss_cfg)
    assert ours_stacked[0]["down1.conv0.weight"].dtype == torch.float64
    loss, grads = ours_vg(ours_stacked, x_t, t_t)
    ours = unstack_stage_params(grads, 4)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    assert set(ours) == set(ref)
    for name, g in ours.items():
        scale = float(ref[name].abs().max())
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=1e-4 * scale + 1e-15, rtol=0,
                                   err_msg=name)
    # The sequential criterion over the stacked stages, differentiated whole.
    outs = torch.stack(model(x_t.permute(0, 3, 1, 2))).to(torch.float32)
    seq = criterion_from_config(loss_cfg)(outs, t_t.expand_as(outs))
    seq.backward()
    np.testing.assert_allclose(float(loss), float(seq), rtol=1e-6)
    for name, p in model.named_parameters():
        scale = float(p.grad.abs().max())
        np.testing.assert_allclose(ours[name].numpy(), p.grad.numpy(), atol=1e-6 * scale + 1e-15,
                                   rtol=0, err_msg=name)


def _flax_to_port_names(params):
    """A float64 flax parameter tree in the port's names and layouts
    (``checkpoint.params_from_flax`` narrows to float32): conv kernels HWIO
    -> OIHW; the cascade has no transposed conv."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                name = ".".join(prefix) + (".weight" if k == "kernel" else f".{k}")
                out[name] = torch.from_numpy(v.transpose(3, 2, 0, 1).copy() if v.ndim == 4 else v)

    walk(params, ())
    return out


def test_pipeline_train_step_learns():
    model = _cascade(3, 2, 0)
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(4, 64, 64, 3).astype(np.float32))
    targets = torch.from_numpy((np.abs(rng.randn(4, 3, 16, 16)) * 0.1).astype(np.float32))
    step, state = pipeline_multistage_train_step(
        model, None, lambda p: torch.optim.Adam(p, 1e-4), ["cpu", "cpu"], 2, {"type": "mse"})
    losses = []
    for _ in range(5):
        state, loss = step(state, x, targets)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    model.load_state_dict(unstack_stage_params(state["params"], 3), strict=False)
    with torch.no_grad():
        assert model(x.permute(0, 3, 1, 2))[-1].shape == (4, 3, 16, 16)


# --- dry run and the training CLI ---

@pytest.mark.parametrize("n_devices", [2, 4])
def test_dryrun_multichip(n_devices, capsys):
    out = dryrun_multichip(n_devices, "cpu", "gloo")
    n_model = 2 if n_devices == 4 else 1
    assert [r["mesh"] for r in out["ranks"]] == [{"data": n_devices // n_model, "model": n_model}] * n_devices
    assert all(np.isfinite(r["loss"]) and r["kps"] == (2 * n_devices // n_model, 4, 2)
               for r in out["ranks"])
    assert (out["ranks"][0]["split"] > 0) == (n_model > 1)
    assert np.isfinite(out["pipeline_loss"])
    assert "dryrun_multichip OK: mesh=" in capsys.readouterr().out


def test_train_cli_on_a_two_rank_mesh(tmp_path):
    data = generate_synthetic_ndds(str(tmp_path / "data"), n_frames=12, image_resolution=(160, 120),
                                   seed=11, out_of_frame_fraction=0.0)
    arch = str(tmp_path / "arch.yaml")
    save_yaml({"architecture": {"type": "vgg", "target": "belief_maps", "input_heads": ["image_rgb"],
                                "output_heads": ["belief_maps"],
                                "image_normalization": {"mean": [0.5] * 3, "stdev": [0.5] * 3},
                                "loss": {"type": "mse"}},
               "training": {"config": {"image_preprocessing": "shrink-and-crop",
                                       "net_input_resolution": [64, 64]}}}, arch)
    out = str(tmp_path / "mesh")
    argv = ["-i", data, "-m", MANIP, "-ar", arch, "-e", "1", "-b", "4", "-o", out, "-s", "1",
            "-w", "2", "--loss-pos-weight", "800", "--loss-sym", "--device", "cpu"]
    ranks = train_cli.train_network(train_cli.make_parser().parse_args(argv + ["--mesh-data", "2"]))
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(set(r["launches"]) == {"score_kernel", "warp_kernel", "conv_int8_kernel"} for r in ranks)
    assert sorted(os.listdir(out)) == ["best_network.msgpack", "best_network.yaml", "epoch_1.msgpack",
                                       "epoch_1.opt.msgpack", "epoch_1.yaml", "training_log.pkl"]
    with open(os.path.join(out, "training_log.pkl"), "rb") as f:
        log = pickle.load(f)
    assert log["epochs"] == [1] and len(log["batch_training_losses"][0]) == 2
    # Each data rank loaded b / 2 frames of each global batch: rank 0 logs its own.
    assert all(len(names) == 2 for names in log["batch_training_sample_names"][0])
    assert np.all(np.isfinite(log["batch_training_losses"][0]))
    net = create_network_from_config_file(os.path.join(out, "epoch_1.yaml"),
                                          os.path.join(out, "epoch_1.msgpack"), device="cpu")
    assert net.network_config["training"]["platform"]["mesh"] == {"data": 2, "model": 1}
    net.inference(torch.zeros((2, 64, 64, 3)))
    # What the mesh flags refuse, before any rank starts.
    for extra, error in ((["--mesh-data", "3"], "divide"), (["--process-id", "0"], "--distributed"),
                         (["--mesh-data", "2", "--dist-backend", "nccl"], "CUDA")):
        with pytest.raises(ValueError, match=error):
            train_cli.train_network(train_cli.make_parser().parse_args(argv + ["-f"] + extra))


def test_nccl_needs_a_gpu_a_rank():
    with pytest.raises(ValueError, match="CUDA"):
        mesh_ops.check_backend("nccl", "cpu")
    with pytest.raises(RuntimeError, match="NCCL needs a GPU"):
        mesh_ops.rank_devices(torch.cuda.device_count() + 1, "cuda", "nccl")
