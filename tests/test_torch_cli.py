"""The port's command-line workflow against dream_tpu, on the CPU in float32.

A tiny vgg-Q (96x96 net input for evaluation, 64x64 for training; 160x120
frames) as in ``tests/test_end_to_end.py``; datasets written by
dream_tpu.

- (a) Evaluation: the r5 vgg-Q checkpoint's parameters, at the tiny net
  input, go to disk once as a float32 flax msgpack through the port's
  carry-across (seeded parameters find almost no keypoint, so PnP had
  nothing to solve; the r5 ones find 38 of 49 at 96x96);
  ``analyze_ndds_dataset`` of both packages runs on one 8-frame dataset,
  plain and with ``pnp_weight_by_score`` + ``pnp_reject_outliers_px=10``.
  ``keypoints.csv``: the same names, values within 1e-3 px.
  ``pnp_results.csv``: the same names, successes and in-frame counts, and
  poses within 1e-3 (m, quaternion entries) and ADD within 1e-3 m on the
  frames PnP got six detections or more for.  With five, the leave-one-out
  candidates are four-point solves with several minima of near-equal cost
  (``tests/test_torch_pnp_modes.py``), and the packages' float32 solves
  part there (two of the 8 frames, ADD 0.27 against 0.38 m; both poses
  are off by decimetres, as at this size every pose is).
  ``analysis_results.txt``: line for line the same once paths and numbers
  are masked, counts equal, and the other numbers within 1e-3 (the ADD
  statistics only in the plain run, for the reason above).
- (b) Training: the port's CLI for 2 epochs, then ``-r -e 3`` (with
  ``--cache-device``) on 16 frames, ``-b 4 -not-a``, with clipping, a
  cosine schedule, an EMA, and checkpoints and validation every second
  epoch (and the last): the file set and log keys
  ``tests/test_end_to_end.py`` asserts for dream_tpu, the ``.opt.msgpack``
  step count equal to the steps taken, flax's ``from_bytes`` restoring it
  against dream_tpu's own optax state, and the evaluation CLI reading
  ``best_network``; unported flags raise.
- (c) Optimizer state: a ``.msgpack`` + ``.opt.msgpack`` pair dream_tpu
  writes (optax's state built directly, moments drawn from a seed, step
  count 3, under clipping and a warmup-cosine schedule) resumes in the
  port; one step from one batch gives the parameters optax's update gives
  from that state on the same gradient (the port's: the two models'
  gradients are held together in ``tests/test_torch_train.py``), to 1e-7
  (float32 rounding of the two Adams; a step moves them ~1e-4), and the
  port's optimizer state after it restores in dream_tpu through
  ``from_bytes`` with step counts 4 and moments within 1e-5 of each leaf's
  largest entry (float32 rounding: ``nu`` differed by 1.3e-6 relative).
- The training CLI takes every flag of ``scripts/train_network.py`` with
  its short form and default, plus ``--device``.
- (d) ``init_encoder_from`` grafts the same leaves with the same values as
  dream_tpu's: a vgg-Q checkpoint into vgg-F, as the r5 vgg-F recipe
  does (every shape-matching leaf of the checkpoint's subtrees, the
  encoder's and six more).
"""

import copy
import csv
import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from dream_tpu import analysis as jax_analysis
from dream_tpu import network as jax_network
from dream_tpu.data.synthetic import generate_synthetic_ndds as jax_generate_synthetic_ndds

from dream_tpu_torch import analysis
from dream_tpu_torch.checkpoint import (
    load_flax_checkpoint,
    params_from_flax,
    params_to_flax,
    save_flax_checkpoint,
    state_to_flax,
)
from dream_tpu_torch.cli import network_inference_dataset as eval_cli
from dream_tpu_torch.cli import train_network as train_cli
from dream_tpu_torch.data.dataset import make_batch_processor
from dream_tpu_torch.network import DreamNetwork
from dream_tpu_torch.utils.config import load_yaml, save_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIP = os.path.join(ROOT, "manip_configs", "panda.yaml")
R5_PARAMS = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5.msgpack")
RES = (160, 120)
ARCH = {
    "type": "vgg",
    "target": "belief_maps",
    "input_heads": ["image_rgb"],
    "output_heads": ["belief_maps"],
    "image_normalization": {"mean": [0.5] * 3, "stdev": [0.5] * 3},
    "loss": {"type": "mse"},
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """These tests run small tensors in long Python loops, where torch's
    idle intra-op threads spin for nothing: two threads take about half
    the CPU time of eight."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def network_config(arch=None, net_in=96, optimizer=None):
    return {
        "manipulator": load_yaml(MANIP)["manipulator"],
        "architecture": {**copy.deepcopy(arch or ARCH), "image_preprocessing": "shrink-and-crop",
                         "compute_dtype": "float32"},
        "training": {"config": {
            "net_input_resolution": [net_in, net_in],
            "image_raw_resolution": list(RES),
            "image_preprocessing": "shrink-and-crop",
            "optimizer": optimizer or {"type": "adam", "learning_rate": 1e-4},
        }, "results": {}},
    }


def jax_net_with(cfg, variables=None, seed=0):
    """A dream_tpu network whose variables come from ``jax.eval_shape`` and
    numpy draws (flax's eager init of vgg-Q takes 12-19 s on a CPU)."""
    net = jax_network.create_network_from_config_data(copy.deepcopy(cfg))
    if variables is None:
        w, h = net.trained_net_input_resolution()
        shapes = jax.eval_shape(net.model.init, jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)))
        rng = np.random.RandomState(seed)

        def draw(leaf):
            if len(leaf.shape) == 4:
                fan_in = int(np.prod(leaf.shape[:3]))
                return rng.normal(0, fan_in ** -0.5, leaf.shape).astype(np.float32)
            return rng.normal(0, 0.05, leaf.shape).astype(np.float32)

        variables = jax.tree_util.tree_map(draw, shapes)
    net.variables = jax.tree_util.tree_map(jnp.asarray, dict(variables))
    return net


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    eval_data, train_data = str(root / "eval_data"), str(root / "train_data")
    jax_generate_synthetic_ndds(eval_data, n_frames=8, image_resolution=RES, seed=7,
                                out_of_frame_fraction=0.25)
    jax_generate_synthetic_ndds(train_data, n_frames=16, image_resolution=RES, seed=11,
                                out_of_frame_fraction=0.0)
    cfg = network_config()
    net = DreamNetwork(copy.deepcopy(cfg), device="cpu")
    net.load_network_params(R5_PARAMS)
    params = str(root / "net.msgpack")
    save_flax_checkpoint(params, state_to_flax(net.model.state_dict()))
    save_yaml(cfg, str(root / "net.yaml"))
    jax_net = jax_net_with(cfg, load_flax_checkpoint(params))
    arch_path = str(root / "arch.yaml")
    save_yaml({"architecture": ARCH, "training": {"config": {
        "image_preprocessing": "shrink-and-crop", "net_input_resolution": [64, 64]}}}, arch_path)
    return {"root": root, "eval_data": eval_data, "train_data": train_data, "params": params,
            "config": str(root / "net.yaml"), "jax_net": jax_net, "arch": arch_path}


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


NUMBER = re.compile(r"-?\d+(?:\.\d+)?")


def _masked(line):
    """A report line with its paths and numbers masked, and its numbers."""
    words = [("<path>" if "/" in w else w) for w in line.split(" ")]
    text = " ".join(words)
    return NUMBER.sub("#", text), [float(x) for x in NUMBER.findall(text)]


@pytest.mark.parametrize("mode", ["plain", "weighted+reject"])
def test_analyze_ndds_dataset_matches_jax(env, mode):
    kwargs = dict(visualize_belief_maps=False, batch_size=4, num_workers=2)
    if mode != "plain":
        kwargs.update(pnp_weight_by_score=True, pnp_reject_outliers_px=10.0)
    ours_dir, ref_dir = str(env["root"] / f"port_{mode}"), str(env["root"] / f"jax_{mode}")
    ours = analysis.analyze_ndds_dataset(env["params"], env["config"], env["eval_data"], ours_dir,
                                         device="cpu", **kwargs)
    ref = jax_analysis.analyze_ndds_dataset(env["params"], env["config"], env["eval_data"], ref_dir,
                                            dream_network=env["jax_net"], **kwargs)
    assert ours[0]["num_found_gt_inframe"] > 30 and ours[1]["num_pnp_found"] >= 5

    a, b = _rows(os.path.join(ours_dir, "keypoints.csv")), _rows(os.path.join(ref_dir, "keypoints.csv"))
    assert a[0] == b[0] and [r[0] for r in a] == [r[0] for r in b] and len(a) == 9
    np.testing.assert_allclose(np.array([r[1:] for r in a[1:]], float),
                               np.array([r[1:] for r in b[1:]], float), atol=1e-3, rtol=0)

    detected = (np.array([r[1:15] for r in a[1:]], float).reshape(8, 7, 2)[..., 0] > -999).sum(1)
    a, b = _rows(os.path.join(ours_dir, "pnp_results.csv")), _rows(os.path.join(ref_dir, "pnp_results.csv"))
    assert a[0] == b[0] and len(a) == 9
    for ra, rb, n_detected in zip(a[1:], b[1:], detected):
        assert ra[:2] == rb[:2] and ra[-1] == rb[-1], (ra, rb)
        if n_detected >= 6:
            np.testing.assert_allclose(np.array(ra[2:-1], float), np.array(rb[2:-1], float),
                                       atol=1e-3, rtol=0, err_msg=ra[0])
    assert (detected >= 6).sum() >= 4

    with open(os.path.join(ours_dir, "analysis_results.txt")) as f:
        ours_lines = f.read().splitlines()
    with open(os.path.join(ref_dir, "analysis_results.txt")) as f:
        ref_lines = f.read().splitlines()
    assert len(ours_lines) == len(ref_lines) > 20
    add_section = False
    for la, lb in zip(ours_lines, ref_lines):
        (ta, na), (tb, nb) = _masked(la), _masked(lb)
        assert ta == tb, (la, lb)
        if re.search(r"\(\d+/\d+\)$", la):  # "share% (count/total)": exact counts
            assert na[1:] == nb[1:], (la, lb)
        add_section = add_section or la.startswith("ADD (m)")
        if mode == "plain" or not add_section:
            np.testing.assert_allclose(na, nb, atol=1e-3, rtol=0, err_msg=la)


def test_train_cli_trains_resumes_and_writes_flax_state(env):
    out = str(env["root"] / "train_out")
    argv = ["-i", env["train_data"], "-m", MANIP, "-ar", env["arch"], "-e", "2", "-b", "4",
            "-o", out, "-s", "42", "-w", "2", "-lr", "0.001", "-not-a", "--grad-clip-norm", "1.0",
            "--lr-decay-steps", "40", "--lr-warmup-steps", "2", "--ema-decay", "0.9",
            "--checkpoint-every", "2", "--valid-every", "2", "--device", "cpu"]
    train_cli.train_network(train_cli.make_parser().parse_args(argv))
    files = set(os.listdir(out))
    assert {"best_network.yaml", "best_network.msgpack", "epoch_2.yaml", "epoch_2.msgpack",
            "epoch_2.opt.msgpack", "epoch_2.ema.msgpack", "best_network_ema.msgpack",
            "training_log.pkl"} <= files
    assert "epoch_1.msgpack" not in files
    with open(os.path.join(out, "training_log.pkl"), "rb") as f:
        log = pickle.load(f)
    assert log["epochs"] == [1, 2] and log["random_seed"] == 42 and len(log["losses"]) == 2
    assert log["losses"][-1] < log["losses"][0]
    assert {"validation_losses", "timestamps", "batch_training_losses",
            "batch_training_sample_names", "start_time"} <= set(log)

    net = train_cli.train_network(train_cli.make_parser().parse_args(
        argv + ["-r", "-e", "3", "--cache-device"]))
    files = set(os.listdir(out))
    assert "epoch_3.msgpack" in files and "epoch_2.msgpack" not in files
    with open(os.path.join(out, "training_log.pkl"), "rb") as f:
        log = pickle.load(f)
    assert log["epochs"] == [1, 2, 3] and log["epochs_resumed"] == [3]

    # 13 training frames at batch 4: three steps an epoch.
    with open(os.path.join(out, "epoch_3.opt.msgpack"), "rb") as f:
        data = f.read()
    saved = serialization.msgpack_restore(data)
    assert int(saved["1"]["0"]["count"]) == int(saved["1"]["1"]["count"]) == 9 == net.steps
    cfg = load_yaml(os.path.join(out, "epoch_3.yaml"))
    assert cfg["training"]["config"]["optimizer"]["schedule"]["decay_steps"] == 40
    jax_net = jax_net_with(cfg)
    jax_net.enable_training()
    restored = serialization.from_bytes(jax_net.opt_state, data)
    assert (jax.tree_util.tree_structure(restored)
            == jax.tree_util.tree_structure(jax_net.opt_state))
    assert int(restored[1][0].count) == 9

    # The evaluation CLI reads what the trainer wrote; flags still to come raise.
    eval_args = eval_cli.make_parser().parse_args(
        ["-i", os.path.join(out, "best_network.msgpack"), "-d", env["eval_data"], "-o",
         str(env["root"] / "eval_cli"), "--no-visualization", "--no-pnp", "-b", "8",
         "--device", "cpu"])
    kp, pnp = eval_cli.network_inference_dataset(eval_args)
    assert pnp is None and kp["num_gt_inframe"] > 0
    assert not os.path.exists(str(env["root"] / "eval_cli" / "pnp_results.csv"))
    eval_args.no_visualization = True
    eval_args.no_visualization = False
    with pytest.raises(NotImplementedError):
        eval_cli.network_inference_dataset(eval_args)
    for extra in (["--mesh-data", "2"], ["--distributed"]):
        with pytest.raises(NotImplementedError):
            train_cli.train_network(train_cli.make_parser().parse_args(argv + ["-f"] + extra))


def test_jax_optimizer_state_resumes_in_port(tmp_path):
    optimizer = {"type": "adam", "learning_rate": 1e-4, "grad_clip_norm": 0.25,
                 "schedule": {"type": "cosine", "decay_steps": 20, "warmup_steps": 2}}
    cfg = network_config(net_in=64, optimizer=optimizer)
    net = DreamNetwork(copy.deepcopy(cfg), device="cpu", seed=5)
    params = state_to_flax(net.model.state_dict())
    tx = optax.chain(optax.clip_by_global_norm(0.25), optax.adam(
        optax.warmup_cosine_decay_schedule(0.0, 1e-4, 2, 20, 0.0)))
    rng = np.random.RandomState(6)
    mu = jax.tree_util.tree_map(lambda p: rng.normal(0, 1e-3, p.shape).astype(np.float32),
                                params["params"])
    nu = jax.tree_util.tree_map(lambda p: rng.uniform(1e-8, 1e-6, p.shape).astype(np.float32),
                                params["params"])
    count = np.asarray(3, np.int32)
    # chain(clip_by_global_norm, chain(scale_by_adam, scale_by_schedule)).
    state = (optax.EmptyState(), (optax.ScaleByAdamState(count=count, mu=mu, nu=nu),
                                  optax.ScaleByScheduleState(count=count)))
    assert (jax.tree_util.tree_structure(state)
            == jax.tree_util.tree_structure(jax.eval_shape(tx.init, params["params"])))
    params_path, opt_path = str(tmp_path / "e.msgpack"), str(tmp_path / "e.opt.msgpack")
    with open(params_path, "wb") as f:
        f.write(serialization.to_bytes(params))
    with open(opt_path, "wb") as f:
        f.write(serialization.to_bytes(state))

    raw = np.random.RandomState(8).randint(0, 256, (2, RES[1], RES[0], 3)).astype(np.uint8)
    kps = np.random.RandomState(9).uniform([60, 30], [100, 90], (2, 7, 2)).astype(np.float32)
    net.load_network_params(params_path)
    process = make_batch_processor(RES, (64, 64), (16, 16), "shrink-and-crop",
                                   ARCH["image_normalization"], augment=False)
    net.enable_fused_training(process)
    net.load_optimizer_state(load_flax_checkpoint(opt_path))
    assert net.steps == 3 and net.scheduler.last_epoch == 3

    # dream_tpu's optax step on the port's gradient of the batch (the two
    # models' gradients are held together in tests/test_torch_train.py).
    batch = process(None, torch.from_numpy(raw), torch.from_numpy(kps))
    net.model.zero_grad(set_to_none=True)
    net.criterion(net.model(batch["image_rgb_input"].permute(0, 3, 1, 2)),
                  batch["belief_maps"]).backward()
    grads = {name: p.grad.detach().clone() for name, p in net.model.named_parameters()}
    with open(opt_path, "rb") as f:
        loaded = serialization.from_bytes(state, f.read())
    def step(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    new_params, ref_state = jax.jit(step)(params_to_flax(grads)["params"], loaded, params["params"])
    ref = params_from_flax({"params": jax.tree_util.tree_map(np.asarray, new_params)})

    net.train_raw(None, torch.from_numpy(raw), torch.from_numpy(kps))
    start, ours = params_from_flax(params), net.model.state_dict()
    moved = 0.0
    for name in ref:
        np.testing.assert_allclose(ours[name].numpy(), ref[name].numpy(), atol=1e-7, rtol=0,
                                   err_msg=name)
        moved = max(moved, float((ours[name] - start[name]).abs().max()))
    assert moved > 1e-5  # the step moved the parameters: the comparison is not vacuous

    path = str(tmp_path / "port.opt.msgpack")
    save_flax_checkpoint(path, net.optimizer_state())
    with open(path, "rb") as f:
        restored = serialization.from_bytes(ref_state, f.read())
    assert int(restored[1][0].count) == int(restored[1][1].count) == 4
    for mine, theirs in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(ref_state)):
        scale = float(np.abs(np.asarray(theirs)).max())
        np.testing.assert_allclose(np.asarray(mine), np.asarray(theirs), atol=1e-5 * scale, rtol=0)


def test_init_encoder_from_matches_jax(env):
    vggf = load_yaml(os.path.join(ROOT, "arch_configs", "dream_vgg_f.yaml"))["architecture"]
    cfg = network_config(arch=vggf, net_in=64)
    jax_net = jax_net_with(cfg, seed=4)
    start = jax.tree_util.tree_map(np.asarray, jax_net.variables)
    ref = jax_net.init_encoder_from(env["params"])
    net = DreamNetwork(copy.deepcopy(cfg), device="cpu")
    net.model.load_state_dict(params_from_flax(start), strict=True)
    assert net.init_encoder_from(env["params"]) == ref and ref[0] > 30 and ref[1] == 0
    merged = params_from_flax(jax.tree_util.tree_map(np.asarray, jax_net.variables))
    ours = net.model.state_dict()
    assert set(ours) == set(merged)
    for name in merged:
        assert torch.equal(ours[name], merged[name]), name
    assert not torch.equal(ours["down1.conv0.weight"], params_from_flax(start)["down1.conv0.weight"])
    assert state_to_flax(ours)["params"].keys() == start["params"].keys()


def test_train_cli_takes_the_jax_scripts_flags():
    """Every flag of ``scripts/train_network.py``, with its short form and
    default, plus ``--device`` (default ``cuda``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_train_network_script", os.path.join(ROOT, "scripts", "train_network.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)

    def flags(parser):
        return {tuple(a.option_strings): a.default for a in parser._actions if a.option_strings}

    ours, ref = flags(train_cli.make_parser()), flags(script.make_parser())
    assert ours.pop(("--device",)) == "cuda"
    assert ours == ref
