"""The channel-split path's float32 gradients against float64, layer by layer, on the CPU.

vgg-Q r5 (its committed weights, cut to a 64x64 net input, batch 2, one
augmented step, as ``chip_smoke.py`` phase 32 steps it) four ways: unsharded
in float32 and float64, and on a (data 1, model 2) mesh of two gloo ranks
in float32 and float64 (``scripts/split_gradient_layers.py`` is the same
reading at full size).  The gradient clip is set to 1e-6 so that it acts.

- float64: the split step's gradients equal the unsharded step's to 1e-12
  (seen 1e-19).  The clip's norm sums the split parameters' squares over
  the model group; that sum went through float32 whatever the model's
  dtype, which left the float64 split step 1e-8 off whenever the clip
  acted (``parallel/mesh.py`` ``sum_over_model_group``, repaired).
- float32: the split step lies no further from float64 than the unsharded
  step does (whole gradient within 1.5x, every leaf within 3x or 1e-5;
  seen 1.43e-6 both), and the two float32 runs take the same discrete
  decisions in the forward: every conv output's sign (the ReLU that
  follows) and every 2x2 max-pool's pick, for the batch's first two
  frames (``parallel.dryrun.record_decisions``; seen 0 of 1.6 million
  apart).  On this CPU the split path adds no float32 error.

The networks are built without drawing their initial parameters
(``torch``'s truncated-normal draw of vgg-Q's 22 million takes ~10 s on a
CPU), in this process and in the ranks: the checkpoint overwrites every
parameter.
"""

import copy
import os

import numpy as np
import pytest
import torch

from dream_tpu_torch.data.synthetic import generate_synthetic_frames
from dream_tpu_torch.models import layers
from dream_tpu_torch.parallel import mesh as mesh_ops
from dream_tpu_torch.parallel.dryrun import (
    mesh_train_run,
    split_gradient_reading,
    train_network_for_run,
    train_steps,
)
from dream_tpu_torch.utils.config import load_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEM = os.path.join(ROOT, "trained_models/results_r5/vggq/dream_vgg_q_r5")


def _skip_initial_draw():
    layers.lecun_normal_ = lambda weight, generator=None: weight


def _rank_run(rank, runs, devices):
    """A mesh rank's runs on one thread, its networks built without the
    initial draw."""
    torch.set_num_threads(1)
    _skip_initial_draw()
    return mesh_train_run(rank, runs, devices)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small convolutions, where the test workers' idle intra-op threads
    spin for nothing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def four_runs():
    cfg = load_yaml(STEM + ".yaml")
    cfg["architecture"]["compute_dtype"] = "float32"
    tcfg = cfg["training"]["config"]
    tcfg["net_input_resolution"] = [64, 64]
    tcfg.pop("net_output_resolution", None)
    tcfg["image_raw_resolution"] = [160, 120]
    tcfg["optimizer"]["grad_clip_norm"] = 1e-6
    names = [kp["name"] for kp in cfg["manipulator"]["keypoints"]]
    frames = generate_synthetic_frames(2, (160, 120), names, seed=0)
    run = {"config": cfg, "params_path": STEM + ".msgpack", "steps": 1, "augment": True, "aug_seed": 32,
           "record_decisions": 2,
           "batch": {"raw": frames["images"], "kp": frames["projections"].astype(np.float32)}}
    f64 = dict(run, float64=True)
    draw = layers.lecun_normal_
    _skip_initial_draw()
    try:
        unsharded = [train_steps(train_network_for_run(copy.deepcopy(r), "cpu"), r) for r in (run, f64)]
    finally:
        layers.lecun_normal_ = draw
    ranks = mesh_ops.spawn_local_ranks(_rank_run, 2, "gloo", ["cpu", "cpu"],
                                       [dict(r, n_data=1, n_model=2) for r in (run, f64)], ["cpu", "cpu"])
    return {"unsharded32": unsharded[0], "unsharded64": unsharded[1],
            "split32": ranks[0][0], "split64": ranks[0][1]}


@pytest.fixture(scope="module")
def reading(four_runs):
    return split_gradient_reading(four_runs["unsharded32"], four_runs["unsharded64"], four_runs["split32"],
                                  four_runs["split64"])


def test_float64_split_step_is_exact(reading):
    assert len(reading["split_leaves"]) == 28  # down3-5 and upsample4: 14 convs, weight and bias
    assert reading["whole"]["split_float64"] < 1e-12, reading["whole"]


def test_float32_split_step_is_as_precise_as_the_whole(reading):
    whole = reading["whole"]
    assert whole["split_float32"] <= 1.5 * whole["unsharded_float32"] and whole["unsharded_float32"] < 1e-4, whole
    assert [leaf[0] for leaf in reading["leaves"][:2]] == ["head.conv2.bias", "head.conv2.weight"]
    for leaf, unsharded, split in reading["leaves"]:
        assert split <= max(3.0 * unsharded, 1e-5), (leaf, split, unsharded)


def test_float32_runs_take_the_same_decisions(reading):
    layers_read = list(reading["decisions"])
    assert len(layers_read) == 23 + 4 and [n for n in layers_read if n.endswith(".pool")] == [
        f"down{i}.pool" for i in range(1, 5)]
    flips = {layer: pairs["split32_vs_unsharded32"] for layer, pairs in reading["decisions"].items()}
    apart = sum(f[0] for f in flips.values())
    total = sum(f[1] for f in flips.values())
    assert total > 1_000_000 and apart <= 1e-5 * total, {k: v for k, v in flips.items() if v[0]}
    assert all(pairs["split64_vs_float64"][0] == 0 for pairs in reading["decisions"].values())
