"""The port's NDDS dataset and loaders against dream_tpu, on a dataset dream_tpu wrote.

- ``ManipulatorNDDSDataset.host_batch`` equal to dream_tpu's (PIL decode),
  keys, dtypes and values; ``sample_names`` equal.
- ``split_indices``, ``DataLoader``'s batches (shuffled, with a seed and an
  epoch, and in order with a short last batch) and
  ``DeviceCachedLoader.epoch_index_matrix`` and its batches equal to
  dream_tpu's.
- ``collect_calibration_batches`` over the dataset: the same batch sizes,
  net inputs within 1e-4 (the batch processor's tolerance in
  ``tests/test_torch_augment.py``).
"""


import os

import numpy as np
import pytest
import torch
from PIL import Image

from dream_tpu.data import dataset as jax_data
from dream_tpu.data.synthetic import generate_synthetic_ndds as jax_generate_synthetic_ndds
from dream_tpu import visualize as jax_viz
from dream_tpu.ops import coords as jax_coords
from dream_tpu.ops import image_proc as jax_image_proc

from dream_tpu_torch.data import dataset as data
from dream_tpu_torch.utils.png import read_png
from dream_tpu_torch.ops.image_proc import preprocess_images as torch_preprocess
from tests.test_torch_visualize import assert_equal_but_names

RES, NET_IN, NET_OUT = (160, 120), (64, 64), (16, 16)
NAMES = ["panda_link0", "panda_link2", "panda_link3", "panda_link4", "panda_link6", "panda_link7",
         "panda_hand"]
NORM = {"mean": [0.5] * 3, "stdev": [0.5] * 3}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing
    and slow the other test workers: two threads take less CPU time than
    the machine's count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ndds") / "jax_panda")
    jax_generate_synthetic_ndds(path, n_frames=10, image_resolution=RES, seed=13)
    args = ("panda", NAMES, NET_IN, NET_OUT, NORM, "shrink-and-crop")
    ours = data.ManipulatorNDDSDataset(path, *args, n_decode_threads=2)
    ref = jax_data.ManipulatorNDDSDataset(path, *args, n_decode_threads=2, use_native_loader=False)
    return ours, ref


def test_host_batch_matches_jax(datasets, tmp_path):
    ours, ref = datasets
    assert len(ours) == len(ref) == 10 and ours.image_raw_resolution == ref.image_raw_resolution
    indices = [7, 0, 3]
    a, b = ours.host_batch(indices), ref.host_batch(indices)
    assert set(a) == set(b)
    for key in b:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert ours.sample_names(indices) == ref.sample_names(indices) == ["000007", "000000", "000003"]

    # The HEAVY and INTERACTIVE debug dumps (formerly refused): dream_tpu's
    # file names, the belief-map mosaics pixel-equal, the overlays equal but
    # for the keypoint names (the loose text bound of
    # tests/test_torch_visualize.py), each sample dumped once.
    args = ("panda", NAMES, NET_IN, NET_OUT, NORM, "shrink-and-crop")
    for level in (2, 3):
        mine_dir, ref_dir = tmp_path / f"port{level}", tmp_path / f"jax{level}"
        mine = data.ManipulatorNDDSDataset((ours.ndds_dataset_data, ours.ndds_dataset_config), *args,
                                           debug_mode=level, debug_dir=str(mine_dir))
        theirs = jax_data.ManipulatorNDDSDataset((ref.ndds_dataset_data, ref.ndds_dataset_config), *args,
                                                 debug_mode=level, debug_dir=str(ref_dir),
                                                 use_native_loader=False)
        for batch in ([7, 0], [0, 3]):
            mine.host_batch(batch)
            theirs.host_batch(batch)
        files = sorted(os.listdir(ref_dir))
        assert sorted(os.listdir(mine_dir)) == files
        assert len(files) == 9 + (level == 3) and ("index.html" in files) == (level == 3)
        if level == 3:
            assert (mine_dir / "index.html").read_text() == (ref_dir / "index.html").read_text()
        to_netin = jax_coords.affine_netin_from_raw(RES, NET_IN, "shrink-and-crop")
        for f in files:
            if not f.endswith(".png"):
                continue
            a = read_png(str(mine_dir / f))
            b = np.asarray(Image.open(ref_dir / f).convert("RGB"))
            assert a.shape == b.shape, f
            if f.endswith("_gt_belief_maps.png"):
                np.testing.assert_array_equal(a, b, err_msg=f)
                continue
            idx = int(f[:6])
            raw = ours.load_images([idx])[0]
            kp = ref.kp_projs_raw[idx]
            if "net_input" in f:
                # Each package's float32 preprocessing, truncated: they agree
                # to 1e-4 (tests/test_torch_augment.py), so within one level
                # where a value lands by an integer; the overlay is held on
                # the port's own net input.
                kp = np.asarray(to_netin(kp))
                theirs = np.asarray(jax_image_proc.preprocess_images(
                    raw[None].astype(np.float32), NET_IN, "shrink-and-crop")[0]).astype(np.uint8)
                raw = torch_preprocess(torch.from_numpy(raw[None].astype(np.float32)), NET_IN,
                                       "shrink-and-crop")[0].numpy().astype(np.uint8)
                assert np.abs(raw.astype(int) - theirs).max() <= 1
                b = np.asarray(jax_viz.overlay_points_on_image(raw, kp, NAMES))
            assert_equal_but_names(a, b, raw, kp, NAMES)


@pytest.mark.parametrize("n,fraction,seed", [(10, 0.8, 42), (37, 0.5, 3)])
def test_split_indices_matches_jax(n, fraction, seed):
    for a, b in zip(data.split_indices(n, fraction, seed), jax_data.split_indices(n, fraction, seed)):
        np.testing.assert_array_equal(a, b)


def test_loaders_match_jax(datasets):
    ours, ref = datasets
    train_idx, _ = jax_data.split_indices(len(ref), 0.8, 42)
    for kwargs in (dict(batch_size=3, shuffle=True, seed=42, indices=train_idx),
                   dict(batch_size=4, shuffle=False, drop_last=False)):
        mine, theirs = data.DataLoader(ours, **kwargs), jax_data.DataLoader(ref, **kwargs)
        assert len(mine) == len(theirs)
        for epoch in (0, 3):
            mine.set_epoch(epoch)
            theirs.set_epoch(epoch)
            batches = list(zip(mine, theirs))
            assert len(batches) == len(theirs)
            for a, b in batches:
                for key in b:
                    np.testing.assert_array_equal(a[key], b[key], err_msg=key)

    kwargs = dict(batch_size=3, shuffle=True, seed=7, indices=train_idx)
    mine = data.DeviceCachedLoader(ours, device="cpu", **kwargs)
    theirs = jax_data.DeviceCachedLoader(ref, **kwargs)
    assert mine.device_images.dtype == torch.uint8 and len(mine) == len(theirs) == 2
    for epoch in (0, 1, 5):
        np.testing.assert_array_equal(mine.epoch_index_matrix(epoch), theirs.epoch_index_matrix(epoch))
    mine.set_epoch(1)
    theirs.set_epoch(1)
    for a, b in zip(mine, theirs):
        for key in b:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)


def test_collect_calibration_batches_matches_jax(datasets):
    ours, ref = datasets
    args = (RES, NET_IN, NET_OUT, "shrink-and-crop", NORM)
    process = data.make_batch_processor(*args, include_belief_maps=False)
    jax_process = jax_data.make_batch_processor(*args, include_belief_maps=False)
    mine = data.collect_calibration_batches(ours, process, 5, batch_size=4)
    theirs = jax_data.collect_calibration_batches(ref, jax_process, 5, batch_size=4)
    assert [b.shape[0] for b in mine] == [b.shape[0] for b in theirs] == [4, 4]
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)
    # The same frames in memory give the same batches.
    frames = ours.load_images(range(len(ours)))
    for a, b in zip(data.collect_calibration_batches(frames, process, 5, batch_size=4), mine):
        assert torch.equal(a, b)
