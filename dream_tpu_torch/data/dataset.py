"""NDDS datasets on disk, their loaders, and the device-side batch transform.

Port of ``dream_tpu/data/dataset.py``.  The host decodes JPEG and PNG
frames with the host loader's C++ thread pool
(:mod:`dream_tpu_torch.data.native_loader`; with ``use_native_loader=False``,
PNG frames with numpy and ``zlib`` in a Python thread pool,
:mod:`dream_tpu_torch.utils.png`), parses keypoints once, shuffles, batches
and prefetches (:class:`ManipulatorNDDSDataset`, :class:`DataLoader`); or
it decodes the set once and keeps it on the card as uint8
(:class:`DeviceCachedLoader`), so batches become gathers there.
Everything after the decode runs on the device in
:func:`make_batch_processor`: preprocessing, augmentation, normalization,
keypoint frame conversion and the belief maps.  The shuffle
order, the train/validation split and the calibration batches follow the
JAX package's numpy ``RandomState`` draws, so a seed gives the same
batches in both packages.
"""

from __future__ import annotations

import concurrent.futures
import enum
import html
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dream_tpu_torch.data import native_loader
from dream_tpu_torch.data.augment import DEFAULT_AUGMENT, AugmentConfig, augment_batch
from dream_tpu_torch.ops import coords as coord_ops
from dream_tpu_torch.ops.belief_maps import create_belief_maps
from dream_tpu_torch.ops.image_proc import normalize_images, preprocess_images
from dream_tpu_torch.utils import ndds as ndds_utils
from dream_tpu_torch.utils.png import read_image, read_png
from dream_tpu_torch.utils.resolutions import KNOWN_IMAGE_PREPROC_TYPES


class ManipulatorNDDSDatasetDebugLevels(enum.IntEnum):
    """``dream_tpu``'s debug levels (reference dream/datasets.py:22-30).

    NONE and LIGHT behave alike.  HEAVY dumps each sample's ground-truth
    overlays (raw frame and net input, with the keypoint names) and its
    belief-map mosaic as PNGs into ``debug_dir`` when its batch is loaded;
    INTERACTIVE also rewrites ``index.html``, a contact sheet of every dump
    so far, in place of the reference's on-screen check, which needs a
    display (dream/datasets.py:228-271)."""

    NONE = 0
    LIGHT = 1
    HEAVY = 2
    INTERACTIVE = 3


class ManipulatorNDDSDataset:
    """Host-side index over an NDDS dataset (``dream_tpu/data/dataset.py:52``).

    ``ndds_dataset`` is a directory or the pair
    :func:`dream_tpu_torch.utils.ndds.find_ndds_data_in_dir` returns.  The
    keypoints of every frame are parsed at construction (float32
    ``kp_projs_raw [N, n_kp, 2]`` and ``kp_positions [N, n_kp, 3]``); images
    are decoded per batch by ``n_decode_threads`` threads.
    ``use_native_loader`` None or True decodes JPEG and PNG through the host
    loader, which is built at construction (a failed build raises), and
    resizes a frame of another size to the camera's resolution as
    ``dream_tpu``'s native loader does; False decodes PNG through the port's
    numpy reader, which raises on a JPEG.
    """

    def __init__(
        self,
        ndds_dataset,
        manipulator_name: str,
        keypoint_names: Sequence[str],
        network_input_resolution: Tuple[int, int],
        network_output_resolution: Tuple[int, int],
        image_normalization: Optional[dict] = None,
        image_preprocessing: str = "shrink-and-crop",
        augment_data: bool = False,
        include_ground_truth: bool = True,
        include_belief_maps: bool = False,
        debug_mode: int = ManipulatorNDDSDatasetDebugLevels.NONE,
        n_decode_threads: int = 8,
        use_native_loader: Optional[bool] = None,
        debug_dir: str = "dataset_debug",
    ):
        if include_belief_maps and not include_ground_truth:
            raise ValueError('If "include_belief_maps" is True, "include_ground_truth" must also be True.')
        if image_preprocessing not in KNOWN_IMAGE_PREPROC_TYPES:
            raise ValueError(f'Image preprocessing type "{image_preprocessing}" is not recognized.')
        if isinstance(ndds_dataset, str):
            ndds_dataset = ndds_utils.find_ndds_data_in_dir(ndds_dataset)
        self.ndds_dataset_data, self.ndds_dataset_config = ndds_dataset
        self.manipulator_name = manipulator_name
        self.keypoint_names = list(keypoint_names)
        self.network_input_resolution = tuple(network_input_resolution)
        self.network_output_resolution = tuple(network_output_resolution)
        self.image_normalization = image_normalization
        self.image_preprocessing = image_preprocessing
        self.augment_data = augment_data
        self.include_ground_truth = include_ground_truth
        self.include_belief_maps = include_belief_maps
        self.debug_mode = debug_mode
        self.debug_dir = debug_dir
        self._debug_dumped: set = set()
        self._n_decode_threads = n_decode_threads
        self._use_native_loader = use_native_loader is not False
        if self._use_native_loader:
            native_loader.load()

        n, n_kp = len(self.ndds_dataset_data), len(self.keypoint_names)
        self.kp_projs_raw = np.zeros((n, n_kp, 2), dtype=np.float32)
        self.kp_positions = np.zeros((n, n_kp, 3), dtype=np.float32)
        if include_ground_truth:
            for i, datum in enumerate(self.ndds_dataset_data):
                kp = ndds_utils.load_keypoints(datum["data_path"], manipulator_name, self.keypoint_names)
                self.kp_projs_raw[i] = np.asarray(kp["projections"], dtype=np.float32)
                self.kp_positions[i] = np.asarray(kp["positions_wrt_cam"], dtype=np.float32)

        if self.ndds_dataset_config and self.ndds_dataset_config.get("camera"):
            self.image_raw_resolution = ndds_utils.load_image_resolution(
                self.ndds_dataset_config["camera"])
        else:
            im = self._decode(0)
            self.image_raw_resolution = (im.shape[1], im.shape[0])

    def __len__(self) -> int:
        return len(self.ndds_dataset_data)

    def _decode(self, index: int) -> np.ndarray:
        path = self.ndds_dataset_data[index]["image_paths"]["rgb"]
        return read_image(path) if self._use_native_loader else read_png(path)

    def load_images(self, indices: Sequence[int]) -> np.ndarray:
        """Decode a batch of raw-resolution uint8 frames ``[B, H, W, 3]``."""
        if self._use_native_loader:
            w, h = self.image_raw_resolution
            paths = [self.ndds_dataset_data[int(i)]["image_paths"]["rgb"] for i in indices]
            return native_loader.decode_batch(paths, h, w, n_threads=self._n_decode_threads)
        with concurrent.futures.ThreadPoolExecutor(max_workers=self._n_decode_threads) as pool:
            return np.stack(list(pool.map(self._decode, [int(i) for i in indices])))

    def host_batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """What the device transform needs, as host numpy arrays."""
        batch = {"image_rgb_raw": self.load_images(indices),
                 "indices": np.asarray(indices, dtype=np.int32)}
        if self.include_ground_truth:
            batch["keypoint_projections_raw"] = self.kp_projs_raw[indices]
            batch["keypoint_positions"] = self.kp_positions[indices]
        if self.debug_mode >= ManipulatorNDDSDatasetDebugLevels.HEAVY:
            self.dump_debug(indices, images=batch["image_rgb_raw"])
        return batch

    def dump_debug(self, indices: Sequence[int], images: Optional[np.ndarray] = None,
                   output_dir: Optional[str] = None) -> List[str]:
        """HEAVY-level dumps (``dream_tpu/data/dataset.py:176-269``): for each
        sample not dumped before, ``{name}_gt_overlay_raw.png`` and
        ``{name}_gt_overlay_net_input.png`` (the ground-truth keypoints and
        their names over the raw frame and over the preprocessed frame,
        truncated to uint8) and ``{name}_gt_belief_maps.png`` (its belief
        maps in a row), in ``output_dir`` or ``debug_dir``; at INTERACTIVE
        level ``index.html`` too.  ``images`` are the samples' raw frames
        when the caller has them.  Returns the files written."""
        from dream_tpu_torch import visualize as viz
        from dream_tpu_torch.utils.png import write_png

        out_dir = output_dir or self.debug_dir
        os.makedirs(out_dir, exist_ok=True)
        to_netin = coord_ops.affine_netin_from_raw(
            self.image_raw_resolution, self.network_input_resolution, self.image_preprocessing)
        to_netout = coord_ops.affine_netout_from_netin(
            self.network_input_resolution, self.network_output_resolution)
        written: List[str] = []
        for j, idx in enumerate(indices):
            idx = int(idx)
            if idx in self._debug_dumped:
                continue
            self._debug_dumped.add(idx)
            name = self.ndds_dataset_data[idx]["name"]
            raw = images[j] if images is not None else self.load_images([idx])[0]
            kp_raw = self.kp_projs_raw[idx]
            # In float32, as dream_tpu maps them.
            kp_netin = to_netin(torch.from_numpy(kp_raw))
            kp_netout = to_netout(kp_netin)
            kp_netin = kp_netin.numpy()
            net_in = preprocess_images(torch.from_numpy(raw[None].astype(np.float32)),
                                       self.network_input_resolution,
                                       self.image_preprocessing)[0].numpy().astype(np.uint8)
            maps = create_belief_maps(kp_netout[None], self.network_output_resolution)[0]
            for kind, image in (
                    ("gt_overlay_raw", viz.overlay_points_on_image(raw, kp_raw, self.keypoint_names)),
                    ("gt_overlay_net_input",
                     viz.overlay_points_on_image(net_in, kp_netin, self.keypoint_names)),
                    ("gt_belief_maps", viz.mosaic_images(viz.images_from_belief_maps(maps), rows=1,
                                                         cols=len(self.keypoint_names)))):
                path = os.path.join(out_dir, f"{name}_{kind}.png")
                write_png(path, image)
                written.append(path)
        if written and self.debug_mode >= ManipulatorNDDSDatasetDebugLevels.INTERACTIVE:
            written.append(self._write_debug_contact_sheet(out_dir))
        return written

    def _write_debug_contact_sheet(self, out_dir: str) -> str:
        """``index.html``: every dump so far, a row a sample (INTERACTIVE)."""
        rows = []
        for idx in sorted(self._debug_dumped):
            name = html.escape(self.ndds_dataset_data[idx]["name"])
            cells = "".join(
                f'<td><img src="{name}_{kind}.png" style="max-width:320px"><br>{kind}</td>'
                for kind in ("gt_overlay_raw", "gt_overlay_net_input", "gt_belief_maps"))
            rows.append(f"<tr><th>{name}</th>{cells}</tr>")
        path = os.path.join(out_dir, "index.html")
        with open(path, "w") as f:
            f.write("<html><body><h1>dream_tpu dataset GT debug</h1>"
                    f"<table border=1>{''.join(rows)}</table></body></html>")
        return path

    def sample_names(self, indices: Sequence[int]) -> List[str]:
        return [self.ndds_dataset_data[int(i)]["name"] for i in indices]


def _batch_count(n: int, batch_size: int, drop_last: bool) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)


def _epoch_order(n: int, shuffle: bool, seed: int, epoch: int) -> np.ndarray:
    """Positions ``0..n-1``, shuffled by ``RandomState(seed + epoch)`` as
    ``dream_tpu``'s loaders shuffle them."""
    order = np.arange(n, dtype=np.int64)
    if shuffle:
        np.random.RandomState(seed + epoch).shuffle(order)
    return order


class DataLoader:
    """Shuffling, batching iterator of host batches with one batch decoded
    ahead on a background thread (``dream_tpu/data/dataset.py:350-413``)."""

    def __init__(self, dataset: ManipulatorNDDSDataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, indices: Optional[Sequence[int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.indices = (np.asarray(indices, dtype=np.int64) if indices is not None
                        else np.arange(len(dataset), dtype=np.int64))
        self._epoch = 0

    def __len__(self) -> int:
        return _batch_count(len(self.indices), self.batch_size, self.drop_last)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _batches(self) -> List[np.ndarray]:
        order = self.indices[_epoch_order(len(self.indices), self.shuffle, self.seed, self._epoch)]
        return [order[i * self.batch_size : (i + 1) * self.batch_size] for i in range(len(self))]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batches()
        if not batches:
            return
        # The pool shuts down when iteration is abandoned early too: closing
        # the generator raises GeneratorExit here and runs __exit__.
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            future = pool.submit(self.dataset.host_batch, batches[0])
            for i in range(len(batches)):
                batch = future.result()
                if i + 1 < len(batches):
                    future = pool.submit(self.dataset.host_batch, batches[i + 1])
                yield batch


class DeviceCachedLoader:
    """The dataset decoded once and held on ``device`` as uint8 (frames and
    key points), batches served as gathers there
    (``dream_tpu/data/dataset.py:414-516``).  Iterates like
    :class:`DataLoader`; ``indices`` in a batch stay host numpy."""

    def __init__(self, dataset: ManipulatorNDDSDataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, indices: Optional[Sequence[int]] = None,
                 chunk: int = 64, device: Any = "cuda"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.indices = (np.asarray(indices, dtype=np.int64) if indices is not None
                        else np.arange(len(dataset), dtype=np.int64))
        self._epoch = 0
        # Decoded in chunks to bound host memory.
        parts = [torch.from_numpy(dataset.load_images(self.indices[i : i + chunk])).to(device)
                 for i in range(0, len(self.indices), chunk)]
        self.device_images = torch.cat(parts) if len(parts) > 1 else parts[0]
        self.device_kp_projs = torch.from_numpy(dataset.kp_projs_raw[self.indices]).to(device)
        self.device_kp_positions = torch.from_numpy(dataset.kp_positions[self.indices]).to(device)

    def __len__(self) -> int:
        return _batch_count(len(self.indices), self.batch_size, self.drop_last)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def epoch_order(self, epoch: int) -> np.ndarray:
        """The seeded permutation of positions this loader uses for ``epoch``."""
        return _epoch_order(len(self.indices), self.shuffle, self.seed, epoch)

    def epoch_index_matrix(self, epoch: int) -> np.ndarray:
        """``[n_steps, batch]`` positions into the cached tensors for
        ``epoch``, full rows only: the input of ``train_epoch_raw``."""
        n_steps = len(self.indices) // self.batch_size
        return self.epoch_order(epoch)[: n_steps * self.batch_size].reshape(n_steps, self.batch_size)

    def __iter__(self):
        order = self.epoch_order(self._epoch)
        for i in range(len(self)):
            sel = order[i * self.batch_size : (i + 1) * self.batch_size]
            sel_dev = torch.from_numpy(sel).to(self.device_images.device)
            batch = {"image_rgb_raw": self.device_images[sel_dev],
                     "indices": self.indices[sel].astype(np.int32)}
            if self.dataset.include_ground_truth:
                batch["keypoint_projections_raw"] = self.device_kp_projs[sel_dev]
                batch["keypoint_positions"] = self.device_kp_positions[sel_dev]
            yield batch


def split_indices(n: int, training_fraction: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Seed-pinned train/valid split (``dream_tpu/data/dataset.py:517``)."""
    order = np.random.RandomState(seed).permutation(n)
    n_train = int(round(n * training_fraction))
    return order[:n_train], order[n_train:]


def make_batch_processor(
    image_raw_resolution: Tuple[int, int],
    network_input_resolution: Tuple[int, int],
    network_output_resolution: Tuple[int, int],
    image_preprocessing: str,
    image_normalization: Optional[dict],
    augment: bool = False,
    augment_config: AugmentConfig = DEFAULT_AUGMENT,
    include_belief_maps: bool = True,
    warp_backend: str = "auto",
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Build the batch transform.

    Returns ``process(generator, image_rgb_raw_u8, kp_projs_raw) -> dict``
    with ``image_rgb_input`` (normalized net input, NHWC),
    ``keypoint_projections_input`` (net-input frame),
    ``keypoint_projections_output`` (net-output frame) and, unless
    ``include_belief_maps`` is false, ``belief_maps [B, n_kp, h, w]``.
    The work runs on the raw images' device; ``generator`` (on that device)
    drives the augmentation and is not read when ``augment`` is false.
    ``warp_backend`` is passed to :func:`augment_batch`.
    """
    to_netin = coord_ops.affine_netin_from_raw(
        image_raw_resolution, network_input_resolution, image_preprocessing
    )
    to_netout = coord_ops.affine_netout_from_netin(
        network_input_resolution, network_output_resolution
    )

    def process(generator: Optional[torch.Generator], image_rgb_raw: torch.Tensor,
                kp_projs_raw: torch.Tensor) -> Dict[str, torch.Tensor]:
        images = preprocess_images(
            image_rgb_raw, network_input_resolution, image_preprocessing
        )  # float32, 0-255 scale
        kp_netin = to_netin(kp_projs_raw.to(images.device, torch.float32))
        if augment:
            images, kp_netin = augment_batch(
                generator, images, kp_netin, augment_config, warp_backend
            )
        if image_normalization:
            net_input = normalize_images(
                images, image_normalization["mean"], image_normalization["stdev"]
            )
        else:
            net_input = images / 255.0
        kp_netout = to_netout(kp_netin)
        out = {
            "image_rgb_input": net_input,
            "keypoint_projections_input": kp_netin,
            "keypoint_projections_output": kp_netout,
        }
        if include_belief_maps:
            out["belief_maps"] = create_belief_maps(kp_netout, network_output_resolution)
        return out

    return process


def collect_calibration_batches(source, process: Callable[..., Dict[str, torch.Tensor]],
                                n_frames: int, batch_size: int = 16,
                                indices: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """Net-input batches of at least ``n_frames`` frames for int8 calibration.

    ``source`` is uint8 frames ``[F, H, W, 3]`` or a
    :class:`ManipulatorNDDSDataset`; batches of ``batch_size`` are taken
    from its head (or the head of ``indices``) in order, the last one kept
    even when short, and run through ``process`` (a non-augmenting
    :func:`make_batch_processor` closure, fed placeholder key points) until
    ``n_frames`` are reached.  Returns the ``image_rgb_input`` batches.
    """
    if batch_size <= 0:
        raise ValueError("batch_size must be positive")
    if isinstance(source, ManipulatorNDDSDataset):
        loader = DataLoader(source, batch_size, shuffle=False, drop_last=False, indices=indices)
        raw_batches = (b["image_rgb_raw"] for b in loader)
    else:
        frames = source if indices is None else source[np.asarray(indices)]
        raw_batches = (frames[s : s + batch_size] for s in range(0, len(frames), batch_size))
    batches: List[torch.Tensor] = []
    n = 0
    for raw in raw_batches:
        images = torch.as_tensor(np.asarray(raw, dtype=np.uint8))
        kp_raw = torch.zeros((images.shape[0], 1, 2), dtype=torch.float32)
        batches.append(process(None, images, kp_raw)["image_rgb_input"])
        n += images.shape[0]
        if n >= n_frames:
            break
    if not batches:
        raise ValueError("calibration frames are empty")
    return batches
