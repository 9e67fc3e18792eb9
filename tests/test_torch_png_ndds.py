"""The port's PNG codec and NDDS reader and writer, against PIL and dream_tpu.

- PNG: frames PIL writes (``dream_tpu``'s synthetic sets, and gray, gray+
  alpha and RGBA images) decode bit for bit as PIL's ``convert("RGB")``
  gives them; hand-built files with one filter type on every row, for each
  of the five types (and a file mixing them row by row), decode bit for
  bit in the port and in PIL; files the port writes decode in PIL bit for
  bit; palette, 16-bit, interlaced and JPEG files raise naming the file.
- ``generate_synthetic_ndds`` for panda and kuka with two seeds: the same
  file names, decoded pixels equal, JSON equal value for value.
- ``find_ndds_data_in_dir``, ``load_camera_intrinsics``,
  ``load_image_resolution`` and ``load_keypoints`` give dream_tpu's results
  on a dataset dream_tpu wrote.
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from dream_tpu.data.synthetic import generate_synthetic_ndds as jax_generate_synthetic_ndds
from dream_tpu.utils import ndds as jax_ndds

from dream_tpu_torch.data.synthetic import generate_synthetic_frames, generate_synthetic_ndds
from dream_tpu_torch.utils import ndds
from dream_tpu_torch.utils.config import load_yaml
from dream_tpu_torch.utils.png import read_png, write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = (160, 120)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing
    and slow the other test workers: two threads take less CPU time than
    the machine's count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _pil_rgb(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ndds") / "jax_panda")
    jax_generate_synthetic_ndds(path, n_frames=4, image_resolution=RES, seed=5)
    return path


def test_pil_written_frames_decode_bit_for_bit(jax_dataset, tmp_path):
    frames = sorted(f for f in os.listdir(jax_dataset) if f.endswith(".png"))
    assert len(frames) == 4
    for f in frames:
        path = os.path.join(jax_dataset, f)
        np.testing.assert_array_equal(read_png(path), _pil_rgb(path))
    rng = np.random.RandomState(0)
    for mode, channels in (("L", 1), ("LA", 2), ("RGBA", 4)):
        pixels = rng.randint(0, 256, (37, 53, channels)).astype(np.uint8)
        path = str(tmp_path / f"{mode}.png")
        Image.fromarray(pixels[..., 0] if channels == 1 else pixels, mode).save(path)
        np.testing.assert_array_equal(read_png(path), _pil_rgb(path))


def _filter_rows(image, kinds):
    """PNG-filter each row of a uint8 [H, W, C] image with its filter kind
    (the PNG specification's filters, written out pixel by pixel)."""
    h, w, c = image.shape
    rows = image.reshape(h, w * c).astype(np.int64)
    out = []
    for y, kind in enumerate(kinds):
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        filt = np.empty_like(cur)
        for x in range(w * c):
            a = cur[x - c] if x >= c else 0
            b = prev[x]
            cc = prev[x - c] if x >= c else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) // 2
            else:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            filt[x] = (cur[x] - pred) % 256
        out.append(bytes([kind]) + filt.astype(np.uint8).tobytes())
    return b"".join(out)


def _png_bytes(width, height, colour, data, depth=8, interlace=0):
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    header = struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(data))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", ["0", "1", "2", "3", "4", "mixed"])
def test_each_row_filter_decodes_bit_for_bit(kinds, tmp_path):
    rng = np.random.RandomState(len(kinds) + ord(kinds[0]))
    image = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    image[3:6] //= 7  # flat rows, where the predictors differ most from noise
    row_kinds = [int(kinds)] * 9 if kinds != "mixed" else [y % 5 for y in range(9)]
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png_bytes(11, 9, 2, _filter_rows(image, row_kinds)))
    np.testing.assert_array_equal(read_png(path), image)
    np.testing.assert_array_equal(_pil_rgb(path), image)


def test_port_written_png_decodes_in_pil(tmp_path):
    frames = generate_synthetic_frames(2, RES, seed=3)["images"]
    for i, image in enumerate(frames):
        path = str(tmp_path / f"{i}.png")
        write_png(path, image)
        np.testing.assert_array_equal(_pil_rgb(path), image)
        np.testing.assert_array_equal(read_png(path), image)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "bad.png"), frames[0].astype(np.float32))


def test_unsupported_files_raise_naming_the_file(tmp_path):
    rng = np.random.RandomState(1)
    cases = {}
    palette = str(tmp_path / "palette.png")
    Image.fromarray(rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)).convert("P").save(palette)
    cases[palette] = "colour type 3"
    deep = str(tmp_path / "deep.png")
    with open(deep, "wb") as f:
        f.write(_png_bytes(4, 4, 2, b"\x00" + bytes(24) * 4, depth=16))
    cases[deep] = "bit depth 16"
    interlaced = str(tmp_path / "interlaced.png")
    with open(interlaced, "wb") as f:
        f.write(_png_bytes(4, 4, 2, bytes(13) * 4, interlace=1))
    cases[interlaced] = "interlace 1"
    jpeg = str(tmp_path / "frame.jpg")
    Image.fromarray(rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)).save(jpeg)
    cases[jpeg] = "JPEG"
    for path, words in cases.items():
        with pytest.raises(ValueError, match=words) as info:
            read_png(path)
        assert path in str(info.value)


@pytest.mark.parametrize("robot,seed", [("panda", 2), ("panda", 9), ("kuka", 2), ("kuka", 9)])
def test_generate_synthetic_ndds_matches_jax(robot, seed, tmp_path):
    manip = load_yaml(os.path.join(ROOT, "manip_configs", f"{robot}.yaml"))["manipulator"]
    names = [kp["name"] for kp in manip["keypoints"]]
    kwargs = dict(n_frames=3, image_resolution=RES, keypoint_names=names,
                  object_class=manip["name"], seed=seed, out_of_frame_fraction=0.34)
    ours, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    generate_synthetic_ndds(ours, **kwargs)
    jax_generate_synthetic_ndds(ref, **kwargs)
    files = sorted(os.listdir(ref))
    assert sorted(os.listdir(ours)) == files and len(files) == 2 + 2 * 3
    for f in files:
        if f.endswith(".png"):
            np.testing.assert_array_equal(read_png(os.path.join(ours, f)),
                                          _pil_rgb(os.path.join(ref, f)))
        else:
            with open(os.path.join(ours, f)) as a, open(os.path.join(ref, f)) as b:
                assert json.load(a) == json.load(b), f


def test_ndds_loaders_match_jax(jax_dataset):
    ours, ref = ndds.find_ndds_data_in_dir(jax_dataset), jax_ndds.find_ndds_data_in_dir(jax_dataset)
    assert ours == ref and len(ours[0]) == 4 and ours[1]["camera"]
    assert ndds.is_ndds_dataset(jax_dataset) and jax_ndds.is_ndds_dataset(jax_dataset)
    camera = ours[1]["camera"]
    np.testing.assert_array_equal(ndds.load_camera_intrinsics(camera),
                                  jax_ndds.load_camera_intrinsics(camera))
    assert ndds.load_image_resolution(camera) == jax_ndds.load_image_resolution(camera) == RES
    names = [kp["name"] for kp in load_yaml(os.path.join(ROOT, "manip_configs/panda.yaml"))
             ["manipulator"]["keypoints"]][::-1]
    for frame in ours[0]:
        assert (ndds.load_keypoints(frame["data_path"], "panda", names)
                == jax_ndds.load_keypoints(frame["data_path"], "panda", names))
    with pytest.raises(KeyError):
        ndds.load_keypoints(ours[0][0]["data_path"], "kuka", names)
    assert ndds.find_ndds_data_in_dir(os.path.dirname(camera) + "/..") == (None, None)
