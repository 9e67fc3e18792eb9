"""The port's host image loader against dream_tpu's native loader and PIL.

- PNG: 8-bit RGB, RGBA, palette (and a 4-bit one), gray, gray+alpha,
  1-bit, tRNS on RGB, gray and palette images, all written by PIL, the
  port's own ``encode_png`` output, and hand-written 16-bit RGB and Adam7
  interlaced files decode bit for bit as ``dream_tpu``'s native loader
  (libpng) and PIL's ``convert("RGB")`` decode them.  A 16-bit gray file
  (PIL's ``I;16``) decodes as the native loader decodes it (libpng keeps
  each sample's high byte); PIL clips such a sample to 255 instead, so
  there the two references part and the port follows ``dream_tpu``'s
  default route.
- JPEG: 4:4:4, 4:2:2 and 4:2:0 at quality 75-100, with Huffman tables
  optimized and with restart markers, at 640x480 and at odd sizes, and
  grayscale, bit for bit as libjpeg (the native loader) and PIL decode
  them.  A progressive JPEG does not decode.
- The resize path (a frame of another size than asked for) bit for bit as
  the native loader's.
- ``decode_bytes`` equals ``decode_batch``; 1 and 8 threads agree; a
  corrupt file raises the failure count as the native loader does;
  ``decode_image`` dispatches on the magic bytes and names other formats.
- The dataset on a JPEG copy of a synthetic NDDS set: ``host_batch`` equal
  to ``dream_tpu``'s with ``use_native_loader=True``; the numpy route
  (``use_native_loader=False``) still refuses a JPEG.
- Builds: four builds at once into one directory leave one working
  library; a build that cannot link raises with the compiler's message.
"""

import io
import os
import struct
import threading
import zlib

import numpy as np
import pytest
from PIL import Image

from dream_tpu.data import dataset as jax_data
from dream_tpu.data import native_loader as jax_loader
from dream_tpu.data.synthetic import generate_synthetic_ndds as jax_generate_synthetic_ndds

from dream_tpu_torch.data import dataset as data
from dream_tpu_torch.data import native_loader
from dream_tpu_torch.ops import cuda_build
from dream_tpu_torch.utils.png import decode_image, decode_png, encode_png, image_format

NAMES = ["panda_link0", "panda_link2", "panda_link3", "panda_link4", "panda_link6", "panda_link7",
         "panda_hand"]


@pytest.fixture(scope="module", autouse=True)
def _reference_is_native():
    """The references are libjpeg and libpng through dream_tpu's native
    loader, never its PIL fallback."""
    assert jax_loader.native_available(), "dream_tpu's native loader did not build"


def _scene(h, w, seed=0):
    """A smooth image with noise: what a camera frame compresses like."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 17.0 + c) * np.cos(y / 23.0 - c) for c in range(3)], -1)
    return np.clip(img + rng.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)


def _both(path, h, w, n_threads=1):
    return (native_loader.decode_batch([path], h, w, n_threads)[0],
            jax_loader.decode_batch([path], h, w, n_threads)[0])


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _png_rgb16(image16):
    """A 16-bit RGB PNG (PIL writes none), every row unfiltered."""
    h, w, _ = image16.shape
    raw = b"".join(b"\x00" + image16[y].astype(">u2").tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _png_adam7(image):
    """An 8-bit RGB Adam7-interlaced PNG (PIL writes none), Sub-filtered."""
    h, w, _ = image.shape
    raw = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
                           (1, 0, 2, 2), (0, 1, 1, 2)):
        sub = image[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        for row in sub:
            flat = row.reshape(-1).astype(np.int16)
            filtered = (flat - np.concatenate([np.zeros(3, np.int16), flat[:-3]])) % 256
            raw += b"\x01" + filtered.astype(np.uint8).tobytes()
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _write_png_case(case, path):
    rng = np.random.RandomState(1)
    h, w = 37, 53
    rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    gray = Image.fromarray(rgb[..., 0])
    writers = {
        "RGB": lambda: Image.fromarray(rgb).save(path),
        "RGBA": lambda: Image.fromarray(np.dstack([rgb, rgb[..., 1]])).save(path),
        "palette": lambda: Image.fromarray(rgb).convert("P").save(path),
        "palette_17": lambda: Image.fromarray(rgb).quantize(17).save(path),
        "palette_4bit": lambda: gray.convert("P").save(path, bits=4),
        "gray": lambda: gray.save(path),
        "gray_alpha": lambda: Image.fromarray(np.dstack([rgb[..., 0], rgb[..., 1]]), "LA").save(path),
        "1bit": lambda: Image.fromarray(rgb[..., 0] > 128).save(path),
        "RGB_tRNS": lambda: Image.fromarray(rgb).save(path, transparency=(1, 2, 3)),
        "gray_tRNS": lambda: gray.save(path, transparency=7),
        "palette_tRNS": lambda: Image.fromarray(rgb).convert("P").save(path, transparency=3),
        "encode_png": lambda: open(path, "wb").write(encode_png(rgb)),
        "RGB16": lambda: open(path, "wb").write(_png_rgb16(rng.randint(0, 65536, (h, w, 3)))),
        "adam7": lambda: open(path, "wb").write(_png_adam7(rgb)),
        "gray16": lambda: Image.fromarray(rng.randint(0, 65536, (h, w)).astype(np.uint16)).save(path),
    }
    writers[case]()


PNG_CASES = ["RGB", "RGBA", "palette", "palette_17", "palette_4bit", "gray", "gray_alpha", "1bit",
             "RGB_tRNS", "gray_tRNS", "palette_tRNS", "encode_png", "RGB16", "adam7", "gray16"]


@pytest.mark.parametrize("case", PNG_CASES)
def test_png_matches_libpng_and_pil(case, tmp_path):
    path = str(tmp_path / f"{case}.png")
    _write_png_case(case, path)
    ours, native = _both(path, 37, 53)
    np.testing.assert_array_equal(ours, native)
    pil = np.asarray(Image.open(path).convert("RGB"))
    if case == "gray16":
        # PIL clips I;16 samples to 255; libpng keeps the high byte.
        assert not np.array_equal(ours, pil)
        return
    np.testing.assert_array_equal(ours, pil)


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("quality,extra", [(75, {}), (90, {}), (95, {"optimize": True}),
                                           (100, {}), (85, {"restart_marker_blocks": 7})],
                         ids=["q75", "q90", "q95opt", "q100", "q85rst"])
def test_jpeg_matches_libjpeg_and_pil(subsampling, quality, extra, tmp_path):
    for h, w in ((480, 640), (37, 53), (9, 17)):
        path = str(tmp_path / f"f{h}.jpg")
        Image.fromarray(_scene(h, w)).save(path, quality=quality, subsampling=subsampling, **extra)
        ours, native = _both(path, h, w)
        np.testing.assert_array_equal(ours, native, err_msg=f"{h}x{w}")
        np.testing.assert_array_equal(ours, np.asarray(Image.open(path).convert("RGB")),
                                      err_msg=f"{h}x{w}")


def test_gray_and_progressive_jpeg(tmp_path):
    gray = str(tmp_path / "gray.jpg")
    Image.fromarray(_scene(45, 61)[..., 1]).save(gray, quality=90)
    ours, native = _both(gray, 45, 61)
    np.testing.assert_array_equal(ours, native)
    np.testing.assert_array_equal(ours, np.asarray(Image.open(gray).convert("RGB")))
    progressive = str(tmp_path / "progressive.jpg")
    Image.fromarray(_scene(45, 61)).save(progressive, quality=90, progressive=True)
    with pytest.raises(IOError, match="failed on 1/1 frames"):
        native_loader.decode_batch([progressive], 45, 61)
    with pytest.raises(ValueError, match="JPEG"):
        decode_image(open(progressive, "rb").read(), progressive)


@pytest.mark.parametrize("kind", ["png", "jpg"])
def test_resize_path_matches_native(kind, tmp_path):
    rng = np.random.RandomState(3)
    path = str(tmp_path / f"frame.{kind}")
    for trial in range(12):
        h, w = rng.randint(2, 90, 2)
        Image.fromarray(_scene(h, w, trial)).save(path, **({"quality": 90} if kind == "jpg" else {}))
        H, W = rng.randint(1, 120, 2)
        ours, native = _both(path, H, W, n_threads=2)
        np.testing.assert_array_equal(ours, native, err_msg=f"{h}x{w} -> {H}x{W}")


def test_bytes_threads_probe_and_failures(tmp_path):
    paths = []
    for i in range(12):
        paths.append(str(tmp_path / f"{i}.{'jpg' if i % 2 else 'png'}"))
        Image.fromarray(_scene(48, 64, i)).save(paths[-1])
    one = native_loader.decode_batch(paths, 48, 64, n_threads=1)
    np.testing.assert_array_equal(one, native_loader.decode_batch(paths, 48, 64, n_threads=8))
    for path, frame in zip(paths, one):
        data = open(path, "rb").read()
        np.testing.assert_array_equal(native_loader.decode_bytes(data), frame)
        np.testing.assert_array_equal(decode_image(data, path), frame)
        np.testing.assert_array_equal(native_loader.decode_bytes(data, 30, 40),
                                      native_loader.decode_batch([path], 30, 40)[0])
    assert native_loader.probe(paths[1]) == jax_loader.probe(paths[1]) == (64, 48)

    corrupt = str(tmp_path / "corrupt.jpg")
    with open(corrupt, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0" + bytes(64))
    missing = str(tmp_path / "missing.png")
    batch = paths[:3] + [corrupt, missing]
    for loader in (native_loader, jax_loader):
        with pytest.raises(IOError, match="failed on 2/5 frames"):
            loader.decode_batch(batch, 48, 64)
    assert native_loader.probe(corrupt) is None


def test_decode_image_dispatch():
    frame = _scene(8, 8)
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=95)
    assert image_format(buf.getvalue()) == "JPEG" and image_format(encode_png(frame)) == "PNG"
    np.testing.assert_array_equal(decode_image(encode_png(frame)), frame)
    np.testing.assert_array_equal(decode_image(encode_png(frame)), decode_png(encode_png(frame)))
    for body, name in ((b"GIF89a" + bytes(10), "GIF"), (b"BM" + bytes(10), "BMP"),
                       (b"RIFF\x00\x00\x00\x00WEBPVP8 ", "WebP"), (b"hello", "unknown")):
        with pytest.raises(ValueError, match=f"body: not a PNG or JPEG file \\({name} format\\)"):
            decode_image(body, "body")
    with pytest.raises(ValueError, match="a JPEG, which decode_png does not read"):
        decode_png(buf.getvalue(), "body")
    with pytest.raises(ValueError, match="body \\(PNG\\): the image"):
        decode_image(encode_png(frame)[:-30], "body")


def test_dataset_on_jpeg_copy_matches_dream_tpu(tmp_path):
    path = str(tmp_path / "panda_jpg")
    jax_generate_synthetic_ndds(path, n_frames=6, image_resolution=(160, 120), seed=21)
    for f in sorted(os.listdir(path)):
        if f.endswith(".png"):
            src = os.path.join(path, f)
            Image.open(src).save(src[:-4] + ".jpg", quality=90)
            os.remove(src)
    args = ("panda", NAMES, (64, 64), (16, 16), {"mean": [0.5] * 3, "stdev": [0.5] * 3},
            "shrink-and-crop")
    ours = data.ManipulatorNDDSDataset(path, *args, n_decode_threads=2)
    ref = jax_data.ManipulatorNDDSDataset(path, *args, n_decode_threads=2, use_native_loader=True)
    assert ref._use_native_loader
    indices = [4, 0, 5, 2]
    got, want = ours.host_batch(indices), ref.host_batch(indices)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(ours._decode(3), np.asarray(Image.open(
        ours.ndds_dataset_data[3]["image_paths"]["rgb"]).convert("RGB")))
    plain = data.ManipulatorNDDSDataset(path, *args, n_decode_threads=2, use_native_loader=False)
    with pytest.raises(ValueError, match="a JPEG, which decode_png does not read"):
        plain.load_images([0])


def test_concurrent_builds_and_a_failed_build(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    errors = []

    def build():
        try:
            cuda_build.build(native_loader.LIBRARY)
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    assert [p.name for p in (tmp_path / "build").iterdir()] == [cuda_build.library_path("image_loader").name]

    monkeypatch.setattr(cuda_build, "HOST_LIBS", {"image_loader": ("-lz", "-ldream_no_such_library")})
    monkeypatch.setattr(native_loader, "_lib", None)
    with pytest.raises(RuntimeError, match="dream_no_such_library"):
        native_loader.load()
    assert not native_loader.native_available()
    with pytest.raises(RuntimeError, match="image_loader.cpp"):
        data.ManipulatorNDDSDataset(str(tmp_path), "panda", NAMES, (64, 64), (16, 16))
