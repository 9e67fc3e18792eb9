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
  grayscale, baseline and progressive, bit for bit as libjpeg-turbo 2.1.5
  (the native loader) and PIL decode them.  A progressive file cut after
  each of its scans, or inside one, decodes as libjpeg decodes it, block
  smoothing included; arithmetic-coded files, sequential and progressive
  (written by libjpeg through a small C encoder compiled here), with and
  without restarts and DAC conditioning, likewise.  CMYK, lossless (SOF3
  and SOF11) and 12-bit files fail in both loaders; DNL is skipped, and a
  sequential file without Huffman tables takes the standard ones, as in
  libjpeg.
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
import subprocess
import threading
import zlib

import numpy as np
import pytest
from PIL import Image, ImageFile

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
    for name, image in (("progressive", _scene(45, 61)), ("progressive_gray", _scene(45, 61)[..., 1])):
        path = str(tmp_path / f"{name}.jpg")
        Image.fromarray(image).save(path, quality=90, progressive=True)
        ours, native = _both(path, 45, 61)
        np.testing.assert_array_equal(ours, native, err_msg=name)
        np.testing.assert_array_equal(ours, np.asarray(Image.open(path).convert("RGB")), err_msg=name)
        with open(path, "rb") as f:
            np.testing.assert_array_equal(decode_image(f.read(), path), ours, err_msg=name)


def _scan_offsets(data):
    """The offsets of a JPEG's SOS markers (PIL's marker segments carry no
    0xFFDA pair, and entropy-coded data never does)."""
    return [i for i in range(2, len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("quality,extra", [(75, {}), (90, {}), (100, {}), (90, {"optimize": True}),
                                           (85, {"restart_marker_blocks": 3}),
                                           (85, {"restart_marker_rows": 1})],
                         ids=["q75", "q90", "q100", "q90opt", "q85rstblocks", "q85rstrows"])
def test_progressive_jpeg_matches_libjpeg_and_pil(subsampling, quality, extra, tmp_path, monkeypatch):
    # PIL holds a whole progressive file in its output buffer.
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 8 << 20)
    for h, w in ((480, 640), (45, 61), (17, 9), (1, 1)):
        path = str(tmp_path / f"f{h}.jpg")
        Image.fromarray(_scene(h, w)).save(path, quality=quality, subsampling=subsampling, progressive=True,
                                           **extra)
        with open(path, "rb") as f:
            assert b"\xff\xc2" in f.read()
        ours, native = _both(path, h, w)
        np.testing.assert_array_equal(ours, native, err_msg=f"{h}x{w}")
        np.testing.assert_array_equal(ours, np.asarray(Image.open(path).convert("RGB")), err_msg=f"{h}x{w}")


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_progressive_jpeg_cut_short(subsampling, tmp_path):
    """PIL's progressive file (libjpeg's standard 10-scan script) cut after
    each of its first 9 scans, EOI appended: coefficients miss their last
    bits, so libjpeg smooths the blocks (jdcoefct.c), and the port with it.
    Cut inside a scan, the rest of it stays as the earlier scans left it.

    PIL bundles libjpeg-turbo 3.x, whose smoothing takes the 5x5 window's
    rows clamped to a component's block rows; 2.1.5, the native loader's,
    decides by iMCU row and repeats a nearer row at the first two and last
    two iMCU rows of a component sampled 2 vertically (luma in 4:2:0).
    There the two references part, and the port follows ``dream_tpu``'s
    native route."""
    path = str(tmp_path / "full.jpg")
    Image.fromarray(_scene(48, 64)).save(path, quality=90, subsampling=subsampling, progressive=True)
    with open(path, "rb") as f:
        data = f.read()
    sos = _scan_offsets(data)
    assert len(sos) == 10
    cut = str(tmp_path / "cut.jpg")
    pil_parts = []
    for k in range(1, 10):
        with open(cut, "wb") as f:
            f.write(data[:sos[k]] + b"\xff\xd9")
        ours, native = _both(cut, 48, 64)
        np.testing.assert_array_equal(ours, native, err_msg=f"after {k} scans")
        pil = np.asarray(Image.open(cut).convert("RGB"))
        if subsampling != 2:
            np.testing.assert_array_equal(ours, pil, err_msg=f"after {k} scans")
        else:
            pil_parts.append(int(np.abs(ours.astype(int) - pil).max()))
    if subsampling == 2:
        assert 0 < pil_parts[0] <= 8 and max(pil_parts) <= 8, pil_parts
    # With restart markers, a cut leaves the next restart's marker missing:
    # the rest of the scan is skipped, not decoded from zero bits.
    restarts = str(tmp_path / "restarts.jpg")
    Image.fromarray(_scene(48, 64)).save(restarts, quality=90, subsampling=subsampling, progressive=True,
                                         restart_marker_blocks=3)
    with open(restarts, "rb") as f:
        restart_data = f.read()
    for label, source in (("", data), ("restarts, ", restart_data)):
        for fraction in (0.45, 0.8):  # inside the 4th and the 9th scans
            body = source[:int(len(source) * fraction)]
            for name, cut_data in (("no EOI", body), ("EOI", body + b"\xff\xd9")):
                with open(cut, "wb") as f:
                    f.write(cut_data)
                ours, native = _both(cut, 48, 64)
                np.testing.assert_array_equal(ours, native, err_msg=f"{label}cut at {fraction}, {name}")
                if name == "no EOI":
                    with pytest.raises(OSError, match="truncated"):  # PIL refuses a file without EOI
                        Image.open(cut).convert("RGB")
                elif subsampling != 2:
                    np.testing.assert_array_equal(ours, np.asarray(Image.open(cut).convert("RGB")),
                                                  err_msg=f"{label}cut at {fraction}")


# Writes a raw image as JPEG through libjpeg with the settings PIL does not
# expose: arithmetic coding (with DAC conditioning values), progression,
# restart rows, the luma sampling factors.
_JPEG_ENCODER_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>
int main(int argc, char** argv) {
  if (argc != 15) return 2;
  int w = atoi(argv[2]), h = atoi(argv[3]), nc = atoi(argv[4]);
  size_t n = (size_t)w * h * nc;
  unsigned char* px = malloc(n);
  FILE* in = fopen(argv[1], "rb");
  if (!in || fread(px, 1, n, in) != n) return 3;
  fclose(in);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE* out = fopen(argv[5], "wb");
  jpeg_stdio_dest(&c, out);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 3 ? JCS_RGB : JCS_GRAYSCALE;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, atoi(argv[6]), TRUE);
  c.arith_code = atoi(argv[7]) ? TRUE : FALSE;
  if (atoi(argv[8])) jpeg_simple_progression(&c);
  c.restart_in_rows = atoi(argv[9]);
  if (nc == 3) {
    c.comp_info[0].h_samp_factor = atoi(argv[10]);
    c.comp_info[0].v_samp_factor = atoi(argv[11]);
  }
  for (int i = 0; i < NUM_ARITH_TBLS; i++) {
    c.arith_dc_L[i] = atoi(argv[12]);
    c.arith_dc_U[i] = atoi(argv[13]);
    c.arith_ac_K[i] = atoi(argv[14]);
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px + (size_t)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(out);
  return 0;
}
"""


@pytest.fixture(scope="module")
def jpeg_encoder(tmp_path_factory):
    """The C encoder above, built against the libjpeg ``dream_tpu``'s native
    loader links (its build is asserted above); a failed build fails."""
    build = tmp_path_factory.mktemp("jpeg_encoder")
    (build / "encode.c").write_text(_JPEG_ENCODER_C)
    made = subprocess.run(["gcc", "-O2", str(build / "encode.c"), "-o", str(build / "encode"), "-ljpeg"],
                          capture_output=True, text=True)
    assert made.returncode == 0, made.stderr
    return str(build / "encode")


def _libjpeg_encode(encoder, image, path, quality=90, arithmetic=True, progressive=False, restart_rows=0,
                    luma=(2, 2), dac=(0, 1, 5)):
    raw = path + ".raw"
    image.tofile(raw)
    subprocess.run([encoder, raw, str(image.shape[1]), str(image.shape[0]), str(1 if image.ndim == 2 else 3),
                    path, str(quality), str(int(arithmetic)), str(int(progressive)), str(restart_rows),
                    str(luma[0]), str(luma[1]), *map(str, dac)], check=True)


ARITHMETIC_CASES = {
    "444": {"luma": (1, 1)},
    "420": {},
    "gray": {"gray": True},
    "restart_rows": {"restart_rows": 1},
    # DC conditioning L=2, U=5 and AC K=12 (the defaults are 0, 1 and 5).
    "dac": {"restart_rows": 2, "dac": (2, 5, 12)},
}


@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
@pytest.mark.parametrize("case", list(ARITHMETIC_CASES))
def test_arithmetic_jpeg_matches_libjpeg_and_pil(case, progressive, jpeg_encoder, tmp_path):
    options = dict(ARITHMETIC_CASES[case])
    gray = options.pop("gray", False)
    for h, w in ((480, 640), (45, 61), (9, 17)):
        image = _scene(h, w)[..., 1].copy() if gray else _scene(h, w)
        path = str(tmp_path / f"f{h}.jpg")
        _libjpeg_encode(jpeg_encoder, image, path, progressive=progressive, **options)
        with open(path, "rb") as f:
            data = f.read()
        assert (b"\xff\xca" if progressive else b"\xff\xc9") in data
        dac = data[data.index(b"\xff\xcc"):][:6]  # the first DAC: DC table 0
        assert dac[4:6] == bytes([0, 0x52 if case == "dac" else 0x10]), dac
        ours, native = _both(path, h, w)
        np.testing.assert_array_equal(ours, native, err_msg=f"{h}x{w}")
        if len(data) > ImageFile.MAXBLOCK:
            # PIL feeds libjpeg MAXBLOCK bytes at a time, and libjpeg's
            # arithmetic decoder cannot wait for more (JERR_CANT_SUSPEND):
            # PIL, dream_tpu's server route, fails a larger file.
            with pytest.raises(OSError, match="broken data stream"):
                Image.open(path).convert("RGB")
            continue
        np.testing.assert_array_equal(ours, np.asarray(Image.open(path).convert("RGB")), err_msg=f"{h}x{w}")
        if h == 45:
            # Cut in the middle of the last scan's data: the QM decoder
            # reads zero bytes past the data and decodes on, and libjpeg's
            # SIMD IDCT saturates the coefficients that makes.
            last = _scan_offsets(data)[-1]
            start = last + 2 + (data[last + 2] << 8 | data[last + 3])
            cut = str(tmp_path / "cut.jpg")
            with open(cut, "wb") as f:
                f.write(data[:(start + len(data)) // 2] + b"\xff\xd9")
            ours, native = _both(cut, h, w)
            np.testing.assert_array_equal(ours, native, err_msg="cut")


def _patched_baseline(tmp_path, case):
    path = str(tmp_path / f"{case}.jpg")
    if case == "CMYK":
        Image.fromarray(_scene(45, 61)).convert("CMYK").save(path, quality=90)
        return path
    Image.fromarray(_scene(45, 61)).save(path, quality=90)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    sof = data.index(b"\xff\xc0")
    if case == "12-bit":
        data[sof + 4] = 12  # the sample precision
    else:
        data[sof + 1] = {"SOF3": 0xC3, "SOF11": 0xCB}[case]
    with open(path, "wb") as f:
        f.write(bytes(data))
    return path


@pytest.mark.parametrize("case", ["CMYK", "SOF3", "SOF11", "12-bit"])
def test_jpeg_refused_as_the_native_loader_refuses(case, tmp_path):
    path = _patched_baseline(tmp_path, case)
    for loader in (native_loader, jax_loader):
        with pytest.raises(IOError, match="failed on 1/1 frames"):
            loader.decode_batch([path], 45, 61)
    with open(path, "rb") as f:
        with pytest.raises(ValueError, match="JPEG"):
            decode_image(f.read(), path)
    if case == "CMYK":  # PIL, dream_tpu's server route, reads it (ROADMAP.md: a departure)
        assert np.asarray(Image.open(path).convert("RGB")).shape == (45, 61, 3)


@pytest.mark.parametrize("case", ["DNL", "no_DHT", "JPG", "second_SOS"])
def test_jpeg_markers_as_libjpeg_reads_them(case, tmp_path):
    """A DNL segment is skipped; a sequential file without DHT takes the
    standard tables (PIL's unoptimized ones are those); the reserved JPG
    marker, and a second scan after one that held every component, fail."""
    path = str(tmp_path / "f.jpg")
    Image.fromarray(_scene(45, 61)).save(path, quality=90)
    with open(path, "rb") as f:
        data = f.read()
    sos, eoi, sof = data.index(b"\xff\xda"), len(data) - 2, data.index(b"\xff\xc0")
    if case == "DNL":
        data = data[:eoi] + b"\xff\xdc\x00\x04\x00\x2d" + data[eoi:]
    elif case == "no_DHT":
        while b"\xff\xc4" in data:
            i = data.index(b"\xff\xc4")
            data = data[:i] + data[i + 2 + (data[i + 2] << 8 | data[i + 3]):]
    elif case == "JPG":
        data = data[:sof] + b"\xff\xc8\x00\x04\x00\x00" + data[sof:]
    else:
        data = data[:eoi] + data[sos:eoi] + data[eoi:]
    with open(path, "wb") as f:
        f.write(data)
    if case in ("DNL", "no_DHT"):
        ours, native = _both(path, 45, 61)
        np.testing.assert_array_equal(ours, native)
        np.testing.assert_array_equal(ours, np.asarray(Image.open(path).convert("RGB")))
    else:
        for loader in (native_loader, jax_loader):
            with pytest.raises(IOError, match="failed on 1/1 frames"):
                loader.decode_batch([path], 45, 61)


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


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_dataset_on_jpeg_copy_matches_dream_tpu(progressive, tmp_path):
    path = str(tmp_path / "panda_jpg")
    jax_generate_synthetic_ndds(path, n_frames=6, image_resolution=(160, 120), seed=21)
    for f in sorted(os.listdir(path)):
        if f.endswith(".png"):
            src = os.path.join(path, f)
            Image.open(src).save(src[:-4] + ".jpg", quality=90, progressive=progressive)
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
