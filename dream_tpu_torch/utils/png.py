"""Frame decoding: JPEG and PNG through the host loader, and 8-bit PNG
reading and writing on the standard library's ``zlib`` and numpy.

:func:`decode_image` is the port's decoder of a frame's bytes: it reads the
magic bytes, as ``native/dream_loader.cpp`` ``DecodeFile`` does, and sends
JPEG and PNG to the host loader (:mod:`dream_tpu_torch.data.native_loader`,
its own decoders equal to libjpeg's and libpng's), which decodes them as
``dream_tpu``'s native loader and PIL's ``convert("RGB")`` do: every JPEG
frame type libjpeg reads (baseline, sequential and progressive, Huffman or
arithmetic); a JPEG that loader refuses (lossless, 12-bit, CMYK) and any
other format raise ``ValueError`` naming the source.  :func:`read_image`
reads a file and calls it.

:func:`decode_png` is the plain route, numpy and ``zlib`` alone, which the
``torch.export`` artifacts' callers and the PNG-only paths keep: it
decodes the files PIL writes for 8-bit images (``dream_tpu/data/
synthetic.py:360`` writes every synthetic frame through PIL): colour types
gray, gray+alpha, RGB and RGBA, returned as RGB as ``convert("RGB")``
returns them (gray replicated, alpha dropped), with all five row filters
undone.  PIL's encoder picks a filter per row, so a frame mixes them;
None, Sub and Up are undone across a whole row at once (Sub as a
cumulative sum mod 256 per channel), Average and Paeth depend on the pixel
to their left and run along the row in Python, which is affordable because
encoders choose them for few rows.  Palette images, other bit depths,
interlaced files and JPEGs raise ``ValueError`` naming the file.
:func:`read_png` reads a file and calls it.  :func:`encode_png` encodes
RGB with the Up filter on every row at zlib level 6 (the HTTP server's
debug streams), and :func:`write_png` writes those bytes to a file.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_MAGIC = b"\xff\xd8"
# Formats named in the error of a frame that is neither JPEG nor PNG.
_OTHER_FORMATS = ((b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"BM", "BMP"), (b"II*\x00", "TIFF"),
                  (b"MM\x00*", "TIFF"))
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel


def _unfilter_serial(kind: int, filt: bytes, prev: bytes, bpp: int) -> bytearray:
    """Average (3) or Paeth (4) row, undone left to right."""
    out = bytearray(filt)
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        b = prev[x]
        if kind == 3:
            out[x] = (out[x] + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[x] = (out[x] + pred) & 0xFF
    return out


def _unfilter(raw: bytes, height: int, width: int, bpp: int, path: str) -> np.ndarray:
    stride = width * bpp
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{path}: image data holds {len(raw)} bytes, expected {height * (stride + 1)}")
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(height, stride + 1)
    kinds = rows[:, 0]
    if int(kinds.max(initial=0)) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {int(kinds.max())}")
    out = np.empty((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    # Row by row: a numpy call a row (Up) beats a cumulative sum down the
    # rows, which walks memory across them.
    for y in range(height):
        kind = int(kinds[y])
        filt = rows[y, 1:]
        if kind == 0:
            out[y] = filt
        elif kind == 1:
            cum = np.cumsum(filt.reshape(width, bpp), axis=0, dtype=np.uint32)
            out[y] = (cum & 0xFF).astype(np.uint8).reshape(stride)
        elif kind == 2:
            np.add(filt, prev, out=out[y])  # uint8 wraps mod 256
        else:
            out[y] = np.frombuffer(
                _unfilter_serial(kind, filt.tobytes(), prev.tobytes(), bpp), dtype=np.uint8)
        prev = out[y]
    return out


def image_format(data: bytes) -> str:
    """The format the magic bytes of ``data`` name: ``"JPEG"``, ``"PNG"``,
    another format's name, or ``"unknown"``."""
    if data.startswith(_JPEG_MAGIC):
        return "JPEG"
    if data.startswith(_SIGNATURE):
        return "PNG"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    return next((name for magic, name in _OTHER_FORMATS if data.startswith(magic)), "unknown")


def decode_image(data: bytes, path: str = "image data") -> np.ndarray:
    """Decode the bytes of a JPEG or PNG frame to uint8 RGB ``[H, W, 3]``
    through the host loader; ``path`` names the source in errors (a file,
    a request body).  Any other format raises ``ValueError`` naming it."""
    kind = image_format(data)
    if kind not in ("JPEG", "PNG"):
        raise ValueError(f"{path}: not a PNG or JPEG file ({kind} format); frames are read as "
                         "PNG or JPEG")
    from dream_tpu_torch.data.native_loader import decode_bytes

    return decode_bytes(data, source=f"{path} ({kind})")


def read_image(path: str) -> np.ndarray:
    """Decode a JPEG or PNG file to uint8 RGB ``[H, W, 3]`` (:func:`decode_image`)."""
    with open(path, "rb") as f:
        return decode_image(f.read(), path)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit PNG file to uint8 RGB ``[H, W, 3]``."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "PNG data") -> np.ndarray:
    """Decode the bytes of an 8-bit PNG to uint8 RGB ``[H, W, 3]``; ``path``
    names the source in errors (a file, a request body)."""
    if not data.startswith(_SIGNATURE):
        if data.startswith(b"\xff\xd8"):
            raise ValueError(f"{path}: a JPEG, which decode_png does not read (decode_image does)")
        raise ValueError(f"{path}: not a PNG file")
    pos = len(_SIGNATURE)
    header = None
    idat = []
    while pos + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: CRC mismatch in the {kind.decode('latin-1')} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type {colour}, interlace "
            f"{interlace}); the port reads 8-bit gray, gray+alpha, RGB and RGBA, not interlaced"
        )
    bpp = _CHANNELS[colour]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width, bpp, path)
    pixels = pixels.reshape(height, width, bpp)
    if bpp <= 2:
        return np.repeat(pixels[..., :1], 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(image: np.ndarray) -> bytes:
    """The PNG bytes of a uint8 RGB ``[H, W, 3]`` image: every row
    Up-filtered, zlib level 6."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"encode_png takes uint8 [H, W, 3], got {image.dtype} {image.shape}")
    height, width, _ = image.shape
    rows = image.reshape(height, width * 3)
    filtered = np.empty((height, width * 3 + 1), dtype=np.uint8)
    filtered[:, 0] = 2
    filtered[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=filtered[1:, 1:])  # uint8 wraps mod 256
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    """Write :func:`encode_png`'s bytes of ``image`` to ``path``."""
    data = encode_png(image)
    with open(path, "wb") as f:
        f.write(data)
