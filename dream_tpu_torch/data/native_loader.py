"""ctypes binding of the port's host image loader (``csrc/image_loader.cpp``).

The counterpart of ``dream_tpu/data/native_loader.py``: JPEG and PNG
frames decoded to uint8 RGB by a pool of C++ threads, without the GIL.
The decoders are the port's own, bit-equal to libjpeg's and libpng's
(the card's machine has neither library); PNG inflates through zlib.  The
library is built with the host's C++ compiler at first use
(:mod:`dream_tpu_torch.ops.cuda_build`) and loaded once a process.  There
is no fallback: a library that does not build raises with the compiler's
output, and :func:`native_available` says whether it built.

- :func:`decode_batch`: files into ``[n, H, W, 3]``; a frame of another
  size is resized by the loader's bilinear filter (``dream_tpu``'s native
  ``ResizeBilinear``); a frame that fails to decode raises ``IOError``
  with the failure count, as in ``dream_tpu``.
- :func:`probe`: a file's ``(width, height)``, None if it does not decode.
- :func:`decode_bytes`: an image in memory (an HTTP body), decoded by the
  same code as a file.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from dream_tpu_torch.ops import cuda_build

LIBRARY = "image_loader"

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """Build (once) and load the loader; raises RuntimeError with the
    compiler's output, naming what the build lacked."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(cuda_build.build(LIBRARY)))
            u8p, intp = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
            lib.dl_decode_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, u8p,
                                            ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.dl_decode_batch.restype = ctypes.c_int
            lib.dl_decode_probe.argtypes = [ctypes.c_char_p, intp, intp]
            lib.dl_decode_probe.restype = ctypes.c_int
            lib.dl_decode_memory.argtypes = [ctypes.c_char_p, ctypes.c_size_t, u8p, ctypes.c_int,
                                             ctypes.c_int]
            lib.dl_decode_memory.restype = ctypes.c_int
            lib.dl_probe_memory.argtypes = [ctypes.c_char_p, ctypes.c_size_t, intp, intp]
            lib.dl_probe_memory.restype = ctypes.c_int
            _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the loader builds and loads here."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _u8_pointer(array: np.ndarray):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def probe(path: str) -> Optional[Tuple[int, int]]:
    """``(width, height)`` of an image file, or None if it does not decode."""
    w, h = ctypes.c_int(), ctypes.c_int()
    if load().dl_decode_probe(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def decode_batch(paths: Sequence[str], height: int, width: int, n_threads: int = 8) -> np.ndarray:
    """Decode image files into a ``[n, height, width, 3]`` uint8 array with
    ``n_threads`` threads; frames of another size are resized."""
    lib = load()
    n = len(paths)
    out = np.empty((n, height, width, 3), dtype=np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    failures = lib.dl_decode_batch(c_paths, n, _u8_pointer(out), height, width, n_threads)
    if failures:
        raise IOError(f"native decoder failed on {failures}/{n} frames")
    return out


def decode_bytes(data: bytes, height: Optional[int] = None, width: Optional[int] = None,
                 source: str = "image data") -> np.ndarray:
    """Decode a JPEG or PNG in memory to uint8 RGB ``[H, W, 3]``: at its own
    size, or resized to ``height`` x ``width``.  ``source`` names the data
    in the error a failed decode raises (``ValueError``)."""
    lib = load()
    data = bytes(data)
    if height is None or width is None:
        w, h = ctypes.c_int(), ctypes.c_int()
        if lib.dl_probe_memory(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
            raise ValueError(f"{source}: the image header does not decode")
        height, width = h.value, w.value
    out = np.empty((height, width, 3), dtype=np.uint8)
    if lib.dl_decode_memory(data, len(data), _u8_pointer(out), height, width) != 0:
        raise ValueError(f"{source}: the image does not decode")
    return out
