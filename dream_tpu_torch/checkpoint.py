"""Read flax msgpack checkpoints and carry their weights into torch modules.

The JAX package saves parameters with ``flax.serialization.to_bytes``: a
msgpack map of string keys whose array leaves are msgpack extension type 1,
holding a nested msgpack array ``(shape, dtype name, raw C-order bytes)``
(``flax.serialization._ndarray_to_bytes``).  The port runs where neither
flax nor the ``msgpack`` package is installed, so :func:`msgpack_restore`
decodes the subset of msgpack that flax writes by hand.  Array payloads are
sliced out of the file with ``np.frombuffer`` and never walked byte by byte,
so a 44 MB checkpoint decodes in milliseconds.

:func:`params_from_flax` then maps the flax tree onto a torch state dict:
``a/b/kernel`` (HWIO) becomes ``a.b.weight`` (OIHW), ``bias`` stays
``bias``, and float16 storage is widened to float32, as
``DreamNetwork.load_network_params`` widens it on the JAX side.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

_EXT_NDARRAY = 1


class _Reader:
    """Recursive msgpack decoder over one ``bytes`` buffer."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        (value,) = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += size
        return value

    def value(self) -> Any:
        b = self.data[self.pos]
        self.pos += 1
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self._unpack(fixed[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",  # bin
                   0xD9: ">B", 0xDA: ">H", 0xDB: ">I",  # str
                   0xDC: ">H", 0xDD: ">I",  # array
                   0xDE: ">H", 0xDF: ">I"}  # map
        if b in lengths:
            n = self._unpack(lengths[b])
            if b in (0xC4, 0xC5, 0xC6):
                return self._take(n)
            if b in (0xD9, 0xDA, 0xDB):
                return self._take(n).decode("utf-8")
            if b in (0xDC, 0xDD):
                return self._array(n)
            return self._map(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        if b in (0xC7, 0xC8, 0xC9):
            n = self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self._ext(n)
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def _ext(self, n: int) -> Any:
        code = self._unpack(">b")
        start = self.pos
        self._take(n)
        if code == _EXT_NDARRAY:
            return _ndarray_from(self.data, start, n)
        raise ValueError(f"unsupported msgpack extension type {code}")


def _ndarray_from(data: bytes, start: int, n: int) -> np.ndarray:
    """Decode flax's ``(shape, dtype name, bytes)`` payload without copying."""
    inner = _Reader(data)
    inner.pos = start
    b = data[inner.pos]
    if not 0x90 <= b <= 0x9F or (b & 0x0F) != 3:
        raise ValueError("malformed flax ndarray payload")
    inner.pos += 1
    shape = tuple(inner.value())
    dtype_name = inner.value()
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 leaves are not supported by this reader")
    # The raw bytes: a msgpack bin (or str) header, then the payload.
    hdr = data[inner.pos]
    inner.pos += 1
    if hdr in (0xC4, 0xD9):
        size = inner._unpack(">B")
    elif hdr in (0xC5, 0xDA):
        size = inner._unpack(">H")
    elif hdr in (0xC6, 0xDB):
        size = inner._unpack(">I")
    elif 0xA0 <= hdr <= 0xBF:
        size = hdr & 0x1F
    else:
        raise ValueError("malformed flax ndarray payload")
    if inner.pos + size != start + n:
        raise ValueError("flax ndarray payload length mismatch")
    dtype = np.dtype(dtype_name)
    arr = np.frombuffer(data, dtype=dtype, count=size // dtype.itemsize, offset=inner.pos)
    return arr.reshape(shape, order="C")


def msgpack_restore(data: bytes) -> Any:
    """Decode flax msgpack bytes into nested dicts of numpy arrays.

    The counterpart of ``flax.serialization.msgpack_restore`` for parameter
    trees: array leaves are read-only views into ``data``.  Numpy scalar and
    complex leaves (flax extension types 2 and 3) and arrays over 1 GiB
    (which flax splits into chunks) do not occur in parameter checkpoints
    and are refused.
    """
    reader = _Reader(bytes(data))
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return tree


def load_flax_checkpoint(path: str) -> Any:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a flax parameter tree onto a torch ``state_dict``.

    Accepts the whole variables tree (``{"params": {...}}``) or the params
    subtree.  Conv ``kernel`` leaves go from HWIO to OIHW as ``weight``;
    ``bias`` leaves keep their name.  Every leaf becomes a contiguous
    float32 CPU tensor.
    """
    params = tree["params"] if "params" in tree else tree
    state: Dict[str, torch.Tensor] = {}

    def walk(node: Dict[str, Any], prefix: str):
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf, f"{prefix}{name}.")
                continue
            arr = np.asarray(leaf).astype(np.float32)
            if name == "kernel" and arr.ndim == 4:
                state[prefix + "weight"] = torch.from_numpy(
                    np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
                )
            elif name == "bias" and arr.ndim == 1:
                state[prefix + "bias"] = torch.from_numpy(np.ascontiguousarray(arr))
            else:
                raise ValueError(
                    f"flax leaf {prefix}{name} {arr.shape} has no torch "
                    "counterpart in this port"
                )

    walk(params, "")
    return state
