"""A frozen reader of flax's msgpack checkpoints, and the flax -> torch layout.

flax writes a parameter tree as nested msgpack maps whose array leaves are
extension type 1 holding ``(shape, dtype name, raw bytes)``.  Conv kernels are
HWIO there; the reference convolves OIHW weights, and a transposed conv
(a module named ``deconv``) takes ``[in, out, kh, kw]`` with its taps flipped.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
            0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        (value,) = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += struct.calcsize(fmt)
        return value

    def value(self) -> Any:
        b = self.data[self.pos]
        self.pos += 1
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _LENGTHS:
            n = self.unpack(_LENGTHS[b])
            if b in (0xC4, 0xC5, 0xC6):
                return self.take(n)
            if b in (0xD9, 0xDA, 0xDB):
                return self.take(n).decode("utf-8")
            if b in (0xDC, 0xDD):
                return [self.value() for _ in range(n)]
            return self.map(n)
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> np.ndarray:
        code = self.unpack(">b")
        start = self.pos
        self.take(n)
        if code != 1:
            raise ValueError(f"unsupported msgpack extension type {code}")
        inner = _Reader(self.data, start)
        shape, dtype_name, payload = inner.value()
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode()
        arr = np.frombuffer(payload, dtype=np.dtype(dtype_name))
        return arr.reshape(tuple(shape))


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The flax variables tree stored at ``path``."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return tree


def torch_layout(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` -> flat float32 tensors named
    ``a.b.weight`` / ``.bias`` / ``.running_mean`` / ``.running_var``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Dict[str, Any], prefix: str, stats: bool) -> None:
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf, f"{prefix}{name}.", stats)
                continue
            t = torch.from_numpy(np.asarray(leaf, dtype=np.float32).copy())
            if stats:
                out[prefix + {"mean": "running_mean", "var": "running_var"}[name]] = t
            elif name == "kernel":
                deconv = prefix.rstrip(".").rsplit(".", 1)[-1].endswith("deconv")
                out[prefix + "weight"] = (t.flip(0, 1).permute(2, 3, 0, 1) if deconv
                                          else t.permute(3, 2, 0, 1)).contiguous()
            else:
                out[prefix + ("weight" if name == "scale" else name)] = t

    walk(tree["params"], "", False)
    if "batch_stats" in tree:
        walk(tree["batch_stats"], "", True)
    return out
