"""Read and write flax msgpack checkpoints, and map their weights to torch.

The JAX package saves parameters with ``flax.serialization.to_bytes``: a
msgpack map of string keys whose array leaves are msgpack extension type 1,
holding a nested msgpack array ``(shape, dtype name, raw C-order bytes)``
(``flax.serialization._ndarray_to_bytes``).  The port runs where neither
flax nor the ``msgpack`` package is installed, so :func:`msgpack_restore`
decodes the subset of msgpack that flax writes by hand.  Array payloads are
sliced out of the file with ``np.frombuffer`` and never walked byte by byte,
so a 44 MB checkpoint decodes in milliseconds.

:func:`params_from_flax` then maps the flax tree onto a torch state dict:
``a/b/kernel`` (HWIO) becomes ``a.b.weight`` (OIHW; a transposed conv's is
flipped into torch's ``[in, out, kh, kw]``), BatchNorm's ``scale`` becomes
``weight``, ``bias`` stays ``bias``, and float16 storage is widened to
float32, as ``DreamNetwork.load_network_params`` widens it on the JAX side.
:func:`batch_stats_from_flax` maps the ``batch_stats`` collection onto the
BatchNorm buffers, and :func:`state_from_flax` / :func:`state_to_flax` carry
a whole model (parameters and running statistics) across.

:func:`quant_from_flax` and :func:`quant_to_flax` carry the calibration
state across in the same way: the flax ``quant`` collection of any
quantized graph (the hourglasses', ``{block: {conv: {"act_amax":
scalar}}}``; the ResNet deploy graph's, ``{"layer2": {"block0": {"conv2":
...}}, "up0_deconv": ...}``) against the port's dict of amax by module path
(``{"down2.conv0": 0-d f32 tensor}``, ``{"layer2.block0.conv2": ...}``).

The write side is the inverse: :func:`params_to_flax` maps a state dict
back onto the flax tree, and :func:`msgpack_serialize` encodes it in the
bytes ``flax.serialization.to_bytes`` writes for a tree that has been
through jax's tree functions (map keys sorted, as in the committed
checkpoints), so ``dream_tpu``'s ``load_network_params`` reads a checkpoint
the port saved.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict, Optional, Sequence

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


def _is_transposed(path: str) -> bool:
    """Both packages name every transposed conv ``deconv`` (``_DeconvBlock``,
    ``_DeconvBNRelu``) or ``up<i>_deconv`` (the ResNet deploy graph's
    ``QuantConvTranspose``); no other conv's name ends so."""
    return path.rstrip(".").rsplit(".", 1)[-1].endswith("deconv")


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a flax parameter tree onto a torch ``state_dict``.

    Accepts the whole variables tree (``{"params": {...}}``) or the params
    subtree.  Conv ``kernel`` leaves go from HWIO to OIHW as ``weight``; a
    transposed conv's (module ``deconv``) becomes ``[in, out, kh, kw]`` with
    its taps flipped, ``K.flip(0, 1).permute(2, 3, 0, 1)``
    (``layers.TorchConvTranspose``); BatchNorm's ``scale`` becomes
    ``weight``; ``bias`` leaves keep their name, and so does the soft-argmax
    head's ``beta`` (``[n_kp]``, a stage's own in the multistage model).
    Every leaf becomes a contiguous float32 CPU tensor (float16 storage
    widens).
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
                # torch's strided copies are threaded; numpy's are not.
                t = torch.from_numpy(arr)
                t = t.flip(0, 1).permute(2, 3, 0, 1) if _is_transposed(prefix) else t.permute(3, 2, 0, 1)
                state[prefix + "weight"] = t.contiguous()
            elif name in ("bias", "scale", "beta") and arr.ndim == 1:
                leaf_name = "weight" if name == "scale" else name
                state[prefix + leaf_name] = torch.from_numpy(np.ascontiguousarray(arr))
            else:
                raise ValueError(
                    f"flax leaf {prefix}{name} {arr.shape} has no torch "
                    "counterpart in this port"
                )

    walk(params, "")
    return state


def _set(tree: Dict[str, Any], path: Sequence[str], leaf: str, arr: np.ndarray) -> None:
    node = tree
    for part in path:
        node = node.setdefault(part, {})
    node[leaf] = arr


def params_to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Map a torch ``state_dict`` of parameters onto the flax variables tree.

    The inverse of :func:`params_from_flax`: ``a.b.weight`` (OIHW) becomes
    ``a/b/kernel`` (HWIO; a transposed conv's ``[in, out, kh, kw]`` flipped
    back), a 1-D ``weight`` BatchNorm's ``scale``, ``bias`` and ``beta``
    keep their names, every leaf a C-order float32 numpy array that owns its memory (a
    snapshot, whatever device ``state`` is on); returns
    ``{"params": {...}}``.  Buffers belong to :func:`batch_stats_to_flax`.
    """
    params: Dict[str, Any] = {}
    for name, tensor in state.items():
        *path, leaf = name.split(".")
        t = tensor.detach().to("cpu", torch.float32)
        if leaf == "weight" and t.ndim == 4:
            # torch's strided copies are threaded; numpy's are not.
            if _is_transposed(name.rsplit(".", 1)[0]):
                t = t.permute(2, 3, 0, 1).flip(0, 1)
            else:
                t = t.permute(2, 3, 1, 0)
            _set(params, path, "kernel", t.clone(memory_format=torch.contiguous_format).numpy())
        elif leaf in ("weight", "bias", "beta") and t.ndim == 1:
            _set(params, path, "scale" if leaf == "weight" else leaf, t.numpy().copy())
        else:
            raise ValueError(f"torch leaf {name} {tuple(t.shape)} has no flax counterpart")
    return {"params": params}


# flax's batch_stats leaves and the BatchNorm buffers they become.
_BATCH_STATS = {"mean": "running_mean", "var": "running_var"}


def is_batch_stat(name: str) -> bool:
    """Whether a state-dict key is a BatchNorm running statistic."""
    return name.rsplit(".", 1)[-1] in _BATCH_STATS.values()


def batch_stats_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a flax ``batch_stats`` collection (or a variables tree holding
    one) onto the BatchNorm buffers: ``a/bn/mean`` and ``a/bn/var`` become
    ``a.bn.running_mean`` and ``a.bn.running_var``, float32 (float16
    storage widens)."""
    stats = tree["batch_stats"] if "batch_stats" in tree else tree
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Dict[str, Any], prefix: str):
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf, f"{prefix}{name}.")
            elif name in _BATCH_STATS and np.ndim(leaf) == 1:
                out[prefix + _BATCH_STATS[name]] = torch.from_numpy(
                    np.ascontiguousarray(np.asarray(leaf).astype(np.float32)))
            else:
                raise ValueError(f"flax batch_stats leaf {prefix}{name} has no torch counterpart")

    walk(stats, "")
    return out


def batch_stats_to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`batch_stats_from_flax` over the running
    statistics in ``state`` (other keys are ignored): the ``batch_stats``
    collection, float32."""
    names = {v: k for k, v in _BATCH_STATS.items()}
    stats: Dict[str, Any] = {}
    for name, tensor in state.items():
        if is_batch_stat(name):
            *path, leaf = name.split(".")
            _set(stats, path, names[leaf], tensor.detach().to("cpu", torch.float32).numpy().copy())
    return stats


def state_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A whole variables tree -> a model's ``state_dict``: the parameters
    and, where the tree has them, the BatchNorm running statistics."""
    state = params_from_flax(tree)
    if "batch_stats" in tree:
        state.update(batch_stats_from_flax(tree["batch_stats"]))
    return state


def state_to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A model's ``state_dict`` -> the variables tree ``dream_tpu`` saves:
    ``{"params"}``, plus ``{"batch_stats"}`` when the model has BatchNorm
    (``dream_tpu/network.py:1107-1114``)."""
    tree = params_to_flax({k: v for k, v in state.items() if not is_batch_stat(k)})
    if any(is_batch_stat(k) for k in state):
        tree["batch_stats"] = batch_stats_to_flax(state)
    return tree


def quant_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a flax ``quant`` collection (or a variables tree holding one)
    onto the port's ``{"block.conv": 0-d f32 tensor}`` amax dict."""
    quant = tree["quant"] if "quant" in tree else tree
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Dict[str, Any], prefix: str):
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf, f"{prefix}{name}.")
            elif name == "act_amax" and np.ndim(leaf) == 0:
                out[prefix[:-1]] = torch.tensor(np.float32(leaf))
            else:
                raise ValueError(f"flax quant leaf {prefix}{name} has no torch counterpart")

    walk(quant, "")
    return out


def quant_to_flax(qvars: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`quant_from_flax`: the ``quant`` collection with
    each amax a 0-d float32 numpy array."""
    quant: Dict[str, Any] = {}
    for name, amax in qvars.items():
        _set(quant, name.split("."), "act_amax", np.asarray(amax.detach().to("cpu", torch.float32).numpy()))
    return quant


def _pack_header(out: bytearray, n: int, fix_base: Optional[int], fix_max: int, codes) -> None:
    """Append a str/bin/array/map length header, or an unsigned int, in
    msgpack's shortest form."""
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
        return
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack(out: bytearray, value: Any) -> None:
    """Append ``value``: the types a flax parameter tree and its array
    payloads hold (str-keyed maps, lists, str, bytes, shapes' ints, arrays)."""
    if isinstance(value, dict):
        _pack_header(out, len(value), 0x80, 15, ((0xDE, ">H"), (0xDF, ">I")))
        for key in sorted(value):
            if not isinstance(key, str):
                raise ValueError(f"msgpack map keys must be str, got {key!r}")
            _pack(out, key)
            _pack(out, value[key])
    elif isinstance(value, (list, tuple)):
        _pack_header(out, len(value), 0x90, 15, ((0xDC, ">H"), (0xDD, ">I")))
        for item in value:
            _pack(out, item)
    elif isinstance(value, str):
        data = value.encode("utf-8")
        _pack_header(out, len(data), 0xA0, 31, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))
        out += data
    elif isinstance(value, bytes):
        _pack_header(out, len(value), None, -1, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))
        out += value
    elif isinstance(value, int) and not isinstance(value, bool) and value >= 0:
        _pack_header(out, value, 0x00, 0x7F,
                     ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")))
    elif isinstance(value, np.ndarray):
        if value.dtype.hasobject or value.dtype.isalignedstruct:
            raise ValueError("object and structured arrays cannot be written")
        if value.nbytes >= 1 << 30:
            raise ValueError("arrays of 1 GiB or more (which flax chunks) cannot be written")
        payload = bytearray()
        _pack(payload, [list(value.shape), value.dtype.name, value.tobytes("C")])
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(payload) in fixext:
            out.append(fixext[len(payload)])
        else:
            _pack_header(out, len(payload), None, -1, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
        out += struct.pack(">b", _EXT_NDARRAY)
        out += payload
    else:
        raise ValueError(f"cannot write {type(value).__name__} to a flax checkpoint")


def msgpack_serialize(tree: Dict[str, Any]) -> bytes:
    """Encode nested dicts of numpy arrays as ``flax.serialization.to_bytes``
    does for a tree jax has mapped over: string-keyed maps with sorted keys,
    each array as msgpack extension type 1 holding ``[shape, dtype name,
    C-order bytes]``."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def save_flax_checkpoint(path: str, tree: Dict[str, Any]) -> None:
    with open(path, "wb") as f:
        f.write(msgpack_serialize(tree))


def optimizer_state_to_flax(optimizer_config: Dict[str, Any], named_parameters,
                            optimizer: torch.optim.Optimizer, steps: int,
                            whole: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
                            ) -> Dict[str, Any]:
    """The tree ``flax.serialization.to_bytes`` writes for the optax state
    ``dream_tpu`` builds from ``optimizer_config`` (``network.py:394-435``),
    from the torch optimizer after ``steps`` steps.

    ``optax.adam(lr)`` is ``chain(scale_by_adam, scale_by_learning_rate)``:
    ``{"0": {"count", "mu", "nu"}, "1": {}}``, where ``"1"`` holds
    ``{"count"}`` under a schedule; ``optax.sgd`` has ``{}`` in place of
    Adam's state.  Global-norm clipping chains its empty state in front:
    ``{"0": {}, "1": <the above>}``.  ``mu`` and ``nu`` are torch Adam's
    ``exp_avg`` and ``exp_avg_sq`` in the parameters' flax layout; counts are
    0-d int32.  ``named_parameters`` is ``model.named_parameters()``;
    ``whole(name, tensor)``, where given, makes a parameter's moment whole
    (a channel-split parameter's are gathered).
    """
    count = np.asarray(steps, dtype=np.int32)
    if optimizer_config["type"] == "adam":
        mu, nu = {}, {}
        for name, p in named_parameters:
            state = optimizer.state.get(p, {})
            mu[name] = state.get("exp_avg", torch.zeros_like(p))
            nu[name] = state.get("exp_avg_sq", torch.zeros_like(p))
            if whole is not None:
                mu[name], nu[name] = whole(name, mu[name]), whole(name, nu[name])
        first = {"count": count, "mu": params_to_flax(mu)["params"], "nu": params_to_flax(nu)["params"]}
    else:
        first = {}
    tree = {"0": first, "1": {"count": count} if optimizer_config.get("schedule") else {}}
    if optimizer_config.get("grad_clip_norm"):
        tree = {"0": {}, "1": tree}
    return tree


def optimizer_state_from_flax(tree: Dict[str, Any], optimizer_config: Dict[str, Any],
                              named_parameters, optimizer: torch.optim.Optimizer) -> Optional[int]:
    """Load an optax state tree (:func:`optimizer_state_to_flax`'s layout,
    read from an ``.opt.msgpack``) into the torch optimizer.  Returns the
    step count the tree holds, ``None`` for plain SGD, whose state holds
    none."""
    if optimizer_config.get("grad_clip_norm"):
        tree = tree["1"]
    counts = [int(node["count"]) for node in (tree["0"], tree["1"]) if "count" in node]
    if optimizer_config["type"] == "adam":
        mu = params_from_flax({"params": tree["0"]["mu"]})
        nu = params_from_flax({"params": tree["0"]["nu"]})
        index = {id(p): i for i, p in enumerate(q for group in optimizer.param_groups
                                                  for q in group["params"])}
        state = optimizer.state_dict()
        step = torch.tensor(float(counts[0]))
        for name, p in named_parameters:
            state["state"][index[id(p)]] = {"step": step.clone(), "exp_avg": mu[name].clone(),
                                            "exp_avg_sq": nu[name].clone()}
        optimizer.load_state_dict(state)
    return counts[0] if counts else None
