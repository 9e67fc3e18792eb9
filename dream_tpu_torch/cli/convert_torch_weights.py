"""Convert reference DREAM PyTorch checkpoints (.pth) to flax msgpack.

The port of ``scripts/convert_torch_weights.py``: the reference's trained
models are torch ``state_dict`` files (reference dream/network.py:
608-616); this writes the flax tree ``dream_tpu``'s script writes, which
both packages load (the port through
:func:`dream_tpu_torch.checkpoint.state_from_flax`).  A ``DataParallel``
``module.`` prefix is stripped.  Layouts:

- Conv2d weight ``[out, in, kh, kw]`` -> HWIO ``[kh, kw, in, out]``;
- ConvTranspose2d weight ``[in, out, kh, kw]`` -> spatially flipped HWIO
  (``layers.TorchConvTranspose`` is a fractionally strided conv);
- BatchNorm: ``weight``/``bias`` -> ``scale``/``bias`` in ``params``, the
  running statistics -> ``mean``/``var`` in ``batch_stats``.

The names cover the vgg hourglasses (single- and multistage,
:func:`convert_vgg`) and ResnetSimple (:func:`convert_resnet`).

Example:
  python3 -m dream_tpu_torch.cli.convert_torch_weights -i dream_vgg_q.pth -a vgg \\
      -o dream_vgg_q.msgpack
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np
import torch

from dream_tpu_torch.checkpoint import save_flax_checkpoint


def _to_hwio(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _deconv_to_hwio(w: np.ndarray) -> np.ndarray:
    return np.transpose(np.flip(w, axis=(2, 3)), (2, 3, 0, 1))


def _strip_module(sd) -> Dict[str, np.ndarray]:
    """The state dict as numpy, the ``DataParallel`` ``module.`` prefix
    stripped."""
    return {(k[7:] if k.startswith("module.") else k): np.asarray(v.detach().cpu().numpy()
                                                                   if hasattr(v, "detach") else v)
            for k, v in sd.items()}


def _put(tree: Dict[str, Any], path, leaf: Dict[str, np.ndarray]) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = leaf


# (torch prefix inside the reference DreamHourglass, flax path)
_HOURGLASS_ENCODER = [
    ("layer_0_1_down.0", ("down1", "conv0")), ("layer_0_1_down.2", ("down1", "conv1")),
    ("layer_0_2_down.5", ("down2", "conv0")), ("layer_0_2_down.7", ("down2", "conv1")),
    ("layer_0_3_down.10", ("down3", "conv0")), ("layer_0_3_down.12", ("down3", "conv1")),
    ("layer_0_3_down.14", ("down3", "conv2")), ("layer_0_3_down.16", ("down3", "conv3")),
    ("layer_0_4_down.19", ("down4", "conv0")), ("layer_0_4_down.21", ("down4", "conv1")),
    ("layer_0_4_down.23", ("down4", "conv2")), ("layer_0_4_down.25", ("down4", "conv3")),
    ("layer_0_5_down.28", ("down5", "conv0")), ("layer_0_5_down.30", ("down5", "conv1")),
    ("layer_0_5_down.32", ("down5", "conv2")), ("layer_0_5_down.34", ("down5", "conv3")),
]
_HOURGLASS_UPSAMPLE = [
    ("upsample_0_4.4", ("upsample4", "conv0")), ("upsample_0_4.6", ("upsample4", "conv1")),
    ("upsample_0_3.4", ("upsample3", "conv0")), ("upsample_0_3.6", ("upsample3", "conv1")),
    ("upsample_0_2.2", ("upsample2", "conv0")), ("upsample_0_2.4", ("upsample2", "conv1")),
    ("upsample_0_1.2", ("upsample1", "conv0")), ("upsample_0_1.4", ("upsample1", "conv1")),
]
_HOURGLASS_DECONV = [
    ("deconv_0_4.0", ("deconv4", "deconv")), ("deconv_0_4.2", ("deconv4", "conv")),
    ("deconv_0_3.0", ("deconv3", "deconv")), ("deconv_0_3.2", ("deconv3", "conv")),
    ("deconv_0_2.0", ("deconv2", "deconv")), ("deconv_0_2.2", ("deconv2", "conv")),
    ("deconv_0_1.0", ("deconv1", "deconv")),
]
_HOURGLASS_HEAD = [
    ("heads_0.0", ("head", "conv0")), ("heads_0.2", ("head", "conv1")),
    ("heads_0.4", ("head", "conv2")),
]


def _convert_hourglass_stage(sd: Dict[str, np.ndarray], torch_prefix: str,
                             out: Dict[str, Any]) -> Dict[str, Any]:
    """One DreamHourglass's weights into the flax params dict ``out``; a
    decoder the checkpoint does not hold is skipped."""
    for tname, fpath in _HOURGLASS_ENCODER + _HOURGLASS_UPSAMPLE + _HOURGLASS_DECONV + _HOURGLASS_HEAD:
        wkey = f"{torch_prefix}{tname}.weight"
        if wkey not in sd:
            continue
        w, b = sd[wkey], sd[f"{torch_prefix}{tname}.bias"]
        _put(out, fpath, {"kernel": _deconv_to_hwio(w) if fpath[-1] == "deconv" else _to_hwio(w),
                          "bias": b})
    return out


def convert_vgg(sd) -> Dict[str, Any]:
    """A DreamHourglass or DreamHourglassMultiStage state dict -> ``{"params"}``."""
    sd = _strip_module(sd)
    params: Dict[str, Any] = {}
    if any(k.startswith("stage1.") for k in sd):
        n_stages = max(int(k.split(".")[0][5:]) for k in sd if k.startswith("stage"))
        for s in range(1, n_stages + 1):
            params[f"stage{s}"] = _convert_hourglass_stage(sd, f"stage{s}.", {})
    else:
        _convert_hourglass_stage(sd, "", params)
    return {"params": params}


def convert_resnet(sd, layers=(3, 4, 23, 3)) -> Dict[str, Any]:
    """A ResnetSimple state dict (torchvision key names; the decoder's
    deconv + BatchNorm blocks in ``upsample``, the full variant's last
    block and 1x1 head in ``upsample2``) -> ``{"params", "batch_stats"}``."""
    sd = _strip_module(sd)
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}

    def put_bn(fpath, prefix):
        _put(params, fpath, {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]})
        _put(batch_stats, fpath, {"mean": sd[prefix + ".running_mean"], "var": sd[prefix + ".running_var"]})

    def put_deconv(fpath, prefix):
        _put(params, fpath, {"kernel": _deconv_to_hwio(sd[prefix + ".weight"]), "bias": sd[prefix + ".bias"]})

    _put(params, ("conv1",), {"kernel": _to_hwio(sd["conv1.weight"])})
    put_bn(("bn1",), "bn1")
    for li, n_blocks in enumerate(layers, start=1):
        for b in range(n_blocks):
            tp, fp = f"layer{li}.{b}", (f"layer{li}", f"block{b}")
            for ci in (1, 2, 3):
                _put(params, fp + (f"conv{ci}",), {"kernel": _to_hwio(sd[f"{tp}.conv{ci}.weight"])})
                put_bn(fp + (f"bn{ci}",), f"{tp}.bn{ci}")
            if f"{tp}.downsample.0.weight" in sd:
                _put(params, fp + ("downsample_conv",), {"kernel": _to_hwio(sd[f"{tp}.downsample.0.weight"])})
                put_bn(fp + ("downsample_bn",), f"{tp}.downsample.1")

    # The decoder: deconv + BatchNorm (+ ReLU) blocks, three indices each,
    # then the half variant's 1x1 head.
    up_idx, seq = 0, 0
    while f"upsample.{seq}.weight" in sd:
        w = sd[f"upsample.{seq}.weight"]
        if w.ndim == 4 and f"upsample.{seq + 1}.weight" in sd:
            put_deconv((f"up{up_idx}", "deconv"), f"upsample.{seq}")
            put_bn((f"up{up_idx}", "bn"), f"upsample.{seq + 1}")
            up_idx += 1
            seq += 3
        else:
            params["head"] = {"kernel": _to_hwio(w), "bias": sd[f"upsample.{seq}.bias"]}
            break
    if "upsample2.0.weight" in sd:  # the full variant: (deconv, BatchNorm, ReLU, 1x1 conv)
        put_deconv((f"up{up_idx}", "deconv"), "upsample2.0")
        put_bn((f"up{up_idx}", "bn"), "upsample2.1")
        params["head"] = {"kernel": _to_hwio(sd["upsample2.3.weight"]), "bias": sd["upsample2.3.bias"]}
    return {"params": params, "batch_stats": batch_stats}


def count_leaves(tree: Any) -> int:
    """The number of array elements in a nested dict of arrays."""
    if isinstance(tree, dict):
        return sum(count_leaves(v) for v in tree.values())
    return int(np.size(tree))


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-i", "--input-pth", required=True, help="Reference .pth state_dict file.")
    parser.add_argument("-a", "--architecture", choices=["vgg", "resnet"], required=True)
    parser.add_argument("-o", "--output", required=True, help="Output .msgpack params file.")
    args = parser.parse_args(argv)
    sd = torch.load(args.input_pth, map_location="cpu")
    variables = convert_vgg(sd) if args.architecture == "vgg" else convert_resnet(sd)
    save_flax_checkpoint(args.output, variables)
    print(f"Wrote {args.output}: {count_leaves(variables)} parameters")
    return variables


if __name__ == "__main__":
    main()
