"""Grafting a pretrained VGG encoder into a network's parameters.

Port of ``dream_tpu/models/pretrain.py:70-120`` on nested dicts of numpy
arrays in flax's layout (the trees :mod:`dream_tpu_torch.checkpoint` reads
and writes), so a graft takes the same leaves as the JAX package's: each
top-level subtree of the source (``down1`` .. ``down5`` of an encoder
file; every submodule of a whole checkpoint, as the r5 vgg-F recipe
grafts a vgg-Q checkpoint) merged into the target's subtrees of that
name at any depth, a leaf replaced only where the shapes agree.  The
denoising autoencoder that pretrains such an encoder is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

ENCODER_KEYS = ("down1", "down2", "down3", "down4", "down5")


def extract_encoder_params(variables: Dict[str, Any]) -> Dict[str, Any]:
    """The encoder subtree of a variables tree, as ``{"params": {...}}``."""
    params = variables["params"]
    return {"params": {k: params[k] for k in ENCODER_KEYS if k in params}}


def graft_encoder_params(target_params: Dict[str, Any],
                         encoder_params: Dict[str, Any]) -> Tuple[Dict[str, Any], int, int]:
    """Merge encoder weights into a params tree.

    ``encoder_params`` is a variables tree or a params subtree; each of its
    top-level subtrees grafts into every subtree of ``target_params`` with
    that name (single-stage ``down1`` and multistage ``stage1/down1``
    alike), leaf by leaf where the shapes agree (a later stage's
    ``down1.conv0`` takes image and belief maps and keeps its own).
    Returns ``(merged_params, n_grafted, n_skipped)``.
    """
    enc = encoder_params["params"] if "params" in encoder_params else encoder_params
    stats = {"grafted": 0, "skipped": 0}

    def merge_subtree(dst, src):
        out = {}
        for key, val in dst.items():
            if key in src and isinstance(val, dict) and isinstance(src[key], dict):
                out[key] = merge_subtree(val, src[key])
            elif key in src and not isinstance(val, dict):
                if tuple(np.shape(src[key])) == tuple(np.shape(val)):
                    out[key] = src[key]
                    stats["grafted"] += 1
                else:
                    out[key] = val
                    stats["skipped"] += 1
            else:
                out[key] = val
        return out

    def walk(node):
        if not isinstance(node, dict):
            return node
        return {key: merge_subtree(val, enc[key]) if key in enc and isinstance(val, dict)
                else walk(val) for key, val in node.items()}

    merged = walk(target_params)
    return merged, stats["grafted"], stats["skipped"]
