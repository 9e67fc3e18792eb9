"""Encoder pretraining: the denoising autoencoder, and grafting its encoder.

Port of ``dream_tpu/models/pretrain.py``.  :class:`EncoderAutoencoder` is
the VGG19-layout encoder of :class:`~dream_tpu_torch.models.hourglass.
DreamHourglass` (the same ``down1`` .. ``down5`` blocks under the same
names) with a light decoder that reconstructs the image at a quarter of
its resolution; ``cli/pretrain_encoder.py`` trains it on synthetic scenes
as a denoising autoencoder.  Its parameters carry across to flax's tree
through :mod:`dream_tpu_torch.checkpoint` like any hourglass's (``rec4``,
``rec3`` and ``rec_out`` are plain 3x3 convs).

:func:`extract_encoder_params` and :func:`graft_encoder_params` work on
nested dicts of numpy arrays in flax's layout (the trees
:mod:`dream_tpu_torch.checkpoint` reads and writes), so a graft takes the
same leaves as the JAX package's: each top-level subtree of the source
(``down1`` .. ``down5`` of an encoder file; every submodule of a whole
checkpoint, as the r5 vgg-F recipe grafts a vgg-Q checkpoint) merged into
the target's subtrees of that name at any depth, a leaf replaced only
where the shapes agree.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dream_tpu_torch.models.hourglass import _VggDownBlock
from dream_tpu_torch.models.layers import conv3x3, init_module_, max_pool_torch, upsample_nearest

ENCODER_KEYS = ("down1", "down2", "down3", "down4", "down5")


class EncoderAutoencoder(nn.Module):
    """VGG19-layout encoder and reconstruction decoder
    (``dream_tpu/models/pretrain.py:34-67``).

    Input: a noisy normalized image ``[B, 3, H, W]``.  Output: its
    reconstruction at a quarter of the resolution, ``[B, 3, H/4, W/4]``,
    float32.  The encoder is ``DreamHourglass``'s (2x2 floor max-pools
    between the blocks); the decoder is nearest x2, ``rec4`` (3x3 conv to
    256) + ReLU, nearest x2, ``rec3`` (to 128) + ReLU, ``rec_out`` (to 3).
    Every conv computes in ``dtype``; the parameters are float32, drawn
    with flax's defaults from ``generator`` in module order.
    """

    def __init__(self, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.down1 = _VggDownBlock(3, 64, 2, dtype)
        self.down2 = _VggDownBlock(64, 128, 2, dtype)
        self.down3 = _VggDownBlock(128, 256, 4, dtype)
        self.down4 = _VggDownBlock(256, 512, 4, dtype)
        self.down5 = _VggDownBlock(512, 512, 4, dtype)
        self.rec4 = conv3x3(512, 256, dtype)
        self.rec3 = conv3x3(256, 128, dtype)
        self.rec_out = conv3x3(128, 3, dtype)
        init_module_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        x = max_pool_torch(self.down1(x))
        x = max_pool_torch(self.down2(x))
        x = max_pool_torch(self.down3(x))
        x = max_pool_torch(self.down4(x))
        x = self.down5(x)
        x = F.relu(self.rec4(upsample_nearest(x, 2)))
        x = F.relu(self.rec3(upsample_nearest(x, 2)))
        return self.rec_out(x).to(torch.float32)


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
