"""Deployable inference artifacts through ``torch.export``.

Port of ``dream_tpu/export.py``.  The whole single-frame pipeline, raw uint8
frames -> preprocessing and normalization -> the model (float32, bf16,
vgg-Q's int8 chain or the quantized conv graph) -> the peak decode ->
**raw-frame keypoints**, is one ``nn.Module``
(:func:`build_raw_inference_fn`).  ``torch.export.export`` traces it, with
the parameters (and the int8 chain's quantized weights and scales, or the
quantized graph's parameters and amax) carried in the program, and
``torch.export.save`` writes a ``.pt2`` archive.  A serving process loads it with ``torch.export.load``
alone: no ``dream_tpu_torch``, no checkpoint (:func:`load_inference`,
:class:`dream_tpu_torch.serve.ArtifactInference`).

The exported graph differs from live inference in two choices, as
``dream_tpu``'s does:

- the peak decode and the int8 chain's convs run their plain torch
  versions (``decode_backend="plain"``, ``backend="plain"``), not the CUDA
  kernels: the kernels are launched through ``ctypes`` on raw device
  pointers, which a traced graph cannot hold, as a serialized
  ``pallas_call`` would pin ``dream_tpu``'s artifact to one Mosaic.  The
  plain versions compute what the kernels compute, bit for bit on the card
  (``chip_smoke.py``), so the artifact's keypoints equal the live ones;
  the int8 chain's plain route is an exact float64 convolution and slow.
  The quantized conv graph needs no such choice: its exact int32 route
  (``torch._int_mm`` on im2col matrices) is what it runs live;
- keypoints come back in raw-frame pixels: the net-output -> net-input ->
  raw affine is a constant of the raw resolution and is baked in.  The
  no-detection sentinel stays below -999.

The program is traced for the device of the network (and of its example
frames): an artifact exported on the card runs on the card.
"""

from __future__ import annotations

import io
from typing import Optional, Tuple

import torch
from torch import nn

from dream_tpu_torch.models import vgg_int8_deploy
from dream_tpu_torch.ops import belief_maps as bm_ops
from dream_tpu_torch.ops import coords as coord_ops
from dream_tpu_torch.ops import image_proc as image_proc_ops

FORMAT = "dream_tpu_torch.export.v1"


def serialized_int8_impl(dream_network) -> Optional[str]:
    """Which int8 graph an artifact of this network carries, named as
    ``dream_tpu`` names it (``dream_tpu/export.py:44-63``): ``"xla_chain"``
    for vgg-Q's chain (live ``"pallas"`` included), ``"quantconv"`` for the
    quantized conv graph, None before ``enable_int8_inference``."""
    if getattr(dream_network, "int8_chain", None) is not None:
        return "xla_chain"
    if getattr(dream_network, "int8_model", None) is not None:
        return "quantconv"
    return None


class RawInference(nn.Module):
    """``raw_uint8 [B, H, W, 3] -> (belief_maps [B, n_kp, h, w] f32,
    keypoints_raw [B, n_kp, 2] f32)`` for frames of one raw resolution."""

    def __init__(self, dream_network, raw_resolution: Tuple[int, int]):
        super().__init__()
        net = dream_network
        if net.network_config["architecture"]["output_heads"] != ["belief_maps"]:
            raise NotImplementedError("export supports the belief-map head networks (all shipped "
                                      "configs), as dream_tpu/export.py:77-79")
        self.net_input_resolution = net.trained_net_input_resolution()
        self.preprocessing = net.image_preprocessing()
        self.normalization = net.image_normalization
        netin_res, netout_res = net.net_resolutions_from_image_raw_resolution(raw_resolution)
        self.kp_to_raw = coord_ops.affine_raw_from_netin(
            netin_res, raw_resolution, self.preprocessing
        ).compose(coord_ops.affine_netin_from_netout(netout_res, netin_res))
        self.offset = net.peak_offset_due_to_upsampling()
        self.use_scores = net.use_belief_peak_scores
        self.gap = net.belief_peak_next_best_score
        self.compute_dtype = net.compute_dtype
        # The int8 chain is a snapshot of quantized tensors, which the
        # trace carries as constants; the float model's (or the quantized
        # graph's) parameters are the program's parameters.
        self.int8_chain = net.int8_chain
        if self.int8_chain is not None:
            self.model = None
        else:
            self.model = net.int8_model if net.int8_model is not None else net.model

    def forward(self, raw_uint8: torch.Tensor):
        net_in = image_proc_ops.preprocess_and_normalize(
            raw_uint8, self.net_input_resolution, self.preprocessing, self.normalization
        )
        if self.int8_chain is not None:
            belief = vgg_int8_deploy.run_int8_chain(
                self.int8_chain, net_in, self.compute_dtype, backend="plain"
            ).permute(0, 3, 1, 2)
        else:
            out = self.model(net_in.permute(0, 3, 1, 2))
            belief = out[-1] if isinstance(out, list) else out
        belief = belief.to(torch.float32)
        keypoints, _ = bm_ops.keypoints_from_belief_maps(
            belief, self.offset, use_belief_peak_scores=self.use_scores,
            belief_peak_next_best_score=self.gap, decode_backend="plain",
        )
        return belief, self.kp_to_raw(keypoints)


def build_raw_inference_fn(dream_network, raw_resolution: Tuple[int, int]) -> RawInference:
    """The pipeline as a module in eval mode: ``raw_resolution`` is the
    (width, height) of the frames; the network's trained preprocessing and
    normalization run first, and the keypoints are mapped back into the
    raw frame as ``DreamNetwork.keypoints_from_image`` maps them."""
    dream_network.enable_evaluation()
    return RawInference(dream_network, raw_resolution).eval()


def export_inference(dream_network, raw_resolution: Tuple[int, int], batch_size: int) -> bytes:
    """The pipeline for uint8 ``[batch_size, H, W, 3]`` frames on the
    network's device, exported and saved: the bytes of a ``.pt2``."""
    module = build_raw_inference_fn(dream_network, raw_resolution)
    w, h = raw_resolution
    example = torch.zeros((batch_size, h, w, 3), dtype=torch.uint8, device=dream_network.device)
    with torch.no_grad():
        program = torch.export.export(module, (example,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_inference(data: bytes):
    """An artifact's bytes -> ``call(raw_uint8) -> (belief, keypoints_raw)``
    (``torch.export.load(...).module()``, its parameters frozen); torch is
    all it needs."""
    module = torch.export.load(io.BytesIO(data)).module()
    for p in module.parameters():
        p.requires_grad_(False)
    return module


def artifact_metadata(dream_network, raw_resolution: Tuple[int, int], batch_size: int) -> dict:
    """The ``<artifact>.meta.json`` sidecar, with ``dream_tpu``'s keys
    (``dream_tpu/export.py:171-204``): keypoint names, the manipulator, the
    input contract, the outputs and the int8 graph carried."""
    net = dream_network
    w, h = raw_resolution
    return {
        "format": FORMAT,
        "manipulator": net.manipulator_name,
        "keypoint_names": list(net.keypoint_names),
        "friendly_keypoint_names": list(net.friendly_keypoint_names),
        "input": {
            "shape": [batch_size, h, w, 3],
            "dtype": "uint8",
            "raw_resolution_wh": [w, h],
        },
        "outputs": [
            "belief_maps [B, n_kp, h_out, w_out] float32",
            "keypoints_raw [B, n_kp, 2] float32 (sentinel: < -999 = no detection)",
        ],
        "int8": serialized_int8_impl(net) is not None,
        "int8_impl": serialized_int8_impl(net),
        "architecture": net.network_config["architecture"]["type"],
    }
