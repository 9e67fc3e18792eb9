"""DreamNetwork: the config-driven inference facade of the port.

Port of the inference half of ``dream_tpu/network.py`` (``:50-66`` and
``:974-1098``) for the vgg-Q configuration: build the model from a
self-describing YAML config, load flax msgpack weights, and run
``image -> (belief_maps, keypoints)`` on one device.  The model computes in
float32 (a config's ``compute_dtype`` bfloat16 is not ported yet).  Peak
decoding runs in the CUDA score kernel for CUDA tensors and in its plain
torch version for CPU tensors, chosen by the tensor's device.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without CUDA they raise instead of falling back.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dream_tpu_torch.checkpoint import load_flax_checkpoint, params_from_flax
from dream_tpu_torch.models import DreamHourglass
from dream_tpu_torch.ops import belief_maps as bm_ops
from dream_tpu_torch.ops import coords as coord_ops
from dream_tpu_torch.ops import image_proc as image_proc_ops
from dream_tpu_torch.utils import resolutions as res_utils
from dream_tpu_torch.utils.config import load_yaml


def resolve_device(device: Any) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device must be available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return dev


def create_network_from_config_file(
    config_file_path: str, network_params_path: Optional[str] = None,
    device: Any = "cuda",
) -> "DreamNetwork":
    """Parity: ``dream_tpu.network.create_network_from_config_file``."""
    if not os.path.exists(config_file_path):
        raise FileNotFoundError(config_file_path)
    network = DreamNetwork(load_yaml(config_file_path), device=device)
    if network_params_path:
        if not os.path.exists(network_params_path):
            raise FileNotFoundError(network_params_path)
        network.load_network_params(network_params_path)
    return network


class DreamNetwork:
    """Config-validated vgg-Q model + decode + coordinate maps."""

    def __init__(self, network_config: Dict[str, Any], device: Any = "cuda"):
        self.device = resolve_device(device)
        for key in ("architecture", "manipulator", "training"):
            if key not in network_config:
                raise ValueError(f'Required key "{key}" is missing from network configuration.')
        arch = network_config["architecture"]
        manip = network_config["manipulator"]
        self.network_config = network_config
        self.manipulator_name = manip["name"]
        self.keypoint_names: List[str] = [kp["name"] for kp in manip["keypoints"]]
        self.n_keypoints = len(self.keypoint_names)
        self.architecture_type = arch["type"]
        self.image_normalization = arch["image_normalization"]
        if self.image_preprocessing() not in res_utils.KNOWN_IMAGE_PREPROC_TYPES:
            raise ValueError(f'Image preprocessing type "{self.image_preprocessing()}" is not recognized.')
        if arch["input_heads"][0] != "image_rgb":
            raise ValueError('First input head must be "image_rgb".')
        unported = [k for k in ("spatial_softmax", "deconv_decoder", "full_output",
                                "skip_connections", "n_stages") if k in arch]
        if self.architecture_type != "vgg" or arch["output_heads"] != ["belief_maps"] or unported:
            raise NotImplementedError(
                "the port runs the vgg upsample-decoder hourglass (vgg-Q) only so far; "
                f"got type={self.architecture_type} output_heads={arch['output_heads']} "
                f"options={unported}"
            )
        if arch.get("quant_mode"):
            raise NotImplementedError("quantized (QAT/int8) inference is not ported yet")

        # Multi-peak disambiguation knobs (reference dream/network.py:187-191).
        self.use_belief_peak_scores = True
        self.belief_peak_next_best_score = 0.25

        self.model = DreamHourglass(self.n_keypoints).to(self.device).eval()

        cfg = network_config["training"]["config"]
        out_res = list(self.net_output_resolution_from_input_resolution(
            self.trained_net_input_resolution()
        ))
        if "net_output_resolution" in cfg and list(cfg["net_output_resolution"]) != out_res:
            raise ValueError("Network model and config file disagree for trained network output resolution.")
        cfg.setdefault("net_output_resolution", out_res)

    # --- getters (reference dream/network.py:319-326) ---

    def trained_net_input_resolution(self) -> Tuple[int, int]:
        return tuple(self.network_config["training"]["config"]["net_input_resolution"])

    def trained_net_output_resolution(self) -> Tuple[int, int]:
        return tuple(self.network_config["training"]["config"]["net_output_resolution"])

    def image_preprocessing(self) -> str:
        return self.network_config["architecture"]["image_preprocessing"]

    def net_output_resolution_from_input_resolution(self, net_input_resolution):
        return res_utils.net_output_resolution_from_input_resolution(net_input_resolution, "vgg")

    def net_resolutions_from_image_raw_resolution(self, image_raw_resolution):
        """Parity: reference dream/network.py:368-395."""
        net_input_resolution = res_utils.resolution_after_preprocessing(
            image_raw_resolution, self.trained_net_input_resolution(), self.image_preprocessing()
        )
        return net_input_resolution, self.net_output_resolution_from_input_resolution(
            net_input_resolution
        )

    def peak_offset_due_to_upsampling(self) -> float:
        w, h = self.trained_net_output_resolution()
        # Heuristic for small belief maps (reference dream/network.py:534-538).
        return 0.0 if (w >= 400 and h >= 400) else 0.4395

    # --- parameters ---

    def load_network_params(self, network_params_path: str) -> None:
        """Load flax msgpack weights (float16 storage is widened to float32)."""
        state = params_from_flax(load_flax_checkpoint(network_params_path))
        self.model.load_state_dict(state, strict=True)

    # --- inference (reference dream/network.py:503-590) ---

    @torch.no_grad()
    def inference(self, network_input: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[B, h, w, 3]`` float net input (channels-last, as the JAX package)
        -> ``(belief_maps [B, n_kp, h/4, w/4], keypoints [B, n_kp, 2])`` in
        the net-output frame; the sentinel marks no detection."""
        x = network_input.to(self.device, torch.float32).permute(0, 3, 1, 2)
        belief = self.model(x)
        keypoints, _ = bm_ops.keypoints_from_belief_maps(
            belief,
            self.peak_offset_due_to_upsampling(),
            use_belief_peak_scores=self.use_belief_peak_scores,
            belief_peak_next_best_score=self.belief_peak_next_best_score,
        )
        return belief, keypoints

    def preprocess(self, images_u8: torch.Tensor) -> torch.Tensor:
        """uint8 ``[B, H, W, 3]`` frames -> normalized float net input on the device."""
        return image_proc_ops.preprocess_and_normalize(
            images_u8.to(self.device),
            self.trained_net_input_resolution(),
            self.image_preprocessing(),
            self.image_normalization,
        )

    def keypoints_from_image(self, input_rgb_image: np.ndarray, debug: bool = False) -> Dict[str, Any]:
        """uint8 ``[H, W, 3]`` array -> raw-frame keypoints (reference
        dream/network.py:423-499); ``debug`` adds the net input, the belief
        maps and the net-output / net-input frame keypoints."""
        image = np.asarray(input_rgb_image, dtype=np.uint8)
        input_resolution = (image.shape[1], image.shape[0])
        netin_res, _ = self.net_resolutions_from_image_raw_resolution(input_resolution)
        net_input = self.preprocess(torch.from_numpy(image)[None])
        belief_maps, kp_netout = self.inference(net_input)
        detected_netout = kp_netout[0].cpu().numpy().astype(float)
        netout_res_inf = (belief_maps.shape[-1], belief_maps.shape[-2])
        kp_netin = coord_ops.convert_keypoints_to_netin_from_netout(
            detected_netout, netout_res_inf, netin_res
        )
        detected = coord_ops.convert_keypoints_to_raw_from_netin(
            kp_netin, netin_res, input_resolution, self.image_preprocessing()
        )
        result = {"detected_keypoints": np.asarray(detected)}
        if debug:
            result["image_rgb_net_input"] = net_input[0]
            result["belief_maps"] = belief_maps[0]
            result["detected_keypoints_net_output"] = detected_netout
            result["detected_keypoints_net_input"] = np.asarray(kp_netin)
        return result
