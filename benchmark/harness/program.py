"""What the benchmark takes from the program under test, ``dream_tpu_torch``:
the network facade, its batch processor and the evaluation entry point.
Imported only here and by the drivers, after the run has found its card.
"""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch


def derive(seed: int, *path: int) -> int:
    """A 31-bit seed drawn from ``seed`` and a path of labels."""
    return int(np.random.SeedSequence([int(seed), *path]).generate_state(1)[0] >> 1)


def network_config(config: dict) -> dict:
    """The port's network config (architecture, manipulator, training) of a
    configuration file, as its sidecar YAML would load."""
    return copy.deepcopy(config["network"])


def build_with_state(net_config: dict, state: Dict[str, torch.Tensor], device) -> "object":
    """A ``DreamNetwork`` holding ``state``: built on the meta device, where
    nothing is drawn, given storage on ``device`` and loaded whole, as
    ``DreamNetwork.from_checkpoint`` builds one from a file."""
    from dream_tpu_torch.network import DreamNetwork

    device = torch.device(device)
    with torch.device("meta"):
        net = DreamNetwork(net_config, device="meta")
    net.device = device
    net.model = net.model.to_empty(device=device).eval()
    for module in net.model.modules():
        if hasattr(module, "reset_buffers"):
            module.reset_buffers()
    net.model.load_state_dict(state, strict=True)
    return net


def from_checkpoint(net_config: dict, path: str, device):
    from dream_tpu_torch.network import DreamNetwork

    return DreamNetwork.from_checkpoint(net_config, path, device)


def batch_processor(net, raw_res, augment: bool):
    from dream_tpu_torch.data.dataset import make_batch_processor

    netin, netout = net.net_resolutions_from_image_raw_resolution(raw_res)
    return make_batch_processor(raw_res, netin, netout, net.image_preprocessing(),
                                net.image_normalization, augment=augment)
