"""Seeded initial parameters, made on the device in a few large draws.

Conv weights are normal with standard deviation ``1/sqrt(fan_in)`` (lecun
normal), transposed-conv weights uniform in ``+-1/sqrt(fan_in)``, biases 0,
BatchNorm scales 1, running means 0 and variances 1: the published networks'
initial distributions.  All normal draws are one call, all uniform draws
another, from a generator on ``device`` seeded by ``seed``; each leaf is a
slice of them, so the same seed gives the same weights to the program and to
the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from benchmark.reference.models import Leaf


def seeded_state(spec: Sequence[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(int(seed))
    n_normal = sum(math.prod(leaf.shape) for leaf in spec if leaf.init == "lecun")
    n_uniform = sum(math.prod(leaf.shape) for leaf in spec if leaf.init == "uniform")
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(n_uniform, generator=g, device=device)
    state: Dict[str, torch.Tensor] = {}
    at = {"lecun": 0, "uniform": 0}
    for leaf in spec:
        size = math.prod(leaf.shape)
        if leaf.init in at:
            pool = normal if leaf.init == "lecun" else uniform
            draw = pool[at[leaf.init]:at[leaf.init] + size].view(leaf.shape)
            at[leaf.init] += size
            bound = 1.0 / math.sqrt(leaf.fan_in)
            state[leaf.name] = draw * bound if leaf.init == "lecun" else (draw * 2.0 - 1.0) * bound
        else:
            fill = 1.0 if leaf.init == "ones" else 0.0
            state[leaf.name] = torch.full(leaf.shape, fill, dtype=torch.float32, device=device)
    return state
