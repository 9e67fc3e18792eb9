"""The CUDA score kernel against its plain torch version, on the card.

Needs an NVIDIA GPU with nvcc (marker ``cuda``); skips elsewhere.  This file
imports neither jax nor dream_tpu, so it also runs where only torch is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py
"""

import numpy as np
import pytest
import torch

from dream_tpu_torch.ops import score_kernel
from dream_tpu_torch.ops.belief_maps import create_belief_maps, peaks_from_belief_maps


def _maps(rng, n, h, w):
    maps = np.zeros((n, h, w), np.float32)
    for _ in range(3):
        kp = torch.from_numpy(rng.uniform([0, 0], [w, h], size=(n, 1, 2)).astype(np.float32))
        amp = rng.uniform(0.2, 1.0, size=(n, 1, 1)).astype(np.float32)
        maps += amp * create_belief_maps(kp, (w, h))[:, 0].numpy()
    return maps + rng.rand(n, h, w).astype(np.float32) * 0.004


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the score kernel is CUDA with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(112, 100, 100), (14, 400, 400), (21, 37, 53), (3, 5, 300)])
def test_score_kernel_matches_plain(cuda, shape):
    maps = torch.from_numpy(_maps(np.random.RandomState(6), *shape)).to(cuda)
    before = score_kernel.score_maps_kernel.launches
    scored, count = score_kernel.score_maps_kernel(maps)
    ref_scored, ref_count = score_kernel.score_maps_plain(maps)
    torch.cuda.synchronize()
    assert score_kernel.score_maps_kernel.launches == before + 1
    assert torch.equal(count, ref_count)
    assert torch.equal(scored, ref_scored)


@pytest.mark.cuda
def test_decode_on_cuda_goes_through_the_kernel(cuda):
    maps = torch.from_numpy(_maps(np.random.RandomState(7), 14, 100, 100)).to(cuda)
    before = score_kernel.score_maps_kernel.launches
    peaks = peaks_from_belief_maps(maps.reshape(2, 7, 100, 100), 0.4395)
    assert score_kernel.score_maps_kernel.launches == before + 1
    ref = peaks_from_belief_maps(maps.cpu().reshape(2, 7, 100, 100), 0.4395)
    assert torch.equal(peaks["count"].cpu(), ref["count"])
    valid = ref["valid"]
    torch.testing.assert_close(peaks["coords"].cpu()[valid], ref["coords"][valid], atol=1e-4, rtol=0)
    torch.testing.assert_close(peaks["scores"].cpu()[valid], ref["scores"][valid], atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    with pytest.raises(ValueError):
        score_kernel.score_maps_kernel(torch.zeros(2, 10, 10, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        score_kernel.score_maps_kernel(torch.zeros(2, 10, 10, device=cuda).transpose(1, 2))
