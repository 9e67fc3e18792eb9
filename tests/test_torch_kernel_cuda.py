"""The CUDA kernels (score, warp) against their plain torch versions, on the card.

Needs an NVIDIA GPU with nvcc (marker ``cuda``); skips elsewhere.  This file
imports neither jax nor dream_tpu, so it also runs where only torch is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py
"""

import numpy as np
import pytest
import torch

from dream_tpu_torch.data.augment import DEFAULT_AUGMENT, affine_matrices, sample_augment_params
from dream_tpu_torch.ops import score_kernel, warp
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
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA with no CPU mode")
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


def _warp_inputs(rng, b, h, w, c, kind):
    images = torch.from_numpy((rng.rand(b, h, w, c) * 255).astype(np.float32))
    n = torch.ones(b, dtype=torch.bool)
    if kind == "identity":
        affines = torch.tensor([[1.0, 0, 0], [0, 1.0, 0]]).expand(b, 2, 3).contiguous()
    elif kind == "random":
        cfg = DEFAULT_AUGMENT._replace(p_shift_scale_rotate=1.0)
        affines = sample_augment_params(torch.Generator().manual_seed(b), b, h, w, cfg).affines
    elif kind == "extreme":  # max rotation, scale-down and shift: folds on every side
        f = torch.ones(b)
        affines = affine_matrices(n, 15 * f, 0.9 * f, 0.0625 * w * f, -0.0625 * h * f, h, w)
    else:  # far outside the augmentation's range: folds more than once
        f = torch.ones(b)
        affines = affine_matrices(n, 70 * f, 0.3 * f, 1.7 * w * f, -2.3 * h * f, h, w)
    return images, affines


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "extreme", "multifold", "identity"])
@pytest.mark.parametrize("shape", [(4, 400, 400, 3), (3, 37, 53, 3), (2, 64, 128, 1), (2, 2, 5, 4)])
def test_warp_kernel_matches_plain(cuda, shape, kind):
    images, affines = _warp_inputs(np.random.RandomState(8), *shape, kind)
    images, affines = images.to(cuda), affines.to(cuda)
    before = warp.warp_batch_kernel.launches
    out = warp.warp_batch_kernel(images, affines)
    ref = warp.warp_batch_plain(images, affines)
    torch.cuda.synchronize()
    assert warp.warp_batch_kernel.launches == before + 1
    if kind == "identity":
        assert torch.equal(out, images)
    # Same rounding order in both: equal to the bit, 2e-3 is the stated bound.
    torch.testing.assert_close(out, ref, atol=2e-3, rtol=0)


@pytest.mark.cuda
def test_warp_batch_on_cuda_goes_through_the_kernel(cuda):
    images, affines = _warp_inputs(np.random.RandomState(9), 2, 48, 40, 3, "random")
    before = warp.warp_batch_kernel.launches
    out = warp.warp_batch(images.to(cuda), affines.to(cuda))
    assert warp.warp_batch_kernel.launches == before + 1
    torch.testing.assert_close(out.cpu(), warp.warp_batch_plain(images, affines), atol=2e-3, rtol=0)


@pytest.mark.cuda
def test_warp_kernel_rejects_bad_inputs(cuda):
    affines = torch.eye(3, device=cuda)[:2].expand(2, 2, 3)
    with pytest.raises(ValueError):
        warp.warp_batch_kernel(torch.zeros(2, 8, 8, 3, dtype=torch.float64, device=cuda), affines)
    with pytest.raises(ValueError):
        warp.warp_batch_kernel(torch.zeros(2, 3, 8, 8, device=cuda).permute(0, 2, 3, 1), affines)
    with pytest.raises(ValueError):
        warp.warp_batch_kernel(torch.zeros(2, 1, 8, 3, device=cuda), affines)
    with pytest.raises(ValueError):
        warp.warp_batch_kernel(torch.zeros(3, 8, 8, 3, device=cuda), affines)
    with pytest.raises(ValueError):
        warp.warp_batch_kernel(torch.zeros(2, 8, 8, 3), affines.cpu())
