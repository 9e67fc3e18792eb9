"""The port's augmentation warp, augmentation and batch processor against dream_tpu.

All on the CPU, float32, inputs made with numpy from fixed seeds.

- Warp: ``warp_batch_plain`` against the vmapped
  ``augment._warp_bilinear_reflect101`` and against the Pallas kernel
  ``warp_batch_pallas`` in interpret mode at ``precision="HIGHEST"``, at
  64x128, to atol 2e-2 on the 0-255 scale: the bound of
  ``tests/test_pallas_warp.py:50``.  The two sides invert the affine with
  different LU codes, and source coordinates of ~100 px carry that rounding
  into the bilinear weights.  Identity affines are exact; an affine far
  outside the augmentation's range, folding more than once, is held
  against the gather oracle only (the Pallas kernel does not take it).
- Augmentation: jax draws every parameter and the noise from a fixed key,
  with ``augment_batch``'s own key splits; the port applies the injected
  draws.  Images agree to 3e-2 on the 0-255 scale (the warp's 2e-2 times a
  contrast factor of at most 1.2, plus the image mean's summation order),
  key points to 1e-3 px.  The port's own sampler is checked by the bounds
  of its draws only, since torch cannot reproduce jax's PRNG.
- Batch processor, augmentation off: raw 128x96 frames, net input 64x64,
  maps 16x16; net input to 1e-4 (the resize's matmul order), key points to
  1e-4 px, belief maps to 1e-5.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dream_tpu.data import augment as jax_augment
from dream_tpu.data.dataset import make_batch_processor as jax_make_batch_processor
from dream_tpu.ops.pallas_warp import warp_batch_pallas

from dream_tpu_torch.data import augment
from dream_tpu_torch.data.dataset import make_batch_processor
from dream_tpu_torch.ops import warp as warp_mod
from dream_tpu_torch.ops.warp import inverse_affines, warp_batch, warp_batch_plain

WARP_ATOL = 2e-2  # tests/test_pallas_warp.py:50, the HIGHEST-precision bound
AUGMENT_ATOL = 3e-2
KEYPOINT_ATOL = 1e-3

H, W = 64, 128
FULL_CFG = jax_augment.AugmentConfig(p_shift_scale_rotate=1.0)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing
    and slow the other test workers: two threads take less CPU time than
    the machine's count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _images(seed, b, h=H, w=W, c=3):
    return (np.random.RandomState(seed).rand(b, h, w, c) * 255).astype(np.float32)


def _gather(images, affines):
    return np.asarray(
        jax.vmap(jax_augment._warp_bilinear_reflect101)(jnp.asarray(images), jnp.asarray(affines))
    )


def _pallas(images, affines):
    return np.asarray(
        warp_batch_pallas(jnp.asarray(images), jnp.asarray(affines), interpret=True,
                          precision="HIGHEST")
    )


def _port(images, affines):
    return warp_batch_plain(torch.from_numpy(images), torch.from_numpy(np.asarray(affines))).numpy()


def _extreme_affine(h, w):
    """Max rotation, max scale-down, max shift: the TPU kernel's worst case,
    with border reflection on every side (tests/test_pallas_warp.py:79)."""
    angle, scale = np.deg2rad(15.0), 0.9
    cos, sin = np.cos(angle) * scale, np.sin(angle) * scale
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    dx, dy = 0.0625 * w, -0.0625 * h
    return np.asarray([[[cos, sin, (1 - cos) * cx - sin * cy + dx],
                        [-sin, cos, sin * cx + (1 - cos) * cy + dy]]], np.float32)


def test_warp_random_affines_match_gather_and_pallas():
    images = _images(0, 3)
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    affines = np.stack([np.asarray(jax_augment._affine_matrix(k, H, W, FULL_CFG)) for k in keys])
    ours = _port(images, affines)
    np.testing.assert_allclose(ours, _gather(images, affines), atol=WARP_ATOL, rtol=0)
    np.testing.assert_allclose(ours, _pallas(images, affines), atol=WARP_ATOL, rtol=0)


def test_warp_extreme_affine_matches_gather_and_pallas():
    images = _images(2, 1)
    affines = _extreme_affine(H, W)
    ours = _port(images, affines)
    np.testing.assert_allclose(ours, _gather(images, affines), atol=WARP_ATOL, rtol=0)
    np.testing.assert_allclose(ours, _pallas(images, affines), atol=WARP_ATOL, rtol=0)


def test_warp_identity_is_exact():
    images = _images(1, 2)
    ident = np.broadcast_to(np.float32([[1, 0, 0], [0, 1, 0]]), (2, 2, 3)).copy()
    ours = _port(images, ident)
    np.testing.assert_array_equal(ours, images)
    np.testing.assert_array_equal(ours, _gather(images, ident))
    np.testing.assert_array_equal(ours, _pallas(images, ident))


def test_warp_multifold_affine_matches_gather():
    """Rotation 70 deg, scale 0.3 and shifts of 1.7 and 2.3 frame sizes:
    source coordinates fold two to three times."""
    images = _images(3, 2)
    apply = torch.ones(2, dtype=torch.bool)
    f = torch.ones(2)
    affines = augment.affine_matrices(apply, 70 * f, 0.3 * f, 1.7 * W * f, -2.3 * H * f, H, W)
    src = inverse_affines(affines)[0].reshape(2, 3).numpy() @ np.float32([[0, W - 1], [0, H - 1], [1, 1]])
    assert np.abs(src).max() > 2 * 2 * (W - 1)  # more than one fold
    ours = _port(images, affines.numpy())
    np.testing.assert_allclose(ours, _gather(images, affines.numpy()), atol=WARP_ATOL, rtol=0)


def test_warp_batch_on_cpu_is_the_plain_version():
    images = torch.from_numpy(_images(4, 2, 20, 30))
    affines = augment.sample_augment_params(torch.Generator().manual_seed(1), 2, 20, 30, FULL_CFG).affines
    assert torch.equal(warp_batch(images, affines), warp_batch_plain(images, affines))


def _fold_model(x, n):
    """numpy model of csrc/warp_kernel.cu's reflect101: fmod only where
    ``|x| >= m`` (elsewhere ``fmod(x, m) == x``), the floor-mod sign fix,
    ``|r|``, the reflection; every step rounded to f32."""
    x = np.asarray(x, np.float32)
    m = np.float32(2 * (n - 1))
    with np.errstate(invalid="ignore"):
        r = np.where(np.abs(x) < m, x, np.fmod(x, m)).astype(np.float32)
    r = np.where((r != 0) & (r < 0), r + m, r).astype(np.float32)
    r = np.abs(r)
    return np.where(r > np.float32(n - 1), m - r, r).astype(np.float32)


def _fold_inputs(n):
    m = np.float32(2 * (n - 1))
    below, above = np.nextafter(m, np.float32(0)), np.nextafter(m, np.float32(np.inf))
    special = [0.0, -0.0, m, -m, below, -below, above, -above, n - 1, np.nextafter(np.float32(n - 1), m),
               0.5, -0.5, -1e-30, -1e-45, 1e-45, 3 * m, -7 * m, 1e6 * m, -1e6 * m, 2.0**40 * m,
               1e30, -1e30, 3.4e38, -3.4e38, np.nan, -np.nan, np.inf, -np.inf]
    rng = np.random.RandomState(n)
    return np.concatenate([np.float32(special), rng.uniform(-3 * m, 3 * m, 500).astype(np.float32),
                           (rng.randint(-50, 50, 100) * m).astype(np.float32)])


def _same_bits(a, b):
    """Equal bit for bit, except that any NaN equals any NaN."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    return bool(np.array_equal(nan, np.isnan(b))
                and np.array_equal(a[~nan].view(np.int32), b[~nan].view(np.int32)))


@pytest.mark.parametrize("n", [2, 5, 53, 400])
def test_warp_fold_fast_path_is_exact(n):
    """The kernel's fold, which skips fmod where |x| < m, equals the port's
    plain ``_reflect101`` and JAX's ``augment._reflect101`` bit for bit,
    at -0.0, +-m, m less one ulp, large multiples of m, NaN and inf.  XLA's
    CPU backend treats subnormal inputs as zero (a subnormal -x folds to x
    there, to 0 in torch and CUDA), so JAX is held to the normal values."""
    x = _fold_inputs(n)
    ours = _fold_model(x, n)
    assert _same_bits(ours, warp_mod._reflect101(torch.from_numpy(x), n).numpy())
    normal = ~((x != 0) & (np.abs(x) < np.finfo(np.float32).tiny))
    assert (~normal).sum() == 2
    assert _same_bits(ours[normal], np.asarray(jax_augment._reflect101(jnp.asarray(x[normal]), n)))


@pytest.mark.parametrize("kind", ["random", "extreme"])
def test_augmentation_range_never_reaches_fmod(kind):
    """Within the augmentation's range every source coordinate of a 400x400
    frame lies inside (-m, m), so the kernel's fold never calls fmodf."""
    h = w = 400
    if kind == "random":
        cfg = augment.DEFAULT_AUGMENT._replace(p_shift_scale_rotate=1.0)
        affines = augment.sample_augment_params(torch.Generator().manual_seed(5), 64, h, w, cfg).affines
    else:
        affines = torch.from_numpy(_extreme_affine(h, w))
    inv = inverse_affines(affines).reshape(-1, 2, 3).numpy()
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    src = inv[:, :, 0, None, None] * xs + inv[:, :, 1, None, None] * ys + inv[:, :, 2, None, None]
    assert np.abs(src[:, 0]).max() < 2 * (w - 1) and np.abs(src[:, 1]).max() < 2 * (h - 1)


def _jax_draws(key, n, h, w, c, cfg):
    """Every draw of ``augment_batch(key, ...)`` for ``n`` images, with its
    own key splits (augment.py:42-95, :171-229)."""
    rows = []
    for k in jax.random.split(key, n):
        k_noise, k_bc, k_aff = jax.random.split(k, 3)
        a_apply, a_ang, a_sc, a_dx, a_dy = jax.random.split(k_aff, 5)
        b_apply, b_b, b_c = jax.random.split(k_bc, 3)
        n_apply, n_var, n_noise = jax.random.split(k_noise, 3)
        u = jax.random.uniform
        rows.append(dict(
            affine=np.asarray(jax_augment._affine_matrix(k_aff, h, w, cfg)),
            apply_affine=bool(jax.random.bernoulli(a_apply, cfg.p_shift_scale_rotate)),
            angle=float(u(a_ang, (), minval=-cfg.rotate_limit_deg, maxval=cfg.rotate_limit_deg)),
            scale=float(1.0 + u(a_sc, (), minval=-cfg.scale_limit, maxval=cfg.scale_limit)),
            dx=float(u(a_dx, (), minval=-cfg.shift_limit, maxval=cfg.shift_limit) * w),
            dy=float(u(a_dy, (), minval=-cfg.shift_limit, maxval=cfg.shift_limit) * h),
            apply_bc=bool(jax.random.bernoulli(b_apply, cfg.p_brightness_contrast)),
            alpha=float(1.0 + u(b_c, (), minval=-cfg.contrast_limit, maxval=cfg.contrast_limit)),
            beta=float(u(b_b, (), minval=-cfg.brightness_limit, maxval=cfg.brightness_limit)),
            apply_noise=bool(jax.random.bernoulli(n_apply, cfg.p_noise)),
            var=float(u(n_var, (), minval=cfg.gauss_noise_var_limit[0],
                        maxval=cfg.gauss_noise_var_limit[1])),
            noise=np.asarray(jax.random.normal(n_noise, (h, w, c))),
        ))
    return rows


@pytest.mark.parametrize("p", [0.5, 1.0])
def test_augment_with_injected_draws_matches_jax(p):
    cfg = jax_augment.AugmentConfig(p_noise=p, p_brightness_contrast=p, p_shift_scale_rotate=p)
    n = 6
    images = _images(5, n)
    kps = np.random.RandomState(6).uniform([0, 0], [W, H], (n, 7, 2)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref_images, ref_kps = jax_augment.augment_batch(
        key, jnp.asarray(images), jnp.asarray(kps), cfg, warp_backend="gather"
    )
    rows = _jax_draws(key, n, H, W, 3, cfg)
    col = {k: [r[k] for r in rows] for k in rows[0]}
    if p < 1.0:  # the draws exercise both branches of every transform
        for flag in ("apply_affine", "apply_bc", "apply_noise"):
            assert 0 < sum(col[flag]) < n, flag
    t = lambda v, dtype=torch.float32: torch.tensor(np.asarray(v), dtype=dtype)
    affines = augment.affine_matrices(
        t(col["apply_affine"], torch.bool), t(col["angle"]), t(col["scale"]), t(col["dx"]),
        t(col["dy"]), H, W,
    )
    np.testing.assert_allclose(affines.numpy(), np.stack(col["affine"]), atol=1e-4, rtol=1e-6)
    params = augment.AugmentParams(
        affines=affines, brightness_contrast=t(col["apply_bc"], torch.bool),
        alpha=t(col["alpha"]), beta=t(col["beta"]),
        noise=t(col["apply_noise"], torch.bool), noise_var=t(col["var"]),
    )
    out, out_kps = augment.apply_augment(
        torch.from_numpy(images), torch.from_numpy(kps), params, t(np.stack(col["noise"]))
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_images), atol=AUGMENT_ATOL, rtol=0)
    np.testing.assert_allclose(out_kps.numpy(), np.asarray(ref_kps), atol=KEYPOINT_ATOL, rtol=0)
    assert out.min() >= 0 and out.max() <= 255


def test_sampler_draws_within_bounds():
    cfg = augment.DEFAULT_AUGMENT
    n, h, w = 4000, 400, 400
    g = torch.Generator().manual_seed(0)
    params = augment.sample_augment_params(g, n, h, w, cfg)
    again = augment.sample_augment_params(torch.Generator().manual_seed(0), n, h, w, cfg)
    for a, b in zip(params, again):
        assert torch.equal(a, b)
    # Each flag is Bernoulli(0.5): 5 standard deviations of 4000 draws is ~158.
    sigma5 = 5 * math.sqrt(n * 0.25)
    a = params.affines.double()
    ident = torch.tensor([[1.0, 0, 0], [0, 1, 0]], dtype=torch.float64)
    applied = (a - ident).abs().amax(dim=(1, 2)) > 0
    for flag in (applied, params.brightness_contrast, params.noise):
        assert abs(int(flag.sum()) - n / 2) < sigma5
    scale = torch.sqrt(a[:, 0, 0] ** 2 + a[:, 0, 1] ** 2)
    angle = torch.rad2deg(torch.atan2(a[:, 0, 1], a[:, 0, 0]))
    cos, sin = a[:, 0, 0], a[:, 0, 1]
    cx, cy = (w - 1) / 2, (h - 1) / 2
    dx = a[:, 0, 2] - ((1 - cos) * cx - sin * cy)
    dy = a[:, 1, 2] - (sin * cx + (1 - cos) * cy)
    s = applied
    assert ((scale[s] >= 0.9 - 1e-6) & (scale[s] <= 1.1 + 1e-6)).all()
    assert (angle[s].abs() <= 15 + 1e-4).all() and angle[s].abs().max() > 14
    assert (dx[s].abs() <= 0.0625 * w + 1e-3).all() and (dy[s].abs() <= 0.0625 * h + 1e-3).all()
    assert dx[s].abs().max() > 0.06 * w
    assert ((params.alpha >= 0.8) & (params.alpha <= 1.2)).all()
    assert ((params.beta >= -0.2) & (params.beta <= 0.2)).all()
    assert ((params.noise_var >= 10) & (params.noise_var <= 50)).all()
    assert 29 < float(params.noise_var.mean()) < 31  # uniform on [10, 50]


def test_augment_batch_keeps_images_in_range_and_tracks_keypoints():
    images = torch.from_numpy(_images(7, 3, 40, 50))
    kps = torch.tensor([[[24.5, 19.5], [10.0, 5.0]]]).expand(3, 2, 2)
    g = torch.Generator().manual_seed(3)
    out, out_kps = augment.augment_batch(g, images, kps, augment.AugmentConfig(
        p_noise=1.0, p_brightness_contrast=1.0, p_shift_scale_rotate=1.0))
    assert out.shape == images.shape and out.dtype == torch.float32
    assert out.min() >= 0 and out.max() <= 255
    # The centre of rotation moves only by the shift: at most 6.25% of the frame.
    assert ((out_kps[:, 0] - kps[:, 0]).abs() <= torch.tensor([50 * 0.0625, 40 * 0.0625]) + 1e-3).all()
    with pytest.raises(ValueError):
        augment.apply_augment(images, kps, augment.sample_augment_params(g, 3, 40, 50), out,
                              warp_backend="pallas")


def test_batch_processor_matches_jax():
    rng = np.random.RandomState(8)
    raw = rng.randint(0, 256, (2, 96, 128, 3)).astype(np.uint8)
    # Inside the crop and 4 px from the map's border, so that every map is drawn.
    kps = rng.uniform([42, 26], [80, 64], (2, 7, 2)).astype(np.float32)
    norm = {"mean": [0.5, 0.5, 0.5], "stdev": [0.5, 0.5, 0.5]}
    args = ((128, 96), (64, 64), (16, 16), "shrink-and-crop", norm)
    ref = jax_make_batch_processor(*args, augment=False)(jax.random.PRNGKey(0), raw, kps)
    ours = make_batch_processor(*args, augment=False)(None, torch.from_numpy(raw), torch.from_numpy(kps))
    assert set(ours) == set(ref)
    assert ours["image_rgb_input"].shape == (2, 64, 64, 3)
    assert ours["belief_maps"].shape == (2, 7, 16, 16)
    assert float(ours["belief_maps"].amax(dim=(2, 3)).min()) > 0.5  # every key point is drawn
    np.testing.assert_allclose(ours["image_rgb_input"].numpy(), np.asarray(ref["image_rgb_input"]),
                               atol=1e-4, rtol=0)
    for key in ("keypoint_projections_input", "keypoint_projections_output"):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ours["belief_maps"].numpy(), np.asarray(ref["belief_maps"]),
                               atol=1e-5, rtol=0)
