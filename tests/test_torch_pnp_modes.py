"""The port's robust PnP modes against dream_tpu on the CPU.

Frames are random poses of the synthetic panda chain projected through the
synthetic camera with 1.5 px noise (``tests/test_torch_pnp_metrics.py``'s
frames), with gross outliers (a keypoint moved 40-90 px) and
missing keypoints (sentinels, NaN) injected by a seed.  The same arrays go
through ``dream_tpu.ops.geometric_vision`` (vmapped over frames) and the
port's batched solver:

- score-weighted ``solve_pnp`` and leave-one-out ``reject_outliers_px``
  (alone and weighted): the same ``valid``, and poses within the
  tolerances of ``tests/test_torch_pnp_metrics.py`` (1e-3 in m and in
  rotation entries, reprojection errors to 1e-3 relative);
- ``solve_pnp_ransac`` with dream_tpu's own hypothesis subsets
  (``jax.random.choice`` under each frame's key) passed in: the same
  ``valid``, the same consensus on most frames, and the same poses where
  the consensus and the final solve's minimum are shared (the test's
  docstring says why only there); marked ``slow``, since compiling
  dream_tpu's RANSAC alone takes ~10 s on a CPU;
- the unweighted call unchanged: bit-equal to the call with unit weights
  (it was bit-equal to the previous solver's output when weights came in);
- the frames the tests above leave out (:func:`_hard`: five-point frames,
  and frames with two gross outliers), where the two packages' poses part:
  the port's final weighted reprojection cost is held to at most (1 +
  1e-3) times the lower of two ``dream_tpu`` runs, jitted over the batch
  and jitted one frame at a time (op-by-op eager ``dream_tpu`` takes ~33 s
  to warm up and ~5 s a frame with rejection on a CPU); each frame where
  it is higher is named, with its cause checked (:data:`HARD_FRAMES_APART`).
"""

import contextlib
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dream_tpu.ops import geometric_vision as jgv

from dream_tpu_torch.ops import geometric_vision as tgv
from test_torch_pnp_metrics import K, _frames


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The solves run small tensors in long Python loops, where torch's idle
    intra-op threads spin for nothing: two threads take about half the CPU
    time of eight."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def reference_theta():
    """The port's Rodrigues formula with ``dream_tpu``'s angle ``|r| + eps``
    (``dream_tpu/ops/geometric_vision.py:49``), for the block."""
    port_rotation = tgv.rotation_matrix_from_axis_angle

    def rotation(rvec):
        theta = tgv._norm(rvec) + tgv._EPS
        K = tgv._skew(rvec / theta[..., None])
        return (tgv._eye(rvec) + torch.sin(theta)[..., None, None] * K
                + (1.0 - torch.cos(theta))[..., None, None] * (K @ K))

    tgv.rotation_matrix_from_axis_angle = rotation
    try:
        yield
    finally:
        tgv.rotation_matrix_from_axis_angle = port_rotation


def _corrupted(seed, n=12, outliers=True):
    """Noisy frames with missing keypoints (one each in frames 1-3, four in
    frame 4, which is then invalid) and, with ``outliers``, one gross
    outlier in each frame that has all seven; and score-like weights in
    [0.3, 1].

    The inputs are chosen where the answer is well posed: every valid frame
    keeps six good points.  With five, the weighted solve has two minima
    close in cost and dream_tpu's jitted batch can settle in the worse
    (seen: 7.4 px and a pose metres off where the port found 1.9 px); on a
    frame left with four or five points of which one is gross, or with two
    gross outliers, the poses the leave-one-out trips choose between differ
    in cost by a few percent, and which one wins depends on float32
    rounding: dream_tpu itself picks differently eagerly, jitted, and
    jitted over a vmapped batch (the port agreed with the eager and the
    vmapped-batch-of-one runs).  A solve that keeps a gross outlier (no
    rejection) is as ill-posed, so the weighted solve alone is held on
    frames without them."""
    X, uv = _frames(seed, n=n)
    rng = np.random.RandomState(100 + seed)
    missing = {1: [2], 2: [5], 3: [4], 4: [0, 1, 2, 3]}
    for i in range(n):
        good = [j for j in range(7) if j not in missing.get(i, [])]
        if outliers and len(good) == 7:
            uv[i, rng.choice(good)] += rng.choice([-1, 1], 2) * rng.uniform(40, 90, 2)
    for i, js in missing.items():
        uv[i, js] = -999.999
    uv[3, 4] = np.nan
    weights = rng.uniform(0.3, 1.0, (n, 7)).astype(np.float32)
    return X, uv.astype(np.float32), weights


def _assert_same(ours, ref, X, uv, label):
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(ours.valid.numpy(), valid, err_msg=label)
    np.testing.assert_allclose(ours.translation.numpy(), np.asarray(ref.translation), atol=1e-3,
                               err_msg=label)
    np.testing.assert_allclose(ours.rotation.numpy(), np.asarray(ref.rotation), atol=1e-3,
                               err_msg=label)
    np.testing.assert_allclose(ours.quaternion.numpy(), np.asarray(ref.quaternion), atol=1e-3,
                               err_msg=label)
    np.testing.assert_allclose(ours.reproj_error.numpy()[valid], np.asarray(ref.reproj_error)[valid],
                               rtol=1e-3, err_msg=label)


@functools.lru_cache(maxsize=None)
def _jax_solve():
    """dream_tpu's solve with rejection, the threshold traced: at an
    infinite threshold no point is ever dropped and the result is the solve
    without rejection, so one compilation serves both."""
    return jax.jit(jax.vmap(
        lambda X, uv, w, threshold: jgv.solve_pnp(X, uv, jnp.asarray(K), weights=w,
                                                  reject_outliers_px=threshold),
        in_axes=(0, 0, 0, None)))


@pytest.mark.parametrize("mode,seed", [("weighted", 0), ("reject", 0), ("reject", 1),
                                       ("weighted+reject", 1)])
def test_weighted_and_rejecting_solves_match_jax(mode, seed):
    X, uv, weights = _corrupted(seed, n=8, outliers="reject" in mode)
    w = weights if "weighted" in mode else np.ones_like(weights)
    reject = 10.0 if "reject" in mode else None
    ref = _jax_solve()(X, uv, w, np.float32(np.inf if reject is None else reject))
    ours = tgv.solve_pnp(torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(K),
                         weights=torch.from_numpy(w), reject_outliers_px=reject)
    assert not ours.valid[4] and int(ours.valid.sum()) == 7
    _assert_same(ours, ref, X, uv, mode)
    # Rejection moved the poses and weights moved them: the comparison is
    # neither the plain solve's nor the unweighted one's.
    other = tgv.solve_pnp(torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(K),
                          weights=None if reject is None else torch.from_numpy(w))
    assert float((other.translation - ours.translation).abs().max()) > 1e-4


@functools.lru_cache(maxsize=None)
def _jax_ransac():
    def subsets(uv, w, key):
        # dream_tpu's draws (geometric_vision.py:557-566), frame by frame.
        valid = jnp.all(jnp.isfinite(uv), 1) & jnp.all(uv > -999.0, 1)
        logits = jnp.where(valid.astype(jnp.float32) * w > 0, 0.0, -1e9)
        return jax.vmap(lambda k: jax.random.choice(k, 7, shape=(4,), replace=False,
                                                    p=jax.nn.softmax(logits)))(
            jax.random.split(key, 64))

    def run(X, uv, w, key):
        result, inliers = jgv.solve_pnp_ransac(X, uv, jnp.asarray(K), key=key, weights=w)
        return result, inliers, subsets(uv, w, key)

    return jax.jit(jax.vmap(run))


@pytest.mark.slow
@pytest.mark.parametrize("seed", [2, 5])
def test_ransac_with_jax_subsets_matches_jax(seed):
    """Each hypothesis solves a minimal four-point set, where EPnP's null
    space has four dimensions: its start, and so its 8-iteration pose and
    inlier count, depends on the eigensolver's choice of basis, and
    dream_tpu itself picks other consensus sets eagerly and jitted on the
    same key (seen on seed 2's first frame).  The final solve on a six-point
    consensus can also land in either of two minima within 1% in cost
    (seen: 1.429 against 1.436 px mean error, poses 0.02 m apart), in
    either package.  So the packages are held to the same ``valid`` on
    every frame, to the same consensus on at least four of the nine valid
    frames, each to the true inliers (within 5 px of the exact projection)
    on three frames or more, and to the same pose wherever they share the
    consensus and their final solves reach the same minimum (mean
    reprojection errors within 0.1%)."""
    n = 10
    X, uv, weights = _corrupted(seed, n=n)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    ref, ref_inliers, jax_subsets = _jax_ransac()(X, uv, weights, keys)
    ours, inliers = tgv.solve_pnp_ransac(
        torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(K),
        weights=torch.from_numpy(weights), subsets=torch.from_numpy(np.array(jax_subsets)))
    ref_inliers, inliers = np.asarray(ref_inliers), inliers.numpy()
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(ours.valid.numpy(), valid)
    assert not valid[4] and int(valid.sum()) == n - 1
    same = (inliers == ref_inliers).all(1) & valid
    assert same.sum() >= 4, (inliers, ref_inliers)
    proj = np.einsum("nkj,ij->nki", X, K)
    truth = np.linalg.norm(uv - proj[..., :2] / proj[..., 2:], axis=-1) < 5.0
    assert ((inliers == truth).all(1) & valid).sum() >= 3
    assert ((ref_inliers == truth).all(1) & valid).sum() >= 3
    err, ref_err = ours.reproj_error.numpy(), np.asarray(ref.reproj_error)
    keep = np.nonzero(same & (np.abs(err - ref_err) <= 1e-3 * ref_err))[0]
    assert len(keep) >= 3, (same, err, ref_err)
    for name in ("translation", "rotation", "quaternion"):
        np.testing.assert_allclose(getattr(ours, name).numpy()[keep],
                                   np.asarray(getattr(ref, name))[keep], atol=1e-3, err_msg=name)


def test_ransac_subsets_draw_distinct_valid_points():
    valid = torch.ones(3, 7, dtype=torch.bool)
    valid[1, :2] = False
    valid[2, :5] = False  # two valid points: the rest of the draw is invalid ones
    g = torch.Generator().manual_seed(1)
    draw = tgv.ransac_subsets(valid, 64, g)
    assert draw.shape == (3, 64, 4)
    assert all(len(set(row.tolist())) == 4 for row in draw.reshape(-1, 4))
    assert bool((draw[1] >= 2).all())
    assert all({5, 6} <= set(row.tolist()) for row in draw[2])
    assert torch.equal(draw, tgv.ransac_subsets(valid, 64, torch.Generator().manual_seed(1)))
    X, uv, weights = _corrupted(3, n=6)
    g = torch.Generator().manual_seed(0)
    result, _ = tgv.solve_pnp_ransac(torch.from_numpy(X), torch.from_numpy(uv),
                                     torch.from_numpy(K), generator=g, n_hypotheses=16)
    assert result.valid.tolist() == [True, True, True, True, False, True]


def test_unweighted_call_is_unchanged():
    X, uv, _ = _corrupted(4, n=6)
    args = (torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(K))
    plain = tgv.solve_pnp(*args)
    unit = tgv.solve_pnp(*args, weights=torch.ones(X.shape[:2]))
    for a, b in zip(plain, unit):
        assert torch.equal(a, b)


def _hard(seed, n=8):
    """Frames with two points missing (even frames: five left, of which
    frames 2 and 6 hold one gross outlier) or with two gross outliers among
    all seven (odd frames), and score-like weights in [0.3, 1]."""
    X, uv = _frames(seed, n=n)
    rng = np.random.RandomState(200 + seed)
    for i in range(n):
        if i % 2 == 0:
            missing = rng.choice(7, 2, replace=False)
            good = [j for j in range(7) if j not in missing]
            if i in (2, 6):
                uv[i, rng.choice(good)] += rng.choice([-1, 1], 2) * rng.uniform(40, 90, 2)
            uv[i, missing] = -999.999
        else:
            for j in rng.choice(7, 2, replace=False):
                uv[i, j] += rng.choice([-1, 1], 2) * rng.uniform(40, 90, 2)
    return X, uv.astype(np.float32), rng.uniform(0.3, 1.0, (n, 7)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_solve_one():
    """dream_tpu's solve jitted for one frame: another compiled program than
    :func:`_jax_solve`'s batch, and so other float32 rounding."""
    return jax.jit(lambda X, uv, w, threshold: jgv.solve_pnp(X, uv, jnp.asarray(K), weights=w,
                                                             reject_outliers_px=threshold))


def _final_cost(R, t, reproj_error, X, uv, w):
    """The weighted reprojection cost (sum of ``(w e)^2``, e in px) of a
    frame's pose over the points its solve kept: the valid points less those
    the rejection dropped, found as the subset (up to three dropped, four or
    more kept) whose mean pixel error is the solve's reported one."""
    cam = X.astype(np.float64) @ np.asarray(R, np.float64).T + np.asarray(t, np.float64)
    p = cam @ K.T.astype(np.float64)
    e = np.linalg.norm(p[:, :2] / p[:, 2:] - uv, axis=1)
    valid = [j for j in range(7) if uv[j, 0] > -999]
    kept = min((s for d in range(4) for s in itertools.combinations(valid, len(valid) - d) if len(s) >= 4),
               key=lambda s: abs(e[list(s)].mean() - reproj_error))
    kept = list(kept)
    assert abs(e[kept].mean() - reproj_error) <= 1e-4 * reproj_error
    return float(np.sum((w[kept] * e[kept]) ** 2))


_FACTOR = 1.0 + 1e-3
# (mode, seed, frame) where the port's final cost exceeds _FACTOR times the
# lower of dream_tpu's two runs, and why:
# - "front starts": the port's departure (moving front starts) lets its
#   leave-one-out solves reach lower least-squares minima, and the trips
#   then drop another point; with dream_tpu's angle patched in, the port
#   meets the bound;
# - "rounding": the frame is ill-posed, and dream_tpu's own runs with the
#   detections moved by one float32 ulp spread beyond the port's cost.
HARD_FRAMES_APART = {("reject", 0, 5): "front starts", ("weighted+reject", 2, 7): "rounding"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hard_frames_hold_the_final_cost(seed):
    X, uv, weights = _hard(seed)
    apart = set()
    for mode in ("weighted", "reject", "weighted+reject"):
        w = weights if "weighted" in mode else np.ones_like(weights)
        reject = 10.0 if "reject" in mode else None
        threshold = np.float32(np.inf if reject is None else reject)
        args = (torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(K))
        ours = tgv.solve_pnp(*args, weights=torch.from_numpy(w), reject_outliers_px=reject)
        batch = _jax_solve()(X, uv, w, threshold)
        # Weighted alone, the frames that keep a gross outlier are ill-posed.
        for i in ([0, 4] if reject is None else range(8)):
            one = _jax_solve_one()(X[i], uv[i], w[i], threshold)
            ref = [_final_cost(r.rotation, r.translation, float(r.reproj_error), X[i], uv[i], w[i])
                   for r in (jax.tree_util.tree_map(lambda a: a[i], batch), one)]
            cost = _final_cost(ours.rotation[i].numpy(), ours.translation[i].numpy(),
                               float(ours.reproj_error[i]), X[i], uv[i], w[i])
            bound = _FACTOR * (max(ref) if max(ref) > _FACTOR * min(ref) else min(ref))
            key = (mode, seed, i)
            if cost <= bound:
                continue
            apart.add(key)
            cause = HARD_FRAMES_APART.get(key)
            if cause == "front starts":
                with reference_theta():
                    patched = tgv.solve_pnp(*args, weights=torch.from_numpy(w), reject_outliers_px=reject)
                assert _final_cost(patched.rotation[i].numpy(), patched.translation[i].numpy(),
                                   float(patched.reproj_error[i]), X[i], uv[i], w[i]) <= bound, key
            elif cause == "rounding":
                spread = []
                for direction in (np.inf, -np.inf):
                    moved = np.where(uv > -999, np.nextafter(uv, np.float32(direction)), uv)
                    r = jax.tree_util.tree_map(lambda a: a[i], _jax_solve()(X, moved, w, threshold))
                    spread.append(_final_cost(r.rotation, r.translation, float(r.reproj_error), X[i], uv[i],
                                              w[i]))
                assert cost <= _FACTOR * max(spread), (key, cost, ref, spread)
    assert apart == {k for k in HARD_FRAMES_APART if k[1] == seed}
