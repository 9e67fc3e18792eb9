"""Where the port's RANSAC PnP parts from dream_tpu's, on the CPU.

At holdout scale (``scripts/compare_ransac_holdout.py``, 20 seeds on the
committed vgg-Q r5 detections) the port's ADD AUC sits above
``dream_tpu``'s.  Patching ``dream_tpu``'s Rodrigues angle into the port
takes most of the gap away; what is left lies inside ``dream_tpu``'s own
spread when its detections move by one float32 ulp.  The two causes are
pinned here on ``tests/test_torch_pnp_modes.py``'s frames (1.5 px noise,
missing keypoints, one gross outlier):

- The refit on the best consensus (``solve_pnp`` on the inliers, in both
  packages) takes the port's front-start departure (ROADMAP.md section 3):
  ``theta = sqrt(|r|^2 + eps^2)`` where ``dream_tpu`` takes ``|r| + eps``.
  On a consensus of five or six points (each frame's points within 5 px of
  the exact projection; seeds 6 and 7) the port's refit equals
  ``dream_tpu``'s pose (1e-3 m, the PnP tests' pose tolerance) with either
  angle.  On a four-point consensus a front start can win: on the two of
  :data:`FRONT_START_CONSENSUS` (the sets ``dream_tpu``'s RANSAC chose
  there, key 0) the port's refit reaches a lower reprojection error than
  ``dream_tpu``'s, and with ``dream_tpu``'s angle (patched in the test, not
  in the package) it lands on ``dream_tpu``'s pose.
- A hypothesis is a four-point subset: EPnP's 12 unknowns get 8 equations,
  so its normal matrix has a four-dimensional null space (four
  eigenvalues below 1e-6 of the largest, the fifth above 1e-4), and its
  start is whatever basis float32 rounding makes the eigensolver return.
  Moving the detections by one float32 ulp moves ``dream_tpu``'s own EPnP
  start on nearly every hypothesis (seed 2, 640 subsets), and the port's
  start differs from ``dream_tpu``'s on nearly every one.  So each
  package's hypotheses, and the consensus they vote for, are drawn anew by
  its rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dream_tpu.ops import geometric_vision as jgv

from dream_tpu_torch.ops import geometric_vision as tgv
from test_torch_pnp_modes import K, _corrupted, reference_theta

# (seed, frame) -> a four-point consensus whose refit a moving front start wins.
FRONT_START_CONSENSUS = {(6, 8): [1, 2, 3, 4], (7, 0): [0, 1, 2, 6]}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_solve(X, uv, w, **kwargs):
    solve = jax.jit(jax.vmap(lambda X, uv, w: jgv.solve_pnp(X, uv, jnp.asarray(K), weights=w, **kwargs)))
    return solve(X, uv, w)


def _port_solve(X, uv, w, **kwargs):
    return tgv.solve_pnp(torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(K),
                         weights=torch.from_numpy(w), **kwargs)


def test_refit_on_a_consensus():
    frames = [_corrupted(seed, n=10)[:2] for seed in (6, 7)]
    X = np.concatenate([f[0] for f in frames])
    uv = np.concatenate([f[1] for f in frames])
    proj = np.einsum("nkj,ij->nki", X, K)
    consensus = ((np.linalg.norm(uv - proj[..., :2] / proj[..., 2:], axis=-1) < 5.0)
                 & (uv > -999).all(-1)).astype(np.float32)
    assert set(consensus.sum(1)) == {3.0, 5.0, 6.0}  # a frame of three points fails in both
    special = []
    for (seed, frame), points in FRONT_START_CONSENSUS.items():
        X_f, uv_f = _corrupted(seed, n=10)[:2]
        special.append((X_f[frame], uv_f[frame], np.isin(np.arange(7), points).astype(np.float32)))
    X = np.concatenate([X, np.stack([s[0] for s in special])])
    uv = np.concatenate([uv, np.stack([s[1] for s in special])])
    w = np.concatenate([consensus, np.stack([s[2] for s in special])])
    ref = _jax_solve(X, uv, w)
    ours = _port_solve(X, uv, w)
    with reference_theta():
        patched = _port_solve(X, uv, w)
    ref_valid, ref_t, ref_err = np.asarray(ref.valid), np.asarray(ref.translation), np.asarray(ref.reproj_error)
    n = len(consensus)
    np.testing.assert_array_equal(ours.valid.numpy(), ref_valid)
    shared = np.nonzero(ref_valid[:n])[0]
    assert len(shared) == 18
    for result in (ours, patched):
        np.testing.assert_allclose(result.translation.numpy()[shared], ref_t[shared], atol=1e-3)
    for i in range(n, len(w)):
        assert float(ours.reproj_error[i]) < ref_err[i] / 1.1, (ours.reproj_error[i], ref_err[i])
        np.testing.assert_allclose(patched.translation[i].numpy(), ref_t[i], atol=1e-3)


def test_minimal_hypotheses_start_from_rounding():
    X, uv = _corrupted(2, n=10)[:2]
    valid = (uv > -999).all(-1) & np.isfinite(uv).all(-1)
    subsets = tgv.ransac_subsets(torch.from_numpy(valid), 64, torch.Generator().manual_seed(0)).numpy()
    pick = np.zeros(subsets.shape[:2] + (7,), np.float32)
    np.put_along_axis(pick, subsets, 1.0, axis=-1)
    w = (pick * valid[:, None]).reshape(-1, 7)
    X, uv = np.repeat(X, 64, 0), np.repeat(uv, 64, 0)
    four = w.sum(1) == 4

    # The null space of a four-point hypothesis's normal matrix.
    Xt, uvt, wt = (torch.from_numpy(a[four]) for a in (X, uv, w))
    uv_norm = torch.stack([(uvt[..., 0] - K[0, 2]) / K[0, 0], (uvt[..., 1] - K[1, 2]) / K[1, 1]], -1)
    uv_norm = torch.where(wt[..., None] > 0, uv_norm, torch.zeros(()))
    Xs = torch.where(wt[..., None] > 0, Xt, torch.zeros(()))
    C = tgv._control_points(Xs, wt)
    eigenvalues = torch.linalg.eigvalsh(tgv._build_MtM(tgv._barycentric(Xs, C), uv_norm, wt).double())
    assert bool((eigenvalues[:, 3] < 1e-6 * eigenvalues[:, -1]).all())
    assert bool((eigenvalues[:, 4] > 1e-4 * eigenvalues[:, -1]).all())

    ref = _jax_solve(X, uv, w, refinement=False)
    moved = _jax_solve(X, np.where(uv > -999, np.nextafter(uv, np.float32(-np.inf)), uv), w, refinement=False)
    ours = _port_solve(X, uv, w, refinement=False)
    both = four & np.asarray(ref.valid) & np.asarray(moved.valid) & ours.valid.numpy()
    assert both.sum() >= 500

    def share(a, b):
        return float(np.mean(np.abs(np.asarray(a) - np.asarray(b)).max(-1)[both] < 1e-3))

    assert share(moved.translation, ref.translation) < 0.05
    assert share(ours.translation.numpy(), ref.translation) < 0.05
