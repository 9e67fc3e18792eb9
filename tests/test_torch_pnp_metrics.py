"""Port PnP, pose utilities and metrics against dream_tpu on the CPU.

Frames are random poses of the synthetic panda chain, projected through the
synthetic camera with pixel noise; the same numpy arrays go through
``dream_tpu.ops.geometric_vision`` (vmapped over frames) and the port's
batched solver.  Both run float32 EPnP + 7-start Levenberg-Marquardt and
converge to the same minimum; they differ only in the order of float32
sums and in eigh/svd implementations.  Both stop after a fixed 20 steps, and
the float32 solve resolves a pose only to ~1e-4 m along the weakly
constrained depth direction (dream_tpu itself lands 1.1e-4 m off the exact
pose of a noise-free frame), so poses are held to 1e-3 (m, and rotation
entries), reprojection errors to 1e-3 relative.

The oracle is dream_tpu's solver as it ships.  The port departs from it on
purpose in one line (ROADMAP, "Departures made on purpose"): dream_tpu's
Rodrigues formula takes ``theta = |r| + eps``, whose Jacobian is NaN at
``r = 0``, so its four front-facing Gauss-Newton starts (the identity and
three 180-degree flips, all ``r = 0``) never move, and an unmoved start can
win.  The port's ``theta = sqrt(|r|^2 + eps^2)`` equals it in float32
wherever ``|r| >= 1e-15`` and has a finite Jacobian.  Of these frames, one
is such a frame (:data:`FRONT_START_WINS`): the parity test holds the port
to dream_tpu on every other frame, and
:func:`test_solve_pnp_moves_the_front_starts` shows the departure there.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dream_tpu import analysis as janalysis
from dream_tpu.data.synthetic import chain_points
from dream_tpu.ops import geometric_vision as jgv

from dream_tpu_torch import analysis as tanalysis
from dream_tpu_torch.ops import geometric_vision as tgv

K = np.array([[614.4, 0.0, 320.0], [0.0, 614.4, 240.0], [0.0, 0.0, 1.0]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small tensors, where torch's idle intra-op threads spin for nothing
    and slow the other test workers: two threads take less CPU time than
    the machine's count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _random_rotations(rng, n):
    axes = rng.randn(n, 3)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = rng.uniform(0.0, 2.0 * np.pi, n)
    return (axes * angles[:, None]).astype(np.float32)


def _frames(seed, n=10, noise_px=1.5):
    rng = np.random.RandomState(seed)
    chain = chain_points(7)
    rvecs = _random_rotations(rng, n)
    R = np.asarray(jax.vmap(jgv.rotation_matrix_from_axis_angle)(rvecs), dtype=np.float64)
    t = np.stack(
        [rng.uniform(-0.25, 0.25, n), rng.uniform(-0.2, 0.2, n), rng.uniform(1.2, 2.6, n)], 1
    )
    X = np.einsum("nij,kj->nki", R, chain - chain.mean(0)) + t[:, None]
    proj = X @ K.T
    uv = proj[..., :2] / proj[..., 2:] + rng.randn(n, 7, 2) * noise_px
    return X.astype(np.float32), uv.astype(np.float32)


# Frames of ``_frames(seed)`` where one of dream_tpu's unmoved front starts
# wins: seed 0's third frame, whose true pose is the identity, gets
# t = (-1.78, -1.84, 1.90) m from dream_tpu.
FRONT_START_WINS = {0: [2], 1: []}


@functools.lru_cache(maxsize=None)
def _jax_solve():
    return jax.jit(jax.vmap(lambda X, uv: jgv.solve_pnp(X, uv, jnp.asarray(K))))


def _parity_frames(seed):
    X, uv = _frames(seed)
    uv[1, :4] = -999.999  # 3 valid correspondences: invalid frame
    uv[2, 0] = -999.999
    uv[3, 5] = np.nan
    return X, uv


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_pnp_matches_jax(seed):
    X, uv = _parity_frames(seed)
    ref = _jax_solve()(X, uv)
    ours = tgv.solve_pnp(torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(K))
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    assert not ours.valid[1]
    held = np.setdiff1d(np.arange(len(X)), FRONT_START_WINS[seed])
    np.testing.assert_allclose(ours.translation.numpy()[held], np.asarray(ref.translation)[held], atol=1e-3)
    np.testing.assert_allclose(ours.rotation.numpy()[held], np.asarray(ref.rotation)[held], atol=1e-3)
    np.testing.assert_allclose(ours.quaternion.numpy()[held], np.asarray(ref.quaternion)[held], atol=1e-3)
    valid = np.asarray(ref.valid)
    valid_held = valid[held]
    np.testing.assert_allclose(
        ours.reproj_error.numpy()[held][valid_held], np.asarray(ref.reproj_error)[held][valid_held],
        rtol=1e-3,
    )
    for convention in ("standard", "transposed"):
        mask = (uv[..., 0] > -999.0).astype(np.float32)
        ref_add = jax.vmap(functools.partial(jgv.add_from_pose, rotation_convention=convention))(
            ref.translation, ref.quaternion, jnp.asarray(X), jnp.asarray(mask)
        )
        ours_add = tgv.add_from_pose(
            ours.translation, ours.quaternion, torch.from_numpy(X), torch.from_numpy(mask),
            rotation_convention=convention,
        )
        np.testing.assert_allclose(ours_add.numpy()[held], np.asarray(ref_add)[held], atol=1e-3)


def test_solve_pnp_moves_the_front_starts():
    """The port's one departure from dream_tpu's PnP: where dream_tpu's
    unmoved front start wins (a pose far from the true identity), the port's
    front starts move, and it lands near the identity with a lower
    reprojection error."""
    X, uv = _parity_frames(0)
    ref = _jax_solve()(X, uv)
    ours = tgv.solve_pnp(torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(K))
    for i in FRONT_START_WINS[0]:
        assert bool(ref.valid[i]) and bool(ours.valid[i])
        assert np.linalg.norm(np.asarray(ref.translation[i])) > 1.0
        assert np.linalg.norm(ours.translation.numpy()[i]) < 0.2
        assert float(ours.reproj_error[i]) < float(ref.reproj_error[i])


def test_solve_pnp_recovers_exact_pose_and_handles_no_points():
    X, uv = _frames(2, n=4, noise_px=0.0)
    uv[3] = -999.999  # no valid correspondence at all
    ours = tgv.solve_pnp(torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(K))
    # X is already in the camera frame, so the true pose is the identity.
    assert ours.valid.tolist() == [True, True, True, False]
    np.testing.assert_allclose(ours.translation.numpy()[:3], 0.0, atol=1e-3)
    np.testing.assert_allclose(ours.rotation.numpy()[:3], np.broadcast_to(np.eye(3), (3, 3, 3)), atol=1e-3)
    assert ours.reproj_error[3] == float("inf")


def test_rotation_utilities_match_jax():
    rng = np.random.RandomState(3)
    rvecs = np.concatenate([_random_rotations(rng, 64), np.zeros((1, 3), np.float32)])
    ours_R = tgv.rotation_matrix_from_axis_angle(torch.from_numpy(rvecs))
    ref_R = jax.vmap(jgv.rotation_matrix_from_axis_angle)(rvecs)
    np.testing.assert_allclose(ours_R.numpy(), np.asarray(ref_R), atol=1e-5)
    ours_q = tgv.quaternion_from_rotation_matrix(ours_R)
    ref_q = jax.vmap(jgv.quaternion_from_rotation_matrix)(ref_R)
    np.testing.assert_allclose(ours_q.numpy(), np.asarray(ref_q), atol=1e-5)
    np.testing.assert_allclose(
        tgv.rotation_matrix_from_quaternion(ours_q).numpy(),
        np.asarray(jax.vmap(jgv.rotation_matrix_from_quaternion)(ref_q)), atol=1e-5,
    )
    np.testing.assert_allclose(
        tgv.axis_angle_from_rotation_matrix(ours_R).numpy(),
        np.asarray(jax.vmap(jgv.axis_angle_from_rotation_matrix)(ref_R)), atol=1e-4,
    )
    np.testing.assert_allclose(
        tgv.convert_rvec_to_quaternion(torch.from_numpy(rvecs)).numpy(),
        np.asarray(jax.vmap(jgv.convert_rvec_to_quaternion)(rvecs)), atol=1e-5,
    )
    pts = np.random.RandomState(4).uniform([-1, -1, 1], [1, 1, 3], (9, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgv.point_projection_from_3d(torch.from_numpy(K), torch.from_numpy(pts)).numpy(),
        np.asarray(jgv.point_projection_from_3d(K, pts)), rtol=1e-5,
    )


def test_keypoint_metrics_match_jax():
    rng = np.random.RandomState(0)
    gt = rng.uniform(-40, 680, size=(700, 2))
    det = gt + rng.randn(700, 2) * 4.0
    det[::9] = [-999.999, -999.999]
    assert tanalysis.keypoint_metrics(det, gt, (640, 480)) == \
        janalysis.keypoint_metrics(det, gt, (640, 480))


@pytest.mark.parametrize(
    "adds,n_inframe",
    [
        ([0.01, 0.02, 0.05, 0.2, -999.99, -999.99], [7, 7, 6, 5, 4, 3]),
        ([-999.99, -999.99], [2, 3]),
    ],
)
def test_pnp_metrics_match_jax(adds, n_inframe):
    ours = tanalysis.pnp_metrics(adds, n_inframe)
    ref = janalysis.pnp_metrics(adds, n_inframe)
    assert ours.keys() == ref.keys()
    for key in ref:
        np.testing.assert_equal(ours[key], ref[key], err_msg=key)
