"""Batched Perspective-n-Point pose solving and pose-error metrics in torch.

Port of ``dream_tpu/ops/geometric_vision.py``: an EPnP initializer (beta
cases 1 and 2) followed by multi-start damped Gauss-Newton
(Levenberg-Marquardt) refinement of the 6-DoF pose on the reprojection
residuals (``_solve_core`` at ``:278-369``, entry ``:372``), with its
options: per-correspondence weights, single-start or no refinement,
leave-one-out outlier rejection (``:446-502``), and RANSAC
(:func:`solve_pnp_ransac`, ``:525-603``).  Every function takes a leading
batch of frames: the JAX package vmaps over frames, here the batch
dimension is written out, and the leave-one-out candidates and RANSAC's
hypotheses join the frames in one batch dimension.

Invalid or missing correspondences carry a 0 weight (sentinel ``<= -999``
and non-finite projections are invalidated automatically); failure is data:
``valid`` is False and the pose is zeroed.  Quaternions are XYZW.

The solve runs in float32 with full-precision matmuls: reduced-precision
(TF32/bf16) matmuls wreck the conditioning of the EPnP normal matrix
(COMPONENTS.md:54), so :func:`solve_pnp` pins "highest" float32 matmul
precision while it runs.  Norms are written as ``sqrt(sum(x * x))`` as jax
writes them, except the rotation angle of
:func:`rotation_matrix_from_axis_angle`, whose Jacobian is finite at a zero
rotation so that the multi-start search's front-facing starts move (in
``dream_tpu`` they never do; ROADMAP.md section 3).

torch's forward-mode AD levels (the Gauss-Newton Jacobian's ``jvp``) and
the float32 matmul precision are process-wide, not per thread: solves on
two threads at once (the pose server's request handlers) corrupt each
other's levels, so :func:`solve_pnp` runs one solve at a time.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import torch
from torch.func import jvp

_EPS = 1e-12
_SOLVE_LOCK = threading.Lock()  # see the module docstring


class PnPResult(NamedTuple):
    valid: torch.Tensor  # bool [B]
    translation: torch.Tensor  # [B, 3]
    quaternion: torch.Tensor  # [B, 4] XYZW
    rotation: torch.Tensor  # [B, 3, 3]
    reproj_error: torch.Tensor  # [B] mean reprojection error (px)


def _norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=dim))


def _eye(like: torch.Tensor, n: int = 3) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _finite_batch(A: torch.Tensor):
    """``(A with non-finite matrices replaced by I, mask of those matrices)``.

    jax's eigh/svd let NaN through to a NaN result (a frame that then comes
    out invalid); torch's raise on non-finite input instead.  The helpers
    below decompose a stand-in and give those frames NaN, as jax would.
    """
    bad = ~torch.isfinite(A).flatten(1).all(-1)
    eye = _eye(A, A.shape[-1]).expand_as(A)
    return torch.where(bad[:, None, None], eye, A), bad[:, None, None]


def _eigh(A: torch.Tensor):
    A, bad = _finite_batch(A)
    lam, V = torch.linalg.eigh(A)
    return torch.where(bad[..., 0], float("nan"), lam), torch.where(bad, float("nan"), V)


def _svd(A: torch.Tensor):
    A, bad = _finite_batch(A)
    U, S, Vt = torch.linalg.svd(A)
    nan = float("nan")
    return torch.where(bad, nan, U), torch.where(bad[..., 0], nan, S), torch.where(bad, nan, Vt)


# -----------------------------------------------------------------------------
# Rotation utilities, over any leading dims
# -----------------------------------------------------------------------------


def _skew(k: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(k[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -k[..., 2], k[..., 1]], dim=-1),
            torch.stack([k[..., 2], zero, -k[..., 0]], dim=-1),
            torch.stack([-k[..., 1], k[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def rotation_matrix_from_axis_angle(rvec: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula ``[..., 3] -> [..., 3, 3]``; safe at theta -> 0.

    ``theta`` is ``sqrt(|r|^2 + eps^2)``, which equals ``dream_tpu``'s
    ``|r| + eps`` in float32 wherever ``|r|`` is not below 1e-15, and whose
    derivative at ``r = 0`` is finite: ``|r| + eps`` has a NaN Jacobian there,
    so a Gauss-Newton start at the identity rotation (or at a 180-degree
    flip, whose axis-angle is 0 too) never moved (``dream_tpu`` has the same
    fault; ROADMAP.md section 3)."""
    theta = torch.sqrt(torch.sum(rvec * rvec, dim=-1) + _EPS * _EPS)
    K = _skew(rvec / theta[..., None])
    s = torch.sin(theta)[..., None, None]
    c = torch.cos(theta)[..., None, None]
    return _eye(rvec) + s * K + (1.0 - c) * (K @ K)


def axis_angle_from_rotation_matrix(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues ``[..., 3, 3] -> [..., 3]``; safe near identity."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
    axis_raw = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    axis = axis_raw / (_norm(axis_raw)[..., None] + _EPS)
    return axis * theta[..., None]


def quaternion_from_rotation_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``[..., 3, 3]`` -> unit quaternion ``[..., 4]`` (XYZW).

    Shepperd's method: all four constructions, the numerically best picked.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(v):
        return torch.sqrt(torch.clamp(v, min=_EPS)) * 2.0

    s = root(tr + 1.0)
    cand_w = torch.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s], -1)
    s = root(1.0 + m00 - m11 - m22)
    cand_x = torch.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s], -1)
    s = root(1.0 + m11 - m00 - m22)
    cand_y = torch.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s], -1)
    s = root(1.0 + m22 - m00 - m11)
    cand_z = torch.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s], -1)

    use_w = (tr > 0.0)[..., None]
    use_x = ((m00 >= m11) & (m00 >= m22))[..., None]
    use_y = (m11 >= m22)[..., None]
    q = torch.where(use_w, cand_w, torch.where(use_x, cand_x, torch.where(use_y, cand_y, cand_z)))
    return q / (_norm(q)[..., None] + _EPS)


def rotation_matrix_from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion ``[..., 4]`` (XYZW) -> rotation matrix ``[..., 3, 3]``."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def convert_rvec_to_quaternion(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> XYZW quaternion (reference dream/geometric_vision.py:12-22)."""
    return quaternion_from_rotation_matrix(rotation_matrix_from_axis_angle(rvec))


def hnormalized(v: torch.Tensor) -> torch.Tensor:
    return (v / v[..., -1:])[..., :-1]


def point_projection_from_3d(camera_K: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Project ``[..., N, 3]`` camera-frame points through K -> ``[..., N, 2]``."""
    return hnormalized(points @ camera_K.transpose(-1, -2))


# -----------------------------------------------------------------------------
# EPnP initializer, batched over frames: X [B, N, 3], uv [B, N, 2], w [B, N]
# -----------------------------------------------------------------------------

_PAIR_I = (0, 0, 0, 1, 1, 2)
_PAIR_J = (1, 2, 3, 2, 3, 3)


def _control_points(X, w):
    """Weighted centroid + principal-axis control points ``[B, 4, 3]``."""
    n = torch.sum(w, -1) + _EPS
    c0 = torch.sum(X * w[..., None], -2) / n[..., None]
    Xd = X - c0[:, None]
    cov = (Xd * w[..., None]).transpose(-1, -2) @ Xd / n[:, None, None]
    lam, V = _eigh(cov)  # ascending
    s = torch.sqrt(torch.clamp(lam, min=1e-8))
    ctrl = c0[:, None] + s[..., None] * V.transpose(-1, -2)
    return torch.cat([c0[:, None], ctrl], dim=-2)


def _barycentric(X, C):
    """alphas ``[B, N, 4]`` with ``X = alphas @ C`` and rows summing to 1."""
    B, N = X.shape[0], X.shape[1]
    Ct = torch.cat([C.transpose(-1, -2), torch.ones(B, 1, 4, dtype=X.dtype, device=X.device)], -2)
    Xt = torch.cat([X.transpose(-1, -2), torch.ones(B, 1, N, dtype=X.dtype, device=X.device)], -2)
    alphas, _ = torch.linalg.solve_ex(Ct, Xt)
    return alphas.transpose(-1, -2)


def _build_MtM(alphas, uv_norm, w):
    """12x12 normal matrix of the weighted EPnP M matrix, ``[B, 12, 12]``."""
    B, N = alphas.shape[0], alphas.shape[1]
    u = uv_norm[..., 0:1]
    v = uv_norm[..., 1:2]
    zeros = torch.zeros_like(alphas)
    rx = torch.stack([alphas, zeros, -alphas * u], -1).reshape(B, N, 12)
    ry = torch.stack([zeros, alphas, -alphas * v], -1).reshape(B, N, 12)
    M = torch.cat([rx * w[..., None], ry * w[..., None]], dim=-2)
    return M.transpose(-1, -2) @ M


def _pairwise_dists(P):
    return P[:, _PAIR_I] - P[:, _PAIR_J]  # [B, 6, 3]


def _kabsch(X, Y, w):
    """Weighted rigid alignment: R, t with ``Y ~= R X + t``."""
    n = (torch.sum(w, -1) + _EPS)[:, None]
    Xc = torch.sum(X * w[..., None], -2) / n
    Yc = torch.sum(Y * w[..., None], -2) / n
    H = ((X - Xc[:, None]) * w[..., None]).transpose(-1, -2) @ (Y - Yc[:, None])
    U, _, Vt = _svd(H)
    d = torch.linalg.det(Vt.transpose(-1, -2) @ U.transpose(-1, -2))
    ones = torch.ones_like(d)
    D = torch.diag_embed(torch.stack([ones, ones, d], -1))
    R = Vt.transpose(-1, -2) @ D @ U.transpose(-1, -2)
    t = Yc - (R @ Xc[..., None])[..., 0]
    return R, t


def _epnp_candidate(vs, C, alphas, X, w):
    """A ``[B, 12]`` null-space combination -> (R, t) via scale + Kabsch."""
    vctrl = vs.reshape(-1, 4, 3)
    ndv = _norm(_pairwise_dists(vctrl))
    ndc = _norm(_pairwise_dists(C))
    beta = torch.sum(ndv * ndc, -1) / (torch.sum(ndv * ndv, -1) + _EPS)
    Xcam = alphas @ (beta[:, None, None] * vctrl)
    # Cheirality: points must lie in front of the camera.
    mean_z = torch.sum(Xcam[..., 2] * w, -1) / (torch.sum(w, -1) + _EPS)
    Xcam = torch.where((mean_z < 0)[:, None, None], -Xcam, Xcam)
    return _kabsch(X, Xcam, w)


def _reproj_residuals(R, t, X, uv_norm, w):
    Xc = X @ R.transpose(-1, -2) + t[:, None]
    z = Xc[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, torch.sign(z) * 1e-9 + 1e-12, z)
    proj = Xc[..., :2] / safe_z[..., None]
    return (proj - uv_norm) * w[..., None]


def _gauss_newton_pose(R0, t0, X, uv_norm, w, iters: int = 20, damping: float = 1e-3):
    """Levenberg-Marquardt on (axis-angle, t) with the classic accept /
    decrease, reject / increase damping schedule, a fixed trip count."""

    def residual_fn(params):
        R = rotation_matrix_from_axis_angle(params[:, :3])
        return _reproj_residuals(R, params[:, 3:], X, uv_norm, w).reshape(params.shape[0], -1)

    params = torch.cat([axis_angle_from_rotation_matrix(R0), t0], dim=-1)
    cost = torch.sum(residual_fn(params) ** 2, -1)
    lam = torch.full_like(cost, damping)
    eye6 = _eye(params, 6)
    for _ in range(iters):
        cols = []
        for d in range(6):
            res, col = jvp(residual_fn, (params,), (eye6[d].expand_as(params),))
            cols.append(col)
        J = torch.stack(cols, dim=-1)  # [B, 2N, 6] forward-mode Jacobian
        JtJ = J.transpose(-1, -2) @ J + lam[:, None, None] * eye6
        delta, _ = torch.linalg.solve_ex(JtJ, (J.transpose(-1, -2) @ res[..., None]))
        cand = params - delta[..., 0]
        cand_cost = torch.sum(residual_fn(cand) ** 2, -1)
        accept = cand_cost < cost
        params = torch.where(accept[:, None], cand, params)
        cost = torch.where(accept, cand_cost, cost)
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-12), torch.clamp(lam * 10.0, max=1e6))
    return rotation_matrix_from_axis_angle(params[:, :3]), params[:, 3:]


def _solve_core(Xs, uv_norm, w, refinement: bool = True, gn_iters: int = 20,
                multi_start: bool = True):
    """EPnP candidates, then 7-start damped Gauss-Newton (``multi_start``),
    one Gauss-Newton from the better EPnP candidate (``refinement`` alone)
    or none -> (R [B,3,3], t [B,3])."""
    B = Xs.shape[0]
    C = _control_points(Xs, w)
    alphas = _barycentric(Xs, C)
    _, eigvec = _eigh(_build_MtM(alphas, uv_norm, w))  # ascending

    # Candidate 1: the smallest null vector (EPnP beta case N=1).
    e0, e1 = eigvec[..., 0], eigvec[..., 1]
    R1, t1 = _epnp_candidate(e0, C, alphas, Xs, w)
    # Candidate 2: two-vector combination from the distance constraints,
    # ||b1*dv1 + b2*dv2||^2 = ||dc||^2 -> least squares in (b1^2, b1*b2, b2^2).
    dv1 = _pairwise_dists(e0.reshape(B, 4, 3))
    dv2 = _pairwise_dists(e1.reshape(B, 4, 3))
    dc = _pairwise_dists(C)
    L = torch.stack(
        [torch.sum(dv1 * dv1, -1), 2.0 * torch.sum(dv1 * dv2, -1), torch.sum(dv2 * dv2, -1)], -1
    )  # [B, 6, 3]
    rho = torch.sum(dc * dc, -1)
    Lt = L.transpose(-1, -2)
    btb, _ = torch.linalg.solve_ex(Lt @ L + 1e-9 * _eye(L), Lt @ rho[..., None])
    btb = btb[..., 0]
    b1 = torch.sqrt(torch.clamp(btb[:, 0], min=_EPS))
    b2 = torch.sqrt(torch.clamp(btb[:, 2], min=_EPS)) * torch.sign(btb[:, 1])
    R2, t2 = _epnp_candidate(b1[:, None] * e0 + b2[:, None] * e1, C, alphas, Xs, w)

    e1_cost = torch.sum(_reproj_residuals(R1, t1, Xs, uv_norm, w) ** 2, dim=(1, 2))
    e2_cost = torch.sum(_reproj_residuals(R2, t2, Xs, uv_norm, w) ** 2, dim=(1, 2))
    use1 = e1_cost <= e2_cost
    R0 = torch.where(use1[:, None, None], R1, R2)
    t0 = torch.where(use1[:, None], t1, t2)
    if not refinement:
        return R0, t0
    if not multi_start:
        return _gauss_newton_pose(R0, t0, Xs, uv_norm, w, iters=gn_iters)

    # Geometric front-facing starts: depth from the 3D/2D spread ratio.
    n_eff = (torch.sum(w, -1) + _EPS)[:, None]
    c3d = torch.sum(Xs * w[..., None], -2) / n_eff
    c2d = torch.sum(uv_norm * w[..., None], -2) / n_eff
    spread3d = torch.sum(_norm((Xs - c3d[:, None]) * w[..., None]), -1) / n_eff[:, 0]
    spread2d = torch.sum(_norm((uv_norm - c2d[:, None]) * w[..., None]), -1) / n_eff[:, 0]
    z0 = spread3d / (spread2d + _EPS)
    front_t = torch.cat([c2d * z0[:, None], z0[:, None]], -1)  # [B, 3]
    flips = torch.tensor(
        [[1.0, 1.0, 1.0], [1.0, -1.0, -1.0], [-1.0, 1.0, -1.0], [-1.0, -1.0, 1.0]],
        dtype=Xs.dtype, device=Xs.device,
    )
    front_R = torch.diag_embed(flips)[None].expand(B, 4, 3, 3)
    front_t = front_t[:, None] - (front_R @ c3d[:, None, :, None])[..., 0]  # [B, 4, 3]
    starts_R = torch.cat([torch.stack([R0, R1, R2], 1), front_R], 1)  # [B, 7, 3, 3]
    starts_t = torch.cat([torch.stack([t0, t1, t2], 1), front_t], 1)  # [B, 7, 3]

    S = starts_R.shape[1]

    def rep(x):
        return x[:, None].expand(B, S, *x.shape[1:]).reshape(B * S, *x.shape[1:])

    Xr, uvr, wr = rep(Xs), rep(uv_norm), rep(w)
    Rf, tf = _gauss_newton_pose(
        starts_R.reshape(B * S, 3, 3), starts_t.reshape(B * S, 3), Xr, uvr, wr, iters=gn_iters
    )
    cost = torch.sum(_reproj_residuals(Rf, tf, Xr, uvr, wr) ** 2, dim=(1, 2))
    # Penalize solutions that put points behind the camera.
    z = (Xr @ Rf[:, 2, :, None])[..., 0] + tf[:, 2:3]
    cost = cost + 1e6 * torch.sum((z < 0) * wr, -1)
    best = torch.argmin(cost.reshape(B, S), dim=1)
    idx = torch.arange(B, device=Xs.device)
    return Rf.reshape(B, S, 3, 3)[idx, best], tf.reshape(B, S, 3)[idx, best]


def _correspondence_weights(X, uv, weights):
    """``[B, N]`` float weights: 0 for non-finite or sentinel (``<= -999``)
    correspondences, else 1 times ``weights`` when given."""
    valid = torch.isfinite(X).all(-1) & torch.isfinite(uv).all(-1) & (uv > -999.0).all(-1)
    w = valid.to(torch.float32)
    return w if weights is None else w * weights.to(w.device, torch.float32)


def _pixel_errors(R, t, Xs, uv_norm, mask, focal):
    """Unweighted per-point pixel reprojection error ``[B, N]``, zero where
    ``mask`` is; ``focal`` is ``[B, 2]`` (fx, fy)."""
    return _norm(_reproj_residuals(R, t, Xs, uv_norm, mask) * focal[:, None])


def _reject_outliers(R, t, Xs, uv_norm, w, focal, threshold, refinement, gn_iters, multi_start):
    """Leave-one-out rejection, three trips (``geometric_vision.py:446-502``).

    On each trip, a frame whose worst valid residual exceeds ``threshold``
    px and that keeps more than four points re-solves from scratch once
    without each of its points, and drops the point whose removal leaves
    the smallest worst residual.  Choosing by the worst residual itself
    would be wrong: a gross outlier drags the pose until a good point
    reprojects worst.  Only the frames that drop a point are solved again;
    their candidates join the frames in one batch.  Returns the pose and
    the surviving weights.
    """
    n_pts = w.shape[1]
    eye = torch.eye(n_pts, dtype=w.dtype, device=w.device)
    for _ in range(3):
        err = _pixel_errors(R, t, Xs, uv_norm, (w > 0).to(w.dtype), focal)
        worst = torch.max(torch.where(w > 0, err, float("-inf")), -1).values
        drop = torch.nonzero((worst > threshold) & (torch.sum(w > 0, -1) > 4))[:, 0]
        if drop.numel() == 0:
            break
        m = drop.numel()

        def rep(x):
            return x[drop, None].expand(m, n_pts, *x.shape[1:]).reshape(m * n_pts, *x.shape[1:])

        w_loo = (w[drop, None, :] * (1.0 - eye)).reshape(m * n_pts, n_pts)
        X_loo, uv_loo = rep(Xs), rep(uv_norm)
        R_i, t_i = _solve_core(X_loo, uv_loo, w_loo, refinement, gn_iters, multi_start)
        px = _pixel_errors(R_i, t_i, X_loo, uv_loo, (w_loo > 0).to(w.dtype), rep(focal))
        cost = torch.max(torch.where(w_loo > 0, px, torch.zeros((), device=px.device)), -1).values
        cost = torch.where(w[drop].reshape(-1) > 0, cost, float("inf")).reshape(m, n_pts)
        best = torch.argmin(cost, dim=1)
        pick = torch.arange(m, device=w.device) * n_pts + best
        R, t, w = R.clone(), t.clone(), w.clone()
        R[drop], t[drop] = R_i[pick], t_i[pick]
        w[drop] = w[drop] * (1.0 - eye[best])
    return R, t, w


def solve_pnp(
    canonical_points: torch.Tensor,
    projections: torch.Tensor,
    camera_K: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    refinement: bool = True,
    gn_iters: int = 20,
    multi_start: bool = True,
    reject_outliers_px: Optional[float] = None,
) -> PnPResult:
    """EPnP + multi-start Gauss-Newton pose recovery for a batch of frames.

    Args:
      canonical_points: ``[B, N, 3]`` 3D points.
      projections: ``[B, N, 2]`` detected pixel coords; sentinel (``<= -999``)
        and non-finite entries are invalidated.
      camera_K: ``[3, 3]`` or ``[B, 3, 3]`` intrinsics.
      weights: optional ``[B, N]`` confidences multiplying the validity
        mask; continuous values weight the least-squares residuals.
      refinement, multi_start, gn_iters: Gauss-Newton from 7 starts
        (default), from the EPnP pose only, or not at all.
      reject_outliers_px: if set, leave-one-out rejection of points that
        reproject worse than this (:func:`_reject_outliers`); the returned
        error then counts the surviving points only.

    ``valid`` is False where fewer than 4 usable correspondences exist (cv2's
    minimum for EPnP) or the solve is not finite.
    """
    X = canonical_points.to(torch.float32)
    uv = projections.to(torch.float32)
    K = camera_K.to(torch.float32).expand(X.shape[0], 3, 3)
    w = _correspondence_weights(X, uv, weights)
    n_valid = torch.sum(w > 0, -1)

    # Normalized camera coordinates for conditioning.
    fx, fy = K[:, 0, 0, None], K[:, 1, 1, None]
    cx, cy = K[:, 0, 2, None], K[:, 1, 2, None]
    uv_norm = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)
    uv_norm = torch.where(w[..., None] > 0, uv_norm, torch.zeros((), device=uv.device))
    Xs = torch.where(w[..., None] > 0, X, torch.zeros((), device=X.device))
    focal = torch.cat([fx, fy], -1)

    with _SOLVE_LOCK:
        previous = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            R, t = _solve_core(Xs, uv_norm, w, refinement, gn_iters, multi_start)
            w_final = w
            if reject_outliers_px is not None:
                R, t, w_final = _reject_outliers(R, t, Xs, uv_norm, w, focal, reject_outliers_px,
                                                 refinement, gn_iters, multi_start)
            valid_mask = (w_final > 0).to(torch.float32)
            err = _pixel_errors(R, t, Xs, uv_norm, valid_mask, focal)
            mean_err = torch.sum(err * valid_mask, -1) / (torch.sum(valid_mask, -1) + _EPS)
        finally:
            torch.set_float32_matmul_precision(previous)

    valid = (n_valid >= 4) & torch.isfinite(t).all(-1) & torch.isfinite(mean_err)
    quat = quaternion_from_rotation_matrix(R)
    v = valid[:, None]
    return PnPResult(
        valid=valid,
        translation=torch.where(v, t, torch.zeros_like(t)),
        quaternion=torch.where(v, quat, torch.tensor([0.0, 0.0, 0.0, 1.0], device=quat.device)),
        rotation=torch.where(v[..., None], R, _eye(R).expand_as(R)),
        reproj_error=torch.where(valid, mean_err, torch.full_like(mean_err, float("inf"))),
    )


def ransac_subsets(valid: torch.Tensor, n_hypotheses: int = 64,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``[B, n_hypotheses, 4]`` point indices: for each frame and hypothesis
    four distinct points drawn uniformly among the valid ones of
    ``valid [B, N]`` (invalid points only where fewer than four are valid),
    as ``jax.random.choice`` without replacement under equal weights draws
    them, from ``generator``'s stream on ``valid``'s device."""
    B, N = valid.shape
    u = torch.rand((B, n_hypotheses, N), generator=generator, device=valid.device)
    u = torch.where(valid[:, None, :], u, u + 2.0)
    return torch.argsort(u, dim=-1)[..., :4]


def solve_pnp_ransac(
    canonical_points: torch.Tensor,
    projections: torch.Tensor,
    camera_K: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    weights: Optional[torch.Tensor] = None,
    inlier_thresh_px: float = 5.0,
    n_hypotheses: int = 64,
    gn_iters: int = 20,
    subsets: Optional[torch.Tensor] = None,
):
    """Fixed-trip-count RANSAC PnP for a batch of frames
    (``geometric_vision.py:525-603``).

    Each frame's ``n_hypotheses`` minimal 4-point subsets (``subsets [B,
    H, 4]`` when given, else :func:`ransac_subsets` from ``generator``)
    are solved with one 8-iteration Gauss-Newton start each, frames and
    hypotheses in one batch; each scores its inliers (pixel error under
    ``inlier_thresh_px``); the frame is solved again on the best
    hypothesis's inliers, and falls back to the plain solve on all points
    when that fails.  Returns ``(PnPResult, inlier_mask [B, N])``.
    """
    X = canonical_points.to(torch.float32)
    uv = projections.to(torch.float32)
    K = camera_K.to(torch.float32).expand(X.shape[0], 3, 3)
    B, N = X.shape[0], X.shape[1]
    w = _correspondence_weights(X, uv, weights)
    if subsets is None:
        subsets = ransac_subsets(w > 0, n_hypotheses, generator)
    H = subsets.shape[1]
    pick = torch.zeros((B, H, N), device=X.device).scatter_(-1, subsets.to(X.device, torch.int64), 1.0)
    sub_w = (pick * w[:, None]).reshape(B * H, N)

    def rep(x):
        return x[:, None].expand(B, H, *x.shape[1:]).reshape(B * H, *x.shape[1:])

    Xr, uvr, Kr = rep(X), rep(uv), rep(K)
    hyp = solve_pnp(Xr, uvr, Kr, weights=sub_w, refinement=True, gn_iters=8, multi_start=False)
    cam = Xr @ hyp.rotation.transpose(-1, -2) + hyp.translation[:, None]
    err = _norm(point_projection_from_3d(Kr, cam) - uvr)
    inliers = ((err < inlier_thresh_px) & (rep(w) > 0)).reshape(B, H, N)
    scores = torch.where(hyp.valid.reshape(B, H), torch.sum(inliers, -1), -1)
    best_inliers = inliers[torch.arange(B, device=X.device), torch.argmax(scores, dim=1)]

    final = solve_pnp(X, uv, K, weights=best_inliers.to(torch.float32), gn_iters=gn_iters)
    # Consensus fallback: fewer than four inliers -> the all-point solve.
    plain = solve_pnp(X, uv, K, weights=weights, gn_iters=gn_iters)
    use = final.valid
    merged = PnPResult(*(
        torch.where(use.reshape((B,) + (1,) * (f.dim() - 1)), f, p) for f, p in zip(final, plain)
    ))
    return merged, torch.where(use[:, None], best_inliers, w > 0)


def add_from_pose(
    translation: torch.Tensor,
    quaternion: torch.Tensor,
    keypoint_positions_wrt_cam_gt: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    rotation_convention: str = "standard",
) -> torch.Tensor:
    """Mean 3D keypoint distance under the recovered pose, per frame ``[B]``.

    Port of ``geometric_vision.add_from_pose`` (reference
    dream/geometric_vision.py:183-202): applies ``[R | t]`` to the GT
    camera-frame keypoints and averages the L2 distance to the untransformed
    GT over the ``weights`` mask (the keypoints fed to PnP).
    ``"standard"`` applies ``R``; ``"transposed"`` applies ``R^T``, the
    alternate convention the JAX package also reports.
    """
    R = rotation_matrix_from_quaternion(quaternion)
    if rotation_convention == "transposed":
        R = R.transpose(-1, -2)
    elif rotation_convention != "standard":
        raise ValueError(f"unknown rotation convention {rotation_convention!r}")
    kp = keypoint_positions_wrt_cam_gt
    aligned = kp @ R.transpose(-1, -2) + translation[..., None, :]
    dists = _norm(aligned - kp)
    if weights is None:
        return dists.mean(-1)
    w = weights.to(dists.dtype)
    return torch.sum(dists * w, -1) / (torch.sum(w, -1) + _EPS)
