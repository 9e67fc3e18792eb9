"""PnP and ADD in plain PyTorch float64, batched over frames.

The solve is EPnP (its beta cases 1 and 2, the better by reprojection cost)
followed by 20 damped Gauss-Newton (Levenberg-Marquardt) trips on the
reprojection residuals from seven starts: the EPnP pose, both EPnP
candidates, and four front-facing starts at the depth the 3D and 2D spreads
imply, the axes flipped in pairs; the cheapest end that keeps the points in
front of the camera wins.  Sentinel (< -999) and non-finite detections are
left out; fewer than four points, or a non-finite pose, is a failed frame.
ADD is the mean distance between the keypoints in the camera frame and those
keypoints moved by the recovered pose, over the keypoints given to PnP.
"""

from __future__ import annotations

import torch
from torch.func import jvp

_EPS = 1e-12
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _norm(x, dim=-1):
    return torch.sqrt(torch.sum(x * x, dim=dim))


def _pairs(P):
    return torch.stack([P[:, i] - P[:, j] for i, j in _PAIRS], 1)


def _rodrigues(r):
    theta = torch.sqrt(torch.sum(r * r, -1) + _EPS * _EPS)
    k = r / theta[..., None]
    z = torch.zeros_like(k[..., 0])
    K = torch.stack([torch.stack([z, -k[..., 2], k[..., 1]], -1),
                     torch.stack([k[..., 2], z, -k[..., 0]], -1),
                     torch.stack([-k[..., 1], k[..., 0], z], -1)], -2)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return eye + torch.sin(theta)[..., None, None] * K + (1 - torch.cos(theta))[..., None, None] * (K @ K)


def _axis_angle(R):
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    a = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], -1)
    return a / (_norm(a)[..., None] + _EPS) * theta[..., None]


def _residuals(R, t, X, uv, w):
    Xc = X @ R.transpose(-1, -2) + t[:, None]
    z = Xc[..., 2]
    z = torch.where(torch.abs(z) < 1e-9, torch.sign(z) * 1e-9 + 1e-12, z)
    return (Xc[..., :2] / z[..., None] - uv) * w[..., None]


def _decompose(fn, A):
    """``fn`` (an eigen or singular value decomposition) of a batch of
    matrices; one that is not finite gives NaN, and its frame fails."""
    bad = ~torch.isfinite(A).flatten(1).all(-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand_as(A)
    parts = fn(torch.where(bad[:, None, None], eye, A))
    return tuple(torch.where(bad.view(-1, *[1] * (p.dim() - 1)), float("nan"), p) for p in parts)


def _kabsch(X, Y, w):
    n = (torch.sum(w, -1) + _EPS)[:, None]
    Xc = torch.sum(X * w[..., None], -2) / n
    Yc = torch.sum(Y * w[..., None], -2) / n
    H = ((X - Xc[:, None]) * w[..., None]).transpose(-1, -2) @ (Y - Yc[:, None])
    U, _, Vt = _decompose(torch.linalg.svd, H)
    d = torch.linalg.det(Vt.transpose(-1, -2) @ U.transpose(-1, -2))
    one = torch.ones_like(d)
    R = Vt.transpose(-1, -2) @ torch.diag_embed(torch.stack([one, one, d], -1)) @ U.transpose(-1, -2)
    return R, Yc - (R @ Xc[..., None])[..., 0]


def _candidate(v, C, alphas, X, w):
    ctrl = v.reshape(-1, 4, 3)
    ndv, ndc = _norm(_pairs(ctrl)), _norm(_pairs(C))
    beta = torch.sum(ndv * ndc, -1) / (torch.sum(ndv * ndv, -1) + _EPS)
    Xcam = alphas @ (beta[:, None, None] * ctrl)
    mean_z = torch.sum(Xcam[..., 2] * w, -1) / (torch.sum(w, -1) + _EPS)
    return _kabsch(X, torch.where((mean_z < 0)[:, None, None], -Xcam, Xcam), w)


def _lm(R0, t0, X, uv, w, iters=20):
    def res(params):
        return _residuals(_rodrigues(params[:, :3]), params[:, 3:], X, uv, w).reshape(params.shape[0], -1)

    params = torch.cat([_axis_angle(R0), t0], -1)
    cost = torch.sum(res(params) ** 2, -1)
    lam = torch.full_like(cost, 1e-3)
    eye6 = torch.eye(6, dtype=params.dtype, device=params.device)
    for _ in range(iters):
        cols = [jvp(res, (params,), (eye6[d].expand_as(params),)) for d in range(6)]
        r = cols[0][0]
        J = torch.stack([c[1] for c in cols], -1)
        A = J.transpose(-1, -2) @ J + lam[:, None, None] * eye6
        delta = torch.linalg.solve_ex(A, J.transpose(-1, -2) @ r[..., None])[0][..., 0]
        cand = params - delta
        cand_cost = torch.sum(res(cand) ** 2, -1)
        ok = cand_cost < cost
        params = torch.where(ok[:, None], cand, params)
        cost = torch.where(ok, cand_cost, cost)
        lam = torch.where(ok, torch.clamp(lam / 3.0, min=1e-12), torch.clamp(lam * 10.0, max=1e6))
    return _rodrigues(params[:, :3]), params[:, 3:]


def solve(X: torch.Tensor, uv: torch.Tensor, K: torch.Tensor, dtype: torch.dtype = torch.float64):
    """``[B, N, 3]`` points, ``[B, N, 2]`` pixels, ``[3, 3]`` intrinsics ->
    (valid [B], R [B, 3, 3], t [B, 3]), in ``dtype``."""
    X, uv, K = X.to(dtype), uv.to(dtype), K.to(dtype)
    B = X.shape[0]
    w = (torch.isfinite(X).all(-1) & torch.isfinite(uv).all(-1) & (uv > -999.0).all(-1)).to(dtype)
    n_valid = (w > 0).sum(-1)
    uvn = torch.stack([(uv[..., 0] - K[0, 2]) / K[0, 0], (uv[..., 1] - K[1, 2]) / K[1, 1]], -1)
    uvn = torch.where(w[..., None] > 0, uvn, torch.zeros_like(uvn))
    X = torch.where(w[..., None] > 0, X, torch.zeros_like(X))
    # EPnP: control points, barycentric coordinates, the 12x12 normal matrix.
    n = torch.sum(w, -1) + _EPS
    c0 = torch.sum(X * w[..., None], -2) / n[..., None]
    Xd = X - c0[:, None]
    lam, V = _decompose(torch.linalg.eigh, (Xd * w[..., None]).transpose(-1, -2) @ Xd / n[:, None, None])
    C = torch.cat([c0[:, None], c0[:, None] + torch.sqrt(lam.clamp(min=1e-8))[..., None] * V.transpose(-1, -2)], 1)
    ones4 = torch.ones(B, 1, 4, dtype=X.dtype, device=X.device)
    onesN = torch.ones(B, 1, X.shape[1], dtype=X.dtype, device=X.device)
    alphas = torch.linalg.solve_ex(torch.cat([C.transpose(-1, -2), ones4], -2),
                                   torch.cat([X.transpose(-1, -2), onesN], -2))[0].transpose(-1, -2)
    zeros = torch.zeros_like(alphas)
    rx = torch.stack([alphas, zeros, -alphas * uvn[..., 0:1]], -1).reshape(B, -1, 12)
    ry = torch.stack([zeros, alphas, -alphas * uvn[..., 1:2]], -1).reshape(B, -1, 12)
    M = torch.cat([rx * w[..., None], ry * w[..., None]], -2)
    _, vec = _decompose(torch.linalg.eigh, M.transpose(-1, -2) @ M)
    e0, e1 = vec[..., 0], vec[..., 1]
    R1, t1 = _candidate(e0, C, alphas, X, w)
    dv1, dv2, dc = _pairs(e0.reshape(B, 4, 3)), _pairs(e1.reshape(B, 4, 3)), _pairs(C)
    L = torch.stack([torch.sum(dv1 * dv1, -1), 2 * torch.sum(dv1 * dv2, -1), torch.sum(dv2 * dv2, -1)], -1)
    rho = torch.sum(dc * dc, -1)
    Lt = L.transpose(-1, -2)
    btb = torch.linalg.solve_ex(Lt @ L + 1e-9 * torch.eye(3, dtype=X.dtype, device=X.device),
                                Lt @ rho[..., None])[0][..., 0]
    b1 = torch.sqrt(btb[:, 0].clamp(min=_EPS))
    b2 = torch.sqrt(btb[:, 2].clamp(min=_EPS)) * torch.sign(btb[:, 1])
    R2, t2 = _candidate(b1[:, None] * e0 + b2[:, None] * e1, C, alphas, X, w)
    use1 = (torch.sum(_residuals(R1, t1, X, uvn, w) ** 2, (1, 2))
            <= torch.sum(_residuals(R2, t2, X, uvn, w) ** 2, (1, 2)))
    R0 = torch.where(use1[:, None, None], R1, R2)
    t0 = torch.where(use1[:, None], t1, t2)
    # Front-facing starts.
    n_eff = n[:, None]
    c3 = torch.sum(X * w[..., None], -2) / n_eff
    c2 = torch.sum(uvn * w[..., None], -2) / n_eff
    z0 = (torch.sum(_norm((X - c3[:, None]) * w[..., None]), -1) / n
          / (torch.sum(_norm((uvn - c2[:, None]) * w[..., None]), -1) / n + _EPS))
    flips = torch.tensor([[1.0, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], dtype=X.dtype, device=X.device)
    fR = torch.diag_embed(flips)[None].expand(B, 4, 3, 3)
    ft = torch.cat([c2 * z0[:, None], z0[:, None]], -1)[:, None] - (fR @ c3[:, None, :, None])[..., 0]
    SR = torch.cat([torch.stack([R0, R1, R2], 1), fR], 1)
    St = torch.cat([torch.stack([t0, t1, t2], 1), ft], 1)
    S = SR.shape[1]

    def rep(x):
        return x[:, None].expand(B, S, *x.shape[1:]).reshape(B * S, *x.shape[1:])

    Xr, uvr, wr = rep(X), rep(uvn), rep(w)
    Rf, tf = _lm(SR.reshape(B * S, 3, 3), St.reshape(B * S, 3), Xr, uvr, wr)
    cost = torch.sum(_residuals(Rf, tf, Xr, uvr, wr) ** 2, (1, 2))
    z = (Xr @ Rf[:, 2, :, None])[..., 0] + tf[:, 2:3]
    cost = cost + 1e6 * torch.sum((z < 0) * wr, -1)
    best = torch.argmin(cost.reshape(B, S), 1)
    idx = torch.arange(B, device=X.device)
    R, t = Rf.reshape(B, S, 3, 3)[idx, best], tf.reshape(B, S, 3)[idx, best]
    valid = (n_valid >= 4) & torch.isfinite(t).all(-1) & torch.isfinite(R).flatten(1).all(-1)
    return valid, R, t


def add(R: torch.Tensor, t: torch.Tensor, positions: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean keypoint distance under the pose, over ``mask``, ``[B]``."""
    P = positions.to(R.dtype)
    d = _norm(P @ R.transpose(-1, -2) + t[:, None] - P)
    m = mask.to(R.dtype)
    return torch.sum(d * m, -1) / (torch.sum(m, -1) + _EPS)
