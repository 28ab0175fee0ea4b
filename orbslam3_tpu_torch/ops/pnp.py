"""Batched PnP RANSAC and maximum-likelihood refinement for relocalization.

Port of ``orbslam3_tpu/ops/pnp.py`` (``PnPResult``, ``_dlt_pnp``,
``pnp_ransac``, ``mlpnp_refine``, and the batched EPnP ``epnp`` with its
RANSAC wrapper ``epnp_ransac``). Every RANSAC hypothesis solves a 6-point linear
PnP (DLT on the 3x4 projection matrix through a 12x12 eigendecomposition) in
one batch, is orthonormalized onto SE(3) and scored by reprojection chi2
against all matches at once. The bearing-vector formulation keeps it
camera-model agnostic: fisheye rays work unchanged.

The reference's ``vmap`` over hypotheses is a written-out batch dimension
here; the tiny eigen- and singular-value decompositions go through batched
``torch.linalg``. Null vectors come with sign and ordering freedom, so the
two packages are compared on poses and inlier sets, not on raw vectors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie


class PnPResult(NamedTuple):
    success: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _dlt_pnp(xw: torch.Tensor, xn: torch.Tensor):
    """Batched 6-point DLT: xw (B,6,3) world, xn (B,6,2) normalized image.
    Returns (R (B,3,3), t (B,3)) projected onto SE(3)."""
    B, n, _ = xw.shape
    ones = torch.ones((B, n, 1), dtype=xw.dtype, device=xw.device)
    Xh = torch.cat([xw, ones], dim=-1)                    # (B,6,4)
    zeros = torch.zeros_like(Xh)
    u = xn[..., 0:1]
    v = xn[..., 1:2]
    r1 = torch.cat([Xh, zeros, -u * Xh], dim=-1)          # (B,6,12)
    r2 = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=1)                        # (B,12,12)
    AtA = A.transpose(1, 2) @ A
    _, vecs = torch.linalg.eigh(AtA)
    P = vecs[..., :, 0].reshape(B, 3, 4)
    # sign: points should be in front (positive depth for the centroid)
    cen = torch.mean(Xh, dim=1)
    depth = (P @ cen[..., None])[:, 2, 0]
    P = P * torch.where(depth < 0, -1.0, 1.0)[:, None, None]
    M = P[:, :, :3]
    # orthonormalize M → R via SVD; scale = mean singular value
    uS, sS, vtS = torch.linalg.svd(M)
    det = torch.linalg.det(uS @ vtS)
    fix = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = (uS * fix[:, None, :]) @ vtS
    scale = torch.mean(sS * fix, dim=-1)
    t = P[:, :, 3] / torch.clamp(scale, min=1e-12)[:, None]
    return R, t


def _control_points(xw: torch.Tensor) -> torch.Tensor:
    """EPnP control points by PCA: the centroid and the principal axes
    scaled by their standard deviations, the smaller axes floored at 1e-3 of
    the largest (a (near-)planar set would otherwise give a singular basis).
    xw (B,n,3) → (B,4,3)."""
    c0 = torch.mean(xw, dim=1)
    d = xw - c0[:, None]
    cov = d.transpose(1, 2) @ d / xw.shape[1]
    w, v = torch.linalg.eigh(cov)                                     # ascending
    std = torch.sqrt(torch.clamp(w, min=1e-12))
    std = torch.maximum(std, 1e-3 * std[..., -1:])
    ax = v.transpose(1, 2) * std[..., None]
    return torch.cat([c0[:, None], c0[:, None] + ax], dim=1)


def _barycentric(xw: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """alphas (B,n,4) with xw = Σ_j a_j C_j and Σ_j a_j = 1."""
    M = (C[:, 1:] - C[:, :1]).transpose(1, 2)                         # (B,3,3)
    rhs = (xw - C[:, :1]).transpose(1, 2)                             # (B,3,n)
    a123 = torch.linalg.solve_ex(M, rhs, check_errors=False)[0].transpose(1, 2)
    a0 = 1.0 - torch.sum(a123, dim=-1, keepdim=True)
    return torch.cat([a0, a123], dim=-1)


_CP_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def epnp(xw: torch.Tensor, xn: torch.Tensor, n_gn: int = 10):
    """Batched EPnP: xw (B,n,3) world points, xn (B,n,2) normalized image
    coordinates → (R (B,3,3), t (B,3)) world→camera. The points are written
    in 4 control points, the 4 smallest eigenvectors of MᵀM span the camera
    control points, Gauss-Newton fits their 4 weights to the 6 control-point
    distances (seeded by the dominant vector's scale), then a fixed-scale
    Horn alignment maps world to camera control points. Eigenvectors come
    with a free sign: the weights absorb it, the cheirality flip fixes the
    dominant one."""
    B, n, _ = xw.shape
    dtype, dev = xw.dtype, xw.device
    C = _control_points(xw)
    alph = _barycentric(xw, C)                                        # (B,n,4)
    u = xn[..., 0:1]
    v = xn[..., 1:2]
    z3 = torch.zeros((B, n, 1), dtype=dtype, device=dev)
    one = torch.ones((B, n, 1), dtype=dtype, device=dev)
    # rows Σ_j a_j (xc_j − u zc_j) = 0 and Σ_j a_j (yc_j − v zc_j) = 0 in
    # the unknowns [c1x c1y c1z ... c4x c4y c4z]
    r1 = torch.cat([alph[..., j:j + 1] * torch.cat([one, z3, -u], -1) for j in range(4)], -1)
    r2 = torch.cat([alph[..., j:j + 1] * torch.cat([z3, one, -v], -1) for j in range(4)], -1)
    M = torch.cat([r1, r2], dim=1)                                    # (B,2n,12)
    _, vecs = torch.linalg.eigh(M.transpose(1, 2) @ M)
    V = vecs[..., :4].transpose(1, 2).reshape(B, 4, 4, 3)             # 4 null vectors
    ii = [p[0] for p in _CP_PAIRS]
    jj = [p[1] for p in _CP_PAIRS]
    dV = V[:, :, ii] - V[:, :, jj]                                    # (B,4,6,3)
    dw = C[:, ii] - C[:, jj]                                          # (B,6,3)
    d2w = torch.sum(dw * dw, dim=-1)                                  # (B,6)
    nv0 = torch.sum(dV[:, 0] * dV[:, 0], dim=-1)
    b0 = (torch.sum(torch.sqrt(nv0 * d2w), -1)
          / torch.clamp(torch.sum(nv0, -1), min=1e-12))
    zero = torch.zeros_like(b0)
    betas = torch.stack([b0, zero, zero, zero], dim=-1)              # (B,4)
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    for _ in range(n_gn):
        dc = torch.einsum("bk,bkps->bps", betas, dV)                  # (B,6,3)
        f = torch.sum(dc * dc, -1) - d2w                              # (B,6)
        Jb = 2.0 * torch.einsum("bps,bkps->bpk", dc, dV)              # (B,6,4)
        JtJ = Jb.transpose(1, 2) @ Jb + 1e-9 * eye4
        g = torch.einsum("bpk,bp->bk", Jb, f)
        betas = betas - torch.linalg.solve_ex(JtJ, g[..., None], check_errors=False)[0][..., 0]
    Cc = torch.einsum("bk,bkps->bps", betas, V)                       # (B,4,3)
    # cheirality: the mean point depth must be positive
    pc = alph @ Cc
    Cc = Cc * torch.where(torch.mean(pc[..., 2], -1) < 0, -1.0, 1.0)[:, None, None]
    mu_w = torch.mean(C, dim=1)
    mu_c = torch.mean(Cc, dim=1)
    Hm = (Cc - mu_c[:, None]).transpose(1, 2) @ (C - mu_w[:, None])
    uS, _, vtS = torch.linalg.svd(Hm)
    det = torch.linalg.det(uS @ vtS)
    fix = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = (uS * fix[:, None, :]) @ vtS
    t = mu_c - (R @ mu_w[..., None])[..., 0]
    return R, t


def epnp_ransac(xw: torch.Tensor, rays: torch.Tensor, valid: torch.Tensor,
                rand_sets: torch.Tensor, inv_sigma2: torch.Tensor,
                chi2_th: float = 5.991, focal: float = 458.0,
                min_inliers: int = 10) -> PnPResult:
    """RANSAC-wrapped EPnP (the reference's PnPsolver RANSAC loop; MLPnP
    replaced it for relocalization): one EPnP per hypothesis of
    ``rand_sets`` (B,s), s ≥ 4, scored as :func:`pnp_ransac` scores."""
    xn = rays[..., :2] / rays[..., 2:3]
    sets = rand_sets.long()
    R, t = epnp(xw[sets], xn[sets])
    xc = xw[None] @ R.transpose(1, 2) + t[:, None, :]
    z = torch.clamp(xc[..., 2], min=1e-6)
    pred = xc[..., :2] / z[..., None]
    err2 = torch.sum((pred - xn[None]) ** 2, dim=-1) * (focal * focal)
    chi2 = err2 * inv_sigma2[None]
    inl = (chi2 < chi2_th) & valid[None] & (xc[..., 2] > 0.05)
    counts = torch.sum(inl, dim=-1, dtype=torch.int32)
    best = torch.argmax(counts)
    return PnPResult(success=counts[best] >= min_inliers, R=R[best], t=t[best],
                     inliers=inl[best], n_inliers=counts[best])


def pnp_ransac(xw: torch.Tensor, rays: torch.Tensor, valid: torch.Tensor,
               rand_sets: torch.Tensor, inv_sigma2: torch.Tensor,
               chi2_th: float = 5.991, focal: float = 458.0,
               min_inliers: int = 10) -> PnPResult:
    """RANSAC PnP. xw: (N,3) world points; rays: (N,3) unit-z bearing rays;
    rand_sets: (B,6) indices of valid matches; chi2 gated in pixel² via focal
    (reference MLPnP RANSAC: ≥10 inliers, 6-point model, χ²=5.991)."""
    xn = rays[..., :2] / rays[..., 2:3]
    sets = rand_sets.long()
    R, t = _dlt_pnp(xw[sets], xn[sets])

    xc = xw[None] @ R.transpose(1, 2) + t[:, None, :]     # (B,N,3)
    z = torch.clamp(xc[..., 2], min=1e-6)
    pred = xc[..., :2] / z[..., None]
    err2 = torch.sum((pred - xn[None]) ** 2, dim=-1) * (focal * focal)
    chi2 = err2 * inv_sigma2[None]
    inl = (chi2 < chi2_th) & valid[None] & (xc[..., 2] > 0.05)
    counts = torch.sum(inl, dim=-1, dtype=torch.int32)
    best = torch.argmax(counts)
    return PnPResult(success=counts[best] >= min_inliers, R=R[best], t=t[best],
                     inliers=inl[best], n_inliers=counts[best])


def mlpnp_refine(xw: torch.Tensor, rays: torch.Tensor, weights: torch.Tensor,
                 valid: torch.Tensor, R0: torch.Tensor, t0: torch.Tensor,
                 iters: int = 8):
    """Maximum-likelihood PnP refinement on bearing vectors (the MLPnP
    Gauss-Newton stage): minimize the weighted residual of the observed
    bearing against the predicted direction, parametrized in each bearing's
    tangent plane (the 2-dof nullspace {r, s} of the observed ray).
    Projection-model-free, so it serves any camera whose unprojection made
    the rays. ``weights``: per-ray scalar information (≈ inv_sigma2 of the
    pixel times focal²). Returns (R, t), world→camera.

    The reference differentiates the residual with ``jacfwd``; here the
    Jacobian at the current pose is written out: for a left perturbation
    exp([ω|υ]) the camera-frame point moves by ω×xc + υ, and the unit
    direction by (I − p pᵀ)/|xc| of that."""
    dtype, dev = xw.dtype, xw.device
    v = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)              # (N,3)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev).expand_as(v)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev).expand_as(v)
    tmp = torch.where(torch.abs(v[:, 2:3]) < 0.9, ez, ex)
    r_b = torch.linalg.cross(v, tmp)
    r_b = r_b / torch.linalg.norm(r_b, dim=-1, keepdim=True)
    s_b = torch.linalg.cross(v, r_b)
    sw = torch.sqrt(weights * valid.to(dtype))                            # (N,)
    basis = torch.stack([r_b, s_b], dim=1)                                # (N,2,3)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def direction(R, t):
        xc = xw @ R.transpose(-1, -2) + t
        nrm = torch.clamp(torch.linalg.norm(xc, dim=-1, keepdim=True), min=1e-9)
        return xc, nrm, xc / nrm

    def residuals(pred):
        return (basis @ pred[..., None])[..., 0] * sw[:, None]            # (N,2)

    R, t = R0.to(dtype), t0.to(dtype)
    lam = torch.tensor(1e-3, dtype=dtype, device=dev)
    for _ in range(iters):
        xc, nrm, pred = direction(R, t)
        r = residuals(pred).reshape(-1)
        d_pred = (eye3 - pred[:, :, None] * pred[:, None, :]) / nrm[..., None]
        J_xc = torch.cat([-lie.hat(xc), eye3.expand(xc.shape[0], 3, 3)], dim=-1)  # (N,3,6)
        J = ((basis @ d_pred @ J_xc) * sw[:, None, None]).reshape(-1, 6)
        H = J.T @ J
        H = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
        d = -torch.linalg.solve_ex(H, (J.T @ r)[:, None])[0][:, 0]
        d = torch.where(torch.isfinite(d), d, 0.0)
        dR, dt = lie.se3_exp(d[None])
        Rn, tn = lie.se3_compose(dR[0], dt[0], R, t)
        better = torch.sum(residuals(direction(Rn, tn)[2]) ** 2) < torch.sum(r * r)
        R = torch.where(better, Rn, R)
        t = torch.where(better, tn, t)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
    return R, t
