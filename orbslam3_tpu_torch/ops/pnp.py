"""Batched PnP RANSAC and maximum-likelihood refinement for relocalization.

Port of ``orbslam3_tpu/ops/pnp.py`` (``PnPResult``, ``_dlt_pnp``,
``pnp_ransac``, ``mlpnp_refine``; the EPnP variants only the reference's
tests reach are not ported). Every RANSAC hypothesis solves a 6-point linear
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
