"""Batched two-view triangulation + acceptance checks on torch tensors.

Port of ``orbslam3_tpu/ops/triangulation.py``.
"""
from __future__ import annotations

import torch

from . import lie


def triangulate_dlt(R1, t1, rays1, R2, t2, rays2):
    """Batched DLT triangulation in the world frame.

    (R*, t*): world→camera poses, (3,3)/(3,) or with batch dims that
    broadcast against the rays' (e.g. (B,1,3,3) for (B,N,3) rays); rays*:
    (…,3) unit-z bearing rays of one common shape. Returns (…,3) world points: the smallest
    eigenvector of AᵀA. Its sign is arbitrary and cancels in the division by w.
    """
    def rows(R, t, ray):
        P = torch.cat([R, t[..., None]], dim=-1)                 # (…,3,4)
        P = P.expand(ray.shape[:-1] + (3, 4))
        r1 = ray[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        r2 = ray[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return r1, r2

    a1, a2 = rows(R1, t1, rays1)
    a3, a4 = rows(R2, t2, rays2)
    A = torch.stack([a1, a2, a3, a4], dim=-2)                     # (…,4,4)
    AtA = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(AtA)
    x = vecs[..., :, 0]
    w = x[..., 3:4]
    return x[..., :3] / torch.where(torch.abs(w) < 1e-10, torch.sign(w) * 1e-10 + 1e-20, w)


def check_triangulation(xw, R1, t1, rays1, R2, t2, rays2, sigma2_1, sigma2_2,
                        min_parallax_cos: float = 0.9998, chi2_th: float = 5.991):
    """Acceptance mask for triangulated points: positive depth in both views,
    parallax above threshold, reprojection chi2 below the gate in both views.
    Returns (ok (…,), depths (…,2))."""
    xc1 = lie.se3_apply(R1, t1, xw)
    xc2 = lie.se3_apply(R2, t2, xw)
    z1, z2 = xc1[..., 2], xc2[..., 2]
    c1 = lie.se3_inverse(R1, t1)[1]
    c2 = lie.se3_inverse(R2, t2)[1]
    d1 = xw - c1
    d2 = xw - c2
    cosp = torch.sum(d1 * d2, dim=-1) / (
        torch.linalg.norm(d1, dim=-1) * torch.linalg.norm(d2, dim=-1) + 1e-12)
    e1 = xc1[..., :2] / torch.clamp(z1[..., None], min=1e-9) - rays1[..., :2]
    e2 = xc2[..., :2] / torch.clamp(z2[..., None], min=1e-9) - rays2[..., :2]
    chi1 = torch.sum(e1 * e1, dim=-1) / torch.clamp(sigma2_1, min=1e-20)
    chi2_ = torch.sum(e2 * e2, dim=-1) / torch.clamp(sigma2_2, min=1e-20)
    ok = (z1 > 0) & (z2 > 0) & (cosp < min_parallax_cos) & (chi1 < chi2_th) & (chi2_ < chi2_th)
    return ok, torch.stack([z1, z2], dim=-1)
