"""Sim(3) estimation between keyframes: batched Horn RANSAC + LM refinement.

Port of ``orbslam3_tpu/ops/sim3.py`` (the reference's ``Sim3Solver``: RANSAC
over 3-point samples, Horn's closed-form similarity, reprojection-error inlier
gating, fixed-scale mode; and ``Optimizer::OptimizeSim3``: one Sim(3) vertex
with paired forward / inverse reprojection edges, Huber, chi2 gate 10).

All RANSAC hypotheses are computed and scored in one batched pass; the
sample indices are drawn on the host by the caller, so both packages score
the same hypotheses. ``optimize_sim3`` writes out its (4N, 7) Jacobian where
the reference differentiates with ``jax.jacfwd``: every row is a camera
projection Jacobian times a 3×7 block that is a few cross products, so the
closed form costs a handful of batched operations per iteration instead of a
seven-way forward pass.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import camera as cam_ops
from . import lie


def _svd_fix(W: torch.Tensor):
    """(u·diag(1,1,det), sv, vt) of (...,3,3) W: the proper rotation of
    Horn's method and the per-axis sign it used."""
    u, sv, vt = torch.linalg.svd(W)
    det = torch.linalg.det(u @ vt)
    fix = torch.cat([torch.ones(det.shape + (2,), dtype=W.dtype, device=W.device),
                     det[..., None]], dim=-1)
    return (u * fix[..., None, :]) @ vt, sv, fix


def horn_sim3(x: torch.Tensor, y: torch.Tensor, fix_scale: bool = False):
    """Closed-form similarity y ≈ s R x + t from (...,N,3) point sets (Horn
    1987, the reference's ComputeSim3). Batched over leading dims."""
    mx = torch.mean(x, dim=-2, keepdim=True)
    my = torch.mean(y, dim=-2, keepdim=True)
    xc = x - mx
    yc = y - my
    W = torch.einsum("...ni,...nj->...ij", yc, xc)
    R, sv, fix = _svd_fix(W)
    if fix_scale:
        s = torch.ones(R.shape[:-2], dtype=x.dtype, device=x.device)
    else:
        num = torch.sum(sv * fix, dim=-1)
        den = torch.sum(xc * xc, dim=(-2, -1))
        s = num / torch.clamp(den, min=1e-12)
    t = my[..., 0, :] - s[..., None] * torch.einsum("...ij,...j->...i", R, mx[..., 0, :])
    return s, R, t


class Sim3Result(NamedTuple):
    success: torch.Tensor
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def sim3_ransac(x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor,
                rand_sets: torch.Tensor, th1_sq: torch.Tensor, th2_sq: torch.Tensor,
                cam_params: torch.Tensor, fix_scale: bool = False, min_inliers: int = 20,
                cam_type: int = cam_ops.PINHOLE) -> Sim3Result:
    """RANSAC similarity between matched 3D point sets in two keyframes'
    camera frames: x1, x2 (N,3), valid (N,), rand_sets (iters,3) sample
    indices, th*_sq (N,) squared pixel gates (9.21·sigma2). Returns the Sim3
    x2 ≈ s R x1 + t refined by a weighted Horn fit on the best hypothesis'
    inliers."""
    rs = rand_sets.long()
    s_h, R_h, t_h = horn_sim3(x1[rs], x2[rs], fix_scale=fix_scale)   # (B,...)

    def project(p):
        return cam_ops.project(cam_type, cam_params, p.reshape(-1, 3)).reshape(
            p.shape[:-1] + (2,))

    x1h = s_h[:, None, None] * torch.einsum("bij,nj->bni", R_h, x1) + t_h[:, None, :]
    s_i = 1.0 / s_h
    R_i = R_h.transpose(-1, -2)
    t_i = -s_i[:, None] * torch.einsum("bij,bj->bi", R_i, t_h)
    x2h = s_i[:, None, None] * torch.einsum("bij,nj->bni", R_i, x2) + t_i[:, None, :]

    e2 = torch.sum((project(x1h) - project(x2[None])) ** 2, dim=-1)   # (B,N)
    e1 = torch.sum((project(x2h) - project(x1[None])) ** 2, dim=-1)
    inl = (e1 < th1_sq[None]) & (e2 < th2_sq[None]) & valid[None]
    counts = torch.sum(inl.to(torch.int32), dim=-1)
    best = torch.argmax(counts)
    n_best = counts[best]

    w = inl[best].to(x1.dtype)
    sw = torch.clamp(torch.sum(w), min=1.0)
    mx = torch.sum(x1 * w[:, None], dim=0) / sw
    my = torch.sum(x2 * w[:, None], dim=0) / sw
    xc = (x1 - mx) * w[:, None]
    yc = (x2 - my) * w[:, None]
    Rr, sv, fix = _svd_fix(torch.einsum("ni,nj->ij", yc, xc))
    if fix_scale:
        sr = torch.ones((), dtype=x1.dtype, device=x1.device)
    else:
        sr = torch.sum(sv * fix) / torch.clamp(torch.sum(xc * xc), min=1e-12)
    tr = my - sr * (Rr @ mx)
    return Sim3Result(success=n_best >= min_inliers, s=sr, R=Rr, t=tr,
                      inliers=inl[best], n_inliers=n_best)


class Sim3OptResult(NamedTuple):
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor      # (N,) both-direction chi2 < th
    n_inliers: torch.Tensor


def optimize_sim3(x1, x2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid, s0, R0, t0,
                  cam_params, valid21=None, cam_params2=None, fix_scale: bool = False,
                  iters: int = 10, chi2_th: float = 10.0, cam_type: int = cam_ops.PINHOLE,
                  cam_type2: int | None = None) -> Sim3OptResult:
    """LM refinement of S21 (x2 ≈ s R x1 + t) from matched 3D↔feature pairs.

    Residuals: project2(S21·x1) − uv2 and project1(S21⁻¹·x2) − uv1, Huber
    δ=√chi2_th, per-point information inv_sigma2; ``valid`` gates the →cam1
    rows, ``valid21`` (default ``valid``) the →cam2 rows. The update is
    s ← s·exp(ls), R ← Exp(w)·R, t ← t + v on params (ls, w, v), with the
    reference's damping, step clamp and accept-if-cheaper rule."""
    dtype, dev = x1.dtype, x1.device
    if valid21 is None:
        valid21 = valid
    if cam_params2 is None:
        cam_params2 = cam_params
    if cam_type2 is None:
        cam_type2 = cam_type
    delta = torch.sqrt(torch.tensor(chi2_th, dtype=dtype, device=dev))
    m21 = (valid & valid21).to(dtype)
    m12 = valid.to(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    def residuals(s, R, t):
        y1 = s * (x1 @ R.T)                       # s R x1
        x1_in2 = y1 + t
        q = x2 - t
        x2_in1 = (q @ R) / s                      # Rᵀ (x2 − t) / s
        r21 = cam_ops.project(cam_type2, cam_params2, x1_in2) - uv2
        r12 = cam_ops.project(cam_type, cam_params, x2_in1) - uv1
        return r21, r12, y1, x1_in2, q, x2_in1

    def chi2_of(r21, r12):
        return (torch.sum(r21 * r21, -1) * inv_sigma2_2,
                torch.sum(r12 * r12, -1) * inv_sigma2_1)

    def hw(c):
        rn = torch.sqrt(torch.clamp(c, min=1e-12))
        return torch.where(rn <= delta, 1.0, delta / rn)

    def rho(c):
        rn = torch.sqrt(torch.clamp(c, min=1e-12))
        return torch.where(rn <= delta, c, 2.0 * delta * rn - delta * delta)

    def robust_cost(s, R, t):
        c21, c12 = chi2_of(*residuals(s, R, t)[:2])
        return torch.sum(rho(c21) * m21) + torch.sum(rho(c12) * m12)

    def jacobian(R, s, y1, x1_in2, q, x2_in1):
        """(4N,7) d[r21; r12]/d(ls, w, v) at the current estimate."""
        n = x1.shape[0]
        # forward edge: d(s R x1 + t) = [y1 | -hat(y1) | I]
        B21 = torch.cat([y1[:, :, None], -lie.hat(y1), eye3.expand(n, 3, 3)], dim=-1)
        # inverse edge: d(Rᵀ(x2 - t)/s) = [-x2_in1 | Rᵀ hat(q)/s | -Rᵀ/s]
        Rt_s = R.T / s
        B12 = torch.cat([-x2_in1[:, :, None], Rt_s @ lie.hat(q),
                         (-Rt_s).expand(n, 3, 3)], dim=-1)
        J21 = cam_ops.project_jac(cam_type2, cam_params2, x1_in2) @ B21    # (N,2,7)
        J12 = cam_ops.project_jac(cam_type, cam_params, x2_in1) @ B12
        return torch.cat([J21.reshape(-1, 7), J12.reshape(-1, 7)])

    s = torch.as_tensor(s0, dtype=dtype, device=dev)
    R = torch.as_tensor(R0, dtype=dtype, device=dev)
    t = torch.as_tensor(t0, dtype=dtype, device=dev)
    lam = torch.tensor(1e-3, dtype=dtype, device=dev)
    scale_pin = torch.zeros(7, dtype=dtype, device=dev)
    if fix_scale:
        scale_pin[0] = 1e12
    eye7 = torch.eye(7, dtype=dtype, device=dev)
    for _ in range(iters):
        r21, r12, y1, x1_in2, q, x2_in1 = residuals(s, R, t)
        r = torch.cat([r21.reshape(-1), r12.reshape(-1)])
        J = jacobian(R, s, y1, x1_in2, q, x2_in1)
        c21, c12 = chi2_of(r21, r12)
        w21 = hw(c21) * inv_sigma2_2 * m21
        w12 = hw(c12) * inv_sigma2_1 * m12
        wrow = torch.cat([w21.repeat_interleave(2), w12.repeat_interleave(2)])
        H = J.T @ (J * wrow[:, None]) + torch.diag(scale_pin)
        g = J.T @ (r * wrow)
        H = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye7
        d = -torch.linalg.solve(H, g)
        d = torch.where(torch.isfinite(d), d, 0.0)
        d = torch.cat([torch.clamp(d[:1], -0.3, 0.3), d[1:]])
        s_n = s * torch.exp(d[0])
        R_n = lie.so3_exp(d[1:4]) @ R
        t_n = t + d[4:7]
        better = robust_cost(s_n, R_n, t_n) < robust_cost(s, R, t)
        s = torch.where(better, s_n, s)
        R = torch.where(better, R_n, R)
        t = torch.where(better, t_n, t)
        lam = torch.where(better, torch.clamp(lam * 0.5, min=1e-6),
                          torch.clamp(lam * 4.0, max=1e4))
    c21, c12 = chi2_of(*residuals(s, R, t)[:2])
    inl = ((c21 < chi2_th) | ~valid21) & (c12 < chi2_th) & valid
    return Sim3OptResult(s=s, R=R, t=t, inliers=inl,
                         n_inliers=torch.sum(inl.to(torch.int32)))
