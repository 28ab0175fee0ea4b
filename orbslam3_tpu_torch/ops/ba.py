"""Bundle adjustment: Levenberg-Marquardt with block-sparse Schur complement.

Port of ``orbslam3_tpu/ops/ba.py`` (monocular and stereo rows; the two-camera
rig rows are not ported yet). The problem is SoA tensors with validity masks:
K poses, P landmarks, O observations. Each LM step scatter-adds the
per-observation blocks into Hpp (K,6,6), Hll (P,3,3) and the cross tensor
B (P,K,6,3), forms the reduced camera system S = Hpp − Σ_p B_p Hll_p⁻¹ B_pᵀ
as dense products, solves it with a Cholesky factorization and
back-substitutes the landmarks.

The scatters are ``index_add_``; on CUDA they are atomics whose summation
order changes from run to run, so two runs on the card agree to float32
rounding, not bit for bit. Products always run in full float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import camera as cam_ops
from . import lie

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class BAProblem(NamedTuple):
    R: torch.Tensor              # (K,3,3) world→cam rotations
    t: torch.Tensor              # (K,3)
    pts: torch.Tensor            # (P,3) world points
    obs_kf: torch.Tensor         # (O,) int
    obs_mp: torch.Tensor         # (O,) int
    obs_uv: torch.Tensor         # (O,2)
    obs_inv_sigma2: torch.Tensor  # (O,)
    obs_valid: torch.Tensor      # (O,) bool
    fixed_pose: torch.Tensor     # (K,) bool
    obs_ur: torch.Tensor = None  # (O,) right-image u; <0 ⇒ mono observation
    bf: float = 0.0              # baseline*fx


class BAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    pts: torch.Tensor
    obs_inlier: torch.Tensor     # (O,) bool final chi2 classification
    chi2: torch.Tensor           # () robust total on valid+inlier obs
    n_inlier: torch.Tensor


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form (adjugate) 3x3 inverse."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    adj = torch.stack([torch.stack([A, D, G], -1),
                       torch.stack([B, E, H], -1),
                       torch.stack([C, F, I], -1)], -2)
    return adj / det[..., None, None]


def _obs_ur(p: BAProblem):
    if p.obs_ur is None:
        return torch.full(p.obs_kf.shape, -1.0, dtype=p.pts.dtype, device=p.pts.device)
    return p.obs_ur


def _linearize(p: BAProblem, pts, R, t, w_mask, cam_type, cam_params, huber):
    """Return (chi2 (O,), w_row (O,3), Jpose (O,3,6), Jpt (O,3,3), r (O,3)).
    Row 3 is the stereo right-column residual, zero-weighted for mono rows."""
    kf = p.obs_kf.long()
    Rk = R[kf]
    xc = (Rk @ pts[p.obs_mp.long()][..., None])[..., 0] + t[kf]
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(xc.shape[:-1] + (3, 3))
    Jse3 = torch.cat([-lie.hat(xc), eye], dim=-1)                     # (O,3,6)
    pos = xc[..., 2] > 1e-3
    xc = torch.cat([xc[..., :2], torch.clamp(xc[..., 2:3], min=1e-2)], dim=-1)
    pred = cam_ops.project(cam_type, cam_params, xc)
    Jproj = cam_ops.project_jac(cam_type, cam_params, xc)             # (O,2,3)
    r_uv = p.obs_uv - pred

    obs_ur = _obs_ur(p)
    has_ur = obs_ur >= 0
    z = xc[..., 2]
    bf = torch.as_tensor(p.bf, dtype=xc.dtype, device=xc.device)
    ur_pred = pred[..., 0] - bf / z
    r_ur = torch.where(has_ur, obs_ur - ur_pred, 0.0)
    zero = torch.zeros_like(z)
    Jur_xc = Jproj[:, 0, :] + torch.stack([zero, zero, bf / (z * z)], dim=-1)
    r = torch.cat([r_uv, r_ur[..., None]], dim=-1)                    # (O,3)
    Jxc = torch.cat([Jproj, Jur_xc[:, None, :]], dim=1)               # (O,3,3)
    Jpose = Jxc @ Jse3                                                # (O,3,6)
    Jpt = Jxc @ Rk                                                    # (O,3,3)
    row_w = torch.cat([torch.ones_like(r_uv), has_ur[..., None].to(r.dtype)], dim=-1)

    chi2 = torch.sum(r * r * row_w, dim=-1) * p.obs_inv_sigma2
    chi2 = torch.where(pos, chi2, 1e9)   # behind-camera ⇒ never an inlier
    huber_eff = torch.where(has_ur, huber * (CHI2_STEREO / CHI2_MONO) ** 0.5, huber)
    rn = torch.sqrt(chi2 + 1e-12)
    w_huber = torch.where(rn <= huber_eff, 1.0, huber_eff / rn)
    w = w_mask * pos.to(xc.dtype) * p.obs_inv_sigma2 * w_huber
    return chi2, w[:, None] * row_w, Jpose, Jpt, r


def _robust_cost_elems(chi2, w_mask, huber):
    """Per-observation Huber cost (for LM accept/reject)."""
    d2 = huber * huber
    cost = torch.where(chi2 <= d2, chi2, 2.0 * huber * torch.sqrt(chi2 + 1e-12) - d2)
    return cost * w_mask


def _gn_step_from_lin(p: BAProblem, pts, R, t, lin, lam):
    """One damped Schur step from a precomputed linearization."""
    K = p.R.shape[0]
    P = p.pts.shape[0]
    dtype, dev = pts.dtype, pts.device
    _, w, Jpose, Jpt, r = lin
    kf = p.obs_kf.long()
    mp = p.obs_mp.long()

    wJp = w[..., None] * Jpose                                         # (O,3,6)
    wJl = w[..., None] * Jpt                                           # (O,3,3)
    Hpp = torch.zeros((K, 6, 6), dtype=dtype, device=dev).index_add_(
        0, kf, Jpose.transpose(1, 2) @ wJp)
    bp = torch.zeros((K, 6), dtype=dtype, device=dev).index_add_(
        0, kf, torch.sum(wJp * r[..., None], dim=1))
    Hll = torch.zeros((P, 3, 3), dtype=dtype, device=dev).index_add_(
        0, mp, Jpt.transpose(1, 2) @ wJl)
    bl = torch.zeros((P, 3), dtype=dtype, device=dev).index_add_(
        0, mp, torch.sum(wJl * r[..., None], dim=1))
    B = torch.zeros((P * K, 6, 3), dtype=dtype, device=dev).index_add_(
        0, mp * K + kf, Jpose.transpose(1, 2) @ wJl).reshape(P, K, 6, 3)

    # landmark damping + guard for unobserved points
    diagl = torch.diagonal(Hll, dim1=-2, dim2=-1)
    Hll = Hll + torch.diag_embed(lam * diagl + 1e-6)
    Hll_inv = inv3(Hll)

    # Schur complement S = Hpp − Σ_p B_p Hll_p⁻¹ B_pᵀ as two dense products
    C = B @ Hll_inv[:, None]                                           # (P,K,6,3)
    S = -(C.permute(1, 2, 0, 3).reshape(K * 6, P * 3)
          @ B.permute(0, 3, 1, 2).reshape(P * 3, K * 6))               # (6K,6K)
    Sb = S.reshape(K, 6, K, 6)
    ar = torch.arange(K, device=dev)
    Sb[ar, :, ar, :] += Hpp
    bs = bp - torch.einsum("pkim,pm->ki", C, bl)

    # pose damping + fixed-pose gauge handling
    Sm = Sb.reshape(K * 6, K * 6)
    Sm = Sm + torch.diag(lam * torch.diagonal(Sm) + 1e-6)
    free = (~p.fixed_pose).repeat_interleave(6)
    Sm = torch.where(free[:, None] & free[None, :], Sm, 0.0)
    Sm = Sm + torch.diag(torch.where(free, 0.0, 1.0))
    bs_flat = torch.where(free, bs.reshape(-1), 0.0)

    L, _ = torch.linalg.cholesky_ex(Sm)
    dx0 = torch.cholesky_solve(bs_flat[:, None], L)[:, 0]
    if K >= 64:
        # one iterative-refinement pass for the large, ill-conditioned systems
        dx0 = dx0 + torch.cholesky_solve((bs_flat - Sm @ dx0)[:, None], L)[:, 0]
    dx = dx0.reshape(K, 6)
    dl = (Hll_inv @ (bl - torch.einsum("pkim,ki->pm", B, dx))[..., None])[..., 0]

    dR, dt = lie.se3_exp(dx)
    Rn, tn = lie.se3_compose(dR, dt, R, t)
    Rn = torch.where(p.fixed_pose[:, None, None], R, Rn)
    tn = torch.where(p.fixed_pose[:, None], t, tn)
    # only move points that actually have (weighted) observations
    has_obs = torch.zeros(P, dtype=dtype, device=dev).index_add_(0, mp, torch.sum(w, -1)) > 0
    ptsn = torch.where(has_obs[:, None], pts + dl, pts)
    return Rn, tn, ptsn


def ba_iterate(p: BAProblem, n_iters: int, inlier: torch.Tensor,
               cam_params: torch.Tensor, cam_type: int = cam_ops.PINHOLE,
               huber_chi2: float = CHI2_MONO):
    """Run n_iters LM iterations with the given inlier mask → (R, t, pts).
    One linearization per iteration: the candidate's doubles as its
    acceptance cost and, when accepted, as the next step's system."""
    dtype = p.pts.dtype
    huber = torch.sqrt(torch.tensor(huber_chi2, dtype=dtype, device=p.pts.device))
    w_mask = (p.obs_valid & inlier).to(dtype)

    def lin_at(pts, R, t):
        return _linearize(p, pts, R, t, w_mask, cam_type, cam_params, huber)

    R, t, pts = p.R, p.t, p.pts
    lin = lin_at(pts, R, t)
    cost_e = _robust_cost_elems(lin[0], w_mask, huber)
    lam = torch.tensor(1e-4, dtype=dtype, device=p.pts.device)
    for _ in range(n_iters):
        Rn, tn, ptsn = _gn_step_from_lin(p, pts, R, t, lin, lam)
        lin_n = lin_at(ptsn, Rn, tn)
        cost_en = _robust_cost_elems(lin_n[0], w_mask, huber)
        # accept on the sum of per-observation differences (see the reference)
        good = (torch.sum(cost_en - cost_e)
                < -1e-6 * torch.clamp(torch.sum(cost_e), min=1.0))
        R = torch.where(good, Rn, R)
        t = torch.where(good, tn, t)
        pts = torch.where(good, ptsn, pts)
        cost_e = torch.where(good, cost_en, cost_e)
        lin = tuple(torch.where(good, a, b) for a, b in zip(lin_n, lin))
        lam = torch.where(good, lam * 0.5, lam * 4.0)
    return R, t, pts


def classify_inliers(p: BAProblem, cam_params: torch.Tensor,
                     cam_type: int = cam_ops.PINHOLE, chi2_th: float = CHI2_MONO):
    """Chi2 classification at the problem's current state → (inlier, chi2)."""
    huber = torch.sqrt(torch.tensor(chi2_th, dtype=p.pts.dtype, device=p.pts.device))
    chi2 = _linearize(p, p.pts, p.R, p.t, p.obs_valid.to(p.pts.dtype), cam_type,
                      cam_params, huber)[0]
    return (chi2 < chi2_th) & p.obs_valid, chi2


def local_ba(p: BAProblem, cam_params: torch.Tensor, cam_type: int = cam_ops.PINHOLE,
             chi2_th: float = CHI2_MONO, iters1: int = 5, iters2: int = 10) -> BAResult:
    """Two-phase local BA: optimize(iters1), reclassify chi2 outliers,
    optimize(iters2), final classification."""
    ones = torch.ones(p.obs_kf.shape[0], dtype=torch.bool, device=p.pts.device)
    R, t, pts = ba_iterate(p, iters1, ones, cam_params, cam_type, chi2_th)
    p1 = p._replace(R=R, t=t, pts=pts)
    inlier, _ = classify_inliers(p1, cam_params, cam_type, chi2_th)
    R, t, pts = ba_iterate(p1, iters2, inlier, cam_params, cam_type, chi2_th)
    p2 = p1._replace(R=R, t=t, pts=pts)
    inlier, chi2 = classify_inliers(p2, cam_params, cam_type, chi2_th)
    return BAResult(R=R, t=t, pts=pts, obs_inlier=inlier,
                    chi2=torch.sum(torch.where(inlier, chi2, 0.0)),
                    n_inlier=torch.sum(inlier, dtype=torch.int32))
