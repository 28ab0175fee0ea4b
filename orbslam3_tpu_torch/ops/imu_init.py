"""Inertial-only MAP optimization: gravity direction, scale, biases, velocities.

Port of ``orbslam3_tpu/ops/imu_init.py`` (reference
``Optimizer::InertialOptimization``, src/Optimizer.cc:5072, and
``Map::ApplyScaledRotation``): keyframe poses fixed; gravity rotation
Rwg0·Exp([gx, gy, 0]), scale exp(sigma), shared biases and per-keyframe
velocities solved over the 9-dim preintegration residuals. A closed-form
linear seed (gyro bias, then scale / gravity / velocities) starts a fixed
number of damped Gauss-Newton steps, one robust reweighting round, then half
as many again. Jacobians are forward-mode derivatives of the batched residual
(``lie.jacobian_fwd``).

Every solve is ``solve_ex`` / ``cholesky_ex`` without error checks: a
singular or indefinite system gives non-finite numbers, as in the reference
package, never an exception or a host synchronization.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import imu as imu_ops
from . import lie
from .stereo import _median_as_jax


class InertialInitResult(NamedTuple):
    Rwg: torch.Tensor     # (3,3) gravity-alignment rotation (world' ← world)
    scale: torch.Tensor   # () map scale correction
    bg: torch.Tensor      # (3,)
    ba: torch.Tensor      # (3,)
    vels: torch.Tensor    # (K,3) body velocities in (unscaled) world frame
    cost: torch.Tensor


def _solve(A, b):
    return torch.linalg.solve_ex(A, b[..., None], check_errors=False)[0][..., 0]


def _tri_inv(C):
    """Inverse of the lower Cholesky factor of each (…,9,9) covariance."""
    L = torch.linalg.cholesky_ex(C, check_errors=False)[0]
    eye = torch.eye(C.shape[-1], dtype=C.dtype, device=C.device).expand(C.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def _bmv(M, v):
    """(K,i,j)·(K,j) → (K,i)."""
    return (M @ v[..., None])[..., 0]


def _residuals(params, R_wb, p_wb, dT, dR, dV, dP, JRg, JVg, JVa, JPg, JPa,
               opt_scale, Rwg0):
    """params (B, n) = [gx, gy, sigma, bg(3), ba(3), vels(K*3)] per row;
    Rwg = Rwg0·Exp([gx, gy, 0]). Returns (B, K-1, 9)."""
    K = R_wb.shape[0]
    B = params.shape[0]
    gx, gy, sigma = params[:, 0], params[:, 1], params[:, 2]
    bg = params[:, 3:6]
    ba = params[:, 6:9]
    vels = params[:, 9:].reshape(B, K, 3)
    Rwg = Rwg0 @ lie.so3_exp(torch.stack([gx, gy, torch.zeros_like(gx)], dim=-1))
    g = _bmv(Rwg, imu_ops.gravity_vec(params.dtype, params.device))     # (B,3)

    # bias-corrected deltas (first-order, reference EdgeInertialGS)
    bgc, bac = bg[:, None, :], ba[:, None, :]
    dR_c = dR @ lie.so3_exp(_bmv(JRg, bgc))
    dV_c = dV + _bmv(JVg, bgc) + _bmv(JVa, bac)
    dP_c = dP + _bmv(JPg, bgc) + _bmv(JPa, bac)

    R1, R2 = R_wb[:-1], R_wb[1:]
    R1T = R1.transpose(-1, -2)
    p1, p2 = p_wb[:-1], p_wb[1:]
    if opt_scale:
        s = torch.exp(sigma)[:, None, None]
        p1, p2 = p1 * s, p2 * s
    v1, v2 = vels[:, :-1], vels[:, 1:]
    t = dT[:, None]
    gt = g[:, None, :]
    # er = Log(ΔR_cᵀ · R1ᵀ · R2)
    er = lie.so3_log(dR_c.transpose(-1, -2) @ R1T @ R2)
    ev = _bmv(R1T, v2 - v1 - gt * t) - dV_c
    ep = _bmv(R1T, p2 - p1 - v1 * t - 0.5 * gt * t * t) - dP_c
    return torch.cat([er, ev, ep], dim=-1)


def inertial_init(R_wb, p_wb, dT, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, pair_valid,
                  cov=None, opt_scale: bool = True, iters: int = 30,
                  prior_g: float = 1e2, prior_a: float = 1e6) -> InertialInitResult:
    """Solve for gravity / scale / biases / velocities given fixed keyframe
    body poses: (K,...) poses, (K-1,...) preintegration terms between
    consecutive keyframes, ``cov`` (K-1,9,9) their covariances (information
    = C⁻¹, with the reference package's visual-noise floor added)."""
    K = R_wb.shape[0]
    dtype, dev = p_wb.dtype, p_wb.device
    eye9 = torch.eye(9, dtype=dtype, device=dev)
    if cov is None:
        Linv = eye9.expand(K - 1, 9, 9)
    else:
        floor = torch.tensor([1e-4] * 3 + [2.5e-3] * 3 + [4e-4] * 3, dtype=dtype,
                             device=dev)
        Linv = _tri_inv(cov + torch.diag(floor))

    # ---- closed-form linear seed (gyro bias → scale/gravity/velocities) ----
    pv = pair_valid.to(dtype)
    R1, R2 = R_wb[:-1], R_wb[1:]
    R1T = R1.transpose(-1, -2)
    # 1) gyro bias from rotation alignment: er(bg) ≈ er0 − JRg·bg
    er0 = lie.so3_log(dR.transpose(-1, -2) @ R1T @ R2)
    Ag = torch.einsum("kij,kil,k->jl", JRg, JRg, pv) + 1e-6 * torch.eye(3, dtype=dtype,
                                                                       device=dev)
    bgv = torch.einsum("kij,ki,k->j", JRg, er0, pv)
    bg_seed = _solve(Ag, bgv)
    # 2) bias-corrected deltas at bg_seed (ba = 0)
    dV_c = dV + JVg @ bg_seed
    dP_c = dP + JPg @ bg_seed
    # 3) linear system in x = [s, g(3), v_0..v_{K-1}]
    n_lin = 4 + 3 * K
    Km1 = K - 1
    t_ = dT[:, None, None]
    W = Linv[:, 3:9, 3:9]
    A = torch.zeros((Km1, 6, n_lin), dtype=dtype, device=dev)
    s_col = _bmv(R1T, p_wb[1:] - p_wb[:-1])
    if opt_scale:
        A[:, 3:6, 0] = s_col
    A[:, 0:3, 1:4] = -t_ * R1T
    A[:, 3:6, 1:4] = -0.5 * t_ * t_ * R1T
    idx = torch.arange(Km1, device=dev)
    for r in range(3):
        for c in range(3):
            A[idx, r, 4 + 3 * idx + c] += -R1T[:, r, c]
            A[idx, r, 4 + 3 * (idx + 1) + c] += R1T[:, r, c]
            A[idx, 3 + r, 4 + 3 * idx + c] += -dT * R1T[:, r, c]
    b_lin = torch.cat([dV_c, dP_c], dim=-1)                 # (K-1,6)
    if not opt_scale:
        # s fixed at 1: its column moves to the right-hand side
        b_lin = torch.cat([b_lin[:, :3], b_lin[:, 3:6] - s_col], dim=-1)
    Aw = (W @ A) * pv[:, None, None]
    bw = _bmv(W, b_lin) * pv[:, None]
    Am = Aw.reshape(-1, n_lin)
    bm = bw.reshape(-1)
    H = Am.T @ Am + 1e-8 * torch.eye(n_lin, dtype=dtype, device=dev)
    x = _solve(H, Am.T @ bm)
    s_lin = x[0] if opt_scale else torch.ones((), dtype=dtype, device=dev)
    g_lin = x[1:4]
    v_lin = x[4:].reshape(K, 3)
    # gravity-alignment rotation from the linear g estimate
    dirG = g_lin / torch.clamp(torch.linalg.norm(g_lin), min=1e-9)
    gI = torch.tensor([0.0, 0.0, -1.0], dtype=dtype, device=dev)
    axis = torch.linalg.cross(gI, dirG)
    sin_n = torch.linalg.norm(axis)
    ang = torch.atan2(sin_n, torch.dot(gI, dirG))
    axis = torch.where(sin_n > 1e-6, axis / torch.clamp(sin_n, min=1e-9),
                       torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev))
    Rwg0 = lie.so3_exp(axis * ang)

    args = (R_wb, p_wb, dT, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, opt_scale, Rwg0)

    def whitened(p):
        # (B, n) → (B, K-1, 9)
        return _bmv(Linv, _residuals(p, *args))

    def res_flat(p):
        return (whitened(p) * pair_valid[:, None]).reshape(p.shape[0], -1)

    sigma0 = (torch.log(torch.clamp(s_lin, 1e-3, 1e3)) if opt_scale
              else torch.zeros((), dtype=dtype, device=dev))
    params0 = torch.cat([torch.zeros(2, dtype=dtype, device=dev), sigma0[None], bg_seed,
                         torch.zeros(3, dtype=dtype, device=dev), v_lin.reshape(-1)])
    n = params0.shape[0]
    prior = torch.cat([torch.zeros(3, dtype=dtype, device=dev),
                       torch.full((3,), prior_g, dtype=dtype, device=dev),
                       torch.full((3,), prior_a, dtype=dtype, device=dev),
                       torch.zeros(3 * K, dtype=dtype, device=dev)])
    eye_n = torch.eye(n, dtype=dtype, device=dev)

    def gn(fn, p, lam, n_steps):
        # the reference's fixed-length scan with its accept/reject rule
        for _ in range(n_steps):
            r, J = lie.jacobian_fwd(fn, p)
            H = J.T @ J + torch.diag(prior) + lam * eye_n
            b = -J.T @ r - prior * p
            p_new = p + _solve(H, b)
            good = torch.sum(fn(p_new[None]) ** 2) < torch.sum(r ** 2)
            p = torch.where(good, p_new, p)
            lam = torch.where(good, lam * 0.5, lam * 5.0)
        return p

    lam0 = torch.tensor(1e-3, dtype=dtype, device=dev)
    p = gn(res_flat, params0, lam0, iters)

    # one robust reweighting round: drop pairs whose whitened residual² is an
    # outlier. The median is jnp.median's: NaN as soon as one pair is invalid,
    # and then (nan → 1e12) the cut keeps every pair
    pc = torch.sum(whitened(p[None])[0] ** 2, dim=-1)
    med = _median_as_jax(torch.where(pair_valid, pc, float("nan")))
    med = torch.nan_to_num(med, nan=1e12)
    keep = pair_valid & (pc <= 5.0 * med)

    def res_flat2(q):
        return (whitened(q) * keep[:, None]).reshape(q.shape[0], -1)

    p = gn(res_flat2, p, lam0, iters // 2)
    Rwg = Rwg0 @ lie.so3_exp(torch.stack([p[0], p[1], torch.zeros_like(p[0])]))
    return InertialInitResult(
        Rwg=Rwg,
        scale=torch.exp(p[2]) if opt_scale else torch.ones((), dtype=dtype, device=dev),
        bg=p[3:6], ba=p[6:9], vels=p[9:].reshape(K, 3),
        cost=torch.sum(res_flat(p[None]) ** 2))


def apply_scaled_rotation(R_cw, t_cw, mp_xyz, Rgw, s):
    """Gravity-align and rescale the whole map (reference
    Map::ApplyScaledRotation): world' = s · Rgw · world. R_cw/t_cw (K,3,3),
    (K,3) camera poses; mp_xyz (P,3). Returns (R_cw', t_cw', mp_xyz')."""
    R_new = R_cw @ Rgw.T
    t_new = t_cw * s
    mp_new = s * (mp_xyz @ Rgw.T)
    return R_new, t_new, mp_new
