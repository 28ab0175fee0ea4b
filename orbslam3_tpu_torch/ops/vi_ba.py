"""Visual-inertial optimization: the sliding-window pose / velocity / bias
smoother, the frame-rate 15-dim pose-inertial solve and the joint landmark +
pose / velocity / bias bundle adjustment.

Port of ``vi_window_optimize``, ``pose_inertial_optimize`` and
``vi_joint_ba`` of ``orbslam3_tpu/ops/vi_ba.py`` (the pose side of the
reference's LocalInertialBA, src/Optimizer.cc:4314, against fixed landmarks;
PoseInertialOptimizationLastFrame, :7785; LocalInertialBA / FullInertialBA,
:4314 / :495).
The fixed iteration counts and the accept / reject rule are the reference
package's; Jacobians of the packed residuals are forward-mode derivatives on
batched dual tensors (``lie.jacobian_fwd``, ``_pair_jacobians``).

The linear algebra is ``cholesky_ex`` / ``solve_ex`` / ``inv_ex`` without
error checks: an indefinite or singular system gives non-finite numbers as
in the reference package (``vi_joint_ba`` then zeroes a non-finite step),
never an exception or a host synchronization.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.autograd.forward_ad as fwAD

from . import camera as cam_ops
from . import imu as imu_ops
from . import lie


def _solve(A, b):
    return torch.linalg.solve_ex(A, b[..., None], check_errors=False)[0][..., 0]


def _chol(A):
    return torch.linalg.cholesky_ex(A, check_errors=False)[0]


def _tri_inv(L):
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


class VIBAResult(NamedTuple):
    R: torch.Tensor       # (K,3,3) world→cam
    t: torch.Tensor       # (K,3)
    vels: torch.Tensor    # (K,3)
    bg: torch.Tensor
    ba: torch.Tensor
    cost: torch.Tensor


def vi_window_optimize(
    R0, t0, vels0, bg0, ba0,
    pts_w, obs_kf, obs_uv, obs_inv_sigma2, obs_valid,
    dT, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, pre_cov, pair_valid,
    cam_params, fixed_pose, cam_type: int = 0, iters: int = 8,
    huber_chi2: float = 5.991, prior_g: float = 1e2, prior_a: float = 1e5,
) -> VIBAResult:
    """Optimize K poses, K velocities and one shared gyro / accelerometer
    bias against fixed landmarks: Huber-weighted reprojection rows, 9-dim
    preintegration rows between consecutive keyframes (whitened by the
    preintegration covariance), and the bias priors. ``iters`` damped
    Gauss-Newton steps on the packed vector (pose deltas, absolute
    velocities and biases), each accepted only if it lowers the cost.

    Shapes: poses (K,…); visual rows (O,) with the landmark of each row in
    ``pts_w`` (O,3); inertial terms (K-1,…). ``fixed_pose`` (K,) nodes keep
    their pose (the reference fixes the window's boundary keyframe). The
    Jacobian is one forward-mode pass over the packed vector
    (``lie.jacobian_fwd``, under ``lie.FORWARD_AD_LOCK``)."""
    K = R0.shape[0]
    dtype, dev = t0.dtype, t0.device
    huber = float(huber_chi2) ** 0.5
    L = _chol(pre_cov + 1e-10 * torch.eye(9, dtype=dtype, device=dev))
    Linv = _tri_inv(L)
    n_pose, n_vel = 6 * K, 3 * K
    n = n_pose + n_vel + 6
    g = imu_ops.gravity_vec(dtype, dev)
    sw = torch.sqrt(obs_inv_sigma2)[:, None]
    w_obs = obs_valid.to(dtype)
    tt = dT[:, None]
    kf = obs_kf.long()

    def unpack(p):
        """(B,n) packed vectors → (R, t, vels, bg, ba), each with the batch."""
        B = p.shape[0]
        dRp, dtp = lie.se3_exp(p[:, :n_pose].reshape(B, K, 6))
        Rn, tn = lie.se3_compose(dRp, dtp, R0, t0)
        Rn = torch.where(fixed_pose[:, None, None], R0, Rn)
        tn = torch.where(fixed_pose[:, None], t0, tn)
        vels = p[:, n_pose:n_pose + n_vel].reshape(B, K, 3)
        return Rn, tn, vels, p[:, n_pose + n_vel:n_pose + n_vel + 3], p[:, n_pose + n_vel + 3:]

    def residuals(p):
        """(B,n) → (B,m)."""
        B = p.shape[0]
        Rn, tn, vels, bg, ba = unpack(p)
        # visual
        xc = _mv(Rn[:, kf], pts_w) + tn[:, kf]
        pos = xc[..., 2] > 1e-3
        xc = torch.cat([xc[..., :2], torch.clamp(xc[..., 2:3], min=1e-2)], dim=-1)
        rv = (obs_uv - cam_ops.project(cam_type, cam_params, xc)) * sw
        chi = torch.sum(rv * rv, dim=-1)
        w_h = torch.sqrt(torch.where(chi > huber * huber,
                                     huber / torch.sqrt(chi + 1e-12), 1.0))
        rv = rv * (w_h * w_obs * pos.to(dtype))[..., None]
        # inertial: body = camera (Tbc = I), the body pose is the inverse
        R_wb = Rn.transpose(-1, -2)
        p_wb = -_mv(R_wb, tn)
        dbg = bg - bg0
        dba = ba - ba0
        dR_c = dR @ lie.so3_exp(_mv(JRg, dbg[:, None]))
        dV_c = dV + _mv(JVg, dbg[:, None]) + _mv(JVa, dba[:, None])
        dP_c = dP + _mv(JPg, dbg[:, None]) + _mv(JPa, dba[:, None])
        R1, R2 = R_wb[:, :-1], R_wb[:, 1:]
        p1, p2 = p_wb[:, :-1], p_wb[:, 1:]
        v1, v2 = vels[:, :-1], vels[:, 1:]
        R1T = R1.transpose(-1, -2)
        er = lie.so3_log(dR_c.transpose(-1, -2) @ R1T @ R2)
        ev = _mv(R1T, v2 - v1 - g * tt) - dV_c
        ep = _mv(R1T, p2 - p1 - v1 * tt - 0.5 * g * tt * tt) - dP_c
        ri = _mv(Linv, torch.cat([er, ev, ep], dim=-1)) * pair_valid.to(dtype)[:, None]
        # bias priors
        rb = torch.cat([prior_g ** 0.5 * dbg, prior_a ** 0.5 * dba], dim=-1)
        return torch.cat([rv.reshape(B, -1), ri.reshape(B, -1), rb], dim=-1)

    p = torch.cat([torch.zeros(n_pose, dtype=dtype, device=dev), vels0.reshape(-1), bg0, ba0])
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    eye = torch.eye(n, dtype=dtype, device=dev)
    for _ in range(iters):
        r, J = lie.jacobian_fwd(residuals, p)
        H = J.T @ J + lam * eye
        p_new = p + _solve(H, -J.T @ r)
        good = torch.sum(residuals(p_new[None])[0] ** 2) < torch.sum(r ** 2)
        p = torch.where(good, p_new, p)
        lam = torch.where(good, lam * 0.5, lam * 5.0)
    Rn, tn, vels, bg, ba = (x[0] for x in unpack(p[None]))
    return VIBAResult(R=Rn, t=tn, vels=vels, bg=bg, ba=ba,
                      cost=torch.sum(residuals(p[None])[0] ** 2))


class PoseInertialResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    v: torch.Tensor
    inlier: torch.Tensor
    n_inliers: torch.Tensor
    H_marg: torch.Tensor       # (15,15) marginal information on (pose, vel, bias)
    prev_moved: torch.Tensor   # (15,) increment applied to the previous state
    bg: torch.Tensor           # (3,) current gyro bias
    ba: torch.Tensor           # (3,) current accel bias


def pose_inertial_optimize(
    R0, t0, v0, R1_wb, p1_wb, v1,
    bg, ba, dT, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, pre_cov,
    pts_w, obs_uv, obs_inv_sigma2, obs_valid, cam_params,
    cam_type: int = 0, iters: int = 12, chi2_th: float = 5.991,
    prior_H=None, sigma_gw: float = 1e-5, sigma_aw: float = 1e-4,
) -> PoseInertialResult:
    """Frame-rate visual-inertial pose optimization: the current frame's
    pose + velocity + biases against the previous 15-dim state through the
    preintegration edge, the bias random-walk edges and the visual rows;
    4 rounds of ``iters // 3`` damped Gauss-Newton steps with chi2 gates
    {12, 7.5, chi2_th, chi2_th}.

    The previous body state enters as a variable held by the marginal prior
    ``prior_H`` ((15,15) information on its [δθ, δp, δv, δbg, δba]); with
    ``prior_H=None`` it is fixed. The bias deltas are parametrized in units
    of the per-frame walk std (sb = σ_walk·sqrt(dT)). The returned ``H_marg``
    is the current state's 15x15 marginal information after eliminating the
    previous state: the next frame's prior."""
    dtype, dev = t0.dtype, t0.device
    huber = torch.sqrt(torch.tensor(chi2_th, dtype=dtype, device=dev))
    C = pre_cov + torch.diag(torch.tensor([1e-8] * 3 + [1e-6] * 3 + [1e-7] * 3,
                                          dtype=dtype, device=dev))
    Linv = _tri_inv(_chol(C))
    g = imu_ops.gravity_vec(dtype, dev)

    use_prior = prior_H is not None
    n_state = 30 if use_prior else 15
    dT = torch.as_tensor(dT, dtype=dtype, device=dev)
    sb_g = sigma_gw * torch.sqrt(torch.clamp(dT, min=1e-3))
    sb_a = sigma_aw * torch.sqrt(torch.clamp(dT, min=1e-3))
    if use_prior:
        # ConstraintPoseImu: whitened prior residual on the previous state's
        # deviation from its marginal estimate (a constant factor)
        LpT = _chol(prior_H + 1e-6 * torch.eye(15, dtype=dtype, device=dev)).T

    def unpack(p):
        # p (B, n_state): one parameter vector per row
        dRp, dtp = lie.se3_exp(p[:, :6])
        R, t = lie.se3_compose(dRp, dtp, R0, t0)
        bg2 = bg + sb_g * p[:, 9:12]
        ba2 = ba + sb_a * p[:, 12:15]
        if use_prior:
            # previous BODY state perturbed on its tangent: R1' = R1 Exp(δθ)
            R1n = R1_wb @ lie.so3_exp(p[:, 15:18])
            p1n = p1_wb + p[:, 18:21]
            v1n = v1 + p[:, 21:24]
            bg1 = bg + sb_g * p[:, 24:27]
            ba1 = ba + sb_a * p[:, 27:30]
        else:
            R1n, p1n, v1n, bg1, ba1 = R1_wb, p1_wb, v1, bg, ba
        return R, t, p[:, 6:9], bg2, ba2, R1n, p1n, v1n, bg1, ba1

    def project(R, t):
        xc = pts_w @ R.transpose(-1, -2) + t[:, None, :]
        pos = xc[..., 2] > 1e-3
        xc = torch.cat([xc[..., :2], torch.clamp(xc[..., 2:3], min=1e-2)], dim=-1)
        return cam_ops.project(cam_type, cam_params, xc), pos

    sqrt_info = torch.sqrt(obs_inv_sigma2)[:, None]
    valid_f = obs_valid.to(dtype)

    def residuals(p, w_in):
        """(B, n_state) → (B, m); ``w_in`` the round's inlier weights."""
        n_b = p.shape[0]
        R, t, v, bg2, ba2, R1n, p1n, v1n, bg1, ba1 = unpack(p)
        pred, pos = project(R, t)
        rv = (obs_uv - pred) * sqrt_info
        chi = torch.sum(rv * rv, dim=-1)
        w_h = torch.sqrt(torch.where(chi > huber * huber,
                                     huber / torch.sqrt(chi + 1e-12), 1.0))
        rv = rv * (w_h * w_in * pos.to(dtype))[..., None]
        # inertial edge to the previous state, at the previous frame's bias
        dbg1 = bg1 - bg
        dba1 = ba1 - ba
        dR_c = dR @ lie.so3_exp(_mv(JRg, dbg1))
        dV_c = dV + _mv(JVg, dbg1) + _mv(JVa, dba1)
        dP_c = dP + _mv(JPg, dbg1) + _mv(JPa, dba1)
        R_wb = R.transpose(-1, -2)
        p_wb = -_mv(R_wb, t)
        R1T = R1n.transpose(-1, -2)
        er = lie.so3_log(dR_c.transpose(-1, -2) @ (R1T @ R_wb))
        ev = _mv(R1T, v - v1n - g * dT) - dV_c
        ep = _mv(R1T, p_wb - p1n - v1n * dT - 0.5 * g * dT * dT) - dP_c
        ri = _mv(Linv, torch.cat([er, ev, ep], dim=-1))
        # bias random walk between the two frames (EdgeGyroRW / EdgeAccRW),
        # exactly whitened in the scaled parametrization
        if use_prior:
            r_rw = torch.cat([p[:, 9:12] - p[:, 24:27], p[:, 12:15] - p[:, 27:30]], dim=-1)
            return torch.cat([rv.reshape(n_b, -1), ri, r_rw, _mv(LpT, p[:, 15:30])], dim=-1)
        return torch.cat([rv.reshape(n_b, -1), ri.expand(n_b, 9), p[:, 9:15]], dim=-1)

    def chi2_of(p):
        R, t = unpack(p[None])[:2]
        pred, pos = project(R, t)
        chi = torch.sum((obs_uv - pred[0]) ** 2, dim=-1) * obs_inv_sigma2
        return torch.where(pos[0], chi, 1e9)

    schedule = (12.0, 7.5, chi2_th, chi2_th)
    p = torch.cat([torch.zeros(6, dtype=dtype, device=dev), v0,
                   torch.zeros(n_state - 9, dtype=dtype, device=dev)])
    inlier = torch.ones(pts_w.shape[0], dtype=torch.bool, device=dev)
    eye_n = torch.eye(n_state, dtype=dtype, device=dev)
    for i in range(4):
        w_in = inlier.to(dtype) * valid_f

        def fn(q, w_in=w_in):
            return residuals(q, w_in)
        lam = torch.tensor(1e-4, dtype=dtype, device=dev)
        for _ in range(iters // 3):
            r, J = lie.jacobian_fwd(fn, p)
            H = J.T @ J + lam * eye_n
            p_new = p + _solve(H, -J.T @ r)
            good = torch.sum(fn(p_new[None]) ** 2) < torch.sum(r ** 2)
            p = torch.where(good, p_new, p)
            lam = torch.where(good, lam * 0.5, lam * 5.0)
        inlier = chi2_of(p) < schedule[i]
    inlier = inlier & obs_valid
    R, t, v, bg2, ba2 = (x[0] for x in unpack(p[None])[:5])
    # marginal information of the CURRENT 15-dim state: Schur-eliminate the
    # previous state from the final Hessian (reference Marginalize)
    w_fin = inlier.to(dtype) * valid_f
    Jf = lie.jacobian_fwd(lambda q: residuals(q, w_fin), p)[1]
    Hf = Jf.T @ Jf
    if use_prior:
        Hcc = Hf[:15, :15]
        Hcp = Hf[:15, 15:]
        Hpp = Hf[15:, 15:] + 1e-6 * torch.eye(15, dtype=dtype, device=dev)
        H_marg = Hcc - Hcp @ torch.linalg.solve_ex(Hpp, Hcp.T, check_errors=False)[0]
        prev_moved = p[15:30]
    else:
        H_marg = Hf[:15, :15]
        prev_moved = torch.zeros(15, dtype=dtype, device=dev)
    return PoseInertialResult(
        R=R, t=t, v=v, inlier=inlier, n_inliers=torch.sum(inlier, dtype=torch.int32),
        H_marg=H_marg, prev_moved=prev_moved, bg=bg2, ba=ba2)


class VIJointResult(NamedTuple):
    R: torch.Tensor        # (K,3,3) world→cam
    t: torch.Tensor        # (K,3)
    vels: torch.Tensor     # (K,3)
    bg: torch.Tensor       # (K,3)
    ba: torch.Tensor       # (K,3)
    pts: torch.Tensor      # (P,3)
    obs_inlier: torch.Tensor
    cost: torch.Tensor


def _pair_residual(d30, R1, t1, v1, bg1, ba1, R2, t2, v2, bg2, ba2,
                   bg0, ba0, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, dT, Linv, rw_sqrt, pv):
    """Whitened 9-dim preintegration residual + 6 bias random-walk rows of
    every keyframe pair (K-1,), at 30-dim perturbations d30 (..., K-1, 30)
    (state1 | state2) of the current linearization point. Returns
    (..., K-1, 15)."""
    def split(d15, R, t, v, bgk, bak):
        dRp, dtp = lie.se3_exp(d15[..., :6])
        Rn, tn = lie.se3_compose(dRp, dtp, R, t)
        return Rn, tn, v + d15[..., 6:9], bgk + d15[..., 9:12], bak + d15[..., 12:15]
    R1, t1, v1, bg1, ba1 = split(d30[..., :15], R1, t1, v1, bg1, ba1)
    R2, t2, v2, bg2, ba2 = split(d30[..., 15:], R2, t2, v2, bg2, ba2)
    g = imu_ops.gravity_vec(d30.dtype, d30.device)
    tt = dT[:, None]
    R1b, R2b = R1.transpose(-1, -2), R2.transpose(-1, -2)
    p1 = -_mv(R1b, t1)
    p2 = -_mv(R2b, t2)
    dbg = bg1 - bg0
    dba = ba1 - ba0
    dR_c = dR @ lie.so3_exp(_mv(JRg, dbg))
    dV_c = dV + _mv(JVg, dbg) + _mv(JVa, dba)
    dP_c = dP + _mv(JPg, dbg) + _mv(JPa, dba)
    R1bT = R1b.transpose(-1, -2)
    er = lie.so3_log(dR_c.transpose(-1, -2) @ (R1bT @ R2b))
    ev = _mv(R1bT, v2 - v1 - g * tt) - dV_c
    ep = _mv(R1bT, p2 - p1 - v1 * tt - 0.5 * g * tt * tt) - dP_c
    ri = _mv(Linv, torch.cat([er, ev, ep], dim=-1))
    rw = torch.cat([bg2 - bg1, ba2 - ba1], dim=-1) * rw_sqrt
    return torch.cat([ri, rw], dim=-1) * pv[:, None]


def _pair_jacobians(args, n_pairs: int, dtype, dev):
    """Residuals (K-1,15) at zero perturbation and their Jacobians
    (K-1,15,30): the zero perturbation is a dual tensor (30,K-1,30) whose
    k-th slice carries the tangent e_k."""
    zero = torch.zeros((n_pairs, 30), dtype=dtype, device=dev)
    basis = torch.eye(30, dtype=dtype, device=dev)[:, None, :].expand(30, n_pairs, 30)
    with lie.FORWARD_AD_LOCK, fwAD.dual_level():
        x = fwAD.make_dual(zero.expand(30, n_pairs, 30).contiguous(), basis)
        primal, tangent = fwAD.unpack_dual(_pair_residual(x, *args))
    return primal[0], tangent.permute(1, 2, 0)


def vi_joint_ba(
    R0, t0, vels0, bg0, ba0, fixed_pose,
    pts0, obs_kf, obs_mp, obs_uv, obs_ur, obs_inv_sigma2, obs_valid, bf,
    dT, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, pre_cov, pair_valid,
    cam_params, cam_type: int = 0, iters: int = 10,
    prior_g: float = 0.0, prior_a: float = 0.0,
    rw_gyro: float = 1e4, rw_acc: float = 1e3,
    fix_landmarks: bool = False, fix_vel_bias_of_fixed: bool = True,
) -> VIJointResult:
    """Joint landmark + pose/velocity/bias bundle adjustment as one Schur
    solve: landmarks (P,3) are eliminated against a dense per-keyframe state
    [δpose(6), vel(3), bg(3), ba(3)]. Residuals: visual mono / stereo rows
    with Huber √5.991 / √7.815, whitened 9-dim preintegration rows between
    consecutive keyframes (Huber √16.92), bias random-walk rows (information
    rw_*/dT), optional bias priors on the first keyframe. Pair i connects
    keyframe i → i+1 (``pair_valid`` masks broken chains). ``fixed_pose``
    keyframes keep their pose; with ``fix_vel_bias_of_fixed`` also their
    velocity and biases (LocalInertialBA's window boundary), otherwise those
    are estimated (FullInertialBA at initialization)."""
    K = R0.shape[0]
    P = pts0.shape[0]
    dtype, dev = t0.dtype, t0.device
    hub_m = torch.sqrt(torch.tensor(5.991, dtype=dtype, device=dev))
    hub_s = torch.sqrt(torch.tensor(7.815, dtype=dtype, device=dev))
    hub_i = torch.sqrt(torch.tensor(16.92, dtype=dtype, device=dev))
    NS = 15
    N = K * NS
    C = pre_cov + torch.diag(torch.tensor([1e-8] * 3 + [1e-6] * 3 + [1e-7] * 3,
                                          dtype=dtype, device=dev))
    Linv = _tri_inv(_chol(C))
    bf = torch.as_tensor(bf, dtype=dtype, device=dev)
    obs_kf_l = obs_kf.long()
    obs_mp_l = obs_mp.long()

    has_ur = obs_ur >= 0
    w_stereo_row = torch.cat([torch.ones((obs_uv.shape[0], 2), dtype=dtype, device=dev),
                              has_ur[:, None].to(dtype)], dim=-1)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    def visual_residual(R, t, pts):
        """The visual rows' residuals r (O,3) and chi2 (O,) at a state, with
        what their Jacobians reuse."""
        Rk = R[obs_kf_l]
        tk = t[obs_kf_l]
        xw = pts[obs_mp_l]
        xc = _mv(Rk, xw) + tk
        pos = xc[..., 2] > 1e-3
        xc = torch.cat([xc[..., :2], torch.clamp(xc[..., 2:3], min=1e-2)], dim=-1)
        pred = cam_ops.project(cam_type, cam_params, xc)
        r_uv = obs_uv - pred
        z = xc[..., 2]
        ur_pred = pred[..., 0] - bf / z
        r_ur = torch.where(has_ur, obs_ur - ur_pred, 0.0)
        r = torch.cat([r_uv, r_ur[:, None]], dim=-1)                   # (O,3)
        chi2 = torch.sum(r * r * w_stereo_row, dim=-1) * obs_inv_sigma2
        chi2 = torch.where(pos, chi2, 1e9)
        return chi2, r, pos, xc, Rk

    def visual_linearize(R, t, pts, w_mask):
        chi2, r, pos, xc, Rk = visual_residual(R, t, pts)
        Jproj = cam_ops.project_jac(cam_type, cam_params, xc)          # (O,2,3)
        # left-increment se3: d xc/d xi = [ -[xc]x | I ]
        Jse3 = torch.cat([-lie.hat(xc), eye3.expand(xc.shape[:-1] + (3, 3))], dim=-1)
        z = xc[..., 2]
        zero = torch.zeros_like(z)
        Jur = Jproj[:, 0, :] + torch.stack([zero, zero, bf / (z * z)], dim=-1)
        Jxc = torch.cat([Jproj, Jur[:, None, :]], dim=1)               # (O,3,3)
        Jpose = Jxc @ Jse3                                             # (O,3,6)
        Jpt = Jxc @ Rk
        hub = torch.where(has_ur, hub_s, hub_m)
        rn = torch.sqrt(chi2 + 1e-12)
        w_h = torch.where(rn <= hub, 1.0, hub / rn)
        w = w_mask * pos.to(dtype) * obs_inv_sigma2 * w_h
        return chi2, w[:, None] * w_stereo_row, Jpose, Jpt, r

    i1 = torch.arange(K - 1, device=dev)
    i2 = i1 + 1
    dT_c = torch.clamp(dT, min=1e-3)[:, None]
    rw_w = torch.cat([torch.full((K - 1, 3), rw_gyro, dtype=dtype, device=dev) / dT_c,
                      torch.full((K - 1, 3), rw_acc, dtype=dtype, device=dev) / dT_c], dim=-1)
    pv = pair_valid.to(dtype)
    z30 = torch.zeros((K - 1, 30), dtype=dtype, device=dev)

    def pair_args(R, t, v, bg, ba):
        return (R[i1], t[i1], v[i1], bg[i1], ba[i1], R[i2], t[i2], v[i2], bg[i2], ba[i2],
                bg0[i1], ba0[i1], dR, dV, dP, JRg, JVg, JVa, JPg, JPa, dT, Linv,
                torch.sqrt(rw_w), pv)

    def inertial_weights(res):
        # robust (Huber) on the 9-dim preintegration part
        rn = torch.sqrt(torch.sum(res[:, :9] ** 2, dim=-1) + 1e-12)
        w_h = torch.where(rn <= hub_i, 1.0, hub_i / rn)
        return torch.cat([w_h[:, None].expand(K - 1, 9),
                          torch.ones((K - 1, 6), dtype=dtype, device=dev)], dim=-1)

    rows_idx = torch.cat([i1[:, None] * NS + torch.arange(NS, device=dev)[None, :],
                          i2[:, None] * NS + torch.arange(NS, device=dev)[None, :]],
                         dim=-1)                                         # (K-1,30)
    pose_idx = (torch.arange(K, device=dev)[:, None] * NS
                + torch.arange(6, device=dev)[None, :]).reshape(-1)
    if fix_vel_bias_of_fixed:
        free = (~fixed_pose).repeat_interleave(NS)
    else:
        per = torch.cat([torch.zeros(6, dtype=torch.bool, device=dev),
                         torch.ones(9, dtype=torch.bool, device=dev)])
        free = (~fixed_pose).repeat_interleave(NS) | per.repeat(K)
    free2 = free[:, None] & free[None, :]
    gauge = torch.diag(torch.where(free, 0.0, 1.0).to(dtype))

    def visual_cost(chi2, w_mask):
        d2 = 5.991
        cv = torch.where(chi2 <= d2, chi2,
                         2.0 * torch.sqrt(torch.tensor(d2, dtype=dtype, device=dev))
                         * torch.sqrt(chi2 + 1e-12) - d2)
        return torch.sum(cv * w_mask)

    def assemble_and_solve(R, t, v, bg, ba, pts, w_mask, lam):
        """One damped Schur step from the current state; also returns the
        current state's cost (``total_cost``), from the same linearization."""
        chi2, w_row, Jpose, Jpt, r = visual_linearize(R, t, pts, w_mask)
        # landmark blocks
        All = torch.einsum("oik,oi,oil->okl", Jpt, w_row, Jpt)
        Hll = torch.zeros((P, 3, 3), dtype=dtype, device=dev).index_add_(0, obs_mp_l, All)
        bl = torch.zeros((P, 3), dtype=dtype, device=dev).index_add_(
            0, obs_mp_l, torch.einsum("oik,oi,oi->ok", Jpt, w_row, r))
        Bo = torch.einsum("oik,oi,oil->okl", Jpose, w_row, Jpt)
        B = torch.zeros((P * K, 6, 3), dtype=dtype, device=dev).index_add_(
            0, obs_mp_l * K + obs_kf_l, Bo).reshape(P, K, 6, 3)
        diagl = torch.diagonal(Hll, dim1=-2, dim2=-1)
        Hll_d = Hll + torch.diag_embed(lam * diagl + 1e-6)
        Hll_inv = torch.linalg.inv_ex(Hll_d, check_errors=False)[0]
        # visual pose blocks + Schur reduction onto the poses
        App = torch.einsum("oik,oi,oil->okl", Jpose, w_row, Jpose)
        Hpp = torch.zeros((K, 6, 6), dtype=dtype, device=dev).index_add_(0, obs_kf_l, App)
        bp = torch.zeros((K, 6), dtype=dtype, device=dev).index_add_(
            0, obs_kf_l, torch.einsum("oik,oi,oi->ok", Jpose, w_row, r))
        Cm = torch.einsum("pkil,plm->pkim", B, Hll_inv)
        S2 = torch.einsum("pkim,pqjm->kiqj", Cm, B)
        bs = bp - torch.einsum("pkim,pm->ki", Cm, bl)

        Svis = -S2
        kk = torch.arange(K, device=dev)
        Svis[kk, :, kk, :] += Hpp
        A = torch.zeros((N, N), dtype=dtype, device=dev)
        A[pose_idx[:, None], pose_idx[None, :]] = Svis.reshape(K * 6, K * 6)
        b = torch.zeros(N, dtype=dtype, device=dev)
        b[pose_idx] = bs.reshape(-1)

        # inertial rows, linearized at the current state
        pa = pair_args(R, t, v, bg, ba)
        res_i, Jp = _pair_jacobians(pa, K - 1, dtype, dev)            # (K-1,15), (K-1,15,30)
        w_rows = inertial_weights(res_i)
        cost = visual_cost(chi2, w_mask) + torch.sum(res_i * res_i * w_rows)
        JtWJ = torch.einsum("kri,kr,krj->kij", Jp, w_rows, Jp)         # (K-1,30,30)
        JtWr = torch.einsum("kri,kr,kr->ki", Jp, w_rows, res_i)
        A = A.index_put((rows_idx[:, :, None].expand(-1, -1, 30),
                         rows_idx[:, None, :].expand(-1, 30, -1)), JtWJ, accumulate=True)
        b = b.index_put((rows_idx,), -JtWr, accumulate=True)

        # bias priors on the first keyframe (reference bInit)
        if prior_g > 0.0 or prior_a > 0.0:
            pw = torch.tensor([prior_g] * 3 + [prior_a] * 3, dtype=dtype, device=dev)
            A = A + torch.diag(torch.cat([torch.zeros(9, dtype=dtype, device=dev), pw,
                                          torch.zeros(N - 15, dtype=dtype, device=dev)]))
            b = b + torch.cat([torch.zeros(9, dtype=dtype, device=dev),
                               -pw * torch.cat([bg[0] - bg0[0], ba[0] - ba0[0]]),
                               torch.zeros(N - 15, dtype=dtype, device=dev)])

        # damping + fixed-state gauge
        A = A + torch.diag(lam * torch.diagonal(A) + 1e-6)
        A = torch.where(free2, A, 0.0) + gauge
        dx = _solve(A, torch.where(free, b, 0.0)).reshape(K, NS)
        dx = torch.where(torch.isfinite(dx), dx, 0.0)

        dRp, dtp = lie.se3_exp(dx[:, :6])
        Rn, tn = lie.se3_compose(dRp, dtp, R, t)
        vn = v + dx[:, 6:9]
        bgn = bg + dx[:, 9:12]
        ban = ba + dx[:, 12:15]
        # landmark back-substitution
        if fix_landmarks:
            ptsn = pts
        else:
            dl = _mv(Hll_inv, bl - torch.einsum("pkim,ki->pm", B, dx[:, :6]))
            has_obs = torch.zeros(P, dtype=dtype, device=dev).index_add_(
                0, obs_mp_l, w_mask) > 0
            ptsn = torch.where(has_obs[:, None], pts + dl, pts)
        return (Rn, tn, vn, bgn, ban, ptsn), cost

    def total_cost(R, t, v, bg, ba, pts, w_mask):
        chi2 = visual_residual(R, t, pts)[0]
        res_i = _pair_residual(z30, *pair_args(R, t, v, bg, ba))
        return visual_cost(chi2, w_mask) + torch.sum(res_i * res_i * inertial_weights(res_i))

    w_mask = obs_valid.to(dtype)
    R, t, v, bg, ba, pts = R0, t0, vels0, bg0, ba0, pts0
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    fx3 = fixed_pose[:, None, None]
    fx2 = fixed_pose[:, None]
    for _ in range(iters):
        (Rn, tn, vn, bgn, ban, ptsn), old = assemble_and_solve(R, t, v, bg, ba, pts,
                                                               w_mask, lam)
        Rn = torch.where(fx3, R, Rn)
        tn = torch.where(fx2, t, tn)
        new = total_cost(Rn, tn, vn, bgn, ban, ptsn, w_mask)
        good = new < old
        R = torch.where(good, Rn, R)
        t = torch.where(good, tn, t)
        v = torch.where(good, vn, v)
        bg = torch.where(good, bgn, bg)
        ba = torch.where(good, ban, ba)
        pts = torch.where(good, ptsn, pts)
        lam = torch.where(good, lam * 0.5, lam * 4.0)
    chi2 = visual_residual(R, t, pts)[0]
    inlier = (chi2 < torch.where(has_ur, 7.815, 5.991)) & obs_valid
    return VIJointResult(R=R, t=t, vels=v, bg=bg, ba=ba, pts=pts, obs_inlier=inlier,
                         cost=total_cost(R, t, v, bg, ba, pts, w_mask))
