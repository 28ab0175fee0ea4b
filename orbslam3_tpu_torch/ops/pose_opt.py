"""Pose-only optimization (motion-only bundle adjustment) on torch tensors.

Port of ``orbslam3_tpu/ops/pose_opt.py``: rounds x iterations of
Levenberg-Marquardt on SE(3) with Huber IRLS, chi2 outlier reclassification
between rounds, optional stereo rows and the weak anchored prior.

The reference's early-exit ``lax.while_loop`` becomes a fixed ``iters`` loop
whose carry freezes once converged (``torch.where(done, old, new)`` on every
carried value): the same result with no device→host sync per iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import camera as cam_ops
from . import lie

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def solve6(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled 6x6 Cholesky solve (H SPD after LM damping), elementwise so it
    needs no LAPACK call and no info check. Batched over leading dims."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-12))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


class PoseOptResult(NamedTuple):
    R: torch.Tensor          # (3,3)
    t: torch.Tensor          # (3,)
    inlier: torch.Tensor     # (N,) bool — final chi2 classification
    n_inliers: torch.Tensor  # () int32
    chi2: torch.Tensor       # () float32 total inlier chi2


def _build_normal_eq(R, t, pts_w, uv, obs_ur, bf, inv_sigma2, w_mask,
                     cam_type, cam_params, huber_mono, huber_stereo):
    """One linearization with mono+stereo rows: H (6,6), b (6,), chi2 (N,)."""
    xc = lie.se3_apply(R, t, pts_w)
    pos = xc[..., 2] > 1e-3
    # sanitize depth: masked-out / behind-camera entries would otherwise emit
    # inf/NaN Jacobians, and 0-weight × NaN = NaN still poisons the sums
    xc = torch.cat([xc[..., :2], torch.clamp(xc[..., 2:3], min=1e-2)], dim=-1)
    pred = cam_ops.project(cam_type, cam_params, xc)
    r_uv = uv - pred
    Jproj = cam_ops.project_jac(cam_type, cam_params, xc)           # (N,2,3)
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(xc.shape[:-1] + (3, 3))
    Jse3 = torch.cat([-lie.hat(xc), eye], dim=-1)                   # (N,3,6)

    has_ur = obs_ur >= 0
    z = xc[..., 2]
    ur_pred = pred[..., 0] - bf / z
    r_ur = torch.where(has_ur, obs_ur - ur_pred, 0.0)
    zero = torch.zeros_like(z)
    Jur_xc = Jproj[:, 0, :] + torch.stack([zero, zero, bf / (z * z)], dim=-1)
    r = torch.cat([r_uv, r_ur[..., None]], dim=-1)                  # (N,3)
    Jxc = torch.cat([Jproj, Jur_xc[:, None, :]], dim=1)             # (N,3,3)
    J = Jxc @ Jse3                                                  # (N,3,6)
    row_w = torch.cat([torch.ones_like(r_uv), has_ur[..., None].to(r.dtype)], dim=-1)

    chi2 = torch.sum(r * r * row_w, dim=-1) * inv_sigma2
    chi2 = torch.where(pos, chi2, 1e9)
    huber = torch.where(has_ur, huber_stereo, huber_mono)
    rn = torch.sqrt(chi2 + 1e-12)
    w_huber = torch.where(rn <= huber, 1.0, huber / rn)
    w = w_mask * pos.to(r.dtype) * inv_sigma2 * w_huber
    wr = w[:, None] * row_w                                         # (N,3)
    H = torch.einsum("nik,ni,nil->kl", J, wr, J)
    b = torch.einsum("nik,ni,ni->k", J, wr, r)
    return H, b, chi2


def pose_optimize(
    R0: torch.Tensor, t0: torch.Tensor,
    pts_w: torch.Tensor, uv: torch.Tensor, inv_sigma2: torch.Tensor, valid: torch.Tensor,
    cam_params: torch.Tensor, cam_type: int = cam_ops.PINHOLE,
    rounds: int = 4, iters: int = 10, chi2_th: float = CHI2_MONO,
    chi2_schedule=None, obs_ur: torch.Tensor | None = None, bf=0.0,
    prior_R: torch.Tensor | None = None, prior_t: torch.Tensor | None = None,
    prior_eps=0.0,
) -> PoseOptResult:
    """rounds x iters LM with between-round chi2 reclassification.

    pts_w (N,3) world points; uv (N,2) observations; valid (N,) mask;
    obs_ur optional (N,) right-image u (−1 ⇒ mono); prior_R/prior_t/prior_eps
    a weak SE(3) prior with per-block information eps·tr(H_block at the
    seed)/3 (see the reference module)."""
    dtype, dev = pts_w.dtype, pts_w.device
    if obs_ur is None:
        obs_ur = torch.full(pts_w.shape[:1], -1.0, dtype=dtype, device=dev)
    bf = torch.as_tensor(bf, dtype=dtype, device=dev)
    huber_m = torch.sqrt(torch.tensor(CHI2_MONO, dtype=dtype, device=dev))
    huber_s = torch.sqrt(torch.tensor(CHI2_STEREO, dtype=dtype, device=dev))
    if chi2_schedule is None:
        schedule = [chi2_th] * rounds
    else:
        schedule = [float(v) for v in chi2_schedule]
    has_ur = obs_ur >= 0
    gate_scale = torch.where(has_ur, CHI2_STEREO / CHI2_MONO, 1.0)

    def nq(R, t, w_mask):
        return _build_normal_eq(R, t, pts_w, uv, obs_ur, bf, inv_sigma2,
                                w_mask, cam_type, cam_params, huber_m, huber_s)

    if prior_R is None:
        prior_R, prior_t = R0, t0
    prior_eps = torch.as_tensor(prior_eps, dtype=dtype, device=dev)
    H_seed, _, _ = nq(R0, t0, valid.to(dtype))
    lam_rot = prior_eps * torch.trace(H_seed[:3, :3]) / 3.0
    lam_t = prior_eps * torch.trace(H_seed[3:, 3:]) / 3.0
    lam_diag = torch.cat([lam_rot.expand(3), lam_t.expand(3)])
    pRi, pti = lie.se3_inverse(prior_R, prior_t)
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def huber_cost(chi2, w_mask):
        d = torch.where(has_ur, huber_s, huber_m)
        d2 = d * d
        rho = torch.where(chi2 <= d2, chi2, 2.0 * d * torch.sqrt(chi2 + 1e-12) - d2)
        rho = torch.clamp(rho, max=1e6)
        return torch.sum(rho * w_mask)

    def nq_prior(R, t, w_mask):
        H, b, chi2 = nq(R, t, w_mask)
        dRr, dtr = lie.se3_compose(R, t, pRi, pti)
        e0 = lie.se3_log(dRr, dtr)
        Hp = H + torch.diag(lam_diag)
        bp = b - lam_diag * e0
        cost = huber_cost(chi2, w_mask) + torch.sum(lam_diag * e0 * e0)
        return Hp, bp, cost

    def lm_iters(R, t, w_mask):
        H, b, c = nq_prior(R, t, w_mask)
        lam = torch.tensor(1e-3, dtype=dtype, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(iters):
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
            dx = solve6(Hd, b)
            Rn_, tn_ = lie.se3_exp(dx)
            Rn, tn = lie.se3_compose(Rn_, tn_, R, t)
            Hn, bn, cn = nq_prior(Rn, tn, w_mask)
            # an accepted step moves the carry; a converged carry stays put
            good = (cn < c) & ~done
            R = torch.where(good, Rn, R)
            t = torch.where(good, tn, t)
            H = torch.where(good, Hn, H)
            b = torch.where(good, bn, b)
            c = torch.where(good, cn, c)
            lam = torch.where(done, lam, torch.where(good, lam * 0.5, lam * 4.0))
            done = done | (torch.sum(dx * dx) < 1e-16)
        return R, t

    R, t = R0, t0
    inlier = torch.ones(pts_w.shape[0], dtype=torch.bool, device=dev)
    for i in range(rounds):
        w_mask = (valid & inlier).to(dtype)
        R, t = lm_iters(R, t, w_mask)
        _, _, chi2 = nq(R, t, torch.ones_like(w_mask))
        inlier = chi2 < schedule[i] * gate_scale
    inlier = inlier & valid
    _, _, chi2 = nq(R, t, inlier.to(dtype))
    return PoseOptResult(
        R=R, t=t, inlier=inlier,
        n_inliers=torch.sum(inlier, dtype=torch.int32),
        chi2=torch.sum(torch.where(inlier, chi2, 0.0)),
    )


def _nanmedian_as_jax(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a 1-D float tensor: the median of the non-NaN
    entries, the mean of the two middle ones on an even count
    (``torch.nanmedian`` returns the lower one), NaN when every entry is NaN.
    No host synchronization."""
    n = x.shape[0]
    s = torch.sort(x).values                           # NaNs sort last
    k = torch.sum(~torch.isnan(x))
    lo = torch.clamp(torch.div(k - 1, 2, rounding_mode="floor"), 0, n - 1)
    hi = torch.clamp(torch.div(k, 2, rounding_mode="floor"), 0, n - 1)
    mid = 0.5 * s[lo] + 0.5 * s[hi]
    return torch.where(k > 0, mid, torch.full_like(mid, float("nan")))


# the camera-frame start shifts, in units of spread·median depth: the prior,
# then the viewing axis (the weakly observed direction), then sideways
_START_DIRS = ((0.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, 0.0, -1.0),
               (0.0, 0.0, 2.0), (0.0, 0.0, -2.0), (1.0, 0.0, 0.0),
               (-1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, -1.0, 0.0))


def multistart_solves(
    R0: torch.Tensor, t0: torch.Tensor,
    pts_w: torch.Tensor, uv: torch.Tensor, inv_sigma2: torch.Tensor, valid: torch.Tensor,
    cam_params: torch.Tensor, cam_type: int = cam_ops.PINHOLE,
    rounds: int = 4, iters: int = 10, chi2_th: float = CHI2_MONO,
    obs_ur: torch.Tensor | None = None, bf=0.0,
    n_starts: int = 7, spread: float = 0.015,
):
    """Every start of ``pose_optimize_multistart``: the (n_starts,) stacked
    ``PoseOptResult`` fields and each result's unmasked Huber cost."""
    dtype, dev = pts_w.dtype, pts_w.device
    if obs_ur is None:
        obs_ur = torch.full(pts_w.shape[:1], -1.0, dtype=dtype, device=dev)
    bf = torch.as_tensor(bf, dtype=dtype, device=dev)
    # characteristic depth that scales the shifts
    z = lie.se3_apply(R0, t0, pts_w)[..., 2]
    z0 = torch.where(valid & (z > 0), z, torch.full_like(z, float("nan")))
    med_z = torch.nan_to_num(_nanmedian_as_jax(z0), nan=1.0)
    dirs = torch.tensor(_START_DIRS[:n_starts], dtype=dtype, device=dev)
    t0s = t0[None, :] + spread * med_z * dirs

    def solve(tt):
        res = pose_optimize(R0, tt, pts_w, uv, inv_sigma2, valid, cam_params,
                            cam_type=cam_type, rounds=rounds, iters=iters,
                            chi2_th=chi2_th, obs_ur=obs_ur, bf=bf)
        return res.R, res.t, res.inlier, res.n_inliers, res.chi2

    Rs, ts, inliers, n_inl, chi2s = torch.func.vmap(solve)(t0s)

    huber_m = torch.sqrt(torch.tensor(CHI2_MONO, dtype=dtype, device=dev))
    huber_s = torch.sqrt(torch.tensor(CHI2_STEREO, dtype=dtype, device=dev))
    has_ur = obs_ur >= 0
    w_valid = valid.to(dtype)

    def total_cost(R, t):
        _, _, chi2 = _build_normal_eq(R, t, pts_w, uv, obs_ur, bf, inv_sigma2, w_valid,
                                      cam_type, cam_params, huber_m, huber_s)
        d = torch.where(has_ur, huber_s, huber_m)
        d2 = d * d
        rho = torch.where(chi2 <= d2, chi2, 2.0 * d * torch.sqrt(chi2 + 1e-12) - d2)
        rho = torch.clamp(rho, max=1e6)
        return torch.sum(rho * w_valid)

    costs = torch.func.vmap(total_cost)(Rs, ts)
    return PoseOptResult(R=Rs, t=ts, inlier=inliers, n_inliers=n_inl, chi2=chi2s), costs


def pose_optimize_multistart(R0, t0, pts_w, uv, inv_sigma2, valid, cam_params,
                             cam_type: int = cam_ops.PINHOLE, rounds: int = 4, iters: int = 10,
                             chi2_th: float = CHI2_MONO, obs_ur=None, bf=0.0,
                             n_starts: int = 7, spread: float = 0.015) -> PoseOptResult:
    """Multi-start pose LM: ``pose_optimize`` from the prior pose and from
    camera-frame translation shifts of it (mostly along the viewing axis),
    all starts in one batched solve (``torch.func.vmap``); the winner is the
    first start with the lowest robust Huber cost over ALL valid
    observations (the inlier sets differ between starts, so a masked total
    would reward aggressive censoring). The pose prior is not used.

    It guards against spurious minima of the robust cost displaced along the
    depth direction, which a drifting motion-model prediction falls into and
    the chi2 reclassification then locks in."""
    res, costs = multistart_solves(R0, t0, pts_w, uv, inv_sigma2, valid, cam_params,
                                   cam_type=cam_type, rounds=rounds, iters=iters,
                                   chi2_th=chi2_th, obs_ur=obs_ur, bf=bf, n_starts=n_starts,
                                   spread=spread)
    best = torch.argmin(costs)        # the first minimum, as jnp.argmin
    return PoseOptResult(*(f[best] for f in res))
