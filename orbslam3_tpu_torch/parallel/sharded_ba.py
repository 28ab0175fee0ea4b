"""Landmark-sharded bundle adjustment over a list of devices.

Port of ``orbslam3_tpu/parallel/sharded_ba.py``:

- Landmarks (map points) and their observations are cut into ``len(mesh)``
  contiguous shards (``partition_by_landmark`` on the host). Shard ``s``
  lives on ``mesh[s]`` with every observation of its landmarks, so its
  landmark blocks Hll, its cross blocks B and its back-substitution never
  leave that device.
- The reduced camera (Schur) system S = Σ_shards (Hpp_s − B_s Hll_s⁻¹ B_sᵀ)
  and its right side are summed onto ``mesh[0]`` (the JAX package's one
  ``psum``), solved there (6K×6K, small) and the pose step is broadcast back.
  Between distinct cards the sum is ``torch.cuda.comm.reduce_add`` and the
  broadcast ``torch.cuda.comm.broadcast`` (NCCL inside one process); shards
  that share a device are first summed on it.
- The LM accept test sums each shard's cost change and cost onto ``mesh[0]``,
  decides there once, and broadcasts the decision: every shard applies the
  same one. Nothing in an iteration waits for the host.

A mesh is a list of ``torch.device``; it may repeat a device (logical shards
on one card, or on the CPU as the tests run it). Each shard's work is issued
on its device's current stream, so distinct cards overlap.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.cuda import comm

from .. import resolve_device
from ..ops import camera as cam_ops
from ..ops import lie
from ..ops.ba import inv3


def make_mesh(n_devices: int | None = None, device=None) -> list:
    """The devices of a mesh. On CUDA every visible card, or the first
    ``n_devices``; on the CPU one device, or ``n_devices`` logical shards of
    it. ``device=None`` is the card (raises without one)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        n_vis = torch.cuda.device_count()
        n = n_vis if n_devices is None else int(n_devices)
        if not 1 <= n <= n_vis:
            raise ValueError(f"make_mesh: {n} devices asked for, {n_vis} visible; "
                             f"pass a list that repeats a card for logical shards")
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * (1 if n_devices is None else int(n_devices))


def _distinct(mesh) -> list:
    return list(dict.fromkeys(mesh))


def _reduce(mesh, parts):
    """Σ parts (one per shard, each on its shard's device) → on mesh[0]."""
    per_dev = {}
    for d, p in zip(mesh, parts):
        per_dev[d] = p if d not in per_dev else per_dev[d] + p
    if len(per_dev) == 1:
        return per_dev[mesh[0]]
    return comm.reduce_add(list(per_dev.values()), destination=mesh[0])


def _broadcast(mesh, x):
    """x on mesh[0] → one tensor per shard, on the shard's device."""
    devs = _distinct(mesh)
    if len(devs) == 1:
        return [x] * len(mesh)
    copies = dict(zip(devs, comm.broadcast(x, devices=devs)))
    return [copies[d] for d in mesh]


def _replicate(mesh, x):
    """One copy of ``x`` per shard (one per distinct device)."""
    copies = {d: x.to(d) for d in _distinct(mesh)}
    return [copies[d] for d in mesh]


def _split(mesh, x):
    """Cut ``x`` along axis 0 into len(mesh) equal contiguous blocks, block s
    on mesh[s] (the JAX package's ``P(axis)``)."""
    n = len(mesh)
    if x.shape[0] % n:
        raise ValueError(f"axis 0 of length {x.shape[0]} does not split into {n} shards")
    return [b.to(d) for b, d in zip(torch.chunk(x, n), mesh)]


def _solve_pose_system(S, bs, fixed_pose, lam):
    """Damped, gauge-fixed solve of the reduced pose system by Cholesky with
    one refinement pass (f32 LU is useless at the conditioning of 256
    densely covisible keyframes). A failed factorization gives NaN, as the
    JAX package's ``cho_factor`` does: the LM step is then rejected."""
    S = S + torch.diag(lam * torch.diagonal(S) + 1e-6)
    free = (~fixed_pose).repeat_interleave(6)
    S = torch.where(free[:, None] & free[None, :], S, 0.0)
    S = S + torch.diag(torch.where(free, 0.0, 1.0))
    bs = torch.where(free, bs, 0.0)
    L, info = torch.linalg.cholesky_ex(S)
    L = torch.where(info == 0, L, float("nan"))
    dx0 = torch.cholesky_solve(bs[:, None], L)[:, 0]
    dx1 = dx0 + torch.cholesky_solve((bs - S @ dx0)[:, None], L)[:, 0]
    return dx1.reshape(fixed_pose.shape[0], 6)


def Hpp_to_dense(Hpp, K):
    """(K,6,6) diagonal blocks → the dense (6K,6K) block-diagonal matrix."""
    S = torch.zeros((K, 6, K, 6), dtype=Hpp.dtype, device=Hpp.device)
    ar = torch.arange(K, device=Hpp.device)
    S[ar, :, ar, :] = Hpp
    return S.reshape(K * 6, K * 6)


def _project_obs(R, t, pts_sh, obs_kf, obs_mp_local, cam_params, cam_type):
    """Camera-frame points (depth clamped), whether in front, and pixels."""
    Rk = R[obs_kf]
    xc = (Rk @ pts_sh[obs_mp_local][..., None])[..., 0] + t[obs_kf]
    pos = xc[..., 2] > 1e-3
    xc = torch.cat([xc[..., :2], torch.clamp(xc[..., 2:3], min=1e-2)], dim=-1)
    return Rk, xc, pos, cam_ops.project(cam_type, cam_params, xc)


def _local_schur_pieces(R, t, pts_sh, obs_kf, obs_mp_local, obs_uv, obs_w,
                        cam_params, n_kf, huber, lam, cam_type):
    """Per shard: the shard's part of the reduced system (S_part (6K,6K),
    bs_part (6K,)) and its local Hll⁻¹ (P,3,3), B (P,K,6,3) and bl (P,3).
    ``obs_mp_local`` indexes the shard's own landmarks."""
    kf = obs_kf.long()
    mp = obs_mp_local.long()
    Rk, xc, pos, pred = _project_obs(R, t, pts_sh, kf, mp, cam_params, cam_type)
    r = obs_uv - pred
    Jproj = cam_ops.project_jac(cam_type, cam_params, xc)
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(xc.shape[:-1] + (3, 3))
    Jse3 = torch.cat([-lie.hat(xc), eye], dim=-1)
    Jpose = Jproj @ Jse3                                              # (O,2,6)
    Jpt = Jproj @ Rk                                                  # (O,2,3)
    chi2 = torch.sum(r * r, dim=-1) * obs_w
    rn = torch.sqrt(chi2 + 1e-12)
    w_h = torch.where(rn <= huber, 1.0, huber / rn)
    w = obs_w * w_h * pos.to(xc.dtype)

    P = pts_sh.shape[0]
    K = n_kf
    dtype, dev = xc.dtype, xc.device
    wJp = w[:, None, None] * Jpose
    wJl = w[:, None, None] * Jpt
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

    diagl = torch.diagonal(Hll, dim1=-2, dim2=-1)
    Hll_inv = inv3(Hll + torch.diag_embed(lam * diagl + 1e-6))
    C = B @ Hll_inv[:, None]                                          # (P,K,6,3)
    S_part = Hpp_to_dense(Hpp, K) - (C.permute(1, 2, 0, 3).reshape(K * 6, P * 3)
                                     @ B.permute(0, 3, 1, 2).reshape(P * 3, K * 6))
    bs_part = (bp - torch.einsum("pkim,pm->ki", C, bl)).reshape(-1)
    return S_part, bs_part, Hll_inv, B, bl


def _apply_step(R, t, pts_sh, fixed_pose, dx, Hll_inv, B, bl):
    """The pose update from dx and the shard's landmark back-substitution."""
    dl = (Hll_inv @ (bl - torch.einsum("pkim,ki->pm", B, dx))[..., None])[..., 0]
    dR, dt = lie.se3_exp(dx)
    Rn, tn = lie.se3_compose(dR, dt, R, t)
    Rn = torch.where(fixed_pose[:, None, None], R, Rn)
    tn = torch.where(fixed_pose[:, None], t, tn)
    return Rn, tn, pts_sh + dl


def _shard_inputs(mesh, R, t, fixed_pose, pts, obs, cam_params):
    """Poses, gauge and intrinsics replicated; landmarks and observations
    cut into the mesh's blocks. Returns per-shard lists."""
    rep = [_replicate(mesh, x) for x in (R, t, fixed_pose, cam_params)]
    cut = [_split(mesh, x) for x in (pts,) + tuple(obs)]
    return rep, cut


def make_sharded_ba_step(mesh, n_kf: int, cam_type: int = cam_ops.PINHOLE,
                         huber_chi2: float = 5.991):
    """One Gauss-Newton step over the mesh.

    ``step(R, t, fixed_pose, pts, obs_kf, obs_mp_local, obs_uv, obs_w,
    cam_params, lam) -> (R, t, pts)``: pts (P,3) and obs_* (O,…) are global
    arrays cut into len(mesh) contiguous shards along axis 0 (the host puts
    each observation with its landmark's shard, ``partition_by_landmark``);
    poses are replicated. The results are on mesh[0]."""
    huber = float(huber_chi2) ** 0.5

    def step(R, t, fixed_pose, pts, obs_kf, obs_mp_local, obs_uv, obs_w, cam_params, lam):
        (Rs, ts, fs, cams), (ps, kfs, mps, uvs, ws) = _shard_inputs(
            mesh, R, t, fixed_pose, pts, (obs_kf, obs_mp_local, obs_uv, obs_w), cam_params)
        lams = _replicate(mesh, torch.as_tensor(lam, dtype=pts.dtype))
        pieces = [_local_schur_pieces(*a, n_kf, huber, lm, cam_type)
                  for *a, lm in zip(Rs, ts, ps, kfs, mps, uvs, ws, cams, lams)]
        dx = _solve_pose_system(_reduce(mesh, [p[0] for p in pieces]),
                                _reduce(mesh, [p[1] for p in pieces]), fs[0], lams[0])
        out = [_apply_step(Rs[s], ts[s], ps[s], fs[s], d, *pieces[s][2:])
               for s, d in enumerate(_broadcast(mesh, dx))]
        return out[0][0], out[0][1], torch.cat([o[2].to(mesh[0]) for o in out])

    return step


def partition_by_landmark(obs_mp, n_pts, n_shards, obs_arrays):
    """Host-side: repartition observations so each lands on its landmark's
    shard, padding every shard to equal size. Returns (n_pts_pad, o_per,
    local mp indices, per-shard obs validity, obs arrays concatenated shard
    by shard).

    obs_mp: (O,) global landmark index per observation (numpy).
    obs_arrays: dict of (O,...) numpy arrays to repartition alongside.
    """
    per = -(-n_pts // n_shards)          # landmarks per shard (ceil)
    n_pts_pad = per * n_shards
    shard_of_mp = obs_mp // per
    local_mp = obs_mp % per
    counts = np.bincount(shard_of_mp, minlength=n_shards)
    o_per = max(int(counts.max()), 1)
    out_mp = np.zeros(o_per * n_shards, np.int32)
    out_valid = np.zeros(o_per * n_shards, bool)
    outs = {k: np.zeros((o_per * n_shards,) + v.shape[1:], v.dtype)
            for k, v in obs_arrays.items()}
    for s in range(n_shards):
        sel = np.nonzero(shard_of_mp == s)[0]
        base = s * o_per
        out_mp[base: base + len(sel)] = local_mp[sel]
        out_valid[base: base + len(sel)] = True
        for k, v in obs_arrays.items():
            outs[k][base: base + len(sel)] = v[sel]
    return n_pts_pad, o_per, out_mp, out_valid, outs


def make_sharded_ba_solver(mesh, n_kf: int, cam_type: int = cam_ops.PINHOLE,
                           huber_chi2: float = 5.991, iters1: int = 5, iters2: int = 10,
                           chi2_th: float = 5.991):
    """The full distributed LM solve (the reference's LocalBundleAdjustment /
    GlobalBundleAdjustemnt schedule: optimize, reclassify chi2 outliers,
    optimize again) over the landmark-sharded mesh:

    - every iteration is one reduced Schur step with Levenberg damping and
      accept/reject on the mesh-wide robust cost change;
    - after ``iters1`` iterations observations with chi2 > ``chi2_th`` are
      gated out and ``iters2`` more run, the damping restarted;
    - returns the final inlier classification with the solution.

    ``solve(R, t, fixed_pose, pts, obs_kf, obs_mp_local, obs_uv, obs_w,
    cam_params) -> (R, t, pts, inlier)``, the arguments as for
    :func:`make_sharded_ba_step`; pts and inlier come back in shard order,
    everything on mesh[0]."""
    huber = float(huber_chi2) ** 0.5

    def solve(R, t, fixed_pose, pts, obs_kf, obs_mp_local, obs_uv, obs_w, cam_params):
        (Rs, ts, fs, cams), (ps, kfs, mps, uvs, ws) = _shard_inputs(
            mesh, R, t, fixed_pose, pts, (obs_kf, obs_mp_local, obs_uv, obs_w), cam_params)
        kfs = [k.long() for k in kfs]
        mps = [m.long() for m in mps]
        n = len(mesh)

        def local_chi2(s, R, t, pts_sh):
            _, _, pos, pred = _project_obs(R, t, pts_sh, kfs[s], mps[s], cams[s], cam_type)
            chi2 = torch.sum((uvs[s] - pred) ** 2, dim=-1)
            return torch.where(pos, chi2, 1e9)

        def robust_cost_elems(s, R, t, pts_sh, w):
            chi2 = local_chi2(s, R, t, pts_sh) * w
            d2 = huber * huber
            return torch.where(chi2 <= d2, chi2, 2.0 * huber * torch.sqrt(chi2 + 1e-12) - d2)

        def run(state, w, iters):
            lams = _replicate(mesh, torch.tensor(1e-4, dtype=pts.dtype))
            for _ in range(iters):
                pieces = [_local_schur_pieces(state[s][0], state[s][1], state[s][2], kfs[s],
                                              mps[s], uvs[s], w[s], cams[s], n_kf, huber,
                                              lams[s], cam_type) for s in range(n)]
                dx = _solve_pose_system(_reduce(mesh, [p[0] for p in pieces]),
                                        _reduce(mesh, [p[1] for p in pieces]), fs[0], lams[0])
                cand, costs = [], []
                for s, d in enumerate(_broadcast(mesh, dx)):
                    c = _apply_step(*state[s], fs[s], d, *pieces[s][2:])
                    old = robust_cost_elems(s, *state[s], w[s])
                    # the cost change as a sum of per-observation differences
                    # (cancellation-free, see ops/ba.py:ba_iterate)
                    costs.append(torch.stack([torch.sum(robust_cost_elems(s, *c, w[s]) - old),
                                              torch.sum(old)]))
                    cand.append(c)
                dcost, tot = _reduce(mesh, costs).unbind(0)
                good = (dcost < -1e-6 * torch.clamp(tot, min=1.0)).to(torch.uint8)
                goods = [g.bool() for g in _broadcast(mesh, good)]
                state = [tuple(torch.where(g, a, b) for a, b in zip(c, st))
                         for g, c, st in zip(goods, cand, state)]
                lams = [torch.where(g, lm * 0.5, lm * 4.0) for g, lm in zip(goods, lams)]
            return state

        state = run(list(zip(Rs, ts, ps)), ws, iters1)
        # the two-phase outlier gate
        w2 = [w * (local_chi2(s, *state[s]) < chi2_th).to(w.dtype) for s, w in enumerate(ws)]
        state = run(state, w2, iters2)
        inl = [(local_chi2(s, *state[s]) < chi2_th) & (ws[s] > 0) for s in range(n)]
        return (state[0][0], state[0][1], torch.cat([st[2].to(mesh[0]) for st in state]),
                torch.cat([i.to(mesh[0]) for i in inl]))

    return solve
