"""Composite device steps used by the tracking / mapping drivers.

Port of the factories of ``orbslam3_tpu/models/kernels.py`` (the visual ones and
the visual-inertial fused step). Each
factory fixes its static configuration (camera, pyramid, thresholds, device)
and returns a closure over torch tensors. Packed-output layouts are the
reference's, word for word, so host bookkeeping reads the same buffers.

Every masked windowed Hamming top-2 — the staged and pooled projection
matchers, the fused visual and visual-inertial trackers and the batched fuse — goes through
``ops.match_rows``: ``match_rows`` for one radius, ``match_rows_dual`` for the
fused tracker's radius / 2x-radius pair (one launch); the Hopper kernels for
CUDA tensors, their plain PyTorch versions for CPU tensors.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import resolve_device
from ..ops import camera as cam_ops
from ..ops import lie, matching, triangulation
from ..ops.features import f32_bits, fold_u32_to_i32
from ..ops.match_rows import match_rows, match_rows_dual


def _cached_per_device(factory):
    """``functools.lru_cache`` for a factory that takes ``device``: the key
    holds the resolved device's name, so ``device=None`` (the CUDA card) and
    ``device="cpu"`` never share an entry, and a missing card raises here."""
    cached = functools.lru_cache(maxsize=None)(factory)

    @functools.wraps(factory)
    def wrapper(*args, device=None, **kw):
        return cached(*args, device=str(resolve_device(device)), **kw)

    wrapper.cache_clear = cached.cache_clear
    return wrapper


def _levels(scale: float, n_levels: int, device):
    sf = torch.tensor([scale ** i for i in range(n_levels)], dtype=torch.float32, device=device)
    log_scale = torch.log(torch.tensor(scale, dtype=torch.float32, device=device))
    return sf, log_scale


def _frustum(xyz, normal, mind, maxd, mvalid, R, t, cam_type, camp, whv,
             view_cos_th, log_scale, n_levels):
    """Frustum + scale-prediction gates (reference Frame::isInFrustum,
    MapPoint::PredictScale) for map points (…,M,3) seen from world→camera
    poses (…,3,3)/(…,3). Returns (uv (…,M,2), lvl (…,M) int32, frustum)."""
    Rt = R.transpose(-1, -2)
    xc = xyz @ Rt + t[..., None, :]
    z_ok = xc[..., 2] > 0.05
    uv = cam_ops.project(cam_type, camp, xc)
    in_img = ((uv[..., 0] >= 0) & (uv[..., 0] < whv[0])
              & (uv[..., 1] >= 0) & (uv[..., 1] < whv[1]))
    cam_center = -(Rt @ t[..., None])[..., 0]
    d = xyz - cam_center[..., None, :]
    dist = torch.linalg.norm(d, dim=-1)
    dist_ok = (dist > 0.8 * mind) & (dist < 1.2 * maxd)
    view_cos = torch.sum(d * normal, dim=-1) / torch.clamp(dist, min=1e-9)
    lvl = torch.ceil(torch.log(torch.clamp(maxd, min=1e-9) / torch.clamp(dist, min=1e-9))
                     / log_scale)
    lvl = torch.clamp(lvl, 0, n_levels - 1).to(torch.int32)
    frustum = mvalid & z_ok & in_img & dist_ok & (view_cos > view_cos_th)
    return uv, lvl, frustum


def _ratio_ok(best, second, ratio, max_dist):
    return (best <= max_dist) & (best.to(torch.float32) < ratio * second.to(torch.float32))


@_cached_per_device
def projection_matcher(cam_type: int, n_levels: int, scale: float,
                       octave_lo: int = 1, octave_hi: int = 1, device=None):
    """Fused frustum-check + projection-window matcher.

    fn(mp_xyz (M,3), mp_desc (M,8), mp_normal (M,3), mp_mind (M,), mp_maxd (M,),
       mp_valid (M,), R, t, cam_params, feat_xy (N,2), feat_desc (N,8),
       feat_octave (N,), feat_valid (N,), wh (2,), base_radius, ratio,
       max_dist, view_cos_th)
      → (idx (M,), ok (M,), pred_uv (M,2), pred_level (M,), frustum (M,))"""
    sf, log_scale = _levels(scale, n_levels, torch.device(device))

    def fn(mp_xyz, mp_desc, mp_normal, mp_mind, mp_maxd, mp_valid, R, t,
           cam_params, feat_xy, feat_desc, feat_octave, feat_valid, wh,
           base_radius, ratio, max_dist, view_cos_th):
        uv, lvl, frustum_ok = _frustum(mp_xyz, mp_normal, mp_mind, mp_maxd, mp_valid,
                                       R, t, cam_type, cam_params, wh, view_cos_th,
                                       log_scale, n_levels)
        radius = base_radius * sf[lvl.long()]
        idx, best, second = match_rows(mp_desc, uv, radius, lvl, frustum_ok,
                                       feat_desc, feat_xy, feat_octave, feat_valid,
                                       octave_lo=octave_lo, octave_hi=octave_hi)
        ok = _ratio_ok(best, second, ratio, max_dist)
        ok = matching.resolve_duplicates(idx, best, ok, feat_desc.shape[0])
        return idx, ok, uv, lvl, frustum_ok

    return fn


@functools.lru_cache(maxsize=None)
def pose_opt_kernel(cam_type: int, rounds: int = 4, iters: int = 10, n_starts: int = 1):
    from ..ops import pose_opt

    def fn(R0, t0, pts_w, uv, inv_sigma2, valid, cam_params, obs_ur=None, bf=0.0,
           prior_R=None, prior_t=None, prior_eps=0.0):
        if n_starts > 1:
            # the multi-start solve has no pose prior
            return pose_opt.pose_optimize_multistart(
                R0, t0, pts_w, uv, inv_sigma2, valid, cam_params,
                cam_type=cam_type, rounds=rounds, iters=iters, obs_ur=obs_ur, bf=bf,
                n_starts=n_starts)
        return pose_opt.pose_optimize(
            R0, t0, pts_w, uv, inv_sigma2, valid, cam_params,
            cam_type=cam_type, rounds=rounds, iters=iters, obs_ur=obs_ur, bf=bf,
            prior_R=prior_R, prior_t=prior_t, prior_eps=prior_eps)
    return fn


@functools.lru_cache(maxsize=None)
def init_matcher():
    def fn(desc1, valid1, xy1, angle1, desc2, valid2, xy2, angle2):
        return matching.search_for_initialization(
            desc1, valid1, xy1, angle1, desc2, valid2, xy2, angle2)
    return fn


@functools.lru_cache(maxsize=None)
def two_view_kernel(sigma_n: float):
    from ..ops import twoview

    def fn(x1, x2, valid, rand_sets):
        return twoview.reconstruct_two_views(x1, x2, valid, rand_sets, sigma_n=sigma_n)
    return fn


def _epipolar_ok(rays1, xy2, oct2, R21, t21, camp, sf2):
    """(…,N1,N2) epipolar gate: distance of x2 to the epipolar line of x1 in
    pixels, below 3.84·σ² of x2's octave (reference CheckDistEpipolarLine)."""
    E = lie.hat(t21) @ R21
    l2 = rays1 @ E.transpose(-1, -2)
    fx, fy, cx, cy = camp[0], camp[1], camp[2], camp[3]
    a = l2[..., 0] / fx
    b = l2[..., 1] / fy
    c = l2[..., 2] - l2[..., 0] * cx / fx - l2[..., 1] * cy / fy
    num = (a[..., :, None] * xy2[..., None, :, 0] + b[..., :, None] * xy2[..., None, :, 1]
           + c[..., :, None])
    dsq = (num * num) / torch.clamp((a * a + b * b)[..., :, None], min=1e-18)
    return dsq < 3.84 * sf2[oct2.long()][..., None, :]


@_cached_per_device
def triangulation_matcher(cam_type: int, n_levels: int, scale: float, device=None):
    """Epipolar-constrained matching of two keyframes' features + DLT
    triangulation + acceptance gates → (idx (N,), ok (N,), xw (N,3), depths)."""
    sf2 = torch.tensor([(scale ** i) ** 2 for i in range(n_levels)], dtype=torch.float32,
                       device=torch.device(device))

    def fn(R1, t1, R2, t2, cam_params, xy1, desc1, valid1, oct1,
           xy2, desc2, valid2, oct2, ratio, max_dist, sigma_n):
        rays1 = cam_ops.unproject(cam_type, cam_params, xy1)
        rays2 = cam_ops.unproject(cam_type, cam_params, xy2)
        R1i, t1i = lie.se3_inverse(R1, t1)
        R21, t21 = lie.se3_compose(R2, t2, R1i, t1i)
        ep = _epipolar_ok(rays1, xy2, oct2, R21, t21, cam_params, sf2)
        dist = matching.hamming_matrix(desc1, desc2)
        mask = valid1[:, None] & valid2[None, :] & ep
        idx, best, ok = matching.masked_match(dist, mask, max_dist, ratio)
        ok = matching.resolve_duplicates(idx, best, ok, desc2.shape[0])
        il = idx.long()
        r2m = rays2[il]
        xw = triangulation.triangulate_dlt(R1, t1, rays1, R2, t2, r2m)
        tri_ok, depths = triangulation.check_triangulation(
            xw, R1, t1, rays1, R2, t2, r2m,
            sigma_n * sigma_n * sf2[oct1.long()], sigma_n * sigma_n * sf2[oct2[il].long()],
            min_parallax_cos=0.9998, chi2_th=5.991)
        return idx, ok & tri_ok, xw, depths
    return fn


# ---------------------------------------------------------------------------
# Packed-I/O pooled steps: map-side candidates arrive as id vectors into the
# device-resident pool (models/device_map.py); each returns ONE packed int32
# buffer so the host reads one copy per call.
# ---------------------------------------------------------------------------

def _pack_bits_i32(b: torch.Tensor) -> torch.Tensor:
    """(N,) bool → (ceil(N/32),) int32, bit i of word w = element 32·w+i
    (host unpacks with np.unpackbits(buf.view(np.uint8), bitorder='little'))."""
    n = b.shape[0]
    pad = (-n) % 32
    if pad:
        b = torch.cat([b, torch.zeros(pad, dtype=torch.bool, device=b.device)])
    shifts = torch.arange(32, dtype=torch.int64, device=b.device)
    return fold_u32_to_i32((b.reshape(-1, 32).to(torch.int64) << shifts).sum(dim=1))


def unpack_bits_host(buf_i32, n: int):
    u8 = np.asarray(buf_i32, np.int32).view(np.uint8)
    return np.unpackbits(u8, bitorder="little")[:n].astype(bool)


def _gather_pool(mpf, mpu, ids):
    """Gather packed map-point rows by id (−1 ⇒ invalid). mpf (P,8) f32:
    xyz, normal, min_dist, max_dist; mpu (P,9) int32: desc (8), valid."""
    safe = torch.clamp(ids, min=0).long()
    f = mpf[safe]
    u = mpu[safe]
    valid = (u[..., 8] > 0) & (ids >= 0)
    return f[..., 0:3], u[..., 0:8], f[..., 3:6], f[..., 6], f[..., 7], valid


def _compact(ok_flat: torch.Tensor, cap: int):
    """Fixed-size cumsum compaction of the set positions of ``ok_flat`` (the
    reference's ``jnp.nonzero(size=cap, fill_value=len)``) with no host sync:
    returns (sel (cap,) with len(ok_flat) as fill, got (cap,))."""
    n = ok_flat.shape[0]
    pos = torch.cumsum(ok_flat.to(torch.int64), 0) - 1
    slot = torch.where(ok_flat & (pos < cap), pos, cap)
    sel = torch.full((cap + 1,), n, dtype=torch.int64, device=ok_flat.device)
    sel.scatter_(0, slot, torch.arange(n, device=ok_flat.device))
    sel = sel[:cap]
    return sel, sel < n


def _make_pool_matcher(cam_type: int, n_levels: int, scale: float, camp, whv, device):
    """Frustum + projection-window + ratio-test matcher over gathered pool
    rows, with the motion-model 2x-radius rescue (both radii always matched,
    the wide result selected by a scalar when the narrow one is thin)."""
    sf, log_scale = _levels(scale, n_levels, device)

    def _accept(idx, best, second, ratio, max_dist, n_feat):
        ok = _ratio_ok(best, second, ratio, max_dist)
        return idx, matching.resolve_duplicates(idx, best, ok, n_feat)

    def _match(xyz, desc, normal, mind, maxd, mvalid, R, t,
               feat_xy, feat_desc, feat_octave, feat_valid,
               radius, ratio, max_dist, view_cos_th, retry_min=0):
        uv, lvl, frustum = _frustum(xyz, normal, mind, maxd, mvalid, R, t, cam_type,
                                    camp, whv, view_cos_th, log_scale, n_levels)
        rad = radius * sf[lvl.long()]
        n_feat = feat_desc.shape[0]
        feats = (feat_desc, feat_xy, feat_octave, feat_valid)
        if not retry_min:
            idx, ok = _accept(*match_rows(desc, uv, rad, lvl, frustum, *feats),
                              ratio, max_dist, n_feat)
            return idx, ok, frustum
        # one launch for both radii; 2·(radius·sf) and (2·radius)·sf are the
        # same float32, so this equals two launches at radius and 2·radius
        narrow, wide = match_rows_dual(desc, uv, rad, lvl, frustum, *feats, wide=2.0)
        idx, ok = _accept(*narrow, ratio, max_dist, n_feat)
        idx_w, ok_w = _accept(*wide, ratio, max_dist, n_feat)
        use_wide = torch.sum(ok, dtype=torch.int32) < retry_min
        return torch.where(use_wide, idx_w, idx), torch.where(use_wide, ok_w, ok), frustum

    return _match


def _assign(n_feat: int, idx, ok, device):
    """Per-feature candidate index: max over candidates matched to it (−1 = none)."""
    cand = torch.where(ok, torch.arange(idx.shape[0], dtype=torch.int32, device=device), -1)
    return torch.full((n_feat,), -1, dtype=torch.int32, device=device).scatter_reduce(
        0, idx.long(), cand, "amax", include_self=True)


@_cached_per_device
def fused_track_pooled(cam_type: int, n_levels: int, scale: float,
                       cam_params: tuple, wh: tuple, bf: float,
                       motion_radius: float, local_radius: float,
                       motion_ratio: float, local_ratio: float,
                       th_high: int, pose_rounds: int = 2,
                       pose_iters: int = 10, device=None):
    """Per-frame visual tracking against the device-resident pool: last-frame
    points matched at the predicted pose → pose LM → local-map points matched
    at the refined pose → pose LM. ONE packed int32 result:
      [0:12]=bits(R,t), [12]=n1, [13]=n_inl,
      [14:14+N]=a_last, [14+N:14+2N]=a_loc (indices into the id vector),
      then packbits(frustum over the CC local candidates),
      then packbits(inlier over features).

    fn(pose_in (25,) f32, ids (CL+CC,) int32, mpf (P,8) f32, mpu (P,9) int32,
       feat_xy, feat_desc, feat_octave, feat_valid, feat_ur, *, cl)"""
    from ..ops import pose_opt as pose_ops
    device = torch.device(device)
    sf, _ = _levels(scale, n_levels, device)
    inv_s2_lut = 1.0 / (sf * sf)
    camp = torch.tensor(cam_params, dtype=torch.float32, device=device)
    whv = torch.tensor(wh, dtype=torch.float32, device=device)
    _match = _make_pool_matcher(cam_type, n_levels, scale, camp, whv, device)

    def fn(pose_in, ids, mpf, mpu, feat_xy, feat_desc, feat_octave, feat_valid,
           feat_ur, *, cl: int):
        N = feat_xy.shape[0]
        R0 = pose_in[0:9].reshape(3, 3)
        t0 = pose_in[9:12]
        prior_R = pose_in[12:21].reshape(3, 3)
        prior_t = pose_in[21:24]
        prior_eps = pose_in[24]
        inv_s2 = inv_s2_lut[torch.clamp(feat_octave, 0, n_levels - 1).long()]
        ids_l, ids_c = ids[:cl], ids[cl:]
        l_xyz, l_desc, l_norm, l_mind, l_maxd, l_valid = _gather_pool(mpf, mpu, ids_l)
        c_xyz, c_desc, c_norm, c_mind, c_maxd, c_valid = _gather_pool(mpf, mpu, ids_c)

        # stage 1: last-frame points at the predicted pose
        idx1, ok1, _ = _match(l_xyz, l_desc, l_norm, l_mind, l_maxd, l_valid,
                              R0, t0, feat_xy, feat_desc, feat_octave, feat_valid,
                              motion_radius, motion_ratio, th_high, 0.5, retry_min=20)
        a_last = _assign(N, idx1, ok1, device)
        m1 = a_last >= 0
        pts1 = l_xyz[torch.clamp(a_last, min=0).long()]
        res1 = pose_ops.pose_optimize(
            R0, t0, pts1, feat_xy, inv_s2, m1 & feat_valid, camp,
            cam_type=cam_type, rounds=pose_rounds, iters=pose_iters,
            obs_ur=feat_ur, bf=bf, prior_R=prior_R, prior_t=prior_t, prior_eps=prior_eps)
        a_last = torch.where(res1.inlier & m1, a_last, -1)

        # stage 2: local-map points at the refined pose
        idx2, ok2, frustum2 = _match(c_xyz, c_desc, c_norm, c_mind, c_maxd, c_valid,
                                     res1.R, res1.t, feat_xy, feat_desc, feat_octave,
                                     feat_valid & (a_last < 0), local_radius,
                                     local_ratio, th_high, 0.5)
        a_loc = _assign(N, idx2, ok2, device)
        a_loc = torch.where(a_last >= 0, -1, a_loc)
        m2 = (a_last >= 0) | (a_loc >= 0)
        pts2 = torch.where((a_last >= 0)[:, None],
                           l_xyz[torch.clamp(a_last, min=0).long()],
                           c_xyz[torch.clamp(a_loc, min=0).long()])
        res2 = pose_ops.pose_optimize(
            res1.R, res1.t, pts2, feat_xy, inv_s2, m2 & feat_valid, camp,
            cam_type=cam_type, rounds=pose_rounds, iters=pose_iters,
            obs_ur=feat_ur, bf=bf, prior_R=prior_R, prior_t=prior_t, prior_eps=prior_eps)
        a_last = torch.where(res2.inlier, a_last, -1)
        a_loc = torch.where(res2.inlier, a_loc, -1)
        n1 = torch.sum((m1 & feat_valid), dtype=torch.int32)
        return torch.cat([
            f32_bits(res2.R.reshape(-1)),
            f32_bits(res2.t),
            torch.stack([n1, res2.n_inliers.to(torch.int32)]),
            a_last, a_loc,
            _pack_bits_i32(frustum2),
            _pack_bits_i32(res2.inlier),
        ])

    return fn


@_cached_per_device
def fused_track_vi_pooled(cam_type: int, n_levels: int, scale: float,
                          cam_params: tuple, wh: tuple, bf: float,
                          motion_radius: float, local_radius: float,
                          motion_ratio: float, local_ratio: float,
                          th_high: int, sigma_gw: float, sigma_aw: float,
                          pose_rounds: int = 2, pose_iters: int = 10, device=None):
    """Per-frame VISUAL-INERTIAL tracking against the device-resident pool
    (the reference's PredictStateIMU → SearchByProjection → PoseOptimization
    → TrackLocalMap → PoseInertialOptimizationLastFrame in one step):

      1. IMU state propagation from the previous frame's body state through
         the per-frame preintegration;
      2. last-frame candidates matched at the predicted pose
         (``match_rows_dual``: radius and 2x radius in one launch) → visual
         pose LM with a weak prior anchored at the prediction;
      3. local-map candidates matched at the refined pose (``match_rows``);
      4. ``vi_ba.pose_inertial_optimize``: pose + velocity + biases against
         the previous 15-dim state with the carried marginal prior.

    fn(vi_state (247,) f32, ids (CL+CC,) int32, mpf, mpu, feat_xy, feat_desc,
       feat_octave, feat_valid, feat_ur, pre: PreintState, *, cl) → packed
    int32, the reference's layout:
      [0:12]=bits(R,t), [12]=n1, [13]=n_inl, [14:14+N]=a_last,
      [14+N:14+2N]=a_loc, packbits(frustum over CC), packbits(inlier),
      then bits of v(3), bg(3), ba(3), H_marg(225).

    vi_state = [R1_wb(9), p1_wb(3), v1(3), bg(3), ba(3), prior_H(225),
                prior_eps_visual(1)]."""
    from ..ops import imu as imu_ops
    from ..ops import pose_opt as pose_ops
    from ..ops import vi_ba as vi_ops
    device = torch.device(device)
    sf, _ = _levels(scale, n_levels, device)
    inv_s2_lut = 1.0 / (sf * sf)
    camp = torch.tensor(cam_params, dtype=torch.float32, device=device)
    whv = torch.tensor(wh, dtype=torch.float32, device=device)
    _match = _make_pool_matcher(cam_type, n_levels, scale, camp, whv, device)

    def fn(vi_state, ids, mpf, mpu, feat_xy, feat_desc, feat_octave, feat_valid,
           feat_ur, pre, *, cl: int):
        N = feat_xy.shape[0]
        R1_wb = vi_state[0:9].reshape(3, 3)
        p1_wb = vi_state[9:12]
        v1 = vi_state[12:15]
        bg = vi_state[15:18]
        ba = vi_state[18:21]
        prior_H = vi_state[21:246].reshape(15, 15)
        prior_eps = vi_state[246]
        inv_s2 = inv_s2_lut[torch.clamp(feat_octave, 0, n_levels - 1).long()]

        # 1. PredictStateIMU through the deltas corrected to the current bias
        dR_c, dV_c, dP_c = imu_ops.corrected_delta(pre, bg, ba)
        g = imu_ops.gravity_vec(torch.float32, device)
        dT = pre.dT
        R2_wb = R1_wb @ dR_c
        p2_wb = p1_wb + v1 * dT + 0.5 * g * dT * dT + R1_wb @ dP_c
        v2 = v1 + g * dT + R1_wb @ dV_c
        R0 = R2_wb.T
        t0 = -R2_wb.T @ p2_wb

        ids_l, ids_c = ids[:cl], ids[cl:]
        l_xyz, l_desc, l_norm, l_mind, l_maxd, l_valid = _gather_pool(mpf, mpu, ids_l)
        c_xyz, c_desc, c_norm, c_mind, c_maxd, c_valid = _gather_pool(mpf, mpu, ids_c)

        # 2. last-frame points at the IMU-predicted pose; the visual LM refines
        idx1, ok1, _ = _match(l_xyz, l_desc, l_norm, l_mind, l_maxd, l_valid,
                              R0, t0, feat_xy, feat_desc, feat_octave, feat_valid,
                              motion_radius, motion_ratio, th_high, 0.5, retry_min=20)
        a_last = _assign(N, idx1, ok1, device)
        m1 = a_last >= 0
        pts1 = l_xyz[torch.clamp(a_last, min=0).long()]
        res1 = pose_ops.pose_optimize(
            R0, t0, pts1, feat_xy, inv_s2, m1 & feat_valid, camp,
            cam_type=cam_type, rounds=pose_rounds, iters=pose_iters,
            obs_ur=feat_ur, bf=bf, prior_R=R0, prior_t=t0, prior_eps=prior_eps)
        a_last = torch.where(res1.inlier & m1, a_last, -1)

        # 3. local-map points at the refined pose
        idx2, ok2, frustum2 = _match(c_xyz, c_desc, c_norm, c_mind, c_maxd, c_valid,
                                     res1.R, res1.t, feat_xy, feat_desc, feat_octave,
                                     feat_valid & (a_last < 0), local_radius,
                                     local_ratio, th_high, 0.5)
        a_loc = _assign(N, idx2, ok2, device)
        a_loc = torch.where(a_last >= 0, -1, a_loc)
        m2 = (a_last >= 0) | (a_loc >= 0)
        pts2 = torch.where((a_last >= 0)[:, None],
                           l_xyz[torch.clamp(a_last, min=0).long()],
                           c_xyz[torch.clamp(a_loc, min=0).long()])

        # 4. visual-inertial frame optimization with the marginal prior
        res2 = vi_ops.pose_inertial_optimize(
            res1.R, res1.t, v2, R1_wb, p1_wb, v1, bg, ba, dT, dR_c, dV_c, dP_c,
            pre.JRg, pre.JVg, pre.JVa, pre.JPg, pre.JPa, pre.C[:9, :9],
            pts2, feat_xy, inv_s2, m2 & feat_valid, camp,
            cam_type=cam_type, sigma_gw=sigma_gw, sigma_aw=sigma_aw, prior_H=prior_H)
        a_last = torch.where(res2.inlier, a_last, -1)
        a_loc = torch.where(res2.inlier, a_loc, -1)
        n1 = torch.sum((m1 & feat_valid), dtype=torch.int32)
        return torch.cat([
            f32_bits(res2.R.reshape(-1)),
            f32_bits(res2.t),
            torch.stack([n1, res2.n_inliers.to(torch.int32)]),
            a_last, a_loc,
            _pack_bits_i32(frustum2),
            _pack_bits_i32(res2.inlier),
            f32_bits(res2.v), f32_bits(res2.bg), f32_bits(res2.ba),
            f32_bits(res2.H_marg.reshape(-1)),
        ])

    return fn


@_cached_per_device
def projection_assign_pooled(cam_type: int, n_levels: int, scale: float,
                             cam_params: tuple, wh: tuple,
                             radius: float, ratio: float, max_dist: int,
                             view_cos_th: float,
                             octave_lo: int = 1, octave_hi: int = 1, device=None):
    """Pooled projection matcher: ONE packed int32 result
    [0:C]=idx, then packbits(ok), then packbits(frustum).

    fn(pose (12,) f32, ids (C,) int32, mpf, mpu, feat_xy, feat_desc,
       feat_octave, feat_valid)"""
    device = torch.device(device)
    sf, log_scale = _levels(scale, n_levels, device)
    camp = torch.tensor(cam_params, dtype=torch.float32, device=device)
    whv = torch.tensor(wh, dtype=torch.float32, device=device)

    def fn(pose, ids, mpf, mpu, feat_xy, feat_desc, feat_octave, feat_valid):
        R = pose[0:9].reshape(3, 3)
        t = pose[9:12]
        xyz, desc, normal, mind, maxd, mvalid = _gather_pool(mpf, mpu, ids)
        uv, lvl, frustum = _frustum(xyz, normal, mind, maxd, mvalid, R, t, cam_type,
                                    camp, whv, view_cos_th, log_scale, n_levels)
        idx, best, second = match_rows(desc, uv, radius * sf[lvl.long()], lvl, frustum,
                                       feat_desc, feat_xy, feat_octave, feat_valid,
                                       octave_lo=octave_lo, octave_hi=octave_hi)
        ok = _ratio_ok(best, second, ratio, max_dist)
        ok = matching.resolve_duplicates(idx, best, ok, feat_desc.shape[0])
        return torch.cat([idx, _pack_bits_i32(ok), _pack_bits_i32(frustum)])

    return fn


@_cached_per_device
def pose_opt_pooled(cam_type: int, cam_params: tuple, bf: float,
                    n_levels: int, scale: float,
                    rounds: int = 4, iters: int = 10, device=None):
    """Pooled pose-only LM; world points gathered by the frame's
    feature→point assignment. ONE packed int32 result:
    [0:12]=bits(R,t), [12]=n_inl, then packbits(inlier).

    fn(pose_in (25,) f32, feat_mp (N,) int32, mpf, feat_xy, feat_octave,
       feat_valid, feat_ur)"""
    from ..ops import pose_opt as pose_ops
    device = torch.device(device)
    sf, _ = _levels(scale, n_levels, device)
    inv_s2_lut = 1.0 / (sf * sf)
    camp = torch.tensor(cam_params, dtype=torch.float32, device=device)

    def fn(pose_in, feat_mp, mpf, feat_xy, feat_octave, feat_valid, feat_ur):
        matched = feat_mp >= 0
        pts = mpf[torch.clamp(feat_mp, min=0).long(), 0:3]
        inv_s2 = inv_s2_lut[torch.clamp(feat_octave, 0, n_levels - 1).long()]
        res = pose_ops.pose_optimize(
            pose_in[0:9].reshape(3, 3), pose_in[9:12], pts, feat_xy, inv_s2,
            matched & feat_valid, camp, cam_type=cam_type, rounds=rounds, iters=iters,
            obs_ur=feat_ur, bf=bf, prior_R=pose_in[12:21].reshape(3, 3),
            prior_t=pose_in[21:24], prior_eps=pose_in[24])
        return torch.cat([
            f32_bits(res.R.reshape(-1)),
            f32_bits(res.t),
            res.n_inliers.to(torch.int32)[None],
            _pack_bits_i32(res.inlier),
        ])

    return fn


@_cached_per_device
def triangulation_batched(cam_type: int, n_levels: int, scale: float,
                          cam_params: tuple, cap_new: int = 2048,
                          max_dist: int = 50, sigma_n: float = 1.0, device=None):
    """Epipolar matching + DLT triangulation of a new keyframe against all its
    covisible neighbours in one call (reference CreateNewMapPoints).

    fn(pose1 (12,), xy1 (N,2), desc1 (N,8), oct1 (N,), un1 (N,) bool,
       nb_ids (B,) int32, nb_valid (B,) bool, poses2 (B,12), un2 (B,N) bool,
       pool_xy (Kc,N,2), pool_desc (Kc,N,8), pool_oct (Kc,N))
    → packed int32 (1 + cap_new·6): [0]=count, then f1, f2, b, bits(xw)."""
    device = torch.device(device)
    sf2 = torch.tensor([(scale ** i) ** 2 for i in range(n_levels)], dtype=torch.float32,
                       device=device)
    camp = torch.tensor(cam_params, dtype=torch.float32, device=device)
    sig = float(sigma_n)

    def fn(pose1, xy1, desc1, oct1, un1, nb_ids, nb_valid, poses2, un2,
           pool_xy, pool_desc, pool_oct):
        N = xy1.shape[0]
        B = nb_ids.shape[0]
        R1 = pose1[0:9].reshape(3, 3)
        t1 = pose1[9:12]
        R2 = poses2[:, 0:9].reshape(B, 3, 3)
        t2 = poses2[:, 9:12]
        safe = torch.clamp(nb_ids, min=0).long()
        xy2, desc2, oct2 = pool_xy[safe], pool_desc[safe], pool_oct[safe]
        rays1 = cam_ops.unproject(cam_type, camp, xy1).expand(B, N, 3)
        rays2 = cam_ops.unproject(cam_type, camp, xy2)                    # (B,N,3)
        R1i, t1i = lie.se3_inverse(R1, t1)
        R21 = R2 @ R1i
        t21 = (R2 @ t1i[:, None])[..., 0] + t2
        ep = _epipolar_ok(rays1, xy2, oct2, R21, t21, camp, sf2)
        dist = matching.hamming_matrix(desc1.expand(B, N, 8), desc2)      # (B,N,N)
        mask = un1[None, :, None] & un2[:, None, :] & ep
        idx, best, ok = matching.masked_match(dist, mask, max_dist, 1.0)
        ok = matching.resolve_duplicates(idx, best, ok, N)
        il = idx.long()
        r2m = torch.gather(rays2, 1, il[..., None].expand(B, N, 3))
        R2b, t2b = R2[:, None], t2[:, None]
        xw = triangulation.triangulate_dlt(R1, t1, rays1, R2b, t2b, r2m)
        s1 = sig * sig * sf2[oct1.long()]
        s2 = sig * sig * sf2[torch.gather(oct2, 1, il).long()]
        tri_ok, _ = triangulation.check_triangulation(
            xw, R1, t1, rays1, R2b, t2b, r2m, s1, s2,
            min_parallax_cos=0.9998, chi2_th=5.991)
        ok = ok & tri_ok & nb_valid[:, None] & (nb_ids >= 0)[:, None]
        sel, got = _compact(ok.reshape(-1), cap_new)
        count = torch.sum(got, dtype=torch.int32)
        sel_c = torch.clamp(sel, max=B * N - 1)
        b = (sel_c // N).to(torch.int32)
        f1 = torch.where(got, (sel_c % N).to(torch.int32), -1)
        f2 = idx.reshape(-1)[sel_c].to(torch.int32)
        xw_sel = xw.reshape(-1, 3)[sel_c]
        return torch.cat([count[None], f1, f2, b, f32_bits(xw_sel[:, 0]),
                          f32_bits(xw_sel[:, 1]), f32_bits(xw_sel[:, 2])])

    return fn


@_cached_per_device
def fuse_batched(cam_type: int, n_levels: int, scale: float,
                 cam_params: tuple, wh: tuple, cap_cand: int = 4096,
                 cap_out: int = 4096, radius: float = 3.0,
                 max_dist: int = 50, device=None):
    """Projection fuse of candidate map points into several target keyframes
    in one call (reference SearchInNeighbors → ORBmatcher::Fuse); all
    targets' matching runs as one batched ``match_rows`` launch.

    fn(tgt_ids (T,) int32, tgt_poses (T,12) f32, tgt_fvalid (T,N) bool,
       cand_ids (T,C) int32, mpf, mpu, pool_xy, pool_desc, pool_oct)
    → packed int32: [0]=count, rows (cap_out): t, c, feat."""
    device = torch.device(device)
    sf, log_scale = _levels(scale, n_levels, device)
    camp = torch.tensor(cam_params, dtype=torch.float32, device=device)
    whv = torch.tensor(wh, dtype=torch.float32, device=device)

    def fn(tgt_ids, tgt_poses, tgt_fvalid, cand_ids, mpf, mpu,
           pool_xy, pool_desc, pool_oct):
        T, C = cand_ids.shape
        safe = torch.clamp(tgt_ids, min=0).long()
        xy2, desc2, oct2 = pool_xy[safe], pool_desc[safe], pool_oct[safe]
        R = tgt_poses[:, 0:9].reshape(T, 3, 3)
        t = tgt_poses[:, 9:12]
        xyz, desc, normal, mind, maxd, mvalid = _gather_pool(mpf, mpu, cand_ids)
        uv, lvl, frustum = _frustum(xyz, normal, mind, maxd, mvalid, R, t, cam_type,
                                    camp, whv, 0.5, log_scale, n_levels)
        idx, best, _ = match_rows(desc, uv, radius * sf[lvl.long()], lvl, frustum,
                                  desc2, xy2, oct2, tgt_fvalid)
        ok = matching.resolve_duplicates(idx, best, best <= max_dist, desc2.shape[1])
        ok = ok & (tgt_ids >= 0)[:, None]
        sel, got = _compact(ok.reshape(-1), cap_out)
        count = torch.sum(got, dtype=torch.int32)
        sel_c = torch.clamp(sel, max=T * C - 1)
        t_i = torch.where(got, (sel_c // C).to(torch.int32), -1)
        c_i = (sel_c % C).to(torch.int32)
        f_i = idx.reshape(-1)[sel_c].to(torch.int32)
        return torch.cat([count[None], t_i, c_i, f_i])

    return fn


@functools.lru_cache(maxsize=None)
def ba_result_packer():
    """Pack a BAResult into ONE int32 buffer:
    [bits R (K·9) | bits t (K·3) | bits pts (P·3) | packbits(obs_inlier)]."""
    def fn(R, t, pts, obs_inlier):
        return torch.cat([f32_bits(R.reshape(-1)), f32_bits(t.reshape(-1)),
                          f32_bits(pts.reshape(-1)), _pack_bits_i32(obs_inlier)])
    return fn
