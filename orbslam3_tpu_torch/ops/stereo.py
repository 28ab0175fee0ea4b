"""Rectified stereo, RGB-D and two-camera fisheye feature matching.

Port of ``orbslam3_tpu/ops/stereo.py`` (reference ``Frame::ComputeStereoMatches``,
``ComputeStereoFromRGBD`` and ``ComputeStereoFishEyeMatches``) as plain torch:

- ``stereo_match``: one masked all-pairs Hamming matrix (same row band,
  disparity in (0.1, bf/min_z], octave within ±1), the row argmin (first index
  on ties) under the 75 gate;
- ``subpixel_refine``: the 11x11 centre-normalized SAD slid ±5 px on the right
  image, a parabola through the minimum, and the reference's median-SAD cut
  with the JAX package's behaviour kept exactly (see the function);
- ``depth_to_virtual_ur``: RGB-D depth → a virtual right coordinate;
- ``fisheye_stereo_match``: descriptor matching inside the lapping areas,
  Lowe's ratio, one row per right feature, DLT triangulation through the KB8
  rays and the parallax / reprojection gates.
"""
from __future__ import annotations

import torch

from . import camera as cam_ops
from . import matching
from . import triangulation

TH_ORB = (matching.TH_HIGH + matching.TH_LOW) // 2  # 75


def _over(num, den: torch.Tensor) -> torch.Tensor:
    """num / den in den's dtype, a true division: a Python number on the left
    of ``/`` makes torch multiply by the reciprocal, one rounding more than
    the JAX package's division."""
    return torch.div(torch.as_tensor(num, dtype=den.dtype, device=den.device), den)


def stereo_match(xy_l, desc_l, oct_l, valid_l, xy_r, desc_r, oct_r, valid_r,
                 scale_factors, bf, min_z):
    """Returns (ur (N,), depth (N,), ok (N,)) for the left features.

    scale_factors: (L,) per-octave scale; bf = baseline·fx; min_z: the closest
    depth (the largest disparity is bf/min_z)."""
    sf_l = scale_factors[oct_l.long()]
    dy = torch.abs(xy_l[:, None, 1] - xy_r[None, :, 1])
    row_ok = dy <= 2.0 * sf_l[:, None]
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    max_d = _over(bf, torch.as_tensor(min_z, dtype=xy_l.dtype, device=xy_l.device))
    disp_ok = (disp > 0.1) & (disp <= max_d)
    o_ok = matching.octave_mask(oct_l, oct_r, 1, 1)
    mask = valid_l[:, None] & valid_r[None, :] & row_ok & disp_ok & o_ok

    dist = matching.hamming_matrix(desc_l, desc_r)
    d = torch.where(mask, dist, matching.BIG)
    idx = torch.argmin(d, dim=1)          # the first column on ties, as jnp.argmin
    best = torch.gather(d, 1, idx[:, None])[:, 0]
    ok = best <= TH_ORB

    ur = xy_r[idx, 0]
    disparity = xy_l[:, 0] - ur
    ok = ok & (disparity > 0.1) & (disparity <= max_d)
    depth = _over(bf, torch.clamp(disparity, min=1e-6))
    return ur, depth, ok


def _median_as_jax(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D float tensor: NaN as soon as one entry is NaN,
    else the middle value, or the mean of the two middle values on an even
    count (``torch.median`` returns the lower one; ``torch.nanmedian`` skips
    NaNs). No host synchronization."""
    n = x.shape[0]
    s = torch.sort(x).values            # NaNs sort last
    mid = 0.5 * s[(n - 1) // 2] + 0.5 * s[n // 2]
    return torch.where(torch.isnan(x).any(), torch.full_like(mid, float("nan")), mid)


def subpixel_refine(img_l: torch.Tensor, img_r: torch.Tensor, xy_l: torch.Tensor,
                    ur: torch.Tensor, ok: torch.Tensor, w: int = 5, search: int = 5):
    """Image-SAD subpixel disparity refinement (reference src/Frame.cc:1087-1130:
    an 11x11 window slid ±5 px on the right image, a parabola through the SAD
    minimum). Returns the refined ur (N,) and the validity mask.

    The median-SAD outlier cut takes the median over every feature with the
    unmatched ones as NaN, exactly as the JAX package does: one NaN makes the
    median NaN, which becomes 1e9, so the cut is off whenever a feature has no
    stereo match (almost always). A shared quirk, kept for parity."""
    H, W = img_l.shape
    n = xy_l.shape[0]
    dev = xy_l.device
    xl = torch.round(xy_l[:, 0]).to(torch.int64)       # half to even, as jnp.round
    yl = torch.round(xy_l[:, 1]).to(torch.int64)
    xr0 = torch.round(ur).to(torch.int64)
    rng = torch.arange(-w, w + 1, device=dev)
    dy, dx = torch.meshgrid(rng, rng, indexing="ij")
    flat_l = img_l.reshape(-1).to(torch.float32)
    flat_r = img_r.reshape(-1).to(torch.float32)

    def gather(flat, cx, cy):
        ix = torch.clamp(cx[:, None, None] + dx[None], 0, W - 1)
        iy = torch.clamp(cy[:, None, None] + dy[None], 0, H - 1)
        return flat[(iy * W + ix).reshape(n, -1)].reshape(n, 2 * w + 1, 2 * w + 1)

    patch_l = gather(flat_l, xl, yl)
    patch_l = patch_l - patch_l[:, w:w + 1, w:w + 1]
    sads = []
    for off in range(-search, search + 1):
        patch_r = gather(flat_r, xr0 + off, yl)
        patch_r = patch_r - patch_r[:, w:w + 1, w:w + 1]
        sads.append(torch.sum(torch.abs(patch_l - patch_r), dim=(1, 2)))
    sad = torch.stack(sads, dim=1)                     # (N, 2*search+1)
    best = torch.argmin(sad, dim=1)
    best_in = (best > 0) & (best < 2 * search)
    bc = torch.clamp(best, 1, 2 * search - 1)
    s_m = torch.gather(sad, 1, (bc - 1)[:, None])[:, 0]
    s_0 = torch.gather(sad, 1, bc[:, None])[:, 0]
    s_p = torch.gather(sad, 1, (bc + 1)[:, None])[:, 0]
    denom = s_m + s_p - 2.0 * s_0
    delta = torch.where(torch.abs(denom) > 1e-6, 0.5 * (s_m - s_p) / denom, 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    ur_ref = xr0.to(torch.float32) + (bc - search).to(torch.float32) + delta
    ok = ok & best_in
    med = _median_as_jax(torch.where(ok, s_0, float("nan")))
    med = torch.nan_to_num(med, nan=1e9)
    ok = ok & (s_0 <= 1.5 * 1.4 * med)
    return torch.where(ok, ur_ref, ur), ok


def depth_to_virtual_ur(xy, depth_map_vals, bf):
    """RGB-D → virtual right coordinate ur = u − bf/z (reference
    src/Frame.cc:1279). Returns (ur, depth, ok), −1 where the depth is not
    positive."""
    z = depth_map_vals
    ok = z > 0
    ur = xy[:, 0] - _over(bf, torch.clamp(z, min=1e-6))
    return torch.where(ok, ur, -1.0), torch.where(ok, z, -1.0), ok


def fisheye_stereo_match(xy_l, desc_l, oct_l, valid_l, xy_r, desc_r, oct_r, valid_r,
                         cam_l, cam_r, R_rl, t_rl, lap_l, lap_r, level_sigma2,
                         ratio: float = 0.7, max_dist: int = 50,
                         min_parallax_cos: float = 0.9998, chi2_th: float = 5.991):
    """Two-camera fisheye (Kannala-Brandt-8) stereo matching and triangulation
    (reference Frame::ComputeStereoFishEyeMatches, src/Frame.cc:1440-1480).

    cam_l/cam_r: (8,) KB8 parameters; (R_rl, t_rl): right←left extrinsics;
    lap_l/lap_r: (2,) pixel-u lapping intervals per eye. Returns (idx (N,),
    ok (N,), depth_l (N,), xl (N,3)): the matched right index, acceptance, the
    z-depth and the 3-D point in the LEFT camera."""
    rays_l = cam_ops.kb8_unproject(cam_l, xy_l)
    rays_r = cam_ops.kb8_unproject(cam_r, xy_r)

    in_lap_l = (xy_l[:, 0] >= lap_l[0]) & (xy_l[:, 0] <= lap_l[1])
    in_lap_r = (xy_r[:, 0] >= lap_r[0]) & (xy_r[:, 0] <= lap_r[1])
    mask = (valid_l & in_lap_l)[:, None] & (valid_r & in_lap_r)[None, :]
    mask = mask & matching.octave_mask(oct_l, oct_r, 1, 1)

    dist = matching.hamming_matrix(desc_l, desc_r)
    idx, best, ok = matching.masked_match(dist, mask, max_dist, ratio)
    ok = matching.resolve_duplicates(idx, best, ok, desc_r.shape[0])

    # the left camera anchors the triangulation (T_l = I), the right is (R_rl, t_rl)
    eye = torch.eye(3, dtype=rays_l.dtype, device=rays_l.device)
    zero = torch.zeros(3, dtype=rays_l.dtype, device=rays_l.device)
    il = idx.long()
    r2m = rays_r[il]
    xl = triangulation.triangulate_dlt(eye, zero, rays_l, R_rl, t_rl, r2m)
    # χ² gates in normalized-ray units scaled by the fisheye focal
    f2 = cam_l[0] * cam_l[0]
    sig_l = level_sigma2[oct_l.long()] / f2
    sig_r = level_sigma2[oct_r.long()[il]] / f2
    tri_ok, _ = triangulation.check_triangulation(
        xl, eye, zero, rays_l, R_rl, t_rl, r2m, sig_l, sig_r,
        min_parallax_cos=min_parallax_cos, chi2_th=chi2_th)
    z = xl[..., 2]
    ok = ok & tri_ok & (z > 1e-4)
    return idx, ok, torch.where(ok, z, -1.0), xl
