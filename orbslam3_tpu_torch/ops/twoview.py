"""Two-view reconstruction: batched H/F RANSAC for the monocular bootstrap.

Port of ``orbslam3_tpu/ops/twoview.py``: all 200 hypotheses are estimated and
scored in one batch; the winner's 4 essential (or 8 Faugeras homography)
decompositions are checked with a batched triangulation. Inputs are
normalized camera coordinates; the hypothesis sets are drawn on the host by
the caller's numpy generator, so the port and the reference score the same
sets.

SVD and eigenvector signs are arbitrary: every score is invariant to them
(squared residuals, division by the homogeneous coordinate), and a sign flip
only permutes the decomposition candidates.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import triangulation

CHI2_F = 3.841
CHI2_H = 5.991
SCORE_GAMMA = 5.991


def _ones(x: torch.Tensor) -> torch.Tensor:
    return torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)


def _eight_point_F(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Batched 8-point algorithm. x1,x2: (B,8,2) → F (B,3,3) rank-2 enforced."""
    X1 = torch.cat([x1, _ones(x1)], dim=-1)
    X2 = torch.cat([x2, _ones(x2)], dim=-1)
    A = (X2[..., :, None] * X1[..., None, :]).reshape(x1.shape[0], 8, 9)
    AtA = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(AtA)
    F = vecs[..., :, 0].reshape(-1, 3, 3)
    u, s, vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return (u * s[..., None, :]) @ vt


def _four_point_H(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Batched DLT homography from 8 points. x*: (B,8,2)."""
    X1 = torch.cat([x1, _ones(x1)], dim=-1)
    zeros = torch.zeros_like(X1)
    u2 = x2[..., 0:1]
    v2 = x2[..., 1:2]
    r1 = torch.cat([zeros, -X1, v2 * X1], dim=-1)
    r2 = torch.cat([X1, zeros, -u2 * X1], dim=-1)
    A = torch.cat([r1, r2], dim=1)
    AtA = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(AtA)
    return vecs[..., :, 0].reshape(-1, 3, 3)


def _sym_transfer_chi2_F(F, x1, x2):
    """(B,N) epipolar distances in both images for F hypotheses."""
    X1 = torch.cat([x1, _ones(x1)], dim=-1)[None]
    X2 = torch.cat([x2, _ones(x2)], dim=-1)[None]
    l2 = X1 @ F.transpose(-1, -2)                  # F x1: line in image 2
    l1 = X2 @ F                                    # Fᵀ x2: line in image 1
    d2 = torch.sum(X2 * l2, dim=-1) ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-20)
    d1 = torch.sum(X1 * l1, dim=-1) ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-20)
    return d1, d2


def _sym_transfer_chi2_H(H, x1, x2):
    X1 = torch.cat([x1, _ones(x1)], dim=-1)[None]
    X2 = torch.cat([x2, _ones(x2)], dim=-1)[None]
    Hx1 = X1 @ H.transpose(-1, -2)
    Hx2 = X2 @ torch.linalg.inv_ex(H).inverse.transpose(-1, -2)

    def dehom(p):
        z = p[..., 2:]
        return p[..., :2] / torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)

    d2 = torch.sum((x2[None] - dehom(Hx1)) ** 2, dim=-1)
    d1 = torch.sum((x1[None] - dehom(Hx2)) ** 2, dim=-1)
    return d1, d2


def _score(d1, d2, valid, chi_th, inv_sigma_n2):
    """Per-match contribution (GAMMA − chi) for each direction passing its
    gate; a match is an inlier iff both directions pass."""
    c1 = d1 * inv_sigma_n2
    c2 = d2 * inv_sigma_n2
    ok1 = c1 < chi_th
    ok2 = c2 < chi_th
    sc = torch.where(ok1, SCORE_GAMMA - c1, 0.0) + torch.where(ok2, SCORE_GAMMA - c2, 0.0)
    sc = torch.where(valid[None], sc, 0.0)
    return torch.sum(sc, dim=-1), ok1 & ok2 & valid[None]


def decompose_homography(H: torch.Tensor):
    """Faugeras SVD decomposition of a normalized homography into 8 motion
    hypotheses. Returns (R (8,3,3), t (8,3) unit, n (8,3))."""
    U, D, Vt = torch.linalg.svd(H)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = D[0], D[1], D[2]
    eps = 1e-9
    x1m = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / torch.clamp(d1 * d1 - d3 * d3, min=eps), min=0.0))
    x3m = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / torch.clamp(d1 * d1 - d3 * d3, min=eps), min=0.0))
    e1 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=H.dtype, device=H.device)
    e3 = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=H.dtype, device=H.device)
    x1 = e1 * x1m
    x3 = e3 * x3m
    zero = torch.zeros_like(x1)
    one = torch.ones_like(x1)
    d2c = torch.clamp(d2, min=eps)

    def rotation(c, s_, sign):
        # (4,3,3): [[c, 0, sign·s], [0, −sign, 0], [s, 0, −sign·c]]
        return torch.stack([
            torch.stack([c, zero, sign * s_], dim=-1),
            torch.stack([zero, -sign * one, zero], dim=-1),
            torch.stack([s_, zero, -sign * c], dim=-1),
        ], dim=-2)

    # case d' = +d2: Rp = [[ct,0,-st],[0,1,0],[st,0,ct]]
    st = (d1 - d3) * x1 * x3 / d2c
    ct = (d1 * x3 * x3 + d3 * x1 * x1) / d2c
    Rp_pos = rotation(ct, st, -1.0)
    tp_pos = (d1 - d3) * torch.stack([x1, zero, -x3], dim=-1)
    # case d' = −d2: Rp = [[cp,0,sp],[0,-1,0],[sp,0,-cp]]
    sp = (d1 + d3) * x1 * x3 / d2c
    cp = (d3 * x1 * x1 - d1 * x3 * x3) / d2c
    Rp_neg = rotation(cp, sp, 1.0)
    tp_neg = (d1 + d3) * torch.stack([x1, zero, x3], dim=-1)
    npl = torch.stack([x1, zero, x3], dim=-1)

    Rp = torch.cat([Rp_pos, Rp_neg])                   # (8,3,3)
    tp = torch.cat([tp_pos, tp_neg])                   # (8,3)
    R8 = s * (U @ Rp @ Vt)
    t8 = tp @ U.T
    n8 = torch.cat([npl, npl]) @ Vt
    t8 = t8 / torch.clamp(torch.linalg.norm(t8, dim=-1, keepdim=True), min=1e-12)
    return R8, t8, n8


class TwoViewResult(NamedTuple):
    success: torch.Tensor        # () bool
    R: torch.Tensor              # (3,3) cam1→cam2 (world = cam1)
    t: torch.Tensor              # (3,) unit baseline
    pts: torch.Tensor            # (N,3) triangulated in cam1 frame
    good: torch.Tensor           # (N,) bool
    is_homography: torch.Tensor  # () bool


def reconstruct_two_views(x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor,
                          rand_sets: torch.Tensor, sigma_n: float,
                          min_parallax_cos: float = 0.99995,
                          min_good: int = 50) -> TwoViewResult:
    """Full monocular bootstrap from N matched normalized coords.

    x1, x2: (N,2); valid: (N,); rand_sets: (iters, 8) indices of pre-sampled
    valid matches; sigma_n: pixel sigma / focal."""
    dev, dtype = x1.device, x1.dtype
    inv_sigma_n2 = 1.0 / (sigma_n * sigma_n)
    rs = rand_sets.long()
    s1 = x1[rs]
    s2 = x2[rs]

    F = _eight_point_F(s1, s2)
    H = _four_point_H(s1, s2)
    d1f, d2f = _sym_transfer_chi2_F(F, x1, x2)
    d1h, d2h = _sym_transfer_chi2_H(H, x1, x2)
    sf, inl_f = _score(d1f, d2f, valid, CHI2_F, inv_sigma_n2)
    sh, inl_h = _score(d1h, d2h, valid, CHI2_H, inv_sigma_n2)

    bf = torch.argmax(sf)
    bh = torch.argmax(sh)
    SF = sf[bf]
    SH = sh[bh]
    rh = SH / torch.clamp(SH + SF, min=1e-12)
    # ORB-SLAM2's 0.40 model-selection threshold (see the reference module)
    is_h = rh > 0.40
    inliers = torch.where(is_h, inl_h[bh], inl_f[bf])

    # ReconstructF: E = F in normalized coords; 4 decompositions
    u, _, vt = torch.linalg.svd(F[bf])
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=dtype, device=dev)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    tb = u[:, 2]
    tb = tb / (torch.linalg.norm(tb) + 1e-12)
    f_R = torch.stack([R1, R1, R2, R2])
    f_t = torch.stack([tb, -tb, tb, -tb])
    h_R, h_t, _ = decompose_homography(H[bh])
    cands_R = torch.cat([f_R, h_R])                    # (12,3,3)
    cands_t = torch.cat([f_t, h_t])                    # (12,3)
    cand_valid = torch.cat([(~is_h).expand(4), is_h.expand(8)])

    C = cands_R.shape[0]
    N = x1.shape[0]
    rays1 = torch.cat([x1, _ones(x1)], dim=-1).expand(C, N, 3)
    rays2 = torch.cat([x2, _ones(x2)], dim=-1).expand(C, N, 3)
    eye = torch.eye(3, dtype=dtype, device=dev)
    zero = torch.zeros(3, dtype=dtype, device=dev)
    sig2 = torch.full((N,), sigma_n * sigma_n * 4.0, dtype=dtype, device=dev)
    Rc = cands_R[:, None]
    tc = cands_t[:, None]
    xws = triangulation.triangulate_dlt(eye, zero, rays1, Rc, tc, rays2)   # (C,N,3)
    # the reference's gate CHI2_H·σn⁻²·sig2[0] in its float32 arithmetic
    chi2_th = float(np.float32(CHI2_H * inv_sigma_n2)
                    * np.float32(sigma_n * sigma_n * 4.0))
    oks, _ = triangulation.check_triangulation(
        xws, eye, zero, rays1, Rc, tc, rays2, sig2, sig2,
        min_parallax_cos=min_parallax_cos, chi2_th=chi2_th)
    oks = oks & inliers[None]
    ngood = torch.sum(oks.to(torch.int32), dim=-1)
    ngood = torch.where(cand_valid, ngood, -1)
    bi = torch.argmax(ngood)
    nbest = ngood[bi]
    nsecond = torch.sort(ngood).values[-2]
    n_inl = torch.sum(inliers, dtype=torch.int32)
    success = ((nbest >= min_good)
               & (nbest.to(torch.float32) > 0.75 * n_inl.to(torch.float32))
               & (nsecond.to(torch.float32) < 0.75 * nbest.to(torch.float32)))
    return TwoViewResult(success=success, R=cands_R[bi], t=cands_t[bi],
                         pts=xws[bi], good=oks[bi], is_homography=is_h)
