"""Binary descriptor matching on torch tensors.

Port of ``orbslam3_tpu/ops/matching.py``: one primitive — a masked all-pairs
Hamming matrix plus a row argmin — and every search variant is a different
mask on it. Descriptors are (…, 8) int32 bit patterns of 256-bit ORB words.

The plain Hamming matrix is the popcount of XOR written as one matrix
product over unpacked bits, exact in float32 (see ``hamming_matrix``); the
hand-written CUDA kernel (``ops/match_rows.py``) uses XOR + ``__popc``.
"""
from __future__ import annotations

import math

import torch

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
BIG = 10_000


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(…, 8) int32 words → (…, 256) float32 bits (word-major, LSB first)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    return ((desc[..., None] >> shifts) & 1).reshape(desc.shape[:-1] + (256,)).to(torch.float32)


def hamming_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """All-pairs 256-bit Hamming distance. da: (…,N,8), db: (…,M,8) int32 →
    (…,N,M) int32, as |a| + |b| − 2·a·b over the bit vectors. Exact: the
    products are 0/1 and every float32 partial sum is an integer ≤ 256
    (matmuls run in full float32, see the package ``__init__``)."""
    A = unpack_bits(da)
    B = unpack_bits(db)
    ab = A @ B.transpose(-1, -2)
    return (A.sum(-1)[..., :, None] + B.sum(-1)[..., None, :] - 2.0 * ab).to(torch.int32)


def masked_match(dist: torch.Tensor, mask: torch.Tensor, max_dist: int,
                 ratio: float | None = None):
    """Row-wise best match under a mask → (idx, best, ok). ``idx`` is the lowest
    column among equal bests (``argmin`` order); ``ok`` applies the distance
    threshold and, optionally, Lowe's ratio against the second best."""
    d = torch.where(mask, dist, BIG)
    col = torch.arange(d.shape[-1], device=d.device, dtype=torch.int32)
    if d.shape[-1] <= 8192:
        kmin = torch.amin(d * 8192 + col, dim=-1)
        best = kmin // 8192
        idx = kmin - best * 8192
    else:
        idx = torch.argmin(d, dim=-1).to(torch.int32)
        best = torch.gather(d, -1, idx[..., None].long())[..., 0]
    ok = best <= max_dist
    if ratio is not None:
        second = torch.amin(torch.where(col == idx[..., None], BIG, d), dim=-1)
        ok = ok & (best.to(torch.float32) < ratio * second.to(torch.float32))
    return idx, best, ok


def resolve_duplicates(idx: torch.Tensor, best: torch.Tensor, ok: torch.Tensor,
                       m: int) -> torch.Tensor:
    """Keep only the lowest-distance row per matched column (ties: lowest
    row). Returns the updated ok mask. With leading batch dims (…, n) each
    batch entry resolves against its own m columns."""
    if idx.dim() > 1:
        lead = idx.shape[:-1]
        nb = idx[..., 0].numel()
        off = torch.arange(nb, device=idx.device).reshape(lead + (1,))
        flat = resolve_duplicates((idx.long() + off * m).reshape(-1), best.reshape(-1),
                                  ok.reshape(-1), nb * m)
        return flat.reshape(idx.shape)
    n = idx.shape[0]
    dev = idx.device
    il = idx.long()
    d = torch.where(ok, best, BIG).to(torch.int32)
    col_best = torch.full((m,), BIG, dtype=torch.int32, device=dev).scatter_reduce(
        0, il, d, "amin", include_self=True)
    winner = col_best[il] == d
    row_ids = torch.arange(n, device=dev, dtype=torch.int32)
    col_row = torch.full((m,), n, dtype=torch.int32, device=dev).scatter_reduce(
        0, il, torch.where(winner & ok, row_ids, n), "amin", include_self=True)
    return ok & winner & (col_row[il] == row_ids)


def rotation_consistency(angle_a: torch.Tensor, angle_b: torch.Tensor,
                         idx: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Keep matches whose angle difference falls in the 3 dominant histogram
    bins (with the <10%-of-max bin rejection)."""
    two_pi = 2.0 * math.pi
    rot = torch.remainder(angle_a - angle_b[idx.long()], two_pi)
    bins = torch.clamp((rot * (HISTO_LENGTH / two_pi)).to(torch.int32), 0, HISTO_LENGTH - 1)
    counts = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=ok.device).index_add_(
        0, bins.long(), ok.to(torch.int32))
    top3 = torch.topk(counts, 3).values
    mx = top3[0].to(torch.float32)
    is1 = counts == top3[0]
    is2 = (counts == top3[1]) & (top3[1].to(torch.float32) > 0.1 * mx)
    is3 = (counts == top3[2]) & (top3[2].to(torch.float32) > 0.1 * mx)
    return ok & (is1 | is2 | is3)[bins.long()]


def window_mask(pred_xy: torch.Tensor, feat_xy: torch.Tensor, radius) -> torch.Tensor:
    """(N,M) mask: feature j within Chebyshev `radius` of predicted position i."""
    dx = torch.abs(pred_xy[:, None, 0] - feat_xy[None, :, 0])
    dy = torch.abs(pred_xy[:, None, 1] - feat_xy[None, :, 1])
    r = radius if isinstance(radius, (int, float)) else radius[:, None]
    return (dx <= r) & (dy <= r)


def octave_mask(pred_octave: torch.Tensor, feat_octave: torch.Tensor,
                lo: int = 0, hi: int = 1) -> torch.Tensor:
    """(N,M) mask: feature octave within [pred-lo, pred+hi]."""
    d = feat_octave[None, :] - pred_octave[:, None]
    return (d >= -lo) & (d <= hi)


def search_by_projection(desc_a, valid_a, pred_xy, pred_octave, desc_b, valid_b, feat_xy,
                         feat_octave, radius, max_dist: int = TH_HIGH,
                         ratio: float | None = None, angle_a=None, angle_b=None,
                         check_rotation: bool = False, octave_lo: int = 1, octave_hi: int = 1):
    """Projection-guided matching: map-point descriptors (A) at their
    predicted pixels and octaves against frame features (B) within a search
    window and an octave range (the reference's SearchByProjection family).
    Returns (idx, best, ok)."""
    dist = hamming_matrix(desc_a, desc_b)
    mask = (valid_a[:, None] & valid_b[None, :]
            & window_mask(pred_xy, feat_xy, radius)
            & octave_mask(pred_octave, feat_octave, octave_lo, octave_hi))
    idx, best, ok = masked_match(dist, mask, max_dist, ratio)
    ok = resolve_duplicates(idx, best, ok, desc_b.shape[0])
    if check_rotation and angle_a is not None:
        ok = rotation_consistency(angle_a, angle_b, idx, ok)
    return idx, best, ok


def epipolar_mask(rays1: torch.Tensor, xy2: torch.Tensor, E: torch.Tensor,
                  cam_params: torch.Tensor, sigma2_by_octave: torch.Tensor,
                  octave2: torch.Tensor, th_chi2: float = 3.84) -> torch.Tensor:
    """(N,M) mask of the pairs that satisfy the epipolar constraint: the
    pixel distance of x2 (pinhole ``cam_params``) to the epipolar line
    E·ray1 (E: c2←c1) below th_chi2·σ² of x2's octave (the reference's
    CheckDistEpipolarLine). rays1 (N,3) unit-z rays of camera 1."""
    fx, fy, cx, cy = cam_params[0], cam_params[1], cam_params[2], cam_params[3]
    line = rays1 @ E.T                                                # (N,3)
    a = line[:, 0] / fx
    b = line[:, 1] / fy
    c = line[:, 2] - line[:, 0] * cx / fx - line[:, 1] * cy / fy
    num = a[:, None] * xy2[None, :, 0] + b[:, None] * xy2[None, :, 1] + c[:, None]
    dsq = (num * num) / torch.clamp((a * a + b * b)[:, None], min=1e-12)
    return dsq < th_chi2 * sigma2_by_octave[octave2.long()][None, :]


def search_for_initialization(desc1, valid1, xy1, angle1, desc2, valid2, xy2, angle2,
                              window: float = 100.0, ratio: float = 0.9,
                              max_dist: int = TH_LOW):
    """Monocular-init matching: window search around the level-0 keypoint
    positions, ratio 0.9, rotation check."""
    dist = hamming_matrix(desc1, desc2)
    mask = valid1[:, None] & valid2[None, :] & window_mask(xy1, xy2, window)
    idx, best, ok = masked_match(dist, mask, max_dist, ratio)
    ok = resolve_duplicates(idx, best, ok, desc2.shape[0])
    ok = rotation_consistency(angle1, angle2, idx, ok)
    return idx, best, ok


def search_by_descriptor(desc_a, valid_a, desc_b, valid_b,
                         max_dist: int = TH_LOW, ratio: float = 0.7,
                         angle_a=None, angle_b=None, check_rotation: bool = False):
    """Unconstrained descriptor matching (SearchByBoW semantics)."""
    dist = hamming_matrix(desc_a, desc_b)
    mask = valid_a[:, None] & valid_b[None, :]
    idx, best, ok = masked_match(dist, mask, max_dist, ratio)
    ok = resolve_duplicates(idx, best, ok, desc_b.shape[0])
    if check_rotation and angle_a is not None:
        ok = rotation_consistency(angle_a, angle_b, idx, ok)
    return idx, best, ok
