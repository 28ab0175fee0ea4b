"""ORB feature extraction on torch tensors.

Port of ``orbslam3_tpu/ops/features.py``: 8-level pyramid, FAST-9/16 at two
thresholds with the per-cell fallback, 3x3 NMS, per-cell then per-level
top-k, intensity-centroid orientation and steered 256-bit BRIEF. Shapes are
static per image size; every step is a batched tensor op on the image's
device.

Two details keep the port bit-compatible with the reference:

- The pyramid. ``jax.image.resize(..., "bilinear")`` antialiases when it
  downscales: it is a separable triangle filter whose width follows the
  scale. The same weight matrices are built here in numpy float32 (JAX's
  ``compute_weight_mat`` scale-and-translate recipe) once per level shape and
  applied as ``Wyᵀ @ img @ Wx``. ``F.interpolate(antialias=True)`` uses
  another filter support and does not match.
- Top-k ties. FAST scores on 8-bit images are integer-valued, so ties are
  common. ``lax.top_k`` puts the lower index first; a stable descending sort
  gives the same order, where ``torch.topk`` promises none.

Descriptors are the int32 bit patterns of the reference's uint32 words.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .orb_pattern import BIT_PATTERN_31

EDGE_THRESHOLD = 19
PATCH_HALF = 15

# 16-point Bresenham circle of radius 3, in angular order (dx, dy).
_RING = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)

BRIEF_PATTERN = BIT_PATTERN_31


def scale_factors(n_levels: int, scale: float):
    """Per-level scale factor, sigma2 and inverses."""
    s = np.array([scale ** i for i in range(n_levels)], dtype=np.float32)
    return s, s * s, 1.0 / s, 1.0 / (s * s)


def per_level_capacities(n_features: int, n_levels: int, scale: float):
    """Geometric feature allocation per level."""
    factor = 1.0 / scale
    n_first = n_features * (1 - factor) / (1 - factor ** n_levels)
    caps = []
    acc = 0
    for i in range(n_levels - 1):
        c = int(round(n_first * factor ** i))
        caps.append(c)
        acc += c
    caps.append(max(n_features - acc, 0))
    return caps


class OrbFeatures(NamedTuple):
    """SoA feature set for one image; fixed capacity N with validity mask."""
    xy: torch.Tensor        # (N, 2) float32, level-0 pixels
    response: torch.Tensor  # (N,) float32
    angle: torch.Tensor     # (N,) float32 radians
    octave: torch.Tensor    # (N,) int32
    desc: torch.Tensor      # (N, 8) int32 bit patterns of the uint32 words
    valid: torch.Tensor     # (N,) bool


@dataclass(frozen=True)
class OrbConfig:
    n_features: int = 1024
    n_levels: int = 8
    scale: float = 1.2
    ini_th: int = 20
    min_th: int = 7
    cell: int = 35
    cell_topk: int = 8

    @property
    def capacities(self):
        return per_level_capacities(self.n_features, self.n_levels, self.scale)

    @property
    def total_capacity(self):
        return sum(self.capacities)


def _sort_desc(x: torch.Tensor, k: int):
    """First k of a descending sort along the last dim, lower index first
    among equal values (``lax.top_k`` order)."""
    idx = torch.sort(-x, dim=-1, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


# ---------------------------------------------------------------------------
# FAST
# ---------------------------------------------------------------------------

def fast_response(img: torch.Tensor, th_hi: float, th_lo: float):
    """FAST-9/16 masks at two thresholds + OpenCV arc score. img: (H,W) f32.

    A pixel is a corner at threshold th where some cyclic run of 9 ring
    pixels is brighter than it by more than th (or darker by more than th):
    exactly where the best run's least difference, the arc score plus one,
    exceeds th. So both masks come from the score, as the ring's bit masks
    would give them."""
    h, w = img.shape
    # ring[k][y, x] = img[(y + dy) mod h, (x + dx) mod w]: slices of one
    # circular pad (the radius is 3), the values 16 rolls of the image give
    pad = F.pad(img[None, None], (3, 3, 3, 3), mode="circular")[0, 0]
    ring = torch.stack([pad[3 + int(dy):3 + int(dy) + h, 3 + int(dx):3 + int(dx) + w]
                        for dx, dy in _RING])
    diff = ring - img[None]

    def arc9_min(d):
        # min over each cyclic run of 9 ring entries: run i is e[i..i+8]
        e = torch.cat([d, d[:8]])
        m = torch.minimum(e[:-1], e[1:])          # e[j..j+1]
        m = torch.minimum(m[:-2], m[2:])          # e[j..j+3]
        m = torch.minimum(m[:-4], m[4:])          # e[j..j+7]
        return torch.minimum(m[:16], e[8:])

    bright = torch.amax(arc9_min(diff), dim=0)
    dark = torch.amax(arc9_min(-diff), dim=0)
    best = torch.maximum(bright, dark)
    return best > float(th_hi), best > float(th_lo), best - 1.0


def _cell_any(mask: torch.Tensor, cell: int) -> torch.Tensor:
    """Per-cell 'any' broadcast back to the pixel grid."""
    h, w = mask.shape
    m = F.pad(mask[None].to(torch.uint8), (0, (-w) % cell, 0, (-h) % cell))[0]
    hc, wc = m.shape[0] // cell, m.shape[1] // cell
    cells = m.reshape(hc, cell, wc, cell).amax(dim=(1, 3)) > 0
    up = cells.repeat_interleave(cell, dim=0).repeat_interleave(cell, dim=1)
    return up[:h, :w]


def _nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression mask (ties keep both)."""
    neigh = [torch.roll(score, (dy, dx), (0, 1))
             for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
    return score >= functools.reduce(torch.maximum, neigh)


def detect_level(img: torch.Tensor, cfg: OrbConfig, capacity: int):
    """Detect up to `capacity` FAST keypoints on one pyramid level.

    Returns (xy (capacity,2) int32 level coords, score (capacity,), valid)."""
    h, w = img.shape
    dev = img.device
    corner_hi, corner_lo, score = fast_response(img, cfg.ini_th, cfg.min_th)
    corner = corner_hi | (corner_lo & ~_cell_any(corner_hi, cfg.cell))
    b = EDGE_THRESHOLD
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inb = (ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)
    keep = corner & inb & _nms3(score)
    masked = torch.where(keep, score, -1.0)

    # one boosted winner per adaptive-size cell, then best-response fill
    cell = max(12, min(64, int(round(math.sqrt(h * w / max(capacity, 1))))))
    mp = F.pad(masked[None], (0, (-w) % cell, 0, (-h) % cell), value=-1.0)[0]
    hp, wp = mp.shape
    hc, wc = hp // cell, wp // cell
    cells = mp.reshape(hc, cell, wc, cell).permute(0, 2, 1, 3).reshape(hc * wc, cell * cell)
    k = min(cfg.cell_topk, cell * cell)
    cs, ci = _sort_desc(cells, k)
    boost = torch.where(torch.arange(k, device=dev)[None, :] == 0, 1e7, 0.0)
    cs_rank = torch.where(cs > 0.0, cs + boost, cs)
    cid = torch.arange(hc * wc, device=dev)[:, None]
    cy = (cid // wc) * cell + ci // cell
    cx = (cid % wc) * cell + ci % cell
    flat_rank = cs_rank.reshape(-1)
    kk = min(capacity, flat_rank.shape[0])
    top_r, top_i = _sort_desc(flat_rank, kk)
    top_s = cs.reshape(-1)[top_i]
    xy = torch.stack([cx.reshape(-1)[top_i], cy.reshape(-1)[top_i]], dim=-1).to(torch.int32)
    valid = top_r > 0.0
    if kk < capacity:  # pad (tiny levels)
        pad = capacity - kk
        xy = F.pad(xy, (0, 0, 0, pad))
        top_s = F.pad(top_s, (0, pad), value=-1.0)
        valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool, device=dev)])
    return xy, top_s, valid


# ---------------------------------------------------------------------------
# Orientation + descriptors
# ---------------------------------------------------------------------------

def _umax_table() -> np.ndarray:
    """OpenCV's integer circle boundary for IC_Angle."""
    half = PATCH_HALF
    umax = np.zeros(half + 2, np.int32)
    vmax = int(np.floor(half * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(half * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(np.round(np.sqrt(half * half - v * v)))
    v0 = 0
    for v in range(half, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: half + 1]


@functools.lru_cache(maxsize=1)
def _circ_mask() -> np.ndarray:
    umax = _umax_table()
    d = np.arange(-PATCH_HALF, PATCH_HALF + 1)
    dy, dx = np.meshgrid(d, d, indexing="ij")
    return (np.abs(dx) <= umax[np.abs(dy)]).astype(np.float32)


def ic_angles(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation. img: (H,W) f32; xy: (N,2) int32 level
    coords (in-border). → (N,) radians."""
    h, w = img.shape
    dev = img.device
    P = 2 * PATCH_HALF + 1
    mask = torch.as_tensor(_circ_mask(), device=dev)
    d = torch.arange(-PATCH_HALF, PATCH_HALF + 1, dtype=torch.float32, device=dev)
    dxm = d[None, :] * mask
    dym = d[:, None] * mask
    y0 = torch.clamp(xy[:, 1].long() - PATCH_HALF, 0, h - P)
    x0 = torch.clamp(xy[:, 0].long() - PATCH_HALF, 0, w - P)
    off = torch.arange(P, device=dev)
    patch = img[(y0[:, None] + off)[:, :, None], (x0[:, None] + off)[:, None, :]]
    m10 = torch.sum(patch * dxm, dim=(1, 2))
    m01 = torch.sum(patch * dym, dim=(1, 2))
    return torch.atan2(m01, m10)


def gaussian_blur7(img: torch.Tensor) -> torch.Tensor:
    """7x7 Gaussian, sigma=2, separable, reflect-101 borders."""
    x = np.arange(-3, 4)
    k = np.exp(-(x ** 2) / (2 * 2.0 ** 2))
    kj = torch.as_tensor((k / k.sum()).astype(np.float32), device=img.device)
    H, W = img.shape
    p = F.pad(img[None, None], (0, 0, 3, 3), mode="reflect")[0, 0]
    v = sum(kj[i] * p[i:i + H, :] for i in range(7))
    p = F.pad(v[None, None], (3, 3, 0, 0), mode="reflect")[0, 0]
    return sum(kj[i] * p[:, i:i + W] for i in range(7))


def fold_u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a value in [0, 2^32) → int32 with the same bit pattern."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def brief_descriptors(blurred: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Steered 256-bit BRIEF → (N, 8) int32 bit patterns."""
    h, w = blurred.shape
    dev = blurred.device
    pat = torch.as_tensor(BRIEF_PATTERN.astype(np.float32), device=dev)   # (256,4)
    ca, sa = torch.cos(angle), torch.sin(angle)

    def rot(px, py):
        rx = torch.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None]).to(torch.int32)
        ry = torch.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None]).to(torch.int32)
        return rx, ry

    ax, ay = rot(pat[:, 0], pat[:, 1])
    bx, by = rot(pat[:, 2], pat[:, 3])
    cx = xy[:, 0:1]
    cy = xy[:, 1:2]
    flat = blurred.reshape(-1)

    def sample(ox, oy):
        ix = torch.clamp(cx + ox, 0, w - 1)
        iy = torch.clamp(cy + oy, 0, h - 1)
        return flat[(iy * w + ix).long()]

    bits = sample(ax, ay) < sample(bx, by)                     # (N,256)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    words = bits.reshape(bits.shape[0], 8, 32).to(torch.int64) << shifts
    return fold_u32_to_i32(words.sum(dim=-1))


# ---------------------------------------------------------------------------
# Pyramid
# ---------------------------------------------------------------------------

def _level_shapes(h: int, w: int, cfg: OrbConfig):
    shapes = []
    for i in range(cfg.n_levels):
        s = 1.0 / (cfg.scale ** i)
        shapes.append((int(round(h * s)), int(round(w * s))))
    return shapes


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 weights of JAX's antialiased bilinear resize along one
    axis (scale-and-translate with a triangle kernel widened by 1/scale when
    downscaling), computed in the same float32 operation order."""
    f32 = np.float32
    scale = out_size / in_size
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.0) * inv_scale - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def pyramid_weights(h: int, w: int, cfg: OrbConfig, device) -> list:
    """Per level > 0: (Wy (in_h,out_h), Wx (in_w,out_w)) on ``device``; each
    level resizes the previous one, as the reference does."""
    shapes = _level_shapes(h, w, cfg)
    out = []
    for lvl in range(1, cfg.n_levels):
        (ih, iw), (oh, ow) = shapes[lvl - 1], shapes[lvl]
        out.append((torch.as_tensor(resize_weights(ih, oh), device=device),
                    torch.as_tensor(resize_weights(iw, ow), device=device)))
    return out


def resize_level(img: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    return wy.T @ img @ wx


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------

def extract_orb(img: torch.Tensor, cfg: OrbConfig, weights: list | None = None) -> OrbFeatures:
    """Full ORB extraction on a (H,W) image. Output capacity is
    ``cfg.total_capacity`` with a validity mask."""
    img = img.to(torch.float32)
    h, w = img.shape
    if weights is None:
        weights = pyramid_weights(h, w, cfg, img.device)
    caps = cfg.capacities
    sf, _, _, _ = scale_factors(cfg.n_levels, cfg.scale)
    outs = []
    level_img = img
    for lvl in range(cfg.n_levels):
        if lvl > 0:
            level_img = resize_level(level_img, *weights[lvl - 1])
        cap = max(caps[lvl], 1)
        xy, score, valid = detect_level(level_img, cfg, cap)
        ang = ic_angles(level_img, xy)
        desc = brief_descriptors(gaussian_blur7(level_img), xy, ang)
        outs.append(OrbFeatures(
            xy=xy.to(torch.float32) * float(sf[lvl]),
            response=score,
            angle=ang,
            octave=torch.full((cap,), lvl, dtype=torch.int32, device=img.device),
            desc=desc,
            valid=valid,
        ))
    return OrbFeatures(*(torch.cat(parts) for parts in zip(*outs)))


def make_extractor(h: int, w: int, cfg: OrbConfig, K=None, D=None, device=None):
    """Extractor for a fixed image size on ``device`` (``None``: the CUDA
    card); the pyramid weights are built once. With pinhole ``K`` and a
    non-zero radtan ``D`` the returned ``xy`` is already undistorted."""
    from .. import resolve_device
    from . import camera as cam_ops
    device = resolve_device(device)
    undist = (K is not None and D is not None
              and bool(np.any(np.abs(np.asarray(D)) > 1e-12)))
    Kc = None if K is None else torch.as_tensor(np.asarray(K, np.float32)[:4], device=device)
    Dc = None if D is None else torch.as_tensor(np.asarray(D, np.float32), device=device)
    weights = pyramid_weights(h, w, cfg, device)

    def fn(img: torch.Tensor) -> OrbFeatures:
        feats = extract_orb(img, cfg, weights)
        if undist:
            feats = feats._replace(xy=cam_ops.pinhole_undistort_pixels(Kc, Dc, feats.xy))
        return feats
    return fn


def f32_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 → int32 with the same bits."""
    return x.to(torch.float32).contiguous().view(torch.int32)


def pack_features_for_host(feats: OrbFeatures) -> torch.Tensor:
    """Pack one frame's features into ONE int32 buffer (one device→host copy).

    Layout per row (14 words): xy (2, f32 bits), angle (1, f32 bits),
    response (1, f32 bits), octave (1), valid (1), desc (8)."""
    return torch.cat([
        f32_bits(feats.xy),
        f32_bits(feats.angle)[:, None],
        f32_bits(feats.response)[:, None],
        feats.octave.to(torch.int32)[:, None],
        feats.valid.to(torch.int32)[:, None],
        feats.desc,
    ], dim=1)


def unpack_features_host(buf: np.ndarray):
    """Host-side inverse of :func:`pack_features_for_host`. Returns
    (xy, angle, response, octave, desc, valid); desc as uint32 words, the
    host map's type."""
    buf = np.ascontiguousarray(np.asarray(buf).view(np.int32))
    xy = buf[:, 0:2].copy().view(np.float32)
    angle = buf[:, 2].copy().view(np.float32)
    response = buf[:, 3].copy().view(np.float32)
    octave = buf[:, 4].astype(np.int32)
    valid = buf[:, 5].astype(bool)
    desc = np.ascontiguousarray(buf[:, 6:14]).view(np.uint32)
    return xy, angle, response, octave, desc, valid
