"""The per-frame hot path as one callable: ORB extraction → projection
matching against a map (``match_rows`` on the card) → pose-only
Levenberg-Marquardt. The torch twin of the frame step of the repository's
``__graft_entry__.entry``; its multi-chip dry run is TPU mesh code and has
no twin.

    from orbslam3_tpu_torch.entry import entry
    step, args = entry()            # tensors on the card (device="cpu" to debug)
    R, t, n_inliers = step(*args)
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def entry(device=None):
    """Returns ``(step, args)``: ``step(img, R0, t0, mp_xyz, mp_desc,
    mp_normal, mp_mind, mp_maxd, mp_valid) -> (R, t, n_inliers)`` and a
    752x480 random image with 1024 random map points on ``device`` (None:
    the card)."""
    from .models import kernels
    from .ops import features, pose_opt
    dev = resolve_device(device)
    h, w = 480, 752
    cfg = features.OrbConfig(n_features=512)
    cap = cfg.total_capacity
    K = torch.tensor([458.654, 457.296, 376.0, 240.0], dtype=torch.float32, device=dev)
    wh = torch.tensor([float(w), float(h)], dtype=torch.float32, device=dev)
    n_mp = 1024
    weights = features.pyramid_weights(h, w, cfg, dev)
    proj_match = kernels.projection_matcher(0, cfg.n_levels, cfg.scale, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    def step(img, R0, t0, mp_xyz, mp_desc, mp_normal, mp_mind, mp_maxd, mp_valid):
        feats = features.extract_orb(img, cfg, weights)
        idx, ok, _, _, _ = proj_match(
            mp_xyz, mp_desc, mp_normal, mp_mind, mp_maxd, mp_valid, R0, t0, K,
            feats.xy, feats.desc, feats.octave, feats.valid, wh,
            torch.tensor(8.0, **f32), torch.tensor(0.9, **f32),
            torch.tensor(100, dtype=torch.int32, device=dev), torch.tensor(0.5, **f32))
        # the matched map point of each feature (ok rows have distinct idx)
        fi = torch.where(ok, idx.long(), cap)
        pts = torch.zeros((cap + 1, 3), **f32).index_copy(0, fi, mp_xyz)[:cap]
        valid = torch.zeros(cap + 1, dtype=torch.bool, device=dev).index_copy(0, fi, ok)[:cap]
        inv_s2 = 1.0 / (1.2 ** (2.0 * feats.octave.to(torch.float32)))
        res = pose_opt.pose_optimize(R0, t0, pts, feats.xy, inv_s2, valid, K)
        return res.R, res.t, res.n_inliers

    rng = np.random.default_rng(0)
    args = (torch.as_tensor(rng.uniform(0, 255, (h, w)).astype(np.float32), device=dev),
            torch.eye(3, **f32), torch.zeros(3, **f32),
            torch.as_tensor(rng.uniform([-4, -3, 5], [4, 3, 15], (n_mp, 3)).astype(np.float32),
                            device=dev),
            torch.as_tensor(rng.integers(0, 2 ** 32, (n_mp, 8), dtype=np.uint32).view(np.int32),
                            device=dev),
            torch.as_tensor(np.tile([0, 0, -1.0], (n_mp, 1)).astype(np.float32), device=dev),
            torch.full((n_mp,), 0.5, **f32), torch.full((n_mp,), 50.0, **f32),
            torch.ones(n_mp, dtype=torch.bool, device=dev))
    return step, args
