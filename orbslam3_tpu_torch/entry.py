"""The per-frame hot path as one callable, and the multi-device dry run.

``entry``: ORB extraction → projection matching against a map
(``match_rows`` on the card) → pose-only Levenberg-Marquardt; the torch twin
of the frame step of the repository's ``__graft_entry__.entry``.
``dryrun_multichip``: the twin of ``__graft_entry__.dryrun_multichip``, the
landmark-sharded bundle adjustment and the multi-stream frontend over an
n-device mesh.

    from orbslam3_tpu_torch.entry import entry, dryrun_multichip
    step, args = entry()            # tensors on the card (device="cpu" to debug)
    R, t, n_inliers = step(*args)
    dryrun_multichip(4)             # 4 cards, or 4 logical shards of one
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def make_frame_step(h: int, w: int, cfg, device=None):
    """The single-stream frame step for (h, w) images and ORB config ``cfg``
    on ``device`` (None: the card): ``step(img, R0, t0, mp_xyz, mp_desc,
    mp_normal, mp_mind, mp_maxd, mp_valid, K) -> (R, t, n_inliers)``."""
    from .models import kernels
    from .ops import features, pose_opt
    dev = resolve_device(device)
    cap = cfg.total_capacity
    wh = torch.tensor([float(w), float(h)], dtype=torch.float32, device=dev)
    weights = features.pyramid_weights(h, w, cfg, dev)
    proj_match = kernels.projection_matcher(0, cfg.n_levels, cfg.scale, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    def step(img, R0, t0, mp_xyz, mp_desc, mp_normal, mp_mind, mp_maxd, mp_valid, K):
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
        inv_s2 = 1.0 / (cfg.scale ** (2.0 * feats.octave.to(torch.float32)))
        res = pose_opt.pose_optimize(R0, t0, pts, feats.xy, inv_s2, valid, K)
        return res.R, res.t, res.n_inliers

    return step


def entry(device=None):
    """Returns ``(step, args)``: ``step(img, R0, t0, mp_xyz, mp_desc,
    mp_normal, mp_mind, mp_maxd, mp_valid) -> (R, t, n_inliers)`` and a
    752x480 random image with 1024 random map points on ``device`` (None:
    the card)."""
    from .ops import features
    dev = resolve_device(device)
    h, w = 480, 752
    n_mp = 1024
    K = torch.tensor([458.654, 457.296, 376.0, 240.0], dtype=torch.float32, device=dev)
    frame_step = make_frame_step(h, w, features.OrbConfig(n_features=512), dev)
    f32 = dict(dtype=torch.float32, device=dev)

    def step(img, R0, t0, mp_xyz, mp_desc, mp_normal, mp_mind, mp_maxd, mp_valid):
        return frame_step(img, R0, t0, mp_xyz, mp_desc, mp_normal, mp_mind, mp_maxd,
                          mp_valid, K)

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


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One full landmark-sharded LM solve (3 + 3 iterations with the chi2
    gate between them, the mesh-wide Schur reduction every iteration) and
    one multi-stream frontend step (one stream per shard) on an
    ``n_devices`` mesh, on the JAX package's seeded problem and with its
    asserts. ``device`` names the device type (None: the card). On CUDA with
    fewer cards than ``n_devices`` the mesh is ``n_devices`` logical shards
    of the first card; on the CPU always logical shards. Returns what ran
    where: ``{"mesh": [device names], "logical": bool, "inliers": int,
    "streams": int}``."""
    from .ops import features, lie
    from .parallel import sharded_ba
    from .parallel.frontend_batch import make_batched_frontend

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        mesh = sharded_ba.make_mesh(n_devices, device=dev)
    else:
        mesh = [torch.device(dev.type, 0) if dev.type == "cuda" else dev] * n_devices
    root = mesh[0]
    rng = np.random.default_rng(0)
    n_kf = 4
    n_pts = 16 * n_devices
    pts = rng.uniform([-4, -3, 5], [4, 3, 15], (n_pts, 3)).astype(np.float32)
    Rs, ts, obs_kf, obs_mp, obs_uv = [], [], [], [], []
    for k in range(n_kf):
        R = lie.so3_exp(torch.as_tensor(rng.normal(0, 0.02, 3).astype(np.float32))).numpy()
        t = np.asarray([0.4 * k, 0.0, 0.0], np.float32)
        Rs.append(R)
        ts.append(t)
        pc = pts @ R.T + t
        uv = np.stack([458 * pc[:, 0] / pc[:, 2] + 376,
                       458 * pc[:, 1] / pc[:, 2] + 240], -1).astype(np.float32)
        for j in range(n_pts):
            obs_kf.append(k)
            obs_mp.append(j)
            obs_uv.append(uv[j])
    obs_kf = np.asarray(obs_kf, np.int32)
    obs_mp = np.asarray(obs_mp, np.int32)
    obs_uv = np.stack(obs_uv).astype(np.float32)

    n_pts_pad, _, local_mp, obs_valid, outs = sharded_ba.partition_by_landmark(
        obs_mp, n_pts, n_devices, {"kf": obs_kf, "uv": obs_uv})
    pts_pad = np.zeros((n_pts_pad, 3), np.float32)
    pts_pad[:n_pts] = pts + rng.normal(0, 0.05, pts.shape)
    fixed = np.zeros(n_kf, bool)
    fixed[:2] = True
    on = lambda a: torch.as_tensor(np.asarray(a), device=root)  # noqa: E731
    solver = sharded_ba.make_sharded_ba_solver(mesh, n_kf, iters1=3, iters2=3)
    R, t, p, inl = solver(on(np.stack(Rs)), on(np.stack(ts)), on(fixed), on(pts_pad),
                          on(outs["kf"]), on(local_mp), on(outs["uv"]),
                          on(obs_valid.astype(np.float32)),
                          on(np.asarray([458.0, 458.0, 376.0, 240.0], np.float32)))
    if not (torch.isfinite(R).all() and torch.isfinite(p).all()):
        raise AssertionError("dryrun_multichip: non-finite sharded BA result")
    n_inl = int(inl.sum())
    if n_inl <= 0:
        raise AssertionError("dryrun_multichip: the sharded BA kept no inlier")

    # the multi-stream tracking frontend, one stream per shard
    S = n_devices
    h, w = 64, 96
    cfg = features.OrbConfig(n_features=64, n_levels=2)
    n_mp_f = 64
    fstep = make_batched_frontend(mesh, h, w, cfg, n_mp_f)
    imgs = rng.uniform(0, 255, (S, h, w)).astype(np.float32)
    Kb = np.tile(np.asarray([80.0, 80.0, 48.0, 32.0], np.float32), (S, 1))
    Rb = np.tile(np.eye(3, dtype=np.float32), (S, 1, 1))
    tb = np.zeros((S, 3), np.float32)
    xyzb = rng.uniform([-2, -2, 3], [2, 2, 8], (S, n_mp_f, 3)).astype(np.float32)
    descb = rng.integers(0, 2 ** 32, (S, n_mp_f, 8), dtype=np.uint32).view(np.int32)
    normb = np.tile(np.asarray([0, 0, -1.0], np.float32), (S, n_mp_f, 1))
    Rf, _, _ = fstep(on(imgs), on(Rb), on(tb), on(xyzb), on(descb), on(normb),
                     torch.full((S, n_mp_f), 0.1, device=root),
                     torch.full((S, n_mp_f), 50.0, device=root),
                     torch.ones((S, n_mp_f), dtype=torch.bool, device=root), on(Kb))
    if not torch.isfinite(Rf).all():
        raise AssertionError("dryrun_multichip: non-finite frontend pose")
    return {"mesh": [str(d) for d in mesh], "logical": len(set(mesh)) < len(mesh),
            "inliers": n_inl, "streams": S}
