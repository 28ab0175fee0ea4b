"""Multi-stream tracking frontend over a device mesh.

Port of ``orbslam3_tpu/parallel/frontend_batch.py``: many SLAM sessions
(robots, AR clients, dataset shards), each frame-serial, batched so that
every device runs the same fixed-shape frontend on its block of streams.
One step is ORB extraction → projection matching against the stream's map →
pose-only LM, the per-frame hot path of tracking, for every stream. There is
no exchange between devices: the host routes each block's inputs to its
device and gathers the results on ``mesh[0]``.

On each device the extraction and the frustum gate run per stream, the
projection match is ONE ``match_rows`` launch over that device's streams
(the kernel's leading batch dimension), and the pose LM is one solve batched
over the streams (``torch.func.vmap``). Each stream's result is what the
single-stream frame step (``entry.make_frame_step``) gives for it.
"""
from __future__ import annotations

import contextlib

import torch

from ..models import kernels
from ..ops import features, matching, pose_opt
from ..ops.match_rows import match_rows


def _on(dev):
    """Make ``dev`` the current CUDA device (the kernel launches on its
    streams); nothing for the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _blocks(mesh, n_streams: int) -> dict:
    """Stream indices per distinct device: the stream axis cut into
    len(mesh) contiguous blocks, block s on mesh[s] (the JAX package's
    ``P(axis)``)."""
    if n_streams % len(mesh):
        raise ValueError(f"{n_streams} streams do not split into {len(mesh)} shards")
    per = n_streams // len(mesh)
    out = {}
    for s, d in enumerate(mesh):
        out.setdefault(d, []).extend(range(s * per, (s + 1) * per))
    return out


def make_batched_frontend(mesh, h: int, w: int, orb_cfg: features.OrbConfig | None = None,
                          n_mp: int = 4096):
    """Build a multi-stream frontend step.

    Returns ``step(imgs, R0, t0, mp_xyz, mp_desc, mp_normal, mp_mind,
    mp_maxd, mp_valid, K) -> (R (S,3,3), t (S,3), n_inliers (S,))``: every
    argument has a leading stream axis S (a multiple of len(mesh)), per
    stream the single-stream shapes (imgs (S,h,w), mp_* (S,n_mp,…), mp_desc
    int32 words); K is (S,4) per-stream intrinsics. The results are on
    mesh[0]."""
    cfg = orb_cfg or features.OrbConfig(n_features=1024)
    cap = cfg.total_capacity
    consts = {}
    for d in dict.fromkeys(mesh):
        sf, log_scale = kernels._levels(cfg.scale, cfg.n_levels, d)
        consts[d] = dict(weights=features.pyramid_weights(h, w, cfg, d), sf=sf,
                         log_scale=log_scale,
                         wh=torch.tensor([float(w), float(h)], dtype=torch.float32, device=d))

    def pose(R0, t0, pts, xy, inv_s2, valid, K):
        res = pose_opt.pose_optimize(R0, t0, pts, xy, inv_s2, valid, K)
        return res.R, res.t, res.n_inliers

    solve = torch.func.vmap(pose)

    def device_step(d, imgs, R0, t0, mp_xyz, mp_desc, mp_normal, mp_mind, mp_maxd,
                    mp_valid, K):
        c = consts[d]
        T = imgs.shape[0]
        feats = [features.extract_orb(imgs[i], cfg, c["weights"]) for i in range(T)]
        uv, lvl, frustum = (torch.stack(x) for x in zip(*[
            kernels._frustum(mp_xyz[i], mp_normal[i], mp_mind[i], mp_maxd[i], mp_valid[i],
                             R0[i], t0[i], 0, K[i], c["wh"], 0.5, c["log_scale"],
                             cfg.n_levels) for i in range(T)]))
        xy, desc, octave, fvalid = (torch.stack(x) for x in zip(
            *[(f.xy, f.desc, f.octave, f.valid) for f in feats]))
        # one launch over this device's streams
        idx, best, second = match_rows(mp_desc, uv, 8.0 * c["sf"][lvl.long()], lvl, frustum,
                                       desc, xy, octave, fvalid, octave_lo=1, octave_hi=1)
        ok = kernels._ratio_ok(best, second, 0.9, 100)
        ok = matching.resolve_duplicates(idx, best, ok, cap)
        # the matched map point of each feature (ok rows have distinct idx);
        # unmatched rows go to a dump row per stream
        base = (torch.arange(T, device=d) * (cap + 1))[:, None]
        slot = (torch.where(ok, idx.long(), cap) + base).reshape(-1)
        pts = torch.zeros((T * (cap + 1), 3), dtype=torch.float32, device=d).index_copy(
            0, slot, mp_xyz.reshape(-1, 3)).reshape(T, cap + 1, 3)[:, :cap]
        valid = torch.zeros(T * (cap + 1), dtype=torch.bool, device=d).index_copy(
            0, slot, ok.reshape(-1)).reshape(T, cap + 1)[:, :cap]
        inv_s2 = 1.0 / (cfg.scale ** (2.0 * octave.to(torch.float32)))
        return solve(R0, t0, pts, xy, inv_s2, valid, K)

    def step(imgs, R0, t0, mp_xyz, mp_desc, mp_normal, mp_mind, mp_maxd, mp_valid, K):
        args = (imgs, R0, t0, mp_xyz, mp_desc, mp_normal, mp_mind, mp_maxd, mp_valid, K)
        S = imgs.shape[0]
        if mp_xyz.shape[1] != n_mp:
            raise ValueError(f"mp_xyz has {mp_xyz.shape[1]} map points per stream, not {n_mp}")
        outs = {}
        for d, streams in _blocks(mesh, S).items():
            sel = torch.tensor(streams, device=imgs.device)
            with _on(d):
                outs[d] = (streams, device_step(d, *(a.index_select(0, sel).to(d)
                                                     for a in args)))
        root = mesh[0]
        R = torch.empty((S, 3, 3), dtype=torch.float32, device=root)
        t = torch.empty((S, 3), dtype=torch.float32, device=root)
        n_inl = torch.empty(S, dtype=torch.int32, device=root)
        for streams, (Rd, td, nd) in outs.values():
            at = torch.tensor(streams, device=root)
            R[at], t[at], n_inl[at] = Rd.to(root), td.to(root), nd.to(root)
        return R, t, n_inl

    return step
