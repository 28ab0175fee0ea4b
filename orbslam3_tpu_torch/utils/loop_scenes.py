"""Synthetic loop scenes with known ground truth, built in numpy: maps whose
drift a loop closer must correct (used by the CPU parity tests and by
chip_smoke.py's full-width loop check)."""
from __future__ import annotations

import numpy as np

DRIFTED_K = (458.0, 458.0, 376.0, 240.0)   # the drifted map's pinhole camera
DRIFTED_WH = (752, 480)


def _rot_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def build_drifted_map(map_module=None, max_keyframes: int = 64, n_features: int = 512):
    """A loop that only place recognition can close, in numpy alone:
    20 keyframes around a circle looking outward at a cylinder of 900 points,
    the pose drift growing linearly along the loop (a rotation about y and a
    translation), the last 4 keyframes back at the loop start where the
    revisited points are mapped a second time, drift-displaced, with the
    same descriptors. ``map_module`` is a package's ``models.map`` (default:
    the port's); ``max_keyframes`` is the keyframe pool's capacity and
    ``n_features`` its features per keyframe (at most 500 are used). Returns
    (map, gt_R, gt_t, n_kf)."""
    if map_module is None:
        from ..models import map as map_module
    K = DRIFTED_K

    def project(R, t, pts):
        pc = pts @ R.T + t
        z = pc[:, 2]
        u = K[0] * pc[:, 0] / np.maximum(z, 1e-6) + K[2]
        v = K[1] * pc[:, 1] / np.maximum(z, 1e-6) + K[3]
        w, h = DRIFTED_WH
        ok = (z > 0.5) & (u > 10) & (u < w - 10) & (v > 10) & (v < h - 10)
        return np.stack([u, v], -1), ok

    rng = np.random.default_rng(0)
    n_world = 900
    ang = rng.uniform(0, 2 * np.pi, n_world)
    wp = np.stack([8 * np.cos(ang), rng.uniform(-2, 2, n_world), 8 * np.sin(ang)], -1)
    wdesc = rng.integers(0, 2 ** 32, (n_world, 8), dtype=np.uint32)
    n_kf = 20
    cfg = map_module.MapConfig(max_keyframes=max_keyframes, max_map_points=8192,
                               n_features=n_features)
    m = map_module.MapState(cfg)
    gt_R, gt_t, drift_R, drift_t = [], [], [], []
    for k in range(n_kf):
        a = 2 * np.pi * min(k, n_kf - 4) / (n_kf - 4)
        c = np.array([2 * np.cos(a), 0.0, 2 * np.sin(a)])
        R = _rot_y(-a).T
        t = -R @ c
        gt_R.append(R.astype(np.float32)); gt_t.append(t.astype(np.float32))
        frac = k / (n_kf - 1)
        Rd = _rot_y(0.06 * frac).astype(np.float32) @ R
        td = t + np.array([0.4 * frac, 0.0, 0.25 * frac], np.float32)
        drift_R.append(Rd.astype(np.float32)); drift_t.append(td.astype(np.float32))
    world_mp = np.full(n_world, -1, np.int32)
    for k in range(n_kf):
        uv, ok = project(gt_R[k], gt_t[k], wp)
        sel = np.nonzero(ok)[0][:500]
        n = len(sel)
        new = sel[world_mp[sel] < 0] if k < n_kf - 4 else sel
        xc = wp[new] @ gt_R[k].T + gt_t[k]
        x_est = (xc - drift_t[k]) @ drift_R[k]
        c_k = -drift_R[k].T @ drift_t[k]
        dist = np.linalg.norm(x_est - c_k, axis=1).astype(np.float32)
        ids = m.add_map_points(x_est.astype(np.float32), wdesc[new], k,
                               np.tile([0, 0, 1.0], (len(new), 1)).astype(np.float32),
                               dist / 3.6, dist, first_kf=k)
        feat_mp = np.full(cfg.n_features, -1, np.int32)
        if k < n_kf - 4:
            world_mp[new] = ids
            feat_mp[:n] = world_mp[sel]
        else:
            feat_mp[:n] = ids
        m.add_keyframe(drift_R[k], drift_t[k], float(k), k, uv[sel].astype(np.float32),
                       np.zeros(n, np.float32), np.zeros(n, np.int32), wdesc[sel],
                       np.ones(n, bool), feat_mp=feat_mp[:n])
    return m, gt_R, gt_t, n_kf
