"""Trajectory evaluation: Horn alignment + RMS ATE.

Port of the reference's evaluation methodology (reference
evaluation/evaluate_ate_scale.py:49-60 ``align``: Horn closed-form SO(3)
alignment with optional similarity scale, then RMSE over matched timestamps;
``associate.py`` timestamp pairing).
"""
from __future__ import annotations

import numpy as np


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Greedy nearest-timestamp association (reference evaluation/associate.py)."""
    ia, ib = [], []
    j = 0
    for i, ta in enumerate(ts_a):
        j = int(np.searchsorted(ts_b, ta))
        best, bestd = -1, max_dt
        for jj in (j - 1, j):
            if 0 <= jj < len(ts_b):
                d = abs(ts_b[jj] - ta)
                if d < bestd:
                    best, bestd = jj, d
        if best >= 0:
            ia.append(i)
            ib.append(best)
    return np.asarray(ia, int), np.asarray(ib, int)


def horn_align(model: np.ndarray, data: np.ndarray, with_scale: bool = False):
    """Align model (N,3) to data (N,3): returns (R, t, s) minimizing
    |s R model + t - data| (Horn 1987; reference evaluate_ate_scale.py:49-60
    adds the scale term for monocular)."""
    mu_m = model.mean(0)
    mu_d = data.mean(0)
    mc = model - mu_m
    dc = data - mu_d
    W = dc.T @ mc
    U, S, Vt = np.linalg.svd(W)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    if with_scale:
        s = float((S * np.diag(D)).sum() / max((mc ** 2).sum(), 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_m
    return R, t, s


def ate_rmse(gt_t: np.ndarray, est_t: np.ndarray, with_scale: bool = False) -> float:
    """RMS absolute trajectory error after alignment (positions only, paired)."""
    R, t, s = horn_align(est_t, gt_t, with_scale=with_scale)
    aligned = (s * (R @ est_t.T)).T + t
    err = np.linalg.norm(aligned - gt_t, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def evaluate_trajectory(gt_ts, gt_t, est_ts, est_t, with_scale=True, max_dt=0.02):
    """Associate by timestamp then compute ATE (the full reference pipeline)."""
    ia, ib = associate(gt_ts, est_ts, max_dt)
    if len(ia) < 3:
        return float("inf"), 0
    return ate_rmse(gt_t[ia], est_t[ib], with_scale=with_scale), len(ia)
