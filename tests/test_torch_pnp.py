"""ops/pnp.py: the port's PnP RANSAC and MLPnP refinement against the JAX
package's on the same numpy-seeded problems, both on the CPU.

Tolerances. The 6-point DLT takes the smallest eigenvector of a 12x12 matrix
and an SVD of a 3x3 one; the two LAPACK builds return them with free sign and
to float32 rounding, so raw vectors are never compared. On a well-conditioned
problem (a compact scene, 0.05 px noise, 30% gross outliers) the winning
hypothesis' inlier mask must be identical and its pose agree to 1e-3 rad in
rotation and 5e-3 relative in translation: the translation is the last column
of the smallest eigenvector of a float32 normal matrix, which the two
eigensolvers resolve to a few 1e-3 (measured 0.7-3.5e-3 over six seeds).
After ``mlpnp_refine`` on the RANSAC inliers both land on the same optimum:
1e-3 rad and 1e-3 relative.
"""
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import lie as jlie, pnp as jpnp
from orbslam3_tpu_torch.ops import pnp as tpnp
from torch_port_helpers import J, N, T, torch_threads  # noqa: F401


def _rot_err(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def _problem(seed, n=120, outlier_frac=0.3, noise_px=0.05):
    rng = np.random.default_rng(seed)
    xw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                   rng.uniform(3, 8, n)], -1).astype(np.float32)
    R = np.asarray(jlie.so3_exp(J(np.array([0.3, -0.5, 0.2], np.float32))))
    t = np.array([0.5, -0.3, 1.0], np.float32)
    xc = xw @ R.T + t
    rays = (xc / xc[:, 2:3]).astype(np.float32)
    rays[:, :2] += rng.normal(0, noise_px / 458.0, (n, 2)).astype(np.float32)
    out = rng.choice(n, int(outlier_frac * n), replace=False)
    rays[out, :2] += rng.uniform(0.05, 0.2, (len(out), 2)).astype(np.float32)
    rand = rng.integers(0, n, (128, 6)).astype(np.int32)
    return xw, rays, rand, R, t, out


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_pnp_ransac_and_refine_match_reference(seed):
    xw, rays, rand, R, t, out = _problem(seed)
    n = len(xw)
    ones = np.ones(n, np.float32)
    want = jpnp.pnp_ransac(J(xw), J(rays), J(np.ones(n, bool)), J(rand), J(ones))
    got = tpnp.pnp_ransac(T(xw), T(rays), T(np.ones(n, bool)), T(rand), T(ones))
    assert bool(want.success) and bool(got.success)
    np.testing.assert_array_equal(N(got.inliers), N(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) == n - len(out)
    assert not N(got.inliers)[out].any()
    assert _rot_err(N(got.R), N(want.R)) < 1e-3
    assert np.linalg.norm(N(got.t) - N(want.t)) < 5e-3 * np.linalg.norm(N(want.t))
    # the chain relocalization runs: refine on the RANSAC inliers
    w = np.full(n, 458.0 ** 2, np.float32)
    Rj, tj = jpnp.mlpnp_refine(J(xw), J(rays), J(w), want.inliers, want.R, want.t)
    Rt, tt = tpnp.mlpnp_refine(T(xw), T(rays), T(w), got.inliers, got.R, got.t)
    assert _rot_err(N(Rt), N(Rj)) < 1e-3
    assert np.linalg.norm(N(tt) - N(tj)) < 1e-3 * np.linalg.norm(N(tj))
    assert _rot_err(N(Rt), R) < 2e-3 and np.abs(N(tt) - t).max() < 5e-3


def test_dlt_pnp_poses_match_reference():
    """Every hypothesis of the batch, not only the winner: exact six-point
    sets give the same pose in both packages whatever sign the null vector
    came with."""
    xw, rays, rand, R, t, _ = _problem(2, outlier_frac=0.0)
    xn = rays[:, :2] / rays[:, 2:3]
    Rj, tj = jpnp._dlt_pnp(J(xw[rand]), J(xn[rand]))
    Rt, tt = tpnp._dlt_pnp(T(xw[rand]), T(xn[rand]))
    Rj, tj, Rt, tt = N(Rj), N(tj), N(Rt), N(tt)
    # a near-degenerate six-point set amplifies float32 rounding without
    # bound, so single hypotheses are not held against each other: both
    # solvers must land near the truth on (nearly) the same sets, and agree
    # closely on the typical one
    near_j = np.array([_rot_err(Rj[b], R) < 0.01 for b in range(len(rand))])
    near_t = np.array([_rot_err(Rt[b], R) < 0.01 for b in range(len(rand))])
    assert near_j.sum() > 32 and (near_j == near_t).mean() > 0.9
    both = np.nonzero(near_j & near_t)[0]
    assert np.median([_rot_err(Rt[b], Rj[b]) for b in both]) < 2e-3
    assert np.median([np.linalg.norm(tt[b] - tj[b]) for b in both]) < 1e-2


def test_pnp_fails_on_garbage():
    rng = np.random.default_rng(1)
    n = 60
    xw = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    rays = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)), np.ones((n, 1))], -1).astype(np.float32)
    rand = rng.integers(0, n, (128, 6)).astype(np.int32)
    ones = np.ones(n, np.float32)
    want = jpnp.pnp_ransac(J(xw), J(rays), J(np.ones(n, bool)), J(rand), J(ones))
    got = tpnp.pnp_ransac(T(xw), T(rays), T(np.ones(n, bool)), T(rand), T(ones))
    assert not bool(want.success) and not bool(got.success)


@pytest.mark.parametrize("unit_rays", [False, True])
def test_mlpnp_refine_matches_reference(unit_rays):
    """From a coarse pose both refinements converge to the same pose (and
    the truth), with unit-z rays and with unit-norm bearings."""
    rng = np.random.default_rng(2)
    n = 80
    xw = rng.uniform([-4, -3, 4], [4, 3, 14], (n, 3)).astype(np.float32)
    R_gt = np.asarray(jlie.so3_exp(J(np.array([0.05, -0.1, 0.08], np.float32))))
    t_gt = np.asarray([0.3, -0.2, 0.5], np.float32)
    xc = xw @ R_gt.T + t_gt
    rays = xc / (np.linalg.norm(xc, axis=-1, keepdims=True) if unit_rays else xc[:, 2:3])
    rays = (rays + rng.normal(0, 0.5 / 458.0, rays.shape)).astype(np.float32)
    R0 = (np.asarray(jlie.so3_exp(J(np.array([0.02, 0.03, -0.02], np.float32)))) @ R_gt
          ).astype(np.float32)
    t0 = t_gt + np.asarray([0.1, -0.08, 0.12], np.float32)
    w = np.full(n, 458.0 ** 2, np.float32)
    valid = rng.random(n) < 0.9
    Rj, tj = jpnp.mlpnp_refine(J(xw), J(rays), J(w), J(valid), J(R0), J(t0))
    Rt, tt = tpnp.mlpnp_refine(T(xw), T(rays), T(w), T(valid), T(R0), T(t0))
    assert _rot_err(N(Rt), N(Rj)) < 1e-3
    assert np.linalg.norm(N(tt) - N(tj)) < 1e-3 * np.linalg.norm(N(tj))
    assert np.abs(N(Rt) - R_gt).max() < 0.2 * np.abs(R0 - R_gt).max()
    assert np.abs(N(tt) - t_gt).max() < 0.03
