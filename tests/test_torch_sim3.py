"""Sim(3) estimation and the pose graph: the port (orbslam3_tpu_torch/ops/
{sim3,posegraph}.py) against the JAX package on tests/test_loop_ops.py's
cases, both on the CPU, on the same numpy inputs.

Each case holds both packages to the case's own accuracy bounds and the port
to the JAX result: RANSAC inlier masks and counts equal bit for bit (the
same host-drawn samples score the same hypotheses); s within 1e-4, R within
1e-4 and t within 1e-3 of JAX for the closed forms; after the iterative
solvers (10 LM or 15 GN steps in float32) s within 1e-3, R within 1e-3 and t
within 5e-3 of JAX, and the pose graph's final cost within 1e-5 absolute.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import lie as jlie, posegraph as jpg, sim3 as jsim3
from orbslam3_tpu_torch.ops import posegraph as tpg, sim3 as tsim3
from torch_port_helpers import N, T, torch_threads  # noqa: F401

K4 = np.array([458.0, 458.0, 376.0, 240.0], np.float32)


def _rot(w):
    return np.asarray(jlie.so3_exp(jnp.asarray(w, jnp.float32)))


def test_horn_sim3_exact_and_batched():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 3)).astype(np.float32)
    R = _rot([0.2, -0.3, 0.5])
    s_gt, t_gt = 1.4, np.array([0.3, -1.0, 2.0], np.float32)
    y = (s_gt * x @ R.T + t_gt).astype(np.float32)
    s, Re, te = map(N, tsim3.horn_sim3(T(x), T(y)))
    assert abs(float(s) - s_gt) < 1e-4
    assert np.abs(Re - R).max() < 1e-4 and np.abs(te - t_gt).max() < 1e-3
    # batched 3-point samples of distinct points, and fix_scale (a sample that
    # repeats a point has a rank-1 cross-covariance: its rotation is not
    # defined, and each package's SVD picks its own)
    idx = np.stack([rng.choice(50, 3, replace=False) for _ in range(64)])
    for fix in (False, True):
        out_j = [np.asarray(a) for a in jsim3.horn_sim3(jnp.asarray(x[idx]),
                                                        jnp.asarray(y[idx]), fix_scale=fix)]
        out_t = [N(a) for a in tsim3.horn_sim3(T(x[idx]), T(y[idx]), fix_scale=fix)]
        for a, b in zip(out_t, out_j):
            np.testing.assert_allclose(a, b, atol=1e-3)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_with_outliers(fix_scale):
    rng = np.random.default_rng(1)
    n = 80
    x = (rng.normal(size=(n, 3)) * [2, 2, 1] + [0, 0, 6]).astype(np.float32)
    R = _rot([0.05, 0.8, -0.1])
    s_gt, t_gt = (1.0 if fix_scale else 1.2), np.array([1.0, 0.2, -0.5], np.float32)
    y = (s_gt * x @ R.T + t_gt).astype(np.float32)
    out = rng.choice(n, 20, replace=False)
    y[out] += rng.normal(0, 3.0, (20, 3)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-4:] = False
    rand = rng.integers(0, n - 4, (100, 3)).astype(np.int32)
    th = np.full(n, 9.21 * 4.0, np.float32)
    rj = jsim3.sim3_ransac(jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid),
                           jnp.asarray(rand), jnp.asarray(th), jnp.asarray(th),
                           jnp.asarray(K4), fix_scale=fix_scale)
    rt = tsim3.sim3_ransac(T(x), T(y), T(valid), T(rand), T(th), T(th), T(K4),
                           fix_scale=fix_scale)
    assert bool(rt.success) == bool(rj.success) is True
    np.testing.assert_array_equal(N(rt.inliers), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) >= 50
    assert abs(float(rt.s) - float(rj.s)) < 1e-4
    assert abs(float(rt.s) - s_gt) < 0.02
    np.testing.assert_allclose(N(rt.R), np.asarray(rj.R), atol=1e-4)
    np.testing.assert_allclose(N(rt.t), np.asarray(rj.t), atol=1e-3)
    assert np.abs(N(rt.R) - R).max() < 0.02


def _sim3_pairs():
    rng = np.random.default_rng(0)
    n = 120
    x1 = rng.uniform([-3, -2, 4], [3, 2, 10], (n, 3)).astype(np.float32)
    Rt = _rot([0.01, 0.03, -0.02])
    st, tt = 1.05, np.array([0.2, -0.1, 0.15], np.float32)
    x2 = (st * (x1 @ Rt.T) + tt).astype(np.float32)

    def proj(p):
        return np.stack([458 * p[:, 0] / p[:, 2] + 376,
                         458 * p[:, 1] / p[:, 2] + 240], -1).astype(np.float32)

    uv1 = (proj(x1) + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    uv2 = (proj(x2) + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    uv1[:6] += 40.0                                      # gross outliers
    return x1, x2, uv1, uv2, Rt, st


@pytest.mark.parametrize("fix_scale,half_obs", [(False, False), (True, False), (False, True)])
def test_optimize_sim3_converges(fix_scale, half_obs):
    x1, x2, uv1, uv2, Rt, st = _sim3_pairs()
    n = len(x1)
    ones = np.ones(n, np.float32)
    valid = np.ones(n, bool)
    valid21 = (np.arange(n) % 2 == 0) if half_obs else None
    kw = dict(fix_scale=fix_scale)
    rj = jsim3.optimize_sim3(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(uv1), jnp.asarray(uv2),
        jnp.asarray(ones), jnp.asarray(ones), jnp.asarray(valid), jnp.asarray(1.0, jnp.float32),
        jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32), jnp.asarray(K4),
        valid21=None if valid21 is None else jnp.asarray(valid21), **kw)
    rt = tsim3.optimize_sim3(
        T(x1), T(x2), T(uv1), T(uv2), T(ones), T(ones), T(valid), 1.0,
        torch.eye(3), torch.zeros(3), T(K4),
        valid21=None if valid21 is None else T(valid21), **kw)
    if fix_scale:
        assert abs(float(rt.s) - 1.0) < 1e-5
    else:
        assert abs(float(rt.s) - st) < 0.005
        assert np.abs(N(rt.R) - Rt).max() < 2e-3
    assert abs(float(rt.s) - float(rj.s)) < 1e-3
    np.testing.assert_allclose(N(rt.R), np.asarray(rj.R), atol=1e-3)
    np.testing.assert_allclose(N(rt.t), np.asarray(rj.t), atol=5e-3)
    np.testing.assert_array_equal(N(rt.inliers), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) >= (n - 8 if not fix_scale else 10)


def _ring_graph(K, rng, radius, rot_noise, t_noise, s_noise, yaw_only=False):
    angles = np.linspace(0, 2 * np.pi * (K - 1) / K, K)
    gt_t = (np.stack([np.cos(angles), np.sin(angles), np.zeros(K)], -1) * radius
            ).astype(np.float32)
    gt_R = np.stack([_rot([0, 0, a]) for a in angles])
    gt_s = np.ones(K, np.float32)

    def rel(i, j):
        sji, Rji, tji = jlie.sim3_inverse(jnp.asarray(gt_s[j]), jnp.asarray(gt_R[j]),
                                          jnp.asarray(gt_t[j]))
        return jlie.sim3_compose(jnp.asarray(gt_s[i]), jnp.asarray(gt_R[i]),
                                 jnp.asarray(gt_t[i]), sji, Rji, tji)

    ei, ej, ms, mR, mt = [], [], [], [], []
    for a, b in [(i + 1, i) for i in range(K - 1)] + [(0, K - 1)]:
        s_, R_, t_ = rel(a, b)
        ei.append(a); ej.append(b)
        ms.append(float(s_)); mR.append(np.asarray(R_)); mt.append(np.asarray(t_))
    est_R, est_t, est_s = [gt_R[0]], [gt_t[0]], [1.0]
    for i in range(1, K):
        if yaw_only:
            est_R.append(gt_R[i] @ _rot([0.0, 0.0, rng.normal(0, rot_noise)]))
        else:
            est_R.append(_rot(rng.normal(0, rot_noise, 3)) @ gt_R[i])
        est_t.append(gt_t[i] + rng.normal(0, t_noise, 3).astype(np.float32))
        est_s.append(float(np.exp(rng.normal(0, s_noise))) if s_noise else 1.0)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    args = [np.asarray(est_s, np.float32), np.stack(est_R).astype(np.float32),
            np.stack(est_t).astype(np.float32), np.ones(K, bool), fixed,
            np.asarray(ei, np.int32), np.asarray(ej, np.int32), np.asarray(ms, np.float32),
            np.stack(mR).astype(np.float32), np.stack(mt).astype(np.float32),
            np.ones(K, bool), np.ones(K, np.float32)]
    return args, gt_t


def _both_graphs(args, dof=None):
    out_j = jpg.optimize_pose_graph(*[jnp.asarray(a) for a in args], iters=15,
                                    dof_mask=None if dof is None else jnp.asarray(dof))
    out_t = tpg.optimize_pose_graph(*[T(a) for a in args], iters=15,
                                    dof_mask=None if dof is None else T(dof))
    return [np.asarray(a) for a in out_j], [N(a) for a in out_t]


def test_pose_graph_closes_loop():
    args, gt_t = _ring_graph(12, np.random.default_rng(2), 3.0, 0.03, 0.2, 0.03)
    (sj, Rj, tj, cj), (s, R, t, costs) = _both_graphs(args)
    assert float(costs[-1]) < 1e-5 and np.abs(t - gt_t).max() < 0.02
    assert np.abs(s - 1.0).max() < 0.01
    np.testing.assert_allclose(s, sj, atol=1e-3)
    np.testing.assert_allclose(R, Rj, atol=1e-3)
    np.testing.assert_allclose(t, tj, atol=5e-3)
    np.testing.assert_allclose(costs, cj, rtol=1e-2, atol=1e-5)


def test_pose_graph_4dof_preserves_gravity_and_scale():
    args, gt_t = _ring_graph(10, np.random.default_rng(5), 2.0, 0.05, 0.15, 0.0,
                             yaw_only=True)
    dof = np.array([0, 0, 1, 1, 1, 1, 0], bool)
    (sj, Rj, tj, cj), (s, R, t, costs) = _both_graphs(args, dof)
    est_R = args[1]
    assert np.abs(s - 1.0).max() < 1e-6
    ez = np.array([0, 0, 1.0], np.float32)
    assert np.abs(R @ ez - est_R @ ez).max() < 1e-5
    assert float(costs[-1]) < 1e-4 and np.abs(t - gt_t).max() < 0.05
    np.testing.assert_allclose(R, Rj, atol=1e-3)
    np.testing.assert_allclose(t, tj, atol=5e-3)
