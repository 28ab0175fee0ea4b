"""The public solvers that no path of the system calls, the port against the
JAX package on the CPU: ``ops/pnp.py::epnp`` and ``epnp_ransac`` on
tests/test_pnp.py's inputs, ``ops/vocab.py::l1_scores`` on
tests/test_loop_ops.py's, ``ops/matching.py::search_by_projection`` and
``epipolar_mask`` on seeded inputs of the tracker's shapes (1024 map points
against a 1024-feature frame), and ``ops/vi_ba.py::vi_window_optimize`` on
tests/test_vi_ba.py's.

Tolerances: EPnP poses within 1e-4 (rotation entries, translation; float32
eigen- and singular-value decompositions of another library), RANSAC inlier
sets equal; the L1 scores within 1e-6 relative; matching bit-equal (integer
Hamming distances), the epipolar mask equal on every pair whose squared
line distance is not within 1e-4 relative of its gate; the window smoother
within 1e-4 in poses and velocities and 1e-5 in the biases (8 keyframes,
10 damped Gauss-Newton steps on forward-mode Jacobians). The JAX package's
solvers run under ``jax.jit``, as its own callers compile them, and so do
the inputs' rotations and preintegrations.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_tpu.ops import imu as jimu
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu.ops import matching as jm
from orbslam3_tpu.ops import pnp as jpnp
from orbslam3_tpu.ops import vi_ba as jvi
from orbslam3_tpu.ops import vocab as jvocab
from orbslam3_tpu_torch.ops import matching as tm
from orbslam3_tpu_torch.ops import pnp as tpnp
from orbslam3_tpu_torch.ops import vi_ba as tvi
from orbslam3_tpu_torch.ops import vocab as tvocab
import test_imu_init
from torch_port_helpers import J, N, T, as_i32, torch_threads  # noqa: F401

K_CAM = np.asarray([458.0, 458.0, 376.0, 240.0], np.float32)


def test_epnp():
    """tests/test_pnp.py::test_epnp_recovers_pose's problem, and a batch of
    16 subsets of 12 of its points."""
    rng = np.random.default_rng(2)
    n = 80
    xw = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                   rng.uniform(5, 15, n)], -1).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([-0.2, 0.4, 0.1], jnp.float32)))
    t = np.array([-0.4, 0.2, 0.8], np.float32)
    xc = xw @ R.T + t
    xn = (xc[:, :2] / xc[:, 2:3]).astype(np.float32)
    subsets = np.stack([rng.permutation(n)[:12] for _ in range(16)])
    epnp = jax.jit(jpnp.epnp)
    for sets in (np.arange(n)[None], subsets):
        Rj, tj = epnp(jnp.asarray(xw[sets]), jnp.asarray(xn[sets]))
        Rt, tt = tpnp.epnp(T(xw[sets]), T(xn[sets]))
        np.testing.assert_allclose(N(Rt), np.asarray(Rj), rtol=0, atol=1e-4)
        np.testing.assert_allclose(N(tt), np.asarray(tj), rtol=0, atol=1e-4)
        assert np.abs(N(Rt) - R).max() < 1e-3 and np.abs(N(tt) - t).max() < 5e-3


def test_epnp_ransac():
    """tests/test_pnp.py::test_epnp_ransac_with_outliers's problem."""
    rng = np.random.default_rng(3)
    n = 100
    xw = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                   rng.uniform(4, 12, n)], -1).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.1, 0.3, -0.2], jnp.float32)))
    t = np.array([0.2, -0.1, 0.5], np.float32)
    xc = xw @ R.T + t
    rays = (xc / xc[:, 2:3]).astype(np.float32)
    rays[:, :2] += rng.normal(0, 0.5 / 458.0, (n, 2))
    out = rng.choice(n, n // 5, replace=False)
    rays[out, :2] += rng.uniform(0.05, 0.2, (len(out), 2))
    rand = rng.integers(0, n, (256, 5)).astype(np.int32)
    rj = jax.jit(jpnp.epnp_ransac)(jnp.asarray(xw), jnp.asarray(rays), jnp.ones(n, bool),
                                   jnp.asarray(rand), jnp.ones(n, jnp.float32))
    rt = tpnp.epnp_ransac(T(xw), T(rays), T(np.ones(n, bool)), T(rand), T(np.ones(n, np.float32)))
    assert bool(rt.success) and bool(rj.success)
    assert int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_array_equal(N(rt.inliers), np.asarray(rj.inliers))
    np.testing.assert_allclose(N(rt.R), np.asarray(rj.R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(N(rt.t), np.asarray(rj.t), rtol=0, atol=1e-4)
    assert np.abs(N(rt.R) - R).max() < 0.02 and np.abs(N(rt.t) - t).max() < 0.15
    assert N(rt.inliers)[out].mean() < 0.2


def test_l1_scores():
    """tests/test_loop_ops.py::test_vocab_transform_and_scoring's BoW
    vectors: a query against its perturbed view and an unrelated frame."""
    rng = np.random.default_rng(3)
    v = jvocab.BinaryVocabulary(k=8, levels=3).train(jvocab.random_descriptors(20000, seed=0),
                                                      seed=0)
    tf, bow = v.transform_fn(), v.bow_fn()
    d1 = jvocab.random_descriptors(300, seed=1)
    bits = np.unpackbits(d1.view(np.uint8), axis=-1) ^ (rng.random((300, 256)) < 0.03)
    d1b = np.packbits(bits, axis=-1).view(np.uint32).reshape(-1, 8)
    d2 = jvocab.random_descriptors(300, seed=99)
    ones = jnp.ones(300, bool)
    q, b, c = (np.asarray(bow(tf(jnp.asarray(d), ones))) for d in (d1, d1b, d2))
    db = np.stack([b, c, q, np.zeros_like(q)])
    want = np.asarray(jvocab.l1_scores(jnp.asarray(q), jnp.asarray(db)))
    got = N(tvocab.l1_scores(T(q), T(db)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] > 1.8 * got[1] and abs(got[2] - 2.0 * q.sum()) < 1e-5 and got[3] == 0


def _frame(rng, n, w=752, h=480):
    xy = rng.uniform([0, 0], [w, h], (n, 2)).astype(np.float32)
    return xy, rng.integers(0, 8, n).astype(np.int32)


@pytest.mark.parametrize("ratio,check_rotation", [(None, False), (0.9, True)])
def test_search_by_projection(ratio, check_rotation):
    """1024 projected map points against 1024 features at 752x480: map
    descriptors are noisy copies of feature descriptors near their
    predicted pixels, with duplicates, invalid rows and columns."""
    rng = np.random.default_rng(11)
    M = N_F = 1024
    feat_xy, feat_oct = _frame(rng, N_F)
    desc_b = rng.integers(0, 2 ** 32, (N_F, 8), dtype=np.uint32)
    src = rng.integers(0, N_F, M)
    desc_a = desc_b[src] ^ (rng.integers(0, 2 ** 32, (M, 8), dtype=np.uint32)
                            & rng.integers(0, 2 ** 32, (M, 8), dtype=np.uint32)
                            & rng.integers(0, 2 ** 32, (M, 8), dtype=np.uint32))
    pred_xy = (feat_xy[src] + rng.normal(0, 4, (M, 2))).astype(np.float32)
    pred_oct = np.clip(feat_oct[src] + rng.integers(-1, 2, M), 0, 7).astype(np.int32)
    radius = (8.0 * 1.2 ** pred_oct).astype(np.float32)
    valid_a, valid_b = rng.random(M) < 0.9, rng.random(N_F) < 0.95
    ang_b = rng.uniform(0, 2 * np.pi, N_F).astype(np.float32)
    ang_a = np.mod(ang_b[src] + 0.3 + rng.normal(0, 0.05, M), 2 * np.pi).astype(np.float32)
    args = (desc_a, valid_a, pred_xy, pred_oct, desc_b, valid_b, feat_xy, feat_oct, radius)
    kw = dict(ratio=ratio, check_rotation=check_rotation)
    want = jm.search_by_projection(*[J(a) for a in args], angle_a=J(ang_a), angle_b=J(ang_b),
                                   **kw)
    got = tm.search_by_projection(*[T(a) for a in args], angle_a=T(ang_a), angle_b=T(ang_b),
                                  **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(as_i32(g), as_i32(w))
    assert int(got[2].sum()) > 300


def test_epipolar_mask():
    """1024 rays of one keyframe against 1024 pixels of another, with the
    second camera 0.3 to the side and turned by ~0.05 rad."""
    rng = np.random.default_rng(12)
    R21 = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.05, 0.01], jnp.float32)))
    t21 = np.array([-0.3, 0.02, 0.01], np.float32)
    E = (np.asarray(jlie.hat(jnp.asarray(t21))) @ R21).astype(np.float32)
    X = np.stack([rng.uniform(-3, 3, 1024), rng.uniform(-2, 2, 1024),
                  rng.uniform(3, 10, 1024)], -1).astype(np.float32)
    rays1 = (X / X[:, 2:3]).astype(np.float32)
    x2 = X @ R21.T + t21
    xy2 = (x2[:, :2] / x2[:, 2:3] * K_CAM[:2] + K_CAM[2:] + rng.normal(0, 1.0, (1024, 2)))
    xy2 = xy2.astype(np.float32)
    oct2 = rng.integers(0, 8, 1024).astype(np.int32)
    sig2 = (1.2 ** (2 * np.arange(8))).astype(np.float32)
    args = (rays1, xy2, E, K_CAM, sig2, oct2)
    want = np.asarray(jm.epipolar_mask(*[J(a) for a in args]))
    got = N(tm.epipolar_mask(*[T(a) for a in args]))
    # the gate in float64: only pairs on the threshold may part
    line = rays1.astype(np.float64) @ E.astype(np.float64).T
    a, b = line[:, 0] / K_CAM[0], line[:, 1] / K_CAM[1]
    c = line[:, 2] - line[:, 0] * K_CAM[2] / K_CAM[0] - line[:, 1] * K_CAM[3] / K_CAM[1]
    num = a[:, None] * xy2[None, :, 0] + b[:, None] * xy2[None, :, 1] + c[:, None]
    dsq = num * num / (a * a + b * b)[:, None]
    gate = 3.84 * sig2[oct2][None, :]
    firm = np.abs(dsq - gate) > 1e-4 * gate
    np.testing.assert_array_equal(got[firm], want[firm])
    assert np.diag(got).mean() > 0.9 and got.mean() < 0.2


def test_vi_window_optimize(monkeypatch):
    """tests/test_vi_ba.py::test_vi_window_recovers_perturbed_states's
    problem and its bounds. ``simulate``'s 800 rotations and 7
    preintegrations run compiled (``jax.jit``) instead of op by op: the
    problem moves by ~2e-6, and both packages get the same one."""
    monkeypatch.setattr(test_imu_init, "lie", types.SimpleNamespace(
        so3_exp=jax.jit(jlie.so3_exp), so3_log=jax.jit(jlie.so3_log)))
    monkeypatch.setattr(test_imu_init, "imu_ops", types.SimpleNamespace(
        GRAVITY=jimu.GRAVITY, preintegrate=jax.jit(jimu.preintegrate, static_argnums=(10,))))
    R_map, p_map, preints, _, _, bg_gt, _, v_gt = test_imu_init.simulate(
        n_kf=8, scale=1.0, g_tilt=(0.0, 0.0), seed=3)
    Kn = len(R_map)
    R_gt = np.stack([R.T for R in R_map])
    t_gt = np.stack([-R.T @ p for R, p in zip(R_map, p_map)])
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-4, 4, 150), rng.uniform(-3, 3, 150),
                    rng.uniform(5, 15, 150)], -1).astype(np.float32)
    obs_kf, obs_uv, obs_pts = [], [], []
    for k in range(Kn):
        pc = pts @ R_gt[k].T + t_gt[k]
        uv = np.stack([458 * pc[:, 0] / pc[:, 2] + 376, 458 * pc[:, 1] / pc[:, 2] + 240], -1)
        uv += rng.normal(0, 0.5, uv.shape)
        for j in range(150):
            obs_kf.append(k)
            obs_uv.append(uv[j])
            obs_pts.append(pts[j])
    O = len(obs_kf)
    R0, t0 = R_gt.copy(), t_gt.copy()
    for k in range(1, Kn):
        R0[k] = np.asarray(jlie.so3_exp(jnp.asarray(
            rng.normal(0, 0.01, 3).astype(np.float32)))) @ R_gt[k]
        t0[k] = t_gt[k] + rng.normal(0, 0.03, 3)
    vels0 = v_gt + rng.normal(0, 0.1, v_gt.shape)
    fixed = np.zeros(Kn, bool)
    fixed[0] = True
    pre = [np.stack([np.asarray(getattr(s, f)) for s in preints]).astype(np.float32)
           for f in ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa")]
    cov = np.stack([np.asarray(s.C)[:9, :9] for s in preints]).astype(np.float32)
    args = ([R0.astype(np.float32), t0.astype(np.float32), vels0.astype(np.float32),
             np.zeros(3, np.float32), np.zeros(3, np.float32),
             np.stack(obs_pts).astype(np.float32), np.asarray(obs_kf, np.int32),
             np.stack(obs_uv).astype(np.float32), np.ones(O, np.float32), np.ones(O, bool)]
            + pre + [cov, np.ones(Kn - 1, bool), K_CAM, fixed])
    rj = jax.jit(jvi.vi_window_optimize, static_argnames=("iters",))(*[J(a) for a in args],
                                                                      iters=10)
    rt = tvi.vi_window_optimize(*[T(a) for a in args], iters=10)
    for f, tol in (("R", 1e-4), ("t", 1e-4), ("vels", 1e-4), ("bg", 1e-5), ("ba", 1e-5)):
        np.testing.assert_allclose(N(getattr(rt, f)), np.asarray(getattr(rj, f)),
                                   rtol=0, atol=tol, err_msg=f)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-3)
    assert np.abs(N(rt.t)[1:] - t_gt[1:]).max() < 0.3 * np.abs(t0[1:] - t_gt[1:]).max()
    assert np.abs(N(rt.vels) - v_gt).max() < 0.06
    assert np.abs(N(rt.bg) - bg_gt).max() < 2e-3
