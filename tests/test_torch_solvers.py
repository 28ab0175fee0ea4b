"""The solvers: ops/pose_opt.py, ops/triangulation.py, ops/twoview.py and
ops/ba.py, the port against the JAX package on the same float32 inputs.

Tolerances are stated per test. They are set by float32 rounding carried
through iterative solvers whose sums run in another order: agreement to
~1e-4 in pose (rad, scene units) on well-conditioned problems, and inlier
masks that may differ only where a residual sits on the chi2 gate.
"""
import jax
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import ba as jba
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu.ops import matching as jm
from orbslam3_tpu.ops import pose_opt as jpo
from orbslam3_tpu.ops import triangulation as jtri
from orbslam3_tpu.ops import twoview as jtv
from orbslam3_tpu_torch.ops import ba as tba
from orbslam3_tpu_torch.ops import pose_opt as tpo
from orbslam3_tpu_torch.ops import triangulation as ttri
from orbslam3_tpu_torch.ops import twoview as ttv
from torch_port_helpers import J, N, T, random_pose, room_frames, torch_threads  # noqa: F401

K = np.array([458.654, 457.296, 376.0, 240.0], np.float32)


def _rot_err(Ra, Rb):
    c = (np.trace(np.asarray(Ra).T @ np.asarray(Rb)) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def _project(R, t, X):
    xc = X @ R.T + t
    return np.stack([K[0] * xc[:, 0] / xc[:, 2] + K[2], K[1] * xc[:, 1] / xc[:, 2] + K[3]], -1)


def test_solve6_matches_dense_solve():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(6, 6)).astype(np.float32)
    H = (A @ A.T + 6 * np.eye(6)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    np.testing.assert_allclose(N(tpo.solve6(T(H), T(b))), N(jpo.solve6(J(H), J(b))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(N(tpo.solve6(T(H), T(b))), np.linalg.solve(H, b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("prior_eps", [0.0, 3e-4])
def test_pose_optimize(prior_eps):
    """600 points, 0.7 px noise, 10% gross outliers, seed perturbed by ~2°
    and 5 cm. Pose within 1e-4 rad / 1e-4 units of JAX's; inlier masks differ
    on at most 1% of the observations (gate-borderline residuals)."""
    rng = np.random.default_rng(1)
    X = np.concatenate([rng.uniform(-3, 3, (600, 2)), rng.uniform(3, 9, (600, 1))], 1).astype(np.float32)
    R, t = random_pose(rng, 0.1, 0.2)
    uv = (_project(R, t, X) + rng.normal(0, 0.7, (600, 2))).astype(np.float32)
    uv[::10] += rng.uniform(-60, 60, (60, 2)).astype(np.float32)
    octave = rng.integers(0, 4, 600)
    inv_s2 = (1.0 / 1.44 ** octave).astype(np.float32)
    valid = rng.random(600) < 0.95
    dR = np.asarray(jlie.so3_exp(J(rng.normal(0, 0.035, 3).astype(np.float32))))
    R0 = (dR @ R).astype(np.float32)
    t0 = (t + rng.normal(0, 0.05, 3)).astype(np.float32)
    kw = dict(rounds=4, iters=10, prior_eps=prior_eps)
    rj = jax.jit(lambda *a: jpo.pose_optimize(*a, prior_R=a[0], prior_t=a[1], **kw))(
        J(R0), J(t0), J(X), J(uv), J(inv_s2), J(valid), J(K))
    rt = tpo.pose_optimize(T(R0), T(t0), T(X), T(uv), T(inv_s2), T(valid), T(K),
                           prior_R=T(R0), prior_t=T(t0), **kw)
    assert _rot_err(N(rt.R), N(rj.R)) < 1e-4
    np.testing.assert_allclose(N(rt.t), N(rj.t), rtol=0, atol=1e-4)
    assert (N(rt.inlier) != N(rj.inlier)).mean() <= 0.01
    assert _rot_err(N(rt.R), R) < 5e-3                 # and both found the truth
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 6


def test_triangulation():
    """DLT + acceptance gates on noisy two-view rays. The smallest eigenvector
    of AᵀA squares the conditioning of A, so for far, low-parallax points
    (depth/baseline up to ~20 here) float32 leaves percent-level freedom in
    either implementation: 97% of the points agree to 1e-4 relative, all to
    5%. Gates equal except at most 1% borderline rows."""
    rng = np.random.default_rng(2)
    X = np.concatenate([rng.uniform(-3, 3, (400, 2)), rng.uniform(2, 10, (400, 1))], 1).astype(np.float32)
    R1, t1 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    R2, t2 = random_pose(rng, 0.05, 0.5)
    rays = []
    for R, t in ((R1, t1), (R2, t2)):
        xc = X @ R.T + t
        r = xc / xc[:, 2:3] + np.concatenate([rng.normal(0, 1e-3, (400, 2)), np.zeros((400, 1))], 1)
        rays.append(r.astype(np.float32))
    s2 = np.full(400, (1.0 / K[0]) ** 2, np.float32)
    xj = jtri.triangulate_dlt(J(R1), J(t1), J(rays[0]), J(R2), J(t2), J(rays[1]))
    xt = ttri.triangulate_dlt(T(R1), T(t1), T(rays[0]), T(R2), T(t2), T(rays[1]))
    rel = np.linalg.norm(N(xt) - N(xj), axis=1) / np.linalg.norm(N(xj), axis=1)
    assert (rel <= 1e-4).mean() >= 0.97, (rel <= 1e-4).mean()
    assert rel.max() <= 0.05, rel.max()
    okj, dj = jtri.check_triangulation(xj, J(R1), J(t1), J(rays[0]), J(R2), J(t2), J(rays[1]),
                                       J(s2), J(s2))
    okt, dt = ttri.check_triangulation(T(N(xj)), T(R1), T(t1), T(rays[0]), T(R2), T(t2),
                                       T(rays[1]), T(s2), T(s2))
    assert (N(okt) != N(okj)).mean() <= 0.01
    np.testing.assert_allclose(N(dt), N(dj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pair", [(0, 7), (0, 5)])
def test_two_view_reconstruction_on_real_frames(pair):
    """The monocular bootstrap on two rendered frames with the SAME host-drawn
    RANSAC sets: same success and model choice (frames 0/7 bootstrap through
    the homography, 0/5 are rejected by both), and on success R within 1e-3
    rad, unit t within 1e-3, good masks differing on at most 1% of the
    matches."""
    _, frames = room_frames()
    f0, f1 = frames[pair[0]], frames[pair[1]]
    idx, _, ok = jm.search_for_initialization(
        *map(J, (f0["desc"], f0["valid"], f0["xy"], f0["angle"],
                 f1["desc"], f1["valid"], f1["xy"], f1["angle"])))
    idx, ok = np.asarray(idx), np.asarray(ok)
    x1 = ((f0["xy"] - K[2:]) / K[:2]).astype(np.float32)
    x2 = ((f1["xy"][idx] - K[2:]) / K[:2]).astype(np.float32)
    rand_sets = np.random.default_rng(0).choice(np.nonzero(ok)[0], size=(200, 8)).astype(np.int32)
    sigma_n = 1.0 / float(K[0])
    rj = jax.jit(lambda *a: jtv.reconstruct_two_views(*a, sigma_n=sigma_n))(
        J(x1), J(x2), J(ok), J(rand_sets))
    rt = ttv.reconstruct_two_views(T(x1), T(x2), T(ok), T(rand_sets), sigma_n=sigma_n)
    assert bool(rt.success) == bool(rj.success)
    assert bool(rt.is_homography) == bool(rj.is_homography)
    if not bool(rj.success):
        return
    assert _rot_err(N(rt.R), N(rj.R)) < 1e-3
    np.testing.assert_allclose(N(rt.t), N(rj.t), rtol=0, atol=1e-3)
    assert (N(rt.good) != N(rj.good)).mean() <= 0.01


def _ba_problem(rng, n_kf=5, n_pt=250):
    X = np.concatenate([rng.uniform(-3, 3, (n_pt, 2)), rng.uniform(4, 9, (n_pt, 1))], 1)
    poses = [(np.eye(3), np.zeros(3))] + [random_pose(rng, 0.04, 0.3) for _ in range(n_kf - 1)]
    kf, mp, uv = [], [], []
    for k, (R, t) in enumerate(poses):
        proj = _project(R.astype(np.float32), t.astype(np.float32), X.astype(np.float32))
        for p in range(n_pt):
            if rng.random() < 0.85:
                kf.append(k)
                mp.append(p)
                uv.append(proj[p] + rng.normal(0, 0.7, 2))
    uv = np.asarray(uv, np.float32)
    uv[::25] += 40.0                                # gross outliers
    O = len(kf)
    R0 = np.stack([p[0] for p in poses]).astype(np.float32)
    t0 = np.stack([p[1] for p in poses]).astype(np.float32)
    for k in range(2, n_kf):                        # perturb the free poses
        R0[k] = np.asarray(jlie.so3_exp(J(rng.normal(0, 0.01, 3).astype(np.float32)))) @ R0[k]
        t0[k] += rng.normal(0, 0.02, 3)
    pts = (X + rng.normal(0, 0.03, X.shape)).astype(np.float32)
    fixed = np.zeros(n_kf, bool)
    fixed[:2] = True
    arrays = dict(R=R0, t=t0, pts=pts, obs_kf=np.asarray(kf, np.int32),
                  obs_mp=np.asarray(mp, np.int32), obs_uv=uv,
                  obs_inv_sigma2=np.ones(O, np.float32), obs_valid=np.ones(O, bool),
                  fixed_pose=fixed, obs_ur=np.full(O, -1.0, np.float32))
    return arrays, X


def test_local_ba():
    """Two-phase Schur LM (5 + 10 iterations): poses within 2e-4 rad and
    scene units, points within 2e-3 (weakly constrained depths absorb the
    float32 noise of the dense Schur products), outlier classification equal
    except at most 1% of the observations."""
    rng = np.random.default_rng(3)
    arrays, X = _ba_problem(rng)
    pj = jba.BAProblem(bf=0.0, **{k: J(v) for k, v in arrays.items()})
    pt = tba.BAProblem(bf=0.0, **{k: T(v) for k, v in arrays.items()})
    rj = jax.jit(lambda p, k: jba.local_ba(p, k, iters1=5, iters2=10))(pj, J(K))
    rt = tba.local_ba(pt, T(K), iters1=5, iters2=10)
    for k in range(len(arrays["R"])):
        assert _rot_err(N(rt.R)[k], N(rj.R)[k]) < 2e-4
    np.testing.assert_allclose(N(rt.t), N(rj.t), rtol=0, atol=2e-4)
    np.testing.assert_allclose(N(rt.pts), N(rj.pts), rtol=0, atol=2e-3)
    assert (N(rt.obs_inlier) != N(rj.obs_inlier)).mean() <= 0.01
    assert not N(rt.obs_inlier)[::25].any()         # the gross outliers are rejected
    # and the solve actually fit the observations: median chi2 of the
    # inliers drops to the noise level (0.7 px → chi2 ≈ 1)
    chi_before = N(tba.classify_inliers(pt, T(K))[1])
    chi_after = N(tba.classify_inliers(pt._replace(R=rt.R, t=rt.t, pts=rt.pts), T(K))[1])
    assert np.median(chi_after) < 0.1 * np.median(chi_before)
    assert np.median(chi_after) < 2.0


def test_ba_classify_inliers():
    rng = np.random.default_rng(4)
    arrays, _ = _ba_problem(rng, n_kf=3, n_pt=80)
    pj = jba.BAProblem(bf=0.0, **{k: J(v) for k, v in arrays.items()})
    pt = tba.BAProblem(bf=0.0, **{k: T(v) for k, v in arrays.items()})
    ij, cj = jba.classify_inliers(pj, J(K))
    it, ct = tba.classify_inliers(pt, T(K))
    np.testing.assert_allclose(N(ct), N(cj), rtol=1e-4, atol=1e-3)
    assert (N(it) != N(ij)).mean() <= 0.01


KB8_L = np.array([190.978, 190.973, 256.0, 256.0, 0.00348, 0.000715, -0.00205, 0.000202],
                 np.float32)
KB8_R = np.array([191.2, 191.1, 254.5, 257.0, 0.0031, 0.0009, -0.0019, 0.00018], np.float32)


def _rig_problem(rng, kind: str):
    """_ba_problem's points and poses with the rows of a rig: ``stereo`` adds
    the right-column coordinate u_R = u − bf/z to 60% of the rows of a
    pinhole rig; ``tobody`` observes the points through a KB8 camera and adds,
    for half of them, a row of a second KB8 camera at T_rl ∘ T_kf (the
    reference's EdgeSE3ProjectXYZToBody). Returns (arrays, extra
    BAProblem fields, camera parameters, camera type)."""
    from orbslam3_tpu.ops import camera as jcam
    arrays, X = _ba_problem(rng, n_kf=5, n_pt=200)
    kf, mp = arrays["obs_kf"], arrays["obs_mp"]
    R0, t0 = arrays["R"], arrays["t"]
    O = len(kf)
    if kind == "stereo":
        bf = np.float32(0.11 * K[0])
        xc = np.einsum("oij,oj->oi", R0[kf], X[mp].astype(np.float32)) + t0[kf]
        ur = (arrays["obs_uv"][:, 0] - bf / xc[:, 2] + rng.normal(0, 0.7, O)).astype(np.float32)
        arrays["obs_ur"] = np.where(rng.random(O) < 0.6, ur, -1.0).astype(np.float32)
        return arrays, dict(bf=float(bf)), K, 0
    R_rl = np.asarray(jlie.so3_exp(J(np.float32([0.0, 0.008, 0.0]))))
    t_rl = np.float32([-0.101, 0.0, 0.0])
    # the true poses: the first two are fixed and unperturbed
    xc_l = np.einsum("oij,oj->oi", R0[kf], X[mp].astype(np.float32)) + t0[kf]
    uv_l = np.asarray(jcam.kb8_project(J(KB8_L), J(xc_l.astype(np.float32))))
    two = rng.random(O) < 0.5
    xc_r = xc_l[two] @ R_rl.T + t_rl
    uv_r = np.asarray(jcam.kb8_project(J(KB8_R), J(xc_r.astype(np.float32))))
    uv = np.concatenate([uv_l, uv_r]) + rng.normal(0, 0.5, (O + int(two.sum()), 2))
    uv = uv.astype(np.float32)
    uv[::25] += 20.0                                # gross outliers
    n2 = int(two.sum())
    arrays.update(
        obs_kf=np.concatenate([kf, kf[two]]).astype(np.int32),
        obs_mp=np.concatenate([mp, mp[two]]).astype(np.int32), obs_uv=uv,
        obs_inv_sigma2=np.ones(O + n2, np.float32), obs_valid=np.ones(O + n2, bool),
        obs_ur=np.full(O + n2, -1.0, np.float32))
    extra = dict(bf=float(np.linalg.norm(t_rl) * KB8_L[0]),
                 obs_cam=np.r_[np.zeros(O, np.int32), np.ones(n2, np.int32)],
                 cam_params2=KB8_R, R_rl=R_rl, t_rl=t_rl)
    return arrays, extra, KB8_L, 1


def _rot_err_skew(Ra, Rb):
    """Rotation angle between two float32 rotations from the skew part of
    RaᵀRb in float64: arccos of the trace leaves ~5e-4 rad of noise when
    float32 matrices are off orthonormal by an ulp."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    w = 0.5 * np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(np.arcsin(min(np.linalg.norm(w), 1.0)))


@pytest.mark.parametrize("kind", ["stereo", "tobody"])
def test_ba_rig_rows(kind):
    """Stereo right-column rows and the two-camera rig's second-camera (ToBody)
    rows: one linearization within 1e-5 relative of JAX's (residuals,
    Jacobians, weights, chi2; every entry finite, the SKILL.md hazard), then
    local_ba within test_local_ba's tolerances (points: see below)."""
    rng = np.random.default_rng(11 if kind == "stereo" else 12)
    arrays, extra, camp, cam_type = _rig_problem(rng, kind)
    bf = extra.pop("bf")
    pj = jba.BAProblem(bf=J(np.float32(bf)), **{k: J(v) for k, v in arrays.items()},
                       **{k: J(v) for k, v in extra.items()})
    pt = tba.BAProblem(bf=bf, **{k: T(v) for k, v in arrays.items()},
                       **{k: T(v) for k, v in extra.items()})
    huber = np.sqrt(np.float32(jba.CHI2_MONO))
    w_mask = np.ones(len(arrays["obs_kf"]), np.float32)
    lj = jba._linearize(pj, pj.pts, pj.R, pj.t, J(w_mask), cam_type, J(camp), J(huber))
    lt = tba._linearize(pt, pt.pts, pt.R, pt.t, T(w_mask), cam_type, T(camp), T(huber))
    for name, a, b in zip(("chi2", "w", "Jpose", "Jpt", "r"), lt, lj):
        a, b = N(a), N(b)
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * max(np.abs(b).max(), 1.0),
                                   err_msg=name)
    rj = jax.jit(lambda p, k: jba.local_ba(p, k, cam_type=cam_type, iters1=5, iters2=10))(
        pj, J(camp))
    rt = tba.local_ba(pt, T(camp), cam_type=cam_type, iters1=5, iters2=10)
    for k in range(len(arrays["R"])):
        assert _rot_err_skew(N(rt.R)[k], N(rj.R)[k]) < 2e-4
    np.testing.assert_allclose(N(rt.t), N(rj.t), rtol=0, atol=2e-4)
    # points within 2e-3 as in test_local_ba, but for one in a hundred: with
    # the 190 px fisheye a point left with four inlier rows is three times
    # looser along its ray than with the 458 px pinhole (one point of 200,
    # seed 12: 8e-3 at 6.5 m, every other within 1.2e-4)
    dp = np.abs(N(rt.pts) - N(rj.pts)).max(axis=1)
    assert (dp < 2e-3).mean() >= 0.99 and dp.max() < 1e-2, np.sort(dp)[-3:]
    assert (N(rt.obs_inlier) != N(rj.obs_inlier)).mean() <= 0.01
