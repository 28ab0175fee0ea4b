"""Parity of the port's visual-inertial solvers (ops/vi_ba.py) with the JAX
package on the CPU, on the inputs of tests/test_vi_ba.py.

Tolerances: ``pose_inertial_optimize`` pose within 1e-4 (rotation entries,
translation units), velocity within 1e-3, biases within 1e-5 of their walk
units, inlier masks and counts equal, ``H_marg`` within 1e-3 of its largest
entry; ``vi_joint_ba`` poses within 1e-3, velocities within 5e-3, biases
within 1e-4 / 1e-3, landmarks within 1e-2 (16 damped Schur iterations in
float32 over 960 observations; both packages converge to the same optimum,
the rounding of each step differs), inlier masks equal."""
import jax
import numpy as np
import pytest
import torch

from torch_port_helpers import J, N, T, torch_threads  # noqa: F401
from torch_port_helpers import imu_simulation as simulate
from orbslam3_tpu.ops import imu as jimu
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu.ops import vi_ba as jvi
from orbslam3_tpu_torch.ops import imu as timu
from orbslam3_tpu_torch.ops import vi_ba as tvi

# the JAX side compiled once per static configuration (eager JAX traces each
# scan and loop anew and takes several times as long)
_jax_pose = jax.jit(jvi.pose_inertial_optimize,
                    static_argnames=("cam_type", "iters", "chi2_th", "sigma_gw", "sigma_aw"))
_jax_joint = jax.jit(jvi.vi_joint_ba, static_argnames=(
    "cam_type", "iters", "prior_g", "prior_a", "rw_gyro", "rw_acc", "fix_landmarks",
    "fix_vel_bias_of_fixed"))
K_CAM = np.asarray([458.0, 458.0, 376.0, 240.0], np.float32)
PRE = ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa")


def _np_pre(s):
    return {k: np.asarray(getattr(s, k), np.float32) for k in jimu.PreintState._fields}


def _torch_pre(d):
    return timu.PreintState(**{k: T(v) for k, v in d.items()})


def _pose_inputs(seed=11, n_pts=200, with_prior=False):
    """One frame of tests/test_vi_ba.py's 15-dim chain: a perturbed pose seed,
    observations with 0.4 px noise, a wrong (zero) bias estimate and, with
    ``with_prior``, the marginal prior of the previous frame's solve."""
    R_map, p_map, preints, *_, v_gt = simulate(
        n_kf=8, kf_dt=0.05, scale=1.0, g_tilt=(0.0, 0.0), seed=seed,
        bg=(0.02, -0.015, 0.01), ba=(0.12, -0.08, 0.1))
    R_cw = np.stack([R.T for R in R_map]).astype(np.float32)
    t_cw = np.stack([-R.T @ p for R, p in zip(R_map, p_map)]).astype(np.float32)
    rng = np.random.default_rng(2)
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(5, 15, n_pts)], -1).astype(np.float32)
    k = 2
    pc = pts @ R_cw[k].T + t_cw[k]
    uv = np.stack([458 * pc[:, 0] / pc[:, 2] + 376, 458 * pc[:, 1] / pc[:, 2] + 240], -1)
    uv = (uv + rng.normal(0, 0.4, uv.shape)).astype(np.float32)
    uv[:12] += 40.0          # a few gross outliers for the chi2 schedule
    dRp = np.asarray(jlie.so3_exp(J(rng.normal(0, 0.005, 3).astype(np.float32))))
    R0 = (dRp @ R_cw[k]).astype(np.float32)
    t0 = (t_cw[k] + rng.normal(0, 0.01, 3)).astype(np.float32)
    v0 = (v_gt[k] + rng.normal(0, 0.05, 3)).astype(np.float32)
    v1 = v_gt[k - 1].astype(np.float32)
    pre = _np_pre(preints[k - 1])
    valid = np.ones(n_pts, bool)
    valid[-5:] = False
    prior = None
    if with_prior:
        A = rng.normal(0, 1, (15, 15)).astype(np.float32)
        prior = (A @ A.T + 15 * np.eye(15)).astype(np.float32) * 50.0
    return dict(R0=R0, t0=t0, v0=v0, R1=R_map[k - 1].astype(np.float32),
                p1=p_map[k - 1].astype(np.float32), v1=v1, pre=pre, pts=pts, uv=uv,
                valid=valid, prior=prior)


def _run_pose(pkg, d, bias=np.zeros(3, np.float32)):
    X = J if pkg == "jax" else T
    imu_mod, vi = (jimu, jvi) if pkg == "jax" else (timu, tvi)
    pre = (jimu.PreintState(**{k: J(v) for k, v in d["pre"].items()}) if pkg == "jax"
           else _torch_pre(d["pre"]))
    dR_c, dV_c, dP_c = imu_mod.corrected_delta(pre, X(bias), X(bias))
    fn = _jax_pose if pkg == "jax" else vi.pose_inertial_optimize
    return fn(
        X(d["R0"]), X(d["t0"]), X(d["v0"]), X(d["R1"]), X(d["p1"]), X(d["v1"]),
        X(bias), X(bias), pre.dT, dR_c, dV_c, dP_c,
        pre.JRg, pre.JVg, pre.JVa, pre.JPg, pre.JPa, X(d["pre"]["C"][:9, :9]),
        X(d["pts"]), X(d["uv"]), X(np.ones(len(d["pts"]), np.float32)), X(d["valid"]),
        X(K_CAM), sigma_gw=3e-2, sigma_aw=0.3,
        prior_H=None if d["prior"] is None else X(d["prior"]))


@pytest.mark.parametrize("with_prior", [False, True], ids=["fixed_prev", "marginal_prior"])
def test_pose_inertial_optimize_matches_jax(with_prior):
    d = _pose_inputs(with_prior=with_prior)
    rj = _run_pose("jax", d)
    rt = _run_pose("torch", d)
    assert np.array_equal(N(rt.inlier), N(rj.inlier))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    assert int(rt.n_inliers) < int(d["valid"].sum())          # the outliers went
    assert np.abs(N(rt.R) - N(rj.R)).max() < 1e-4
    assert np.abs(N(rt.t) - N(rj.t)).max() < 1e-4
    assert np.abs(N(rt.v) - N(rj.v)).max() < 1e-3
    # biases move in walk units sb = σ·sqrt(dT) ≈ 7e-3 / 7e-2
    assert np.abs(N(rt.bg) - N(rj.bg)).max() < 1e-5
    assert np.abs(N(rt.ba) - N(rj.ba)).max() < 1e-4
    Hj, Ht = N(rj.H_marg), N(rt.H_marg)
    assert Ht.shape == (15, 15)
    assert np.abs(Ht - Hj).max() < 1e-3 * np.abs(Hj).max()
    assert np.abs(N(rt.prev_moved) - N(rj.prev_moved)).max() < 1e-3


def _joint_inputs(n_pts=120, stereo=False):
    """tests/test_vi_ba.py::test_vi_joint_ba_recovers_states_and_landmarks'
    problem (seed 5), with right-eye rows on every other observation when
    ``stereo``."""
    R_map, p_map, preints, _, _, bg_gt, ba_gt, v_gt = simulate(
        n_kf=8, scale=1.0, g_tilt=(0.0, 0.0), seed=5)
    Kn = len(R_map)
    R_cw_gt = np.stack([R.T for R in R_map])
    t_cw_gt = np.stack([-R.T @ p for R, p in zip(R_map, p_map)])
    rng = np.random.default_rng(1)
    pts_gt = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                       rng.uniform(5, 15, n_pts)], -1).astype(np.float32)
    obs_kf, obs_mp, obs_uv, obs_ur = [], [], [], []
    bf = 0.11 * 458.0
    for k in range(Kn):
        pc = pts_gt @ R_cw_gt[k].T + t_cw_gt[k]
        uv = np.stack([458 * pc[:, 0] / pc[:, 2] + 376, 458 * pc[:, 1] / pc[:, 2] + 240], -1)
        uv += rng.normal(0, 0.4, uv.shape)
        ur = uv[:, 0] - bf / pc[:, 2] + rng.normal(0, 0.4, n_pts)
        for j in range(n_pts):
            obs_kf.append(k)
            obs_mp.append(j)
            obs_uv.append(uv[j])
            obs_ur.append(ur[j] if (stereo and j % 2 == 0) else -1.0)
    R0 = R_cw_gt.copy()
    t0 = t_cw_gt.copy()
    for k in range(1, Kn):
        dR = np.asarray(jlie.so3_exp(J(rng.normal(0, 0.01, 3).astype(np.float32))))
        R0[k] = dR @ R_cw_gt[k]
        t0[k] = t_cw_gt[k] + rng.normal(0, 0.03, 3)
    vels0 = v_gt + rng.normal(0, 0.1, v_gt.shape)
    pts0 = pts_gt + rng.normal(0, 0.05, pts_gt.shape).astype(np.float32)
    fixed = np.zeros(Kn, bool)
    fixed[0] = True
    O = len(obs_kf)
    valid = np.ones(O, bool)
    valid[::17] = False
    pre = {a: np.stack([np.asarray(getattr(s, a), np.float32) for s in preints]) for a in PRE}
    cov = np.stack([np.asarray(s.C, np.float32)[:9, :9] for s in preints])
    args = [R0.astype(np.float32), t0.astype(np.float32), vels0.astype(np.float32),
            np.zeros((Kn, 3), np.float32), np.zeros((Kn, 3), np.float32), fixed,
            pts0, np.asarray(obs_kf, np.int32), np.asarray(obs_mp, np.int32),
            np.stack(obs_uv).astype(np.float32), np.asarray(obs_ur, np.float32),
            np.ones(O, np.float32), valid, np.float32(bf if stereo else 0.0),
            *[pre[a] for a in PRE], cov, np.ones(Kn - 1, bool), K_CAM]
    return args, (t_cw_gt, v_gt, pts_gt, bg_gt, ba_gt)


@pytest.mark.parametrize("case", ["init_mono", "local_stereo"])
def test_vi_joint_ba_matches_jax(case):
    stereo = case == "local_stereo"
    args, (t_gt, v_gt, *_) = _joint_inputs(stereo=stereo)
    if stereo:
        # LocalInertialBA: window boundary fixed with its velocity and biases
        kw = dict(iters=8, fix_vel_bias_of_fixed=True)
    else:
        # FullInertialBA at initialization: first pose fixed, bias priors
        kw = dict(iters=16, prior_g=1e2, prior_a=1e3, fix_vel_bias_of_fixed=False)
    rj = _jax_joint(*[J(a) for a in args], **kw)
    rt = tvi.vi_joint_ba(*[T(a) for a in args], **kw)
    assert np.array_equal(N(rt.obs_inlier), N(rj.obs_inlier))
    assert np.abs(N(rt.R) - N(rj.R)).max() < 1e-3
    assert np.abs(N(rt.t) - N(rj.t)).max() < 1e-3
    assert np.abs(N(rt.vels) - N(rj.vels)).max() < 5e-3
    assert np.abs(N(rt.bg) - N(rj.bg)).max() < 1e-4
    assert np.abs(N(rt.ba) - N(rj.ba)).max() < 1e-3
    assert np.abs(N(rt.pts) - N(rj.pts)).max() < 1e-2
    assert abs(float(rt.cost) - float(rj.cost)) < 1e-3 * float(rj.cost)
    if not stereo:
        # and the port recovers the truth as tests/test_vi_ba.py requires
        t0_err = np.abs(args[1][1:] - t_gt[1:]).max()
        assert np.abs(N(rt.t)[1:] - t_gt[1:]).max() < 0.3 * t0_err
        assert np.abs(N(rt.vels) - v_gt).max() < 0.03


def test_vi_joint_ba_non_finite_step_is_zeroed():
    """A keyframe pair whose covariance has NaN entries makes the dense system
    non-finite: JAX's solve returns NaN and the step is zeroed (vi_ba.py:548);
    the port's solve_ex does the same instead of raising, and every state
    stays where it was (the cost is NaN, no step is accepted)."""
    args, _ = _joint_inputs()
    cov = args[23].copy()
    cov[2, 4, 4] = np.nan
    args[23] = cov
    kw = dict(iters=16, prior_g=1e2, prior_a=1e3, fix_vel_bias_of_fixed=False)
    rj = _jax_joint(*[J(a) for a in args], **kw)
    rt = tvi.vi_joint_ba(*[T(a) for a in args], **kw)
    for name in ("R", "t", "vels", "bg", "ba", "pts"):
        assert np.array_equal(N(getattr(rt, name)), N(getattr(rj, name))), name
    assert np.array_equal(N(rt.t), args[1])
    assert np.array_equal(N(rt.pts), args[6])
    assert np.isnan(float(rt.cost)) and np.isnan(float(rj.cost))


def test_forward_jacobians_from_two_threads():
    """PyTorch's forward-mode level is one per process: the tracker's and the
    mapper's threads differentiate at once in async mode, and
    ``lie.FORWARD_AD_LOCK`` takes them one at a time (without it the second
    raises "Nested forward mode AD is not supported")."""
    import threading
    from orbslam3_tpu_torch.ops import lie as tlie
    errors, results = [], []
    p = torch.linspace(-0.3, 0.3, 12)

    def fn(q):
        return tlie.so3_log(tlie.so3_exp(q.reshape(q.shape[0], 4, 3))).reshape(q.shape[0], -1)

    def work():
        try:
            for _ in range(20):
                results.append(tlie.jacobian_fwd(fn, p)[1])
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(repr(e))
    threads = [threading.Thread(target=work) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[0]
    assert len(results) == 60
    assert all(torch.allclose(r, results[0], atol=1e-6) for r in results)
    assert torch.allclose(results[0], torch.eye(12), atol=1e-5)
