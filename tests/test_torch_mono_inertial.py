"""The monocular-inertial pieces of the port against the JAX package on the
CPU, at unit level:

- ``Tracker.try_imu_init`` on a monocular map (``bf = 0``): the same
  keyframes, landmarks, live frames, logged trajectory and preintegration
  chain in both packages (tests/test_imu_init.py::simulate's trajectory
  with the visual map at a quarter of the metric scale and gravity tilted),
  through a chain that initializes, one stopped by the 2.2 s time-span gate
  and one stopped by the split-sample gate;
- ``ops/imu_init.inertial_init`` with the monocular first init's priors
  (the scale free, ``prior_a = 1e10``).

The JAX package's ``try_imu_init`` calls ``inertial_init`` eagerly; here it
calls the jitted function (the same computation, compiled once for the
three solves of a case).

Tolerances: verdicts equal; the scale within 1e-3 relative, the gravity
rotation within 1e-4, the biases within 1e-5 (gyro) and 1e-4 (acc), the
velocities within 1e-3 of their largest entry (inertial_init's own, as
tests/test_torch_imu.py states them); the rescaled keyframe poses, landmarks,
live frames and logged translations within 1e-4 relative to their scale."""
import numpy as np
import pytest

from orbslam3_tpu.models.map import MapConfig as JMapConfig
from orbslam3_tpu.models.tracking import Tracker as JTracker
from orbslam3_tpu.ops import features as jfeat
from orbslam3_tpu.ops import imu_init as jinit
from orbslam3_tpu_torch.models.tracking import Tracker as TTracker
from orbslam3_tpu_torch.ops import features as tfeat
from orbslam3_tpu_torch.ops import imu_init as tinit
from orbslam3_tpu_torch.utils.convert import map_state_from_arrays, preint_state_from
from test_torch_imu import _close, _jax_init
from torch_port_helpers import (J, N, T, imu_simulation, jax_map_from_arrays,  # noqa: F401
                                torch_threads)

K_CAM = np.asarray([458.0, 458.0, 376.0, 240.0], np.float32)
WH = (752.0, 480.0)
MAP_SCALE = 0.25


def _mono_trackers(n_kf: int, split: float = 1.0):
    """A monocular tracker of each package, IMU enabled, on a map of
    ``simulate``'s first ``n_kf`` keyframes (0.25 s apart; the map at
    MAP_SCALE of the metric scale, gravity tilted) with 60 landmarks, the
    chain of keyframe preintegrations, a last and a current frame and a
    logged trajectory. ``split`` multiplies the map positions of the
    keyframes from the middle on (a scale jump of the visual map, which the
    two halves of the chain then disagree on)."""
    from orbslam3_tpu.models.frame import Frame as JFrame
    from orbslam3_tpu_torch.models.frame import Frame as TFrame
    R_map, p_map, preints, Rwg, _, _, _, _ = imu_simulation(n_kf=n_kf, scale=MAP_SCALE)
    p_map = p_map.copy()
    p_map[n_kf // 2:] = p_map[n_kf // 2] + split * (p_map[n_kf // 2:] - p_map[n_kf // 2])
    cfg = JMapConfig(max_keyframes=32, max_map_points=512,
                     n_features=jfeat.OrbConfig(n_features=128).total_capacity)
    from orbslam3_tpu.models.map import MapState as JMap
    m = JMap(cfg)
    cap = cfg.n_features
    rng = np.random.default_rng(1)
    for k in range(n_kf):
        R = R_map[k].T
        m.add_keyframe(R, (-R @ p_map[k]).astype(np.float32), ts=0.25 * k, frame_id=5 * k,
                       xy=rng.uniform(0, 700, (cap, 2)).astype(np.float32),
                       angle=np.zeros(cap, np.float32), octave=np.zeros(cap, np.int32),
                       desc=rng.integers(0, 2 ** 32, (cap, 8), dtype=np.uint32),
                       fvalid=np.ones(cap, bool))
    pts = rng.normal(0, 2.0, (60, 3)).astype(np.float32)
    m.add_map_points(pts, rng.integers(0, 2 ** 32, (60, 8), dtype=np.uint32), 0,
                     np.tile(np.float32([0, 0, 1]), (60, 1)), np.full(60, 0.1, np.float32),
                     np.full(60, 30.0, np.float32))
    R_l, t_l = m.kf_R[n_kf - 1].copy(), m.kf_t[n_kf - 1].copy()
    traj = [(0.25 * k, k, np.eye(3, dtype=np.float32),
             rng.normal(0, 0.1, 3).astype(np.float32), False) for k in range(n_kf)]
    out = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            tr = JTracker(K_CAM, None, WH, jfeat.OrbConfig(n_features=128),
                          jax_map_from_arrays(vars(m), cfg))
            Frame, kf_pre = JFrame, {k: preints[k - 1] for k in range(1, n_kf)}
        else:
            tr = TTracker(K_CAM, None, WH, tfeat.OrbConfig(n_features=128),
                          map_state_from_arrays(vars(m), cfg), device="cpu")
            Frame = TFrame
            kf_pre = {k: preint_state_from(preints[k - 1], device="cpu") for k in range(1, n_kf)}
        tr.enable_imu(freq=200.0)
        tr.kf_preints = kf_pre
        tr.trajectory = [(a, b, c.copy(), d.copy(), e) for a, b, c, d, e in traj]
        z = np.zeros((1, 2), np.float32)
        for name, dt in (("last_frame", 0.0), ("current_frame", 0.05)):
            f = Frame(99, 0.25 * (n_kf - 1) + dt, xy=z, angle=z[:, 0], octave=z[:, 0],
                      desc=np.zeros((1, 8), np.uint32), valid=np.ones(1, bool),
                      response=z[:, 0], dev=None, R=R_l.copy(), t=(t_l + dt).copy())
            setattr(tr, name, f)
        tr.velocity = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        out[pkg] = tr
    return out, Rwg


def _scaled_close(a, b, rel=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1.0), np.abs(a - b).max()


@pytest.mark.parametrize("case", ["initializes", "time_span_gate", "split_sample_gate"])
def test_try_imu_init_monocular_matches_jax(case, monkeypatch):
    """13 keyframes (3 s of travel) initialize: the scale is observed, the
    map, the live frames and the logged translations are rescaled and
    gravity-aligned, and the world epoch moves; 9 keyframes (2 s) stop at
    the 2.2 s gate; 13 keyframes whose visual map jumps in scale halfway
    stop at the split-sample gate (they pass without it)."""
    n_kf = 9 if case == "time_span_gate" else 13
    trs, _ = _mono_trackers(n_kf, split=4.0 if case == "split_sample_gate" else 1.0)
    monkeypatch.setattr(jinit, "inertial_init", _jax_init)
    ok = {pkg: tr.try_imu_init() for pkg, tr in trs.items()}
    j, t = trs["jax"], trs["torch"]
    assert ok["torch"] == ok["jax"] == (case == "initializes"), ok
    if case == "split_sample_gate":
        for tr in trs.values():
            tr.p.gate_init_split = False
        assert trs["torch"].try_imu_init() and trs["jax"].try_imu_init()
        return
    if case == "time_span_gate":
        assert not t.imu_initialized and t.world_epoch == 0
        return
    assert t.imu_initialized and t.world_epoch == j.world_epoch == 1
    assert t.imu_init_ts == j.imu_init_ts
    mj, mt = j.map, t.map
    n = n_kf
    c_t = np.stack([-mt.kf_R[k].T @ mt.kf_t[k] for k in range(n)])
    c_j = np.stack([-mj.kf_R[k].T @ mj.kf_t[k] for k in range(n)])
    _scaled_close(c_t, c_j)
    _scaled_close(mt.kf_R[:n], mj.kf_R[:n])
    _scaled_close(mt.mp_xyz[:60], mj.mp_xyz[:60])
    _scaled_close(mt.kf_vel[:n], mj.kf_vel[:n], 1e-3)
    np.testing.assert_allclose(mt.kf_bias_g[:n], mj.kf_bias_g[:n], rtol=0, atol=1e-5)
    np.testing.assert_allclose(mt.kf_bias_a[:n], mj.kf_bias_a[:n], rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.imu_bias_g, j.imu_bias_g, rtol=0, atol=1e-5)
    _scaled_close(t.velocity_w, j.velocity_w, 1e-3)
    for name in ("last_frame", "current_frame"):
        _scaled_close(getattr(t, name).R, getattr(j, name).R)
        _scaled_close(getattr(t, name).t, getattr(j, name).t)
    for et, ej in zip(t.trajectory, j.trajectory):
        assert et[1] == ej[1]
        _scaled_close(et[3], ej[3])
    assert t.velocity is None and t.pose_prior_H is None
    # the world is gravity-aligned: gravity in keyframe 0's body frame is
    # the simulation's (simulate's map frame has gravity along its -z)
    g_body = mt.kf_R[0] @ np.array([0.0, 0.0, 1.0])
    g_body_true = imu_simulation(n_kf=n_kf, scale=MAP_SCALE)[0][0].T @ np.array([0.0, 0.0, 1.0])
    assert np.abs(g_body - g_body_true).max() < 0.02, (g_body, g_body_true)
    # the metric scale is recovered (the map was at a quarter of it): the
    # rescaled path length is the true one within 10% (5.1% here)
    true_len = np.linalg.norm(np.diff(imu_simulation(n_kf=n_kf, scale=1.0)[1], axis=0),
                              axis=1).sum()
    got_len = np.linalg.norm(np.diff(c_t, axis=0), axis=1).sum()
    assert abs(got_len / true_len - 1) < 0.1, (got_len, true_len)


def test_inertial_init_with_the_monocular_priors_matches_jax():
    """inertial_init as the monocular first init calls it: the scale free,
    prior_a = 1e10, 40 iterations, on the quarter-scale map: the scale within
    1e-3 relative of JAX's and of the truth within 10%, the gravity rotation
    within 1e-4."""
    from test_torch_imu import _stack
    R_map, p_map, preints, _, scale_gt, _, _, _ = imu_simulation(n_kf=13, scale=MAP_SCALE)
    names = ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa")
    arrs = [_stack(preints, a) for a in names]
    cov = np.stack([np.asarray(s.C, np.float32)[:9, :9] for s in preints])
    valid = np.ones(len(R_map) - 1, bool)
    kw = dict(opt_scale=True, iters=40, prior_g=1e2, prior_a=1e10)
    rj = _jax_init(J(R_map), J(p_map), *[J(a) for a in arrs], J(valid), cov=J(cov), **kw)
    rt = tinit.inertial_init(T(R_map), T(p_map), *[T(a) for a in arrs], T(valid),
                             cov=T(cov), **kw)
    assert abs(float(rt.scale) - float(rj.scale)) <= 1e-3 * float(rj.scale)
    # the accelerometer bias pinned at 0 by the prior leaves the scale 5.1% low
    # in both packages
    assert abs(float(rt.scale) - scale_gt) / scale_gt < 0.1, (float(rt.scale), scale_gt)
    assert np.abs(N(rt.Rwg) - N(rj.Rwg)).max() < 1e-4
    _close(rt.bg, rj.bg, rel=1e-3, floor=1e-5)
    _close(rt.vels, rj.vels, rel=1e-3)
    # and the rescale it drives, at that scale
    rng = np.random.default_rng(2)
    pts = rng.normal(0, 2, (30, 3)).astype(np.float32)
    R_cw = R_map.transpose(0, 2, 1)
    t_cw = -np.einsum("kij,kj->ki", R_cw, p_map)
    oj = jinit.apply_scaled_rotation(J(R_cw), J(t_cw), J(pts), J(N(rj.Rwg).T),
                                     J(np.float32(float(rj.scale))))
    ot = tinit.apply_scaled_rotation(T(R_cw), T(t_cw), T(pts), T(N(rj.Rwg).T),
                                     T(np.float32(float(rj.scale))))
    for a, b in zip(oj, ot):
        _close(a, b, rel=1e-6)
