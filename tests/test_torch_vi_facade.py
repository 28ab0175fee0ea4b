"""The visual-inertial facade on the CPU, the port against the JAX package:
``enable_imu`` binds the mapper's inertial back references and
``_on_bad_imu`` resets the active map; monocular-inertial
(``SlamSystem.track_monocular_inertial``, ``enable_imu`` on a monocular
rig) preintegrates every frame; the inertial RGB-D and fisheye-rig front
ends preintegrate and, on a seeded initialized IMU, track through the fused
visual-inertial step (``torch_port_helpers.inertial_front_end_runs``); the
inertial post-loop BA (FullInertialBA after a loop correction) runs inline
and in the background global BA's thread; the viewer still raises
NotImplementedError naming its ROADMAP item.

Tolerances: the frame preintegrations 1e-6 (1e-6 relative for the
covariance); the poses of the frames on the seeded inertial state 1e-4 (one
fused step each, as tests/test_torch_vi_fused.py holds it); the inertial
BAs' state vi_joint_ba's of tests/test_torch_vi_ba.py (poses 1e-3,
velocities 5e-3)."""
import numpy as np
import pytest

from orbslam3_tpu_torch.models.system import SlamSystem
from torch_port_helpers import torch_threads  # noqa: F401

K = np.array([458.654, 457.296, 376.0, 240.0], np.float32)


def _system(**kw):
    return SlamSystem(K, None, (752, 480), n_features=256, device="cpu", **kw)


MI_PREINT_FRAMES = 3
KB8_FRAMES = 5


def _preint_close(t, j):
    assert (t is None) == (j is None)
    if t is None:
        return
    for k in ("dT", "dR", "dV", "dP"):
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(t["C"], j["C"], rtol=1e-6, atol=1e-12)


def test_track_monocular_inertial_matches_jax():
    """enable_imu on a monocular rig and track_monocular_inertial: the first
    frames of tests/test_e2e_inertial.py's fixture in both packages, the
    frame preintegration and the since-keyframe block after each."""
    from torch_port_helpers import _mono_inertial_system, mono_inertial_inputs
    scene, _, frames, streams = mono_inertial_inputs(MI_PREINT_FRAMES)
    out = {}
    for pkg in ("jax", "torch"):
        s = _mono_inertial_system(pkg, scene, False, 512)
        assert s.tracker.imu_enabled and s.mapper.preserve_temporal_chain
        imu_ts, gyro, acc = streams[pkg]
        rec = []
        for i in range(MI_PREINT_FRAMES):
            s0, s1 = max(i - 1, 0) * 10, i * 10
            s.track_monocular_inertial(frames[i], ts=i / 20.0, imu_ts=imu_ts[s0:s1],
                                       imu_gyro=gyro[s0:s1], imu_acc=acc[s0:s1])
            tr = s.tracker
            rec.append([None if p is None else {k: np.array(getattr(p, k)) for k in
                                                ("dT", "dR", "dV", "dP", "C")}
                        for p in (tr.frame_preint, tr.preint_since_kf)] + [tr.state.name])
        out[pkg] = rec
    for i, (t, j) in enumerate(zip(out["torch"], out["jax"])):
        assert t[2] == j[2], (i, t[2], j[2])
        for a, b in zip(t[:2], j[:2]):
            _preint_close(a, b)
    assert out["torch"][-1][0] is not None


def test_kb8_monocular_inertial_matches_jax():
    """Monocular-inertial with a KB8 camera (``cam_type=1``: keypoints stay
    raw, every projection goes through the model): tests/test_e2e_fisheye.py's
    monocular orbit at 512x512 with its IMU stream, its first KB8_FRAMES
    frames in both packages: the frame preintegrations, and both initialized
    and tracking at the end."""
    from conftest import dense_tracking_params
    from orbslam3_tpu.models.system import SlamSystem as JaxSlam
    from orbslam3_tpu.utils.datasets import RoomScene, orbit_trajectory
    from orbslam3_tpu_torch.models.tracking import TrackingParams
    from orbslam3_tpu_torch.utils.convert import config_from
    from torch_port_helpers import KB8, orbit_imu_stream, render_all
    scene = RoomScene(seed=6, depth=6.0, half_w=4.0, half_h=2.5, h=512, w=512,
                      fx=190.978, fy=190.973, cx=256.0, cy=256.0)
    scene.kb8_params = KB8
    frames = render_all(scene, orbit_trajectory(KB8_FRAMES, radius=0.6, forward=0.03))
    imu_ts, gyro, acc, _ = orbit_imu_stream(0.6, 0.03, KB8_FRAMES)
    jparams = dense_tracking_params()
    kw = dict(n_features=512, seed=0, cam_type=1, enable_loop_closing=False)
    out = {}
    for pkg, s in (("jax", JaxSlam(KB8, None, (512, 512), tracking_params=jparams, **kw)),
                   ("torch", SlamSystem(KB8, None, (512, 512), device="cpu",
                                        tracking_params=config_from(jparams, TrackingParams),
                                        **kw))):
        s.enable_imu(freq=200)
        rec = []
        for i in range(KB8_FRAMES):
            s0, s1 = max(i - 1, 0) * 10, i * 10
            s.track_monocular_inertial(frames[i], ts=i / 20.0, imu_ts=imu_ts[s0:s1],
                                       imu_gyro=gyro[s0:s1], imu_acc=acc[s0:s1])
            fp = s.tracker.frame_preint
            rec.append((None if fp is None else {k: np.array(getattr(fp, k)) for k in
                                                 ("dT", "dR", "dV", "dP", "C")},
                        s.tracker.state.name))
        out[pkg] = rec
    states = {pkg: [st for _, st in rec] for pkg, rec in out.items()}
    assert states["torch"][-1] == states["jax"][-1] == "OK", states
    # the two-view bootstrap parts on pyramid rounding (the JAX package
    # initializes on frame 3, the port on frame 4): within 2 frames, as
    # tests/test_torch_e2e_fisheye_mono.py holds the tracked frames
    assert abs(states["torch"].index("OK") - states["jax"].index("OK")) <= 2, states
    for (pt, _), (pj, _) in zip(out["torch"], out["jax"]):
        _preint_close(pt, pj)


@pytest.fixture(scope="module", params=["rgbd", "rig"])
def front_end(request):
    import gc
    import jax
    from torch_port_helpers import inertial_front_end_runs
    yield request.param, inertial_front_end_runs(request.param)
    jax.clear_caches()
    gc.collect()


def test_inertial_front_end_preintegrates_like_jax(front_end):
    """The inertial RGB-D and fisheye-rig front ends preintegrate every frame
    as the JAX package's do (both packages on their own features)."""
    kind, r = front_end
    j, t = r["jax"], r["torch"]
    assert t["states"] == j["states"][: len(t["states"])], kind
    for a, b in zip(t["preint"], j["preint"]):
        _preint_close(a, b)
    assert t["preint"][0] is None and t["preint"][-1] is not None


def test_inertial_front_end_rides_the_fused_vi_step(front_end):
    """On a seeded initialized IMU the port, handed the JAX package's state,
    tracks every frame through the fused visual-inertial step with the JAX
    package's poses."""
    from torch_port_helpers import IFE_PRE, IFE_VI
    kind, r = front_end
    j, h = r["jax"], r["handoff"]
    fused = [b - a for a, b in zip([j["fused_vi"][IFE_PRE - 1]] + h["fused_vi"][:-1],
                                   h["fused_vi"])]
    assert sum(fused) >= 3 and h["fused_vi"][-1] == j["fused_vi"][-1] - j["fused_vi"][
        IFE_PRE - 1], (kind, h["fused_vi"], j["fused_vi"])
    assert h["states"] == j["states"][IFE_PRE:] == ["OK"] * IFE_VI, kind
    for i, (pt, pj) in enumerate(zip(h["poses"], j["poses"][IFE_PRE:])):
        np.testing.assert_allclose(pt[0], pj[0], rtol=0, atol=1e-4, err_msg=f"{kind} {i}")
        np.testing.assert_allclose(pt[1], pj[1], rtol=0, atol=1e-4, err_msg=f"{kind} {i}")
    for a, b in zip(h["preint"], j["preint"][IFE_PRE:]):
        _preint_close(a, b)
    for key in ("mapper_errors", "gba_errors"):
        assert h["stats"].get(key, 0) == 0


def test_inertial_post_loop_ba_matches_jax():
    """An IMU-initialized map's post-loop global pass is FullInertialBA(7)
    inline (sync) and FullInertialBA in two chunks in the background global
    BA's thread (async), in both packages, on a stereo system."""
    import chip_smoke as cs
    from test_torch_vi_loop_merge import PACKAGES
    sim = cs.vlm_simulation(n_kf=6)
    out = {}
    for pkg, (cls, cfg, pre, extra, gba_cls, _) in PACKAGES.items():
        s = cs.vlm_system(sim, cls, cfg, pre, bf=0.11 * 458.0, th_depth=4.4, **extra)
        assert s.run_post_loop_gba(5) is True
        gba = gba_cls(s)
        gba.start()
        gba.join(300.0)
        st = s.mapper.stats
        assert st.get("vi_ba_runs", 0) == 3 and st.get("gba_runs", 0) == 0, (pkg, st)
        assert st.get("gba_errors", 0) == 0, (pkg, st.get("last_gba_error"))
        m = s.map
        out[pkg] = (m.kf_R[:6].copy(), m.kf_t[:6].copy(), m.kf_vel[:6].copy(),
                    getattr(gba, "applied", None))
    assert out["torch"][3] is True
    for a, b, atol in zip(out["torch"][:3], out["jax"][:3], (1e-3, 1e-3, 5e-3)):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def test_the_viewer_still_raises():
    """``use_viewer=True`` on an inertial system: the live viewer serves the
    page and the state on a free port, and shutdown closes it."""
    import urllib.request
    s = _system(use_viewer=True, viewer_port=0)
    s.enable_imu(freq=200.0)
    base = f"http://127.0.0.1:{s.viewer.port}"
    assert b"live viewer" in urllib.request.urlopen(base + "/", timeout=20).read()
    assert b"n_keyframes" in urllib.request.urlopen(base + "/state", timeout=20).read()
    s.shutdown(print_times=False)
    assert s.viewer is None


def test_enable_imu_and_on_bad_imu_match_jax():
    """enable_imu binds the mapper (inertial back reference, the temporal
    chain kept in culling, the bad-IMU hook); a bad-IMU verdict resets the
    active map: flags off, a new empty map
    under the same id with the mapper rebound to it, as in the JAX package."""
    from orbslam3_tpu.models.system import SlamSystem as JaxSlam
    out = {}
    for name, cls, kw in (("jax", JaxSlam, {}), ("torch", SlamSystem, {"device": "cpu"})):
        s = cls(K, None, (752, 480), n_features=256, bf=0.11 * 458.654, th_depth=4.4, **kw)
        s.enable_imu(freq=200.0)
        assert s.mapper.inertial is s.tracker and s.mapper.preserve_temporal_chain
        tr = s.tracker
        tr.imu_initialized = tr.viba1_done = tr.viba2_done = True
        tr.velocity_w = np.ones(3, np.float32)
        old_map = s.map
        s.mapper.on_bad_imu()
        out[name] = s
        assert s.map is not old_map and s.map.n_kf == 0 and s.map.map_id == old_map.map_id
        assert s.mapper.map is s.map and s.mapper.inertial is tr
        assert s.mapper.on_bad_imu is not None
        assert not (tr.imu_initialized or tr.viba1_done or tr.viba2_done)
        assert tr.velocity_w is None and tr.kf_preints == {} and tr.preint_since_kf is None
        assert tr.state.name == "NOT_INITIALIZED"
    assert out["torch"].tracker.imu_enabled and out["jax"].tracker.imu_enabled
