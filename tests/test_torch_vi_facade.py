"""The visual-inertial facade on the CPU: ``enable_imu`` binds the mapper's
inertial back references, ``_on_bad_imu`` resets the active map as the JAX
package's does, and the paths the port does not have yet raise
NotImplementedError naming their ROADMAP item: monocular-inertial
(``SlamSystem.track_monocular_inertial``, ``enable_imu`` on a monocular
rig), the inertial RGB-D and fisheye-rig front ends, and the inertial
post-loop BA (FullInertialBA after a loop correction, inline and in the
background global BA's thread)."""
import numpy as np
import pytest

from orbslam3_tpu_torch.models.system import SlamSystem
from torch_port_helpers import torch_threads  # noqa: F401

K = np.array([458.654, 457.296, 376.0, 240.0], np.float32)


def _system(**kw):
    return SlamSystem(K, None, (752, 480), n_features=256, device="cpu", **kw)


def test_track_monocular_inertial_raises():
    s = _system()
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*monocular"):
        s.track_monocular_inertial(np.zeros((480, 752), np.float32), 0.0,
                                   np.zeros(0), np.zeros((0, 3)), np.zeros((0, 3)))
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*monocular"):
        s.enable_imu()
    assert not s.tracker.imu_enabled


def test_inertial_rgbd_and_fisheye_rig_raise():
    s = _system(bf=0.11 * 458.654, th_depth=4.4)
    s.enable_imu()
    assert s.tracker.imu_enabled and s.mapper.preserve_temporal_chain
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*visual-inertial"):
        s.track_rgbd(np.zeros((480, 752), np.float32), np.ones((480, 752), np.float32), 0.0)
    f = _system(cam_type=1)
    f.set_fisheye_rig(K, np.eye(3), np.array([-0.1, 0.0, 0.0]))
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*visual-inertial"):
        f.enable_imu()


def test_inertial_post_loop_ba_raises():
    """An IMU-initialized map's post-loop global pass is FullInertialBA(7) in
    the reference package; the port raises inline (sync) and counts the
    error in the background global BA's thread (async)."""
    from orbslam3_tpu_torch.models.async_runtime import BackgroundGBA
    s = _system(bf=0.11 * 458.654, th_depth=4.4)
    s.enable_imu()
    s.tracker.imu_initialized = True
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*visual-inertial"):
        s.run_post_loop_gba(0)
    gba = BackgroundGBA(s)
    gba.start()
    gba.join(60.0)
    assert not gba.running and gba.applied is False
    assert s.mapper.stats["gba_errors"] == 1
    assert "FullInertialBA" in s.mapper.stats["last_gba_error"]


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
