"""Faults of the port's inertial loop and merge branches, each held against
the JAX package on the CPU on chip_smoke.py's simulated visual-inertial map
(``chip_smoke.vlm_simulation``; tests/test_torch_vi_loop_merge.py holds the
simulation against tests/test_vi_loop_merge.py's):

- an Atlas merge (``SlamSystem._merge_with``) rotates and scales the
  tracker's world velocity into the target world
  (``Tracker.rotate_world_state_for_merge``), and so does a relocalization
  into a stored map (``_try_cross_map_reloc``);
- the merge remaps the tracker's preintegration chain (``kf_preints``) to the
  migrated keyframe ids (``remap_trajectory_for_merge``);
- the merge's weld on an IMU-initialized map is the local inertial BA, not
  the visual local BA (``_weld``);
- a propagated global BA's world correction rotates the tracker's world
  velocity (``_on_world_corrected``).

Tolerances: the world velocity, the keyframe ids and the migrated
velocities, biases and parents of the keyframes outside the weld's window
equal JAX's to 1e-6; the welded window within vi_joint_ba's tolerance of
tests/test_torch_vi_ba.py (poses 1e-3, velocities 5e-3, biases 1e-4 /
1e-3)."""
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke as cs
from test_torch_vi_loop_merge import PACKAGES, _system, sim  # noqa: F401
from torch_port_helpers import torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def merged(sim):  # noqa: F811
    out = {}
    for pkg, (cls, cfg, pre, extra) in ((p, v[:4]) for p, v in PACKAGES.items()):
        out[pkg] = cs.vlm_merge(sim, cls, cfg, pre, **extra)
    return out


def test_merge_rotates_the_world_velocity(merged):
    t, j = merged["torch"], merged["jax"]
    assert t["ok"] and j["ok"]
    assert t["kf_map"] == j["kf_map"] == {k: 8 + k for k in range(5)}
    np.testing.assert_allclose(t["velocity_w"], j["velocity_w"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t["velocity_w"], t["velocity_expect"], rtol=0, atol=1e-5)


def test_merge_remaps_the_preintegration_chain(merged):
    t, j = merged["torch"], merged["jax"]
    assert t["preint_keys"] == j["preint_keys"] == t["preint_keys_expect"] == [9, 10, 11, 12]
    assert t["preints_kept"] and j["preints_kept"]
    assert t["traj_keys"] == j["traj_keys"] == [8, 9, 10, 11, 12]
    # the migrated keyframes the weld's window does not reach (ids above the
    # welded keyframe 10) keep the migrated inertial state exactly
    for key in ("kf_vel", "kf_bias_g", "kf_bias_a"):
        np.testing.assert_allclose(t[key][11:], j[key][11:], rtol=0, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(t["kf_parent"], j["kf_parent"])


def test_weld_is_the_local_inertial_ba(merged):
    t, j = merged["torch"], merged["jax"]
    assert t["vi_ba_runs"] == j["vi_ba_runs"] == 1, (t["vi_ba_runs"], j["vi_ba_runs"])
    assert t["ba_runs"] == j["ba_runs"] == 0, (t["ba_runs"], j["ba_runs"])
    for key, atol in (("kf_R", 1e-3), ("kf_t", 1e-3), ("kf_vel", 5e-3), ("kf_bias_g", 1e-4),
                      ("kf_bias_a", 1e-3)):
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=atol, err_msg=key)


def test_world_correction_rotates_the_velocity(sim):  # noqa: F811
    from orbslam3_tpu_torch.ops import lie
    import torch
    R_rel = lie.so3_exp(torch.tensor([0.02, -0.01, 0.3])).numpy()
    t_rel = np.array([0.1, 0.2, -0.05], np.float32)
    v = np.array([0.4, -0.2, 0.1], np.float32)
    out = {}
    for pkg in PACKAGES:
        sysm = _system(pkg, sim, kfs=range(3))
        sysm.tracker.velocity_w = v.copy()
        sysm.tracker.last_frame = SimpleNamespace(R=np.eye(3, dtype=np.float32),
                                                  t=np.zeros(3, np.float32))
        sysm._on_world_corrected(R_rel, t_rel)
        out[pkg] = (sysm.tracker.velocity_w.copy(), sysm.tracker.last_frame)
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["torch"][0], R_rel.T @ v, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["torch"][1].R, out["jax"][1].R, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["torch"][1].t, out["jax"][1].t, rtol=0, atol=1e-6)


def test_cross_map_relocalization_rotates_the_velocity(sim):  # noqa: F811
    """A relocalization into a stored map merges the current map into it
    with the rigid alignment of the frame's two poses; the world velocity
    follows (the relocalization itself is stood in for: it puts the frame
    at stored keyframe 4, the place of current keyframe 4)."""
    R_a = cs.vlm_merge_rotation()
    R_w = R_a.T
    t_w = (-R_a.T @ np.asarray(cs.VLM_SHIFT, np.float32)).astype(np.float32)
    out = {}
    for pkg, (cls, cfg, pre, extra) in ((p, v[:4]) for p, v in PACKAGES.items()):
        sysm = cs.vlm_system(sim, cls, cfg, pre, kfs=range(5), R_w=R_w, t_w=t_w, **extra)
        old = cs.vlm_system(sim, cls, cfg, pre, ts0=20.0, **extra).map
        cur = sysm.map
        sysm.atlas.maps = [old, cur]
        sysm.atlas.current_idx = 1
        sysm._bind_map(cur)
        tr = sysm.tracker
        tr.velocity_w = (R_w @ sim["v"][4]).astype(np.float32)
        tr.last_frame = SimpleNamespace(R=cur.kf_R[4].copy(), t=cur.kf_t[4].copy())

        def reloc(frame, in_map=None, _old=old):
            frame.R, frame.t = _old.kf_R[4].copy(), _old.kf_t[4].copy()
            return in_map is _old
        tr._relocalize = reloc
        assert sysm._try_cross_map_reloc(SimpleNamespace(R=None, t=None))
        assert sysm.map is old and sysm.atlas.merges == 1
        out[pkg] = tr.velocity_w.copy()
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["torch"], sim["v"][4], rtol=0, atol=1e-5)
