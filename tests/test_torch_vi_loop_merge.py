"""The inertial loop and merge branches, the port against the JAX package on
the CPU, on tests/test_vi_loop_merge.py's simulated visual-inertial map as
chip_smoke.py builds it for its ``vi_loop_merge`` phase
(``chip_smoke.vlm_simulation``: numpy and the port's so3 maps; 8 keyframes
0.25 s apart, 120 landmarks seen by every keyframe, gravity along the map's
-z). Both packages get the same numpy map and IMU samples and preintegrate
the samples themselves: the post-loop FullInertialBA(7), the background
global BA's inertial branch (applied; the abort honoured before its second
chunk), the Atlas merge's migration of the inertial state, and the 4-DoF
essential graph of an inertial loop closer.

Tolerances: ``vi_joint_ba``'s of tests/test_torch_vi_ba.py (poses 1e-3,
velocities 5e-3, biases 1e-4 / 1e-3); the ground-truth bounds of
tests/test_vi_loop_merge.py; the migrated velocities, biases and parents
1e-6 of JAX's; the essential graph's rotations 1e-4 and translations 1e-3
of JAX's (tests/test_torch_loop_closing.py's 7-DoF bounds) and every
keyframe's gravity direction unchanged to 1e-5 rad."""
import threading

import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
from orbslam3_tpu.models.async_runtime import BackgroundGBA as JGBA
from orbslam3_tpu.models.loop_closing import LoopCloser as JCloser
from orbslam3_tpu.models.map import MapConfig as JMapConfig
from orbslam3_tpu.models.system import SlamSystem as JSlam
from orbslam3_tpu.ops import imu as jimu
from orbslam3_tpu_torch.models.async_runtime import BackgroundGBA as TGBA
from orbslam3_tpu_torch.models.loop_closing import LoopCloser as TCloser
from orbslam3_tpu_torch.models.map import MapConfig as TMapConfig
from orbslam3_tpu_torch.models.system import SlamSystem as TSlam
from torch_port_helpers import J, N, imu_simulation, torch_threads  # noqa: F401

_jax_pre = jax.jit(jimu.preintegrate, static_argnums=(6, 7, 8, 9, 10))


def jax_preintegrate(acc, gyro, dts):
    z = J(np.zeros(3, np.float32))
    return _jax_pre(J(acc), J(gyro), J(dts), J(np.ones(len(dts), bool)), z, z,
                    *cs.VLM_NOISE, 200.0)


PACKAGES = {"jax": (JSlam, JMapConfig, jax_preintegrate, {}, JGBA, JCloser),
            "torch": (TSlam, TMapConfig, cs.port_preintegrate("cpu"), {"device": "cpu"}, TGBA,
                      TCloser)}


@pytest.fixture(scope="module")
def sim():
    return cs.vlm_simulation()


def _system(pkg, sim, **kw):
    cls, cfg, pre, extra = PACKAGES[pkg][:4]
    return cs.vlm_system(sim, cls, cfg, pre, **kw, **extra)


def _close_to_jax(t, j, keys=("kf_R", "kf_t", "kf_vel"), tol=(1e-3, 1e-3, 5e-3)):
    for key, atol in zip(keys, tol):
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=atol, err_msg=key)


def test_simulation_is_build_vi_systems(sim):
    """chip_smoke.vlm_simulation reproduces tests/test_imu_init.py::simulate at
    scale 1 with gravity along -z (the JAX package's so3 maps there): poses,
    velocities and each link's preintegration."""
    R_map, p_map, preints, _, _, bg, ba, v = imu_simulation(n_kf=8, scale=1.0,
                                                            g_tilt=(0.0, 0.0))
    np.testing.assert_allclose(sim["R_cw"], R_map.transpose(0, 2, 1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sim["t_cw"], np.einsum("kji,kj->ki", R_map, -p_map),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(sim["v"], v, rtol=0, atol=1e-5)
    np.testing.assert_allclose(sim["bg"], bg, rtol=0, atol=1e-7)
    np.testing.assert_allclose(sim["ba"], ba, rtol=0, atol=1e-7)
    port = cs.port_preintegrate("cpu")
    for link, want in zip(sim["links"], preints):
        got = port(*link)
        for name, atol in (("dT", 1e-6), ("dR", 1e-5), ("dV", 1e-4), ("dP", 1e-5)):
            np.testing.assert_allclose(N(getattr(got, name)), np.asarray(getattr(want, name)),
                                       rtol=0, atol=atol, err_msg=name)


def test_post_loop_gba_is_full_inertial_ba(sim):
    """run_post_loop_gba on an IMU-initialized map is FullInertialBA(7) with
    zero bias priors in both packages: tests/test_vi_loop_merge.py's bounds,
    and the state within vi_joint_ba's tolerance of JAX's."""
    r = {pkg: cs.vlm_post_loop_gba(_system(pkg, sim), sim) for pkg in PACKAGES}
    for pkg, x in r.items():
        assert x["vi_ba_runs"] >= 1 and x["gba_runs"] == 0, (pkg, x["vi_ba_runs"])
        assert x["t_err"] < 0.4 * x["t_err0"], (pkg, x["t_err"], x["t_err0"])
        assert x["v_err"] < 0.1 * x["v_err0"], (pkg, x["v_err"], x["v_err0"])
        assert x["bg_err"] < 1e-2 and x["ba_err"] < 0.1, pkg
    _close_to_jax(r["torch"], r["jax"], ("kf_R", "kf_t", "kf_vel", "kf_bias_g", "kf_bias_a"),
                  (1e-3, 1e-3, 5e-3, 1e-4, 1e-3))


@pytest.mark.parametrize("abort", [False, True], ids=["runs", "abort_before_second_chunk"])
def test_background_gba_on_an_imu_map(sim, abort):
    """The background global BA's thread on an IMU-initialized map runs
    FullInertialBA in two chunks of 4 iterations with zero bias priors and
    no error; an abort set as the first chunk returns stops it before the
    second, in both packages. The port's run is ``applied`` only when it was
    not aborted, and its state is JAX's within vi_joint_ba's tolerance."""
    r = {}
    for pkg in PACKAGES:
        gba_cls = PACKAGES[pkg][4]
        r[pkg] = cs.vlm_background_gba(_system(pkg, sim), sim, gba_cls, abort_after_first=abort)
    for pkg, x in r.items():
        assert not x["running"] and x["gba_errors"] == 0, (pkg, x["last_gba_error"])
        assert x["vi_ba_runs"] == (1 if abort else 2), (pkg, x["vi_ba_runs"])
        assert x["t_err"] < 0.4 * x["t_err0"] and x["v_err"] < 0.1 * x["v_err0"], (pkg, x)
    assert r["torch"]["applied"] is (not abort)
    _close_to_jax(r["torch"], r["jax"])


def test_merge_migrates_inertial_state(sim):
    """tests/test_vi_loop_merge.py::test_atlas_merge_migrates_inertial_state
    in both packages: velocities rotated into the target world, biases
    copied, right-eye pixels and spanning-tree parents migrated, the
    preintegration chain remapped, the tracker's world velocity rotated."""
    out = {}
    for pkg in PACKAGES:
        sysm = _system(pkg, sim, kfs=range(5))
        atlas, tr = sysm.atlas, sysm.tracker
        cur = atlas.current
        cur.kf_feat_uvr[1, 0] = (12.5, 34.0)
        tr.velocity_w = sim["v"][4].copy()
        pre_before = dict(tr.kf_preints)
        old = atlas.create_new_map()
        atlas.current_idx = atlas.maps.index(cur)
        cap = sysm.orb_cfg.total_capacity
        rng = np.random.default_rng(0)
        for k in range(2):
            old.add_keyframe(np.eye(3, dtype=np.float32), np.asarray([0.1 * k, 0, 0], np.float32),
                             ts=10.0 + 0.25 * k, frame_id=100 + k,
                             xy=rng.uniform(0, 400, (cap, 2)).astype(np.float32),
                             angle=np.zeros(cap, np.float32), octave=np.zeros(cap, np.int32),
                             desc=rng.integers(0, 2 ** 32, (cap, 8), dtype=np.uint32),
                             fvalid=np.ones(cap, bool))
        R_a = cs.vlm_merge_rotation()
        atlas.merge_current_into(old, R_a, np.array([1.0, -2.0, 0.5], np.float32), s_align=1.0)
        kf_map = atlas.last_merge_kf_map
        tr.remap_trajectory_for_merge(kf_map)
        tr.rotate_world_state_for_merge(R_a, 1.0)
        for k_old, k_new in kf_map.items():
            np.testing.assert_allclose(old.kf_vel[k_new], R_a @ sim["v"][k_old], atol=1e-5)
            np.testing.assert_allclose(old.kf_bias_g[k_new], sim["bg"], atol=1e-7)
            np.testing.assert_allclose(old.kf_bias_a[k_new], sim["ba"], atol=1e-7)
        np.testing.assert_allclose(old.kf_feat_uvr[kf_map[1], 0], (12.5, 34.0))
        assert old.kf_parent[kf_map[1]] == kf_map[0] and old.kf_parent[kf_map[0]] == 1
        assert set(tr.kf_preints) == {kf_map[k] for k in pre_before}
        assert all(tr.kf_preints[kf_map[k]] is p for k, p in pre_before.items())
        np.testing.assert_allclose(tr.velocity_w, R_a @ sim["v"][4], atol=1e-5)
        out[pkg] = (kf_map, old.kf_vel[: old.n_kf].copy(), old.kf_parent[: old.n_kf].copy(),
                    tr.velocity_w.copy())
    assert out["torch"][0] == out["jax"][0]
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out["torch"][2], out["jax"][2])
    np.testing.assert_allclose(out["torch"][3], out["jax"][3], rtol=0, atol=1e-6)


def test_four_dof_essential_graph(sim):
    """An inertial loop closer's essential graph (yaw and translation only)
    corrects a yaw drift on the gravity-aligned map: every keyframe's
    gravity direction stays where it was, the keyframes come closer to the
    truth, and poses and landmarks are JAX's."""
    r = {}
    for pkg in PACKAGES:
        closer_cls, extra = PACKAGES[pkg][5], PACKAGES[pkg][3]
        r[pkg] = cs.vlm_essential_graph(_system(pkg, sim), sim, closer_cls, **extra)
    for pkg, x in r.items():
        assert x["tilt_change"] < 1e-5, (pkg, x["tilt_change"])
        # the JAX package: 0.134 -> 0.076 (the covisibility edges, measured on
        # the drifted poses, hold part of the drift)
        assert x["centre_err"] < 0.7 * x["centre_err0"], (pkg, x["centre_err"],
                                                        x["centre_err0"])
    _close_to_jax(r["torch"], r["jax"], ("kf_R", "kf_t", "mp_xyz"), (1e-4, 1e-3, 1e-3))


def test_forward_jacobians_from_three_threads(sim):
    """With the inertial background global BA three threads differentiate in
    forward mode: the tracker's (``lie.jacobian_fwd``, as the fused
    visual-inertial step), the mapper's local inertial BA and the global
    BA's thread. ``lie.FORWARD_AD_LOCK`` takes them one at a time and is
    never held while a thread waits on the map lock or the abort flag: a
    loop closer that takes the map lock and aborts the global BA gets it
    back at once."""
    from orbslam3_tpu_torch.ops import lie as tlie
    mapper_sys, gba_sys = _system("torch", sim), _system("torch", sim)
    errors, jac = [], []
    p = torch.linspace(-0.3, 0.3, 12)

    def fn(q):
        return tlie.so3_log(tlie.so3_exp(q.reshape(q.shape[0], 4, 3))).reshape(q.shape[0], -1)

    def tracker():
        try:
            for _ in range(30):
                jac.append(tlie.jacobian_fwd(fn, p)[1])
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(repr(e))

    def mapper():
        try:
            for _ in range(3):
                mapper_sys.mapper.local_inertial_ba(7)
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(repr(e))
    threads = [threading.Thread(target=tracker), threading.Thread(target=mapper)]
    gba = TGBA(gba_sys)
    gba.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300.0)
    assert not errors, errors[0]
    assert len(jac) == 30 and all(torch.allclose(j, jac[0], atol=1e-6) for j in jac)
    assert mapper_sys.mapper.stats["vi_ba_runs"] == 3
    gba.join(300.0)
    assert not gba.running and gba.applied and gba_sys.mapper.stats.get("gba_errors", 0) == 0
    # a loop closer's abort under the map lock does not wait on the lock
    gba2 = TGBA(gba_sys)
    gba2.start()
    with gba_sys.map.lock:
        gba2.abort()
    gba2.join(300.0)
    assert not gba2.running and gba_sys.mapper.stats.get("gba_errors", 0) == 0
