"""The port's visual-inertial tracking and mapping steps against the JAX
package's on one frozen IMU-initialized state, on the CPU:
``kernels.fused_track_vi_pooled`` (for a stereo rig and, at ``bf = 0``,
a monocular one, whose frames carry no right coordinate), the tracker's ``_track_with_prediction``
and ``_track_recently_lost_imu`` (through ``_optimize_frame_pose_vi`` and the
pooled visual solve), and ``LocalMapper._inertial_stage`` through VIBA1,
VIBA2, the monocular scale refinement (``bf = 0``) and the bad-IMU reset.

The state: rendered RoomScene(seed=1) orbit frames with the JAX extractor's
features (``room_frames``), a map of their first keyframes with points from
the true depth (``build_reference_map``), and a synthetic 200 Hz IMU stream
consistent with the true poses (gravity along the map's -z): its
preintegrations link consecutive frames and keyframes. The port receives
the map through ``map_state_from_arrays``, the preintegrations through
``preint_state_from`` and the tracker's inertial state through
``tracker_inertial_state_from``.

Tolerances: integer words, match indices, inlier and frustum bits and
outlier erasures bit-equal; poses 1e-4 (one frame) or 1e-3 (a whole-map BA
of 8-12 iterations); velocities 1e-3 / 5e-3; biases 1e-5 / 1e-4; H_marg 1e-3
of its largest entry; landmarks 1e-2 plus 1% of their distance (without
the right-eye rows, bf = 0, far points move along their rays)."""
import gc
import types

import jax
import numpy as np
import pytest

from orbslam3_tpu.models import device_map as jdm
from orbslam3_tpu.models import kernels as jk
from orbslam3_tpu.ops import imu as jimu
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu_torch.models import device_map as tdm
from orbslam3_tpu_torch.models import kernels as tk
from orbslam3_tpu_torch.utils.convert import (map_state_from_arrays, preint_state_from,
                                              tracker_inertial_state_from)
from torch_port_helpers import (J, N, T, build_reference_map, jax_map_from_arrays,  # noqa: F401
                                room_frames, torch_threads)

K = (458.654, 457.296, 376.0, 240.0)
WH = (752.0, 480.0)
BF = 0.11 * 458.654
CC = 1024
DT = 0.05            # room_frames' keyframe spacing (build_reference_map)
G = np.array([0.0, 0.0, -9.81])
NOISE = (1.7e-4, 2e-3, 1e-5, 1e-4)
_pre_jit = jax.jit(jimu.preintegrate, static_argnums=(6, 7, 8, 9, 10))


def _center(f):
    return -f["R"].T @ f["t"]


def _synth_preint(fa, fb, n=10):
    """The preintegration of a constant-velocity, constant-rate motion from
    frame ``fa``'s true pose to ``fb``'s over DT (JAX package)."""
    R_a = fa["R"].T.astype(np.float64)
    R_b = fb["R"].T.astype(np.float64)
    w = np.asarray(jlie.so3_log(J((R_a.T @ R_b).astype(np.float32))), np.float64) / DT
    acc, gyro = [], []
    for k in range(n):
        Rk = R_a @ np.asarray(jlie.so3_exp(J((w * k * DT / n).astype(np.float32))), np.float64)
        acc.append(Rk.T @ (-G))
        gyro.append(w)
    return _pre_jit(J(np.float32(acc)), J(np.float32(gyro)), J(np.full(n, DT / n, np.float32)),
                    J(np.ones(n, bool)), J(np.zeros(3, np.float32)), J(np.zeros(3, np.float32)),
                    *NOISE, 200.0)


@pytest.fixture(scope="module")
def state():
    _, frames = room_frames()
    mref = build_reference_map(frames, n_kf=6)
    pre = [_synth_preint(frames[i], frames[i + 1]) for i in range(len(frames) - 1)]
    vel = [((_center(frames[i + 1]) - _center(frames[i])) / DT).astype(np.float32)
           for i in range(len(frames) - 1)]
    for k in range(mref.n_kf):
        mref.kf_vel[k] = vel[min(k, len(vel) - 1)]
        # a stereo rig: every keyframe's right coordinates from the true depth
        mref.kf_feat_ur[k] = _ur(frames[k])
    return frames, mref, pre, vel


def _feats(f, torch_side, ur=None):
    conv = T if torch_side else J
    out = [conv(f[k]) for k in ("xy", "desc", "octave", "valid")]
    return out + ([conv(ur)] if ur is not None else [])


def _ur(f):
    """The virtual right coordinate of each keypoint from the true depth."""
    xy = f["xy"]
    ij = np.clip(np.round(xy).astype(int), 0, [f["depth"].shape[1] - 1, f["depth"].shape[0] - 1])
    z = f["depth"][ij[:, 1], ij[:, 0]]
    ok = f["valid"] & (z > 0.3)
    return np.where(ok, xy[:, 0] - BF / np.maximum(z, 1e-6), -1.0).astype(np.float32)


def _vi_state(f_prev, v, prior):
    st = np.empty(247, np.float32)
    R1_wb = f_prev["R"].T
    st[0:9] = R1_wb.reshape(-1)
    st[9:12] = -R1_wb @ f_prev["t"]
    st[12:15] = v
    st[15:21] = 0.0
    st[21:246] = prior.reshape(-1)
    st[246] = 3e-4
    return st


def _ids(m, kf, cl):
    last = np.unique(m.kf_feat_mp[kf][m.kf_feat_mp[kf] >= 0])
    loc = np.setdiff1d(m.valid_mp_ids(), last)[:CC]
    ids = np.full(cl + CC, -1, np.int32)
    ids[: len(last)] = last[:cl]
    ids[cl: cl + len(loc)] = loc
    return ids


@pytest.fixture
def clear_jax_after():
    """The JAX package's fused visual-inertial step is among its largest
    programs; its compiled programs go with the test that builds it (as the
    JAX package's own tests/test_vi_fused.py does)."""
    yield
    jax.clear_caches()
    gc.collect()


def test_fused_track_vi_pooled_matches_jax(state, clear_jax_after):
    """Frame 3 tracked from keyframe 2's state through the 2→3
    preintegration: first with the previous state anchored rigidly (the
    dispatch's 1e10·I), then with the marginal prior that first solve
    returns (the carried ConstraintPoseImu)."""
    frames, mref, pre, vel = state
    mport = map_state_from_arrays(vars(mref), mref.cfg)
    cl = len(frames[0]["valid"])
    args = (0, 8, 1.2, K, WH, BF, 8.0, 3.0, 0.9, 0.8, 100, NOISE[2], NOISE[3])
    ids = _ids(mref, 2, cl)
    f = frames[3]
    ur = _ur(f)
    mpf_j, mpu_j = jdm.DeviceMapMirror().sync(mref)
    mpf_t, mpu_t = tdm.DeviceMapMirror("cpu").sync(mport)
    jfn = jk.fused_track_vi_pooled(*args)
    tfn = tk.fused_track_vi_pooled(*args, device="cpu")
    prior = 1e10 * np.eye(15, dtype=np.float32)
    nw_f = (CC + 31) // 32
    tail = 14 + 2 * cl + nw_f + (cl + 31) // 32
    for case in ("rigid", "carried"):
        st = _vi_state(frames[2], vel[2], prior)
        want = np.asarray(jfn(J(st), J(ids), mpf_j, mpu_j, *_feats(f, False, ur), pre[2], cl=cl))
        got = N(tfn(T(st), T(ids), mpf_t, mpu_t, *_feats(f, True, ur),
                    preint_state_from(pre[2]), cl=cl))
        assert got.dtype == np.int32 and got.shape == want.shape == (tail + 234,)
        np.testing.assert_allclose(got[:12].view(np.float32), want[:12].view(np.float32),
                                   rtol=0, atol=1e-4, err_msg=case)
        # n1, n_inl, both assignments, the frustum and inlier bits
        np.testing.assert_array_equal(got[12:tail], want[12:tail], err_msg=case)
        assert want[13] > 100, "the frame must actually track"
        vj, vt = want[tail:].view(np.float32), got[tail:].view(np.float32)
        np.testing.assert_allclose(vt[0:3], vj[0:3], rtol=0, atol=1e-3, err_msg=case)
        np.testing.assert_allclose(vt[3:9], vj[3:9], rtol=0, atol=1e-5, err_msg=case)
        Hj, Ht = vj[9:].reshape(15, 15), vt[9:].reshape(15, 15)
        assert np.isfinite(Ht).all()
        assert np.abs(Ht - Hj).max() <= 1e-3 * np.abs(Hj).max(), case
        prior = Hj


def _frame_pair(pkg, f, fid, ts, feat_mp=None, R=None, t=None, tracked=False):
    """A Frame of either package holding ``f``'s JAX features (device and
    host), its depth-derived right coordinates, and an optional pose and
    assignment."""
    if pkg == "jax":
        from orbslam3_tpu.models.frame import Frame
        from orbslam3_tpu.ops.features import OrbFeatures
        dev = OrbFeatures(**{k: J(f[k]) for k in OrbFeatures._fields})
    else:
        from orbslam3_tpu_torch.models.frame import Frame
        from orbslam3_tpu_torch.ops.features import OrbFeatures
        dev = OrbFeatures(**{k: T(f[k]) for k in OrbFeatures._fields})
    fr = Frame(fid, ts, xy=f["xy"], angle=f["angle"], octave=f["octave"], desc=f["desc"],
               valid=f["valid"], response=f["response"], dev=dev,
               R=None if R is None else R.copy(), t=None if t is None else t.copy(),
               feat_mp=None if feat_mp is None else feat_mp.copy(), ur=_ur(f),
               tracked=tracked)
    ur = fr.ur
    fr.depth = np.where(ur >= 0, BF / np.maximum(f["xy"][:, 0] - ur, 1e-6), -1.0).astype(
        np.float32)
    return fr


def _trackers(state):
    """A tracker of each package on copies of the frozen map, IMU-initialized
    at keyframe 2 with the 2→3 frame preintegration: the JAX tracker's
    inertial state is set by hand, the port's carried across."""
    from orbslam3_tpu.models.tracking import Tracker as JTracker, TrackState as JS
    from orbslam3_tpu.ops.features import OrbConfig as JOrb
    from orbslam3_tpu_torch.models.tracking import Tracker as TTracker, TrackState as TS
    from orbslam3_tpu_torch.ops.features import OrbConfig as TOrb
    frames, mref, pre, vel = state
    K4 = np.asarray(K, np.float32)
    jm = jax_map_from_arrays(vars(mref), mref.cfg)
    tm = map_state_from_arrays(vars(mref), mref.cfg)
    jt = JTracker(K4, None, (752, 480), JOrb(n_features=512), jm, bf=BF, th_depth=0.11 * 40)
    tt = TTracker(K4, None, (752, 480), TOrb(n_features=512), tm, bf=BF, th_depth=0.11 * 40,
                  device="cpu")
    jt.imu_enabled = True
    jt.imu_initialized = True
    jt.velocity_w = vel[2].copy()
    jt.frame_preint = pre[2]
    jt.kf_preints = {k: pre[k - 1] for k in range(1, mref.n_kf)}
    tracker_inertial_state_from(jt, tt)
    for tr, pkg, S in ((jt, "jax", JS), (tt, "torch", TS)):
        f2 = frames[2]
        tr.last_frame = _frame_pair(pkg, f2, 2, 2 * DT, feat_mp=mref.kf_feat_mp[2],
                                    R=f2["R"], t=f2["t"], tracked=True)
        tr.ref_kf = 2
        tr.state = S.OK
        tr.n_frames = 4
    return jt, tt


def _compare_tracked(jt, tt, fj, ft, ok_j, ok_t):
    assert ok_t == ok_j
    np.testing.assert_allclose(ft.R, fj.R, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ft.t, fj.t, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ft.feat_mp, fj.feat_mp)
    np.testing.assert_allclose(tt.velocity_w, jt.velocity_w, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tt.imu_bias_g, jt.imu_bias_g, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt.imu_bias_a, jt.imu_bias_a, rtol=0, atol=1e-4)


def test_track_with_prediction_matches_jax(state):
    """The staged IMU path: PredictStateIMU seeds the pose, the last frame's
    points are matched, and ``_optimize_frame_pose`` takes the visual-inertial
    solve (``_optimize_frame_pose_vi``), whose marginal prior is carried."""
    frames = state[0]
    jt, tt = _trackers(state)
    fj = _frame_pair("jax", frames[3], 3, 3 * DT)
    ft = _frame_pair("torch", frames[3], 3, 3 * DT)
    assert jt._predict_pose_imu(fj) and tt._predict_pose_imu(ft)
    np.testing.assert_allclose(ft.R, fj.R, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ft.t, fj.t, rtol=0, atol=1e-5)
    ok_j, ok_t = jt._track_with_prediction(fj), tt._track_with_prediction(ft)
    assert ok_t and fj.n_matched() > 100
    _compare_tracked(jt, tt, fj, ft, ok_j, ok_t)
    assert tt.pose_prior_H is not None and jt.pose_prior_H is not None
    Hj = np.asarray(jt.pose_prior_H)
    assert np.abs(tt.pose_prior_H - Hj).max() <= 1e-3 * np.abs(Hj).max()
    assert tt.pose_prior_dT == pytest.approx(jt.pose_prior_dT, abs=1e-7)


def test_track_recently_lost_imu_matches_jax(state):
    """RECENTLY_LOST with an initialized IMU: the pose dead-reckons from an
    untracked last frame (the propagated velocity is kept) and re-acquires
    against the reference keyframe's local map in a 2x window."""
    from orbslam3_tpu.models.tracking import TrackState as JS
    from orbslam3_tpu_torch.models.tracking import TrackState as TS
    frames = state[0]
    jt, tt = _trackers(state)
    for tr, S in ((jt, JS), (tt, TS)):
        tr.last_frame.tracked = False
        tr.state = S.RECENTLY_LOST
        tr.lost_ts = 2 * DT
    fj = _frame_pair("jax", frames[3], 3, 3 * DT)
    ft = _frame_pair("torch", frames[3], 3, 3 * DT)
    ok_j, ok_t = jt._track_recently_lost_imu(fj), tt._track_recently_lost_imu(ft)
    assert ok_t, "the frame must re-acquire"
    _compare_tracked(jt, tt, fj, ft, ok_j, ok_t)
    # the tracker's cascade takes the same branch from RECENTLY_LOST (then
    # tracks the local map), in both packages
    jt2, tt2 = _trackers(state)
    for tr, S in ((jt2, JS), (tt2, TS)):
        tr.last_frame.tracked = False
        tr.state = S.RECENTLY_LOST
        tr.lost_ts = 2 * DT
    fj2 = _frame_pair("jax", frames[3], 3, 3 * DT)
    ft2 = _frame_pair("torch", frames[3], 3, 3 * DT)
    assert tt2._track(ft2) and jt2._track(fj2)
    assert tt2.state == TS.OK and ft2.tracked
    np.testing.assert_allclose(ft2.t, fj2.t, rtol=0, atol=1e-4)
    assert tt2.path_counts["reloc_frames"] == 0
    # with an initialized IMU the loss window is time-based: a failed frame
    # more than time_recently_lost after the loss starts a new map
    for tr in (jt2, tt2):
        calls = []
        tr.on_tracking_lost = lambda c=calls: c.append(1)
        tr.state = type(tr.state).RECENTLY_LOST
        tr.lost_ts = 3 * DT - tr.p.time_recently_lost + 0.01
        tr._post_track(_frame_pair("jax" if tr is jt2 else "torch", frames[3], 3, 3 * DT), False)
        assert calls == [] and tr.pose_prior_H is None
        tr._post_track(_frame_pair("jax" if tr is jt2 else "torch", frames[4], 4, 4 * DT), False)
        assert calls == [1] and tr.consecutive_lost == 0


STAGES = {
    # (imu_init_ts offset from the keyframe's ts, viba1_done, viba2_done, bf,
    #  last_scale_refine_ts offset)
    "viba1": (-6.0, False, False, BF, 0.0),
    "viba2": (-16.0, True, False, BF, 0.0),
    "scale_refine": (-30.0, True, True, 0.0, -11.0),
    "bad_imu": (-1.0, False, False, BF, 0.0),
}


@pytest.mark.parametrize("case", list(STAGES))
def test_inertial_stage_matches_jax(state, case):
    from orbslam3_tpu.models.local_mapping import LocalMapper as JLM
    from orbslam3_tpu.ops.features import OrbConfig as JOrb
    from orbslam3_tpu_torch.models.local_mapping import LocalMapper as TLM
    from orbslam3_tpu_torch.ops.features import OrbConfig as TOrb
    frames, mref, pre, vel = state
    arrays = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in vars(mref).items()}
    kf = mref.n_kf - 1
    if case == "bad_imu":
        # the last three keyframes within 0.02 m of each other
        for k in (kf - 2, kf - 1):
            arrays["kf_R"][k] = arrays["kf_R"][kf]
            arrays["kf_t"][k] = arrays["kf_t"][kf] + 0.003
    off, v1, v2, bf, refine_off = STAGES[case]
    K4 = np.asarray(K, np.float32)
    out = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            m = jax_map_from_arrays(arrays, mref.cfg)
            mapper = JLM(m, K4, JOrb(n_features=512), wh=(752, 480))
            preints = {k: pre[k - 1] for k in range(1, mref.n_kf)}
        else:
            m = map_state_from_arrays(arrays, mref.cfg)
            mapper = TLM(m, K4, TOrb(n_features=512), wh=(752, 480), device="cpu")
            preints = {k: preint_state_from(pre[k - 1]) for k in range(1, mref.n_kf)}
        resets = []
        mapper.bf = bf
        mapper.inertial = types.SimpleNamespace(
            imu_enabled=True, imu_initialized=True, imu_init_ts=float(m.kf_ts[kf]) + off,
            viba1_done=v1, viba2_done=v2,
            last_scale_refine_ts=float(m.kf_ts[kf]) + refine_off, kf_preints=preints,
            cam_params=K4, imu_bias_g=np.zeros(3, np.float32),
            imu_bias_a=np.zeros(3, np.float32), world_epoch=0)
        mapper.on_bad_imu = lambda r=resets: r.append(1)
        mapper._inertial_stage(kf)
        out[pkg] = (m, mapper)
    (jm, jmap), (tm, tmap) = out["jax"], out["torch"]
    keys = ("viba1", "viba2", "scale_refines", "bad_imu_resets", "vi_ba_runs")
    assert {k: tmap.stats.get(k) for k in keys} == {k: jmap.stats.get(k) for k in keys}
    ti, ji = tmap.inertial, jmap.inertial
    assert (ti.viba1_done, ti.viba2_done, ti.world_epoch) == (
        ji.viba1_done, ji.viba2_done, ji.world_epoch)
    if case == "bad_imu":
        assert tmap.stats["bad_imu_resets"] == 1 and not tmap.stats.get("vi_ba_runs")
        np.testing.assert_array_equal(tm.kf_t, jm.kf_t)
        return
    assert tmap.stats["vi_ba_runs"] == 1 and ti.world_epoch == 1
    assert ti.last_scale_refine_ts == ji.last_scale_refine_ts
    kfs = jm.valid_kf_ids()
    np.testing.assert_allclose(tm.kf_R[kfs], jm.kf_R[kfs], rtol=0, atol=1e-3)
    np.testing.assert_allclose(tm.kf_t[kfs], jm.kf_t[kfs], rtol=0, atol=1e-3)
    np.testing.assert_allclose(tm.kf_vel[kfs], jm.kf_vel[kfs], rtol=0, atol=5e-3)
    np.testing.assert_allclose(tm.kf_bias_g[kfs], jm.kf_bias_g[kfs], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tm.kf_bias_a[kfs], jm.kf_bias_a[kfs], rtol=0, atol=1e-3)
    np.testing.assert_allclose(ti.imu_bias_g, ji.imu_bias_g, rtol=0, atol=1e-4)
    mps = jm.valid_mp_ids()
    dist = np.linalg.norm(jm.mp_xyz[mps], axis=1, keepdims=True)
    assert (np.abs(tm.mp_xyz[mps] - jm.mp_xyz[mps]) <= 1e-2 + 1e-2 * dist).all()
    np.testing.assert_array_equal(tm.kf_feat_mp, jm.kf_feat_mp)
    # the BA moved the state (the keyframes past the fixed first one)
    assert np.abs(jm.kf_t[kfs] - mref.kf_t[kfs]).max() > 1e-6


def test_map_remap_timestamp_guard_and_chain_cull_match_jax(state):
    """The tracker's inertial bookkeeping around the map: a pool compaction
    renumbers ``kf_preints``; a timestamp gap drops every preintegration, the
    world velocity and the marginal prior; culling a keyframe of an inertial
    map composes the preintegrations across it and refuses the chain's ends."""
    from orbslam3_tpu.models.local_mapping import LocalMapper as JLM
    from orbslam3_tpu.ops.features import OrbConfig as JOrb
    from orbslam3_tpu_torch.models.local_mapping import LocalMapper as TLM
    from orbslam3_tpu_torch.ops.features import OrbConfig as TOrb
    frames, mref, pre, vel = state
    jt, tt = _trackers(state)
    remap = np.full(mref.cfg.max_keyframes, -1, np.int64)
    remap[[0, 1, 3, 4, 5]] = [0, 1, 2, 3, 4]
    for tr in (jt, tt):
        tr._on_map_remap(remap, np.arange(mref.cfg.max_map_points))
    assert sorted(tt.kf_preints) == sorted(jt.kf_preints) == [1, 2, 3, 4]
    np.testing.assert_allclose(N(tt.kf_preints[2].dP), np.asarray(jt.kf_preints[2].dP),
                               rtol=0, atol=1e-7)
    for tr in (jt, tt):
        tr.pose_prior_H = np.eye(15, dtype=np.float32)
        tr._timestamp_guard(5.0)
        assert tr.frame_preint is None and tr.preint_since_kf is None
        assert tr.velocity_w is None and tr.pose_prior_H is None and tr.last_frame is None
    K4 = np.asarray(K, np.float32)
    res = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            m = jax_map_from_arrays(vars(mref), mref.cfg)
            mapper = JLM(m, K4, JOrb(n_features=512), wh=(752, 480))
            preints = {k: pre[k - 1] for k in range(1, mref.n_kf)}
        else:
            m = map_state_from_arrays(vars(mref), mref.cfg)
            mapper = TLM(m, K4, TOrb(n_features=512), wh=(752, 480), device="cpu")
            preints = {k: preint_state_from(pre[k - 1]) for k in range(1, mref.n_kf)}
        tr = types.SimpleNamespace(viba2_done=False, kf_preints=preints,
                                   reanchor_trajectory=lambda k: None)
        mapper.inertial = tr
        mapper.preserve_temporal_chain = True
        args = (tr,) if pkg == "jax" else ()
        done = [mapper._cull_one_keyframe(k, True, *args) for k in (0, 4, 2)]
        res[pkg] = (done, m, tr)
    (dj, mj, tj), (dt, mt, ttr) = res["jax"], res["torch"]
    assert dt == dj == [False, False, True]
    np.testing.assert_array_equal(mt.kf_valid, mj.kf_valid)
    assert sorted(ttr.kf_preints) == sorted(tj.kf_preints) == [1, 3, 4, 5]
    for name in ("dR", "dV", "dP", "C", "dT"):
        np.testing.assert_allclose(N(getattr(ttr.kf_preints[3], name)),
                                   np.asarray(getattr(tj.kf_preints[3], name)),
                                   rtol=1e-5, atol=1e-9, err_msg=name)
    assert float(ttr.kf_preints[3].dT) == pytest.approx(2 * DT, abs=1e-6)


def test_fused_track_vi_pooled_monocular_matches_jax(state, clear_jax_after):
    """The fused visual-inertial step of a monocular rig (bf = 0, the
    frame's right-x vector all -1): tests/test_torch_vi_fused.py's frame 3
    from keyframe 2's state, anchored rigidly and then with the carried
    marginal prior; bit-equal words, matches and bits, poses 1e-4,
    velocity 1e-3, biases 1e-5, H_marg 1e-3 of its largest entry."""
    frames, mref, pre, vel = state
    mport = map_state_from_arrays(vars(mref), mref.cfg)
    cl = len(frames[0]["valid"])
    args = (0, 8, 1.2, K, WH, 0.0, 8.0, 3.0, 0.9, 0.8, 100, NOISE[2], NOISE[3])
    ids = _ids(mref, 2, cl)
    f = frames[3]
    no_ur = np.full(cl, -1.0, np.float32)
    mpf_j, mpu_j = jdm.DeviceMapMirror().sync(mref)
    mpf_t, mpu_t = tdm.DeviceMapMirror("cpu").sync(mport)
    jfn = jk.fused_track_vi_pooled(*args)
    tfn = tk.fused_track_vi_pooled(*args, device="cpu")
    prior = 1e10 * np.eye(15, dtype=np.float32)
    tail = 14 + 2 * cl + (CC + 31) // 32 + (cl + 31) // 32
    for case in ("rigid", "carried"):
        st = _vi_state(frames[2], vel[2], prior)
        want = np.asarray(jfn(J(st), J(ids), mpf_j, mpu_j, *_feats(f, False, no_ur), pre[2],
                              cl=cl))
        got = N(tfn(T(st), T(ids), mpf_t, mpu_t, *_feats(f, True, no_ur),
                    preint_state_from(pre[2]), cl=cl))
        assert got.dtype == np.int32 and got.shape == want.shape == (tail + 234,)
        np.testing.assert_allclose(got[:12].view(np.float32), want[:12].view(np.float32),
                                   rtol=0, atol=1e-4, err_msg=case)
        np.testing.assert_array_equal(got[12:tail], want[12:tail], err_msg=case)
        assert want[13] > 100, "the frame must actually track"
        vj, vt = want[tail:].view(np.float32), got[tail:].view(np.float32)
        np.testing.assert_allclose(vt[0:3], vj[0:3], rtol=0, atol=1e-3, err_msg=case)
        np.testing.assert_allclose(vt[3:9], vj[3:9], rtol=0, atol=1e-5, err_msg=case)
        Hj, Ht = vj[9:].reshape(15, 15), vt[9:].reshape(15, 15)
        assert np.isfinite(Ht).all()
        assert np.abs(Ht - Hj).max() <= 1e-3 * np.abs(Hj).max(), case
        prior = Hj
