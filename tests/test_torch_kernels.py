"""models/kernels.py, models/device_map.py and utils/convert.py: the port's
pooled device steps against the JAX package's, on one shared map.

The map is a JAX-package ``MapState`` built from rendered RoomScene frames
(true depth at the first keyframe's keypoints); the port receives it through
``map_state_from_arrays``. Both sides read the same frame features (the JAX
extractor's output), so every difference comes from the step under test.

Tolerance: the packed buffers' integer words (match indices, counts, packed
bit masks) must be identical; the bitcast pose words agree to 1e-4 (float32
LM iterations summed in another order); triangulated points follow the DLT
tolerance of test_torch_solvers.py.
"""
import numpy as np
import pytest
import torch

from orbslam3_tpu.models import device_map as jdm
from orbslam3_tpu.models import kernels as jk
from orbslam3_tpu_torch.models import device_map as tdm
from orbslam3_tpu_torch.models import kernels as tk
from orbslam3_tpu_torch.models.map import MapConfig
from orbslam3_tpu_torch.utils.convert import map_state_from_arrays
from torch_port_helpers import (J, N, T, as_i32, build_reference_map, room_frames,  # noqa: F401
                                torch_threads)

K = (458.654, 457.296, 376.0, 240.0)
WH = (752.0, 480.0)
CC = 1024


@pytest.fixture(scope="module")
def shared():
    _, frames = room_frames()
    mref = build_reference_map(frames, n_kf=3)
    mport = map_state_from_arrays(vars(mref), mref.cfg)
    return frames, mref, mport


def _feats(f, torch_side):
    conv = T if torch_side else J
    return [conv(f[k]) for k in ("xy", "desc", "octave", "valid")]


def test_map_state_from_arrays_and_mirrors(shared):
    _, mref, mport = shared
    assert isinstance(mport.cfg, MapConfig)
    for name in mref._KF_ARRAYS + mref._MP_ARRAYS:
        np.testing.assert_array_equal(getattr(mport, name), getattr(mref, name), err_msg=name)
    assert (mport.n_kf, mport.n_mp) == (mref.n_kf, mref.n_mp)
    mpf_j, mpu_j = jdm.DeviceMapMirror().sync(mref)
    mpf_t, mpu_t = tdm.mirror_for(mport, "cpu").sync(mport)
    np.testing.assert_array_equal(N(mpf_t), N(mpf_j))
    np.testing.assert_array_equal(N(mpu_t), as_i32(mpu_j))
    xy_j, d_j, o_j = jdm.DeviceKfPool().sync(mref, [0, 1, 2])
    xy_t, d_t, o_t = tdm.kf_pool_for(mport, "cpu").sync(mport, [0, 1, 2])
    np.testing.assert_array_equal(N(xy_t), N(xy_j))
    np.testing.assert_array_equal(N(d_t), as_i32(d_j))
    np.testing.assert_array_equal(N(o_t), N(o_j))


@pytest.mark.parametrize("name", ["OrbConfig", "MapConfig", "TrackingParams"])
def test_config_dataclasses_match_reference(name):
    """The port's config dataclasses keep the reference's field names and
    defaults, and ``config_from`` carries every non-default value across."""
    import dataclasses
    from orbslam3_tpu.models import map as jmap, tracking as jtr
    from orbslam3_tpu.ops import features as jf
    from orbslam3_tpu_torch.models import map as tmap, tracking as ttr
    from orbslam3_tpu_torch.ops import features as tf
    from orbslam3_tpu_torch.utils.convert import config_from
    ref, port = {"OrbConfig": (jf, tf), "MapConfig": (jmap, tmap),
                 "TrackingParams": (jtr, ttr)}[name]
    jcls, tcls = getattr(ref, name), getattr(port, name)
    fields = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)]
    assert fields(tcls) == fields(jcls)
    changed = {f.name: (not f.default if isinstance(f.default, bool) else f.default + 1)
               for f in dataclasses.fields(jcls)
               if isinstance(f.default, (bool, int, float))}
    got = dataclasses.asdict(config_from(jcls(**changed), tcls))
    assert all(got[k] == v for k, v in changed.items())


def _ids(m, cl):
    """[last-frame candidates (points of keyframe 2) | local-map points]."""
    last = np.unique(m.kf_feat_mp[2][m.kf_feat_mp[2] >= 0])
    loc = np.setdiff1d(m.valid_mp_ids(), last)[:CC]
    ids = np.full(cl + CC, -1, np.int32)
    ids[: len(last)] = last[:cl]
    ids[cl: cl + len(loc)] = loc
    return ids


def _pose_in(f_pred, f_prior, eps):
    p = np.empty(25, np.float32)
    p[0:9] = f_pred["R"].reshape(-1)
    p[9:12] = f_pred["t"]
    p[12:21] = f_prior["R"].reshape(-1)
    p[21:24] = f_prior["t"]
    p[24] = eps
    return p


def _check_pose_words(got, want):
    np.testing.assert_allclose(got[:12].view(np.float32), want[:12].view(np.float32),
                               rtol=0, atol=1e-4)


def test_fused_track_pooled(shared):
    """Frame 4 tracked against the 3-keyframe map from frame 2's pose."""
    frames, mref, mport = shared
    cl = len(frames[0]["valid"])
    args = (0, 8, 1.2, K, WH, 0.0, 8.0, 3.0, 0.9, 0.8, 100)
    ids = _ids(mref, cl)
    pose = _pose_in(frames[2], frames[2], 3e-4)
    f = frames[4]
    ur = np.full(cl, -1.0, np.float32)
    mpf_j, mpu_j = jdm.DeviceMapMirror().sync(mref)
    want = np.asarray(jk.fused_track_pooled(*args)(
        J(pose), J(ids), mpf_j, mpu_j, *_feats(f, False), J(ur), cl=cl))
    mpf_t, mpu_t = tdm.DeviceMapMirror("cpu").sync(mport)
    got = N(tk.fused_track_pooled(*args)(
        T(pose), T(ids), mpf_t, mpu_t, *_feats(f, True), T(ur), cl=cl))
    assert got.dtype == np.int32 and got.shape == want.shape
    _check_pose_words(got, want)
    np.testing.assert_array_equal(got[12:], want[12:])
    assert want[13] > 100, "the frame must actually track"


def test_projection_assign_pooled(shared):
    frames, mref, mport = shared
    f = frames[3]
    ids = _ids(mref, len(f["valid"]))[len(f["valid"]):]
    pose = np.concatenate([f["R"].reshape(-1), f["t"]]).astype(np.float32)
    args = (0, 8, 1.2, K, WH, 3.0, 0.8, 100, 0.5)
    want = np.asarray(jk.projection_assign_pooled(*args)(
        J(pose), J(ids), *jdm.DeviceMapMirror().sync(mref), *_feats(f, False)))
    got = N(tk.projection_assign_pooled(*args)(
        T(pose), T(ids), *tdm.DeviceMapMirror("cpu").sync(mport), *_feats(f, True)))
    np.testing.assert_array_equal(got, want)
    ok = tk.unpack_bits_host(want[len(ids): len(ids) + (len(ids) + 31) // 32], len(ids))
    assert ok.sum() > 50


def test_projection_matcher(shared):
    """The staged matcher's form (the kernel-path frame step)."""
    frames, mref, mport = shared
    f = frames[3]
    ids = mref.valid_mp_ids()
    m = mref
    geo = (m.mp_xyz[ids], m.mp_desc[ids], m.mp_normal[ids], m.mp_min_dist[ids],
           m.mp_max_dist[ids], m.mp_valid[ids], f["R"], f["t"], np.asarray(K, np.float32))
    tail = (np.asarray(WH, np.float32),)
    want = jk.projection_matcher(0, 8, 1.2)(*map(J, geo), *_feats(f, False), *map(J, tail),
                                            J(np.float32(8.0)), J(np.float32(0.9)),
                                            J(np.int32(100)), J(np.float32(0.5)))
    got = tk.projection_matcher(0, 8, 1.2)(*map(T, geo), *_feats(f, True), *map(T, tail),
                                           8.0, 0.9, 100, 0.5)
    for name, g, w in zip(("idx", "ok", "uv", "lvl", "frustum"), got, want):
        if name == "uv":
            np.testing.assert_allclose(N(g), N(w), rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(N(g), N(w), err_msg=name)


def test_triangulation_matcher(shared):
    """Two rendered frames (0 and 7, true poses): match indices identical;
    accepted rows identical except where a float32 DLT point sits on a
    gate (at most 1%); accepted points within the DLT tolerance of
    test_torch_solvers.py."""
    frames = shared[0]
    f1, f2 = frames[0], frames[7]
    geo = (f1["R"], f1["t"], f2["R"], f2["t"], np.asarray(K, np.float32))
    feats = [f[k] for f in (f1, f2) for k in ("xy", "desc", "valid", "octave")]
    sig = 1.0 / K[0]
    want = jk.triangulation_matcher(0, 8, 1.2)(*map(J, geo + tuple(feats)), J(np.float32(0.9)),
                                               J(np.int32(50)), J(np.float32(sig)))
    got = tk.triangulation_matcher(0, 8, 1.2)(*map(T, geo + tuple(feats)), 0.9, 50, sig)
    ok_j, ok_t = N(want[1]), N(got[1])
    assert ok_j.sum() > 50, "the pair must triangulate"
    np.testing.assert_array_equal(N(got[0]), N(want[0]))
    assert (ok_t != ok_j).mean() <= 0.01
    both = ok_t & ok_j
    xw_t, xw_j = N(got[2])[both], N(want[2])[both]
    rel = np.linalg.norm(xw_t - xw_j, axis=1) / np.linalg.norm(xw_j, axis=1)
    assert (rel <= 1e-4).mean() >= 0.97 and rel.max() <= 0.05


def test_pose_opt_kernel(shared):
    """The staged pose-LM factory on keyframe 2's own matches (frame 2 is
    keyframe 2), seeded at frame 1's pose: the pose within 1e-4 (rad, scene
    units) of JAX's, inlier masks differing on at most 1% of features."""
    frames, mref, _ = shared
    f = frames[2]
    fm = mref.kf_feat_mp[2]
    valid = f["valid"] & (fm >= 0)
    pts = mref.mp_xyz[np.maximum(fm, 0)].astype(np.float32)
    inv_s2 = (1.0 / 1.44 ** f["octave"]).astype(np.float32)
    args = (frames[1]["R"], frames[1]["t"], pts, f["xy"], inv_s2, valid,
            np.asarray(K, np.float32))
    rj = jk.pose_opt_kernel(0)(*map(J, args))
    rt = tk.pose_opt_kernel(0)(*map(T, args))
    dR = N(rt.R).astype(np.float64).T @ N(rj.R).astype(np.float64)
    assert np.linalg.norm(dR - np.eye(3)) < 1e-4       # √2 × the angle, in rad
    np.testing.assert_allclose(N(rt.t), N(rj.t), rtol=0, atol=1e-4)
    assert (N(rt.inlier) != N(rj.inlier)).mean() <= 0.01
    assert int(rj.n_inliers) > 100, "the frame must actually track"


def test_pose_opt_pooled(shared):
    frames, mref, mport = shared
    f = frames[3]
    cl = len(f["valid"])
    feat_mp = mref.kf_feat_mp[2].copy()        # frame 3 seen with kf 2's assignment
    pose = _pose_in(frames[2], frames[2], 3e-4)
    ur = np.full(cl, -1.0, np.float32)
    args = (0, K, 0.0, 8, 1.2)
    want = np.asarray(jk.pose_opt_pooled(*args)(
        J(pose), J(feat_mp), jdm.DeviceMapMirror().sync(mref)[0],
        J(f["xy"]), J(f["octave"]), J(f["valid"]), J(ur)))
    got = N(tk.pose_opt_pooled(*args)(
        T(pose), T(feat_mp), tdm.DeviceMapMirror("cpu").sync(mport)[0],
        T(f["xy"]), T(f["octave"]), T(f["valid"]), T(ur)))
    _check_pose_words(got, want)
    np.testing.assert_array_equal(got[12:], want[12:])


def test_triangulation_batched(shared):
    """A keyframe at frame 7 against keyframes at frames 0 and 4 (wide enough
    a baseline to pass the parallax gate; B=8 slots, 6 empty): identical
    match selection (count, f1, f2, neighbour), triangulated points within
    the DLT tolerance."""
    frames = shared[0]
    mref = build_reference_map([frames[0], frames[4], frames[7]], n_kf=3, stride=2)
    mport = map_state_from_arrays(vars(mref), mref.cfg)
    cap_new = 2048
    args = (0, 8, 1.2, K)
    kw = dict(cap_new=cap_new, max_dist=50, sigma_n=1.0 / K[0])
    B, cl = 8, len(frames[0]["valid"])
    nb = np.full(B, -1, np.int32)
    nb[:2] = [0, 1]
    poses2 = np.zeros((B, 12), np.float32)
    for i in range(2):
        poses2[i] = np.concatenate([mref.kf_R[i].reshape(-1), mref.kf_t[i]])
    pose1 = np.concatenate([mref.kf_R[2].reshape(-1), mref.kf_t[2]]).astype(np.float32)
    un1 = mref.kf_feat_valid[2] & (mref.kf_feat_mp[2] < 0)
    un2 = np.zeros((B, cl), bool)
    un2[:2] = mref.kf_feat_valid[:2] & (mref.kf_feat_mp[:2] < 0)
    pj = jdm.DeviceKfPool().sync(mref, [0, 1, 2])
    pt = tdm.DeviceKfPool("cpu").sync(mport, [0, 1, 2])
    want = np.asarray(jk.triangulation_batched(*args, **kw)(
        J(pose1), pj[0][2], pj[1][2], pj[2][2], J(un1), J(nb), J(nb >= 0), J(poses2),
        J(un2), *pj))
    got = N(tk.triangulation_batched(*args, **kw)(
        T(pose1), pt[0][2], pt[1][2], pt[2][2], T(un1), T(nb), T(nb >= 0), T(poses2),
        T(un2), *pt))
    n = int(want[0])
    assert n > 20 and int(got[0]) == n
    np.testing.assert_array_equal(got[: 1 + 3 * cap_new], want[: 1 + 3 * cap_new])
    xw_t = got[1 + 3 * cap_new:].view(np.float32).reshape(3, cap_new)[:, :n].T
    xw_j = want[1 + 3 * cap_new:].view(np.float32).reshape(3, cap_new)[:, :n].T
    rel = np.linalg.norm(xw_t - xw_j, axis=1) / np.linalg.norm(xw_j, axis=1)
    assert (rel <= 1e-4).mean() >= 0.97 and rel.max() <= 0.05


def test_fuse_batched(shared):
    """The new keyframe's points fused into its two neighbours and the
    neighbours' points into it, all targets in one batched match: identical
    packed output."""
    frames, mref, mport = shared
    T_, C = 12, CC
    tgt = np.full(T_, -1, np.int32)
    tgt[:3] = [0, 1, 2]
    poses = np.zeros((T_, 12), np.float32)
    for i in range(3):
        poses[i] = np.concatenate([mref.kf_R[i].reshape(-1), mref.kf_t[i]])
    fvalid = np.zeros((T_, len(frames[0]["valid"])), bool)
    fvalid[:3] = mref.kf_feat_valid[:3]
    cand = np.full((T_, C), -1, np.int32)
    pts = mref.valid_mp_ids()[:C]
    cand[:3, : len(pts)] = pts
    args = (0, 8, 1.2, K, WH)
    want = np.asarray(jk.fuse_batched(*args, cap_cand=C)(
        J(tgt), J(poses), J(fvalid), J(cand), *jdm.DeviceMapMirror().sync(mref),
        *jdm.DeviceKfPool().sync(mref, [0, 1, 2])))
    got = N(tk.fuse_batched(*args, cap_cand=C)(
        T(tgt), T(poses), T(fvalid), T(cand), *tdm.DeviceMapMirror("cpu").sync(mport),
        *tdm.DeviceKfPool("cpu").sync(mport, [0, 1, 2])))
    assert int(want[0]) > 100
    np.testing.assert_array_equal(got, want)


def test_ba_result_packer_and_bits():
    rng = np.random.default_rng(0)
    R = rng.normal(size=(4, 3, 3)).astype(np.float32)
    t = rng.normal(size=(4, 3)).astype(np.float32)
    pts = rng.normal(size=(70, 3)).astype(np.float32)
    inl = rng.random(101) < 0.5
    want = np.asarray(jk.ba_result_packer()(J(R), J(t), J(pts), J(inl)))
    got = N(tk.ba_result_packer()(T(R), T(t), T(pts), T(inl)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tk.unpack_bits_host(got[-4:], 101), inl)
