"""The port's loop closer (orbslam3_tpu_torch/models/loop_closing.py) against
the JAX package's on tests/test_loop_closing.py's drifted map (rebuilt in
numpy by ``torch_port_helpers.build_drifted_map``), both on the CPU, each
closer fed the same keyframes in the same order.

The revisit keyframes of that map sit exactly at the loop start, so the true
S21 has zero translation, and then the Sim3's scale moves no reprojection:
OptimizeSim3 leaves it free, and each package's LM drifts it its own way
(JAX and the port land on different scales from the same start, and the
propagated Sim3 then decides the temporal consistency differently). The
decision chain is therefore held with the scale fixed, as a stereo or
inertial rig runs it (``fix_scale=True``); the free-scale run is held on its
first verification's candidate, rotation and translation.

Tolerances: detections, candidates, pending counts, candidates checked, loop
edges, relocalization candidates and fused feature assignments equal
exactly; S21's R within 1e-4 and t within 1e-3; corrected keyframe centres
within 1e-3 scene units of JAX's; the merge's alignment within 1e-5 and the
merged keyframe centres within 5e-3 (a welding local BA and an essential
graph run after it).
"""
import copy
from types import SimpleNamespace

import numpy as np
import pytest

from orbslam3_tpu.models import map as jmap
from orbslam3_tpu.models.local_mapping import LocalMapper as JMapper
from orbslam3_tpu.models.loop_closing import LoopCloser as JCloser
from orbslam3_tpu.models.system import SlamSystem as JSlam
from orbslam3_tpu.ops import features as jfeat
from orbslam3_tpu_torch.models import map as tmap
from orbslam3_tpu_torch.models.local_mapping import LocalMapper as TMapper
from orbslam3_tpu_torch.models.loop_closing import LoopCloser as TCloser
from orbslam3_tpu_torch.models.system import SlamSystem as TSlam
from orbslam3_tpu_torch.ops import features as tfeat
from orbslam3_tpu_torch.utils.convert import loop_closer_state_from, map_state_from_arrays
from torch_port_helpers import build_drifted_map, torch_threads  # noqa: F401

K_CAM = np.asarray([458.0, 458.0, 376.0, 240.0], np.float32)
WH = (752, 480)
PACKAGES = {"jax": (jmap, JCloser, {}), "torch": (tmap, TCloser, {"device": "cpu"})}


def _centres(m, n):
    return np.stack([-m.kf_R[k].T @ m.kf_t[k] for k in range(n)])


def _copy_map(src):
    """A JAX-package copy and a port copy of one map's arrays."""
    arrays = {k: v for k, v in vars(src).items() if isinstance(v, np.ndarray)}
    arrays.update(n_kf=src.n_kf, n_mp=src.n_mp)
    mj = jmap.MapState(src.cfg)
    for k, v in arrays.items():
        setattr(mj, k, v.copy() if isinstance(v, np.ndarray) else v)
    return mj, map_state_from_arrays(arrays, src.cfg)


def _run_closer(pkg, fix_scale, last_kf=None, snapshot_after=None):
    """Both closers over the drifted map's keyframes 0..``last_kf``; with
    ``snapshot_after`` a copy of the map and of the closer's state as they
    stand after that keyframe."""
    mod, Closer, kw = PACKAGES[pkg]
    m, gt_R, gt_t, n_kf = build_drifted_map(mod)
    lc = Closer(m, K_CAM, WH, min_kfs=4, exclude_recent=4, fix_scale=fix_scale, **kw)
    verified = []
    inner = lc._verify_candidate

    def verify(*a, **k):
        ok, S21 = inner(*a, **k)
        if ok:
            verified.append((int(a[0]), int(a[1]), S21))
        return ok, S21

    lc._verify_candidate = verify
    log, s21_at_hit, snap = [], None, None
    for k in range(n_kf if last_kf is None else last_kf + 1):
        pend = None if lc.pending is None else dict(lc.pending)
        done = lc.process_keyframe(k)
        if done and s21_at_hit is None:
            s21_at_hit = pend["S21"]
        log.append((k, bool(done), None if lc.pending is None else
                    (lc.pending["cand"], lc.pending["count"], lc.pending["misses"])))
        if k == snapshot_after:
            snap = (_copy_map(m), SimpleNamespace(
                bow_ids=lc.bow_ids.copy(), bow_w=lc.bow_w.copy(),
                bow_filled=lc.bow_filled.copy(), pending=copy.deepcopy(lc.pending),
                loop_edges=list(lc.loop_edges), last_loop_kf=lc.last_loop_kf,
                rng=copy.deepcopy(lc.rng)))
    gt_c = np.stack([-gt_R[k].T @ gt_t[k] for k in range(n_kf)])
    return dict(map=m, lc=lc, log=log, verified=verified, s21_at_hit=s21_at_hit,
                centres=_centres(m, n_kf), gt=gt_c, n_kf=n_kf, snapshot=snap)


@pytest.fixture(scope="module")
def fixed():
    return {p: _run_closer(p, True, snapshot_after=16) for p in PACKAGES}


def test_same_detection_candidate_and_pending(fixed):
    j, t = fixed["jax"], fixed["torch"]
    assert t["log"] == j["log"]
    det = [k for (k, done, _) in t["log"] if done]
    assert det == [18]                     # the third consecutive verification
    pend = [p[1] for (_, _, p) in t["log"][:18] if p is not None]
    assert pend == [1, 2]
    for key in ("loops_detected", "loops_corrected", "candidates_checked"):
        assert t["lc"].stats[key] == j["lc"].stats[key], key
    assert t["lc"].stats["loops_corrected"] == 1
    assert [v[:2] for v in t["verified"]] == [v[:2] for v in j["verified"]] == [(16, 0)]


def test_s21_and_corrected_poses(fixed):
    j, t = fixed["jax"], fixed["torch"]
    (sj, Rj, tj), (st, Rt, tt) = j["s21_at_hit"], t["s21_at_hit"]
    assert st == sj == 1.0
    np.testing.assert_allclose(Rt, Rj, atol=1e-4)
    np.testing.assert_allclose(tt, tj, atol=1e-3)
    np.testing.assert_allclose(t["centres"], j["centres"], atol=1e-3)
    errs = np.linalg.norm(t["centres"] - t["gt"], axis=1)
    assert errs[-1] < 0.2 and errs[-4] < 0.25 and errs.max() < 0.6, errs


def test_same_loop_edges(fixed):
    assert fixed["torch"]["lc"].loop_edges == fixed["jax"]["lc"].loop_edges == [(18, 0)]


@pytest.mark.parametrize("query_kf", [2, 9, 17])
def test_relocalization_candidates_equal(fixed, query_kf):
    j, t = fixed["jax"], fixed["torch"]
    cj = j["lc"].detect_relocalization_candidates(j["map"].kf_feat_desc[query_kf],
                                                  j["map"].kf_feat_valid[query_kf])
    ct = t["lc"].detect_relocalization_candidates(t["map"].kf_feat_desc[query_kf],
                                                  t["map"].kf_feat_valid[query_kf])
    np.testing.assert_array_equal(ct, cj)
    assert len(ct) > 0 and any(abs(int(c) - query_kf) <= 2 or (query_kf >= 16 and c <= 2)
                               for c in ct[:3]), ct


def test_free_scale_first_verification():
    """Scale left free: the first verification picks the same candidate with
    the same rotation and translation (the scale is unobservable here)."""
    out = {p: _run_closer(p, False, last_kf=16) for p in PACKAGES}
    vj, vt = out["jax"]["verified"][0], out["torch"]["verified"][0]
    assert vt[:2] == vj[:2] == (16, 0)
    np.testing.assert_allclose(vt[2][1], vj[2][1], atol=1e-4)
    np.testing.assert_allclose(vt[2][2], vj[2][2], atol=1e-3)
    assert out["torch"]["log"][16] == out["jax"]["log"][16]


def test_carried_database_goes_on_alike(fixed):
    """The JAX closer's state after keyframes 0-16 (its database filled, a
    candidate pending) and a copy of its map, carried into a port closer
    (``utils/convert.loop_closer_state_from``): the port then takes
    keyframes 17-19 with the JAX run's decisions and corrected poses."""
    j = fixed["jax"]
    (mj, mt), state = j["snapshot"]
    assert state.pending is not None and state.bow_filled[:17].all()
    tlc = loop_closer_state_from(state, TCloser(mt, K_CAM, WH, min_kfs=4, exclude_recent=4,
                                                fix_scale=True, device="cpu"))
    np.testing.assert_array_equal(tlc.bow_ids, state.bow_ids)
    log = []
    for k in range(17, j["n_kf"]):
        done = tlc.process_keyframe(k)
        log.append((k, bool(done), None if tlc.pending is None else
                    (tlc.pending["cand"], tlc.pending["count"], tlc.pending["misses"])))
    assert log == j["log"][17:]
    assert tlc.loop_edges == j["lc"].loop_edges == [(18, 0)]
    np.testing.assert_allclose(_centres(mt, j["n_kf"]), j["centres"], atol=1e-3)


def test_fuse_into_parity(fixed):
    """SearchAndFuse's fuse on the corrected map: the loop-side landmarks of
    keyframe 0's group fused into the revisit keyframes, both mappers on
    copies of one map; every feature assignment and point validity equal."""
    src = fixed["jax"]["map"]
    mj, mt = _copy_map(src)
    jm = JMapper(mj, K_CAM, jfeat.OrbConfig(n_features=512), wh=WH)
    tm = TMapper(mt, K_CAM, tfeat.OrbConfig(n_features=512), wh=WH, device="cpu")
    loop_mps = src.local_map_points(np.asarray([0, 1, 2], np.int32))
    for k in (16, 17, 18, 19):
        jm._fuse_into(loop_mps, k, 4096)
        tm._fuse_into(loop_mps, k, 4096)
    np.testing.assert_array_equal(mt.kf_feat_mp, mj.kf_feat_mp)
    np.testing.assert_array_equal(mt.mp_valid, mj.mp_valid)
    assert (mt.kf_feat_mp[16:20] != src.kf_feat_mp[16:20]).sum() > 50
    assert mt.mp_valid.sum() < src.mp_valid.sum()          # duplicates merged


def _add_right_column(m, bf):
    """Give every observation of ``m`` a stereo right coordinate u − bf/z and
    depth z at the keyframe's pose (the rows a rig with depth adds to BA)."""
    for k in np.nonzero(m.kf_valid[: m.n_kf])[0]:
        fm = m.kf_feat_mp[k]
        sel = fm >= 0
        z = (m.mp_xyz[fm[sel]] @ m.kf_R[k].T + m.kf_t[k])[:, 2]
        m.kf_feat_ur[k, sel] = (m.kf_feat_xy[k, sel, 0] - bf / z).astype(np.float32)
        m.kf_feat_depth[k, sel] = z.astype(np.float32)


def _two_map_system(pkg, rig="mono"):
    """A system whose Atlas holds the drifted map (stored) and a current map
    made of its keyframes 0-5 in a world moved by a known similarity, with a
    logged trajectory on the current map's keyframes. ``rig="stereo"``: both
    maps carry a right column (bf = 0.11·fx), the system is a stereo one
    (fixed-scale loop closer, stereo rows in the weld BA) and the similarity
    is rigid, as a fixed-scale verification gives it."""
    mod = jmap if pkg == "jax" else tmap
    old, _, _, _ = build_drifted_map(mod)
    stereo = rig == "stereo"
    bf = float(0.11 * K_CAM[0]) if stereo else 0.0
    if stereo:
        _add_right_column(old, bf)
    s = 1.0 if stereo else 1.3
    R = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    t = np.array([0.5, -0.2, 1.0], np.float32)
    cur = mod.MapState(old.cfg, map_id=1)
    kfs = list(range(6))
    pts = np.unique(np.concatenate([old.kf_feat_mp[k][old.kf_feat_mp[k] >= 0] for k in kfs]))
    lut = np.full(old.cfg.max_map_points, -1, np.int64)
    new_ids = cur.add_map_points((s * old.mp_xyz[pts] @ R.T + t).astype(np.float32),
                                 old.mp_desc[pts], 0,
                                 (old.mp_normal[pts] @ R.T).astype(np.float32),
                                 old.mp_min_dist[pts] * s, old.mp_max_dist[pts] * s, first_kf=0)
    lut[pts] = new_ids
    for k in kfs:
        fm = old.kf_feat_mp[k]
        fm_new = np.where(fm >= 0, lut[np.clip(fm, 0, None)], -1).astype(np.int32)
        Rk = (old.kf_R[k] @ R.T).astype(np.float32)
        tk = (s * old.kf_t[k] - Rk @ t).astype(np.float32)
        cur.add_keyframe(Rk, tk, 100.0 + k, 100 + k, old.kf_feat_xy[k], old.kf_feat_angle[k],
                         old.kf_feat_octave[k], old.kf_feat_desc[k], old.kf_feat_valid[k],
                         feat_mp=fm_new, ur=old.kf_feat_ur[k], depth=old.kf_feat_depth[k])
    cur.refresh_map_points(new_ids)
    kw = dict(bf=bf, th_depth=0.11 * 40) if stereo else {}
    if pkg == "jax":
        sysm = JSlam(K_CAM, None, WH, n_features=512, seed=0, **kw)
    else:
        sysm = TSlam(K_CAM, None, WH, n_features=512, seed=0, device="cpu", **kw)
    sysm.atlas.maps = [old, cur]
    sysm.atlas.current_idx = 1
    sysm._bind_map(cur)
    eye = np.eye(3, dtype=np.float32)
    sysm.tracker.trajectory = [(100.0 + k, k, eye, np.zeros(3, np.float32), False)
                               for k in kfs] + [(99.0, -2, eye, np.zeros(3, np.float32), False)]
    aligned = []
    inner = sysm.atlas.merge_current_into

    def merge(old_map, R_a, t_a, s_align=1.0):
        out = inner(old_map, R_a, t_a, s_align=s_align)
        c = _centres(old_map, old_map.n_kf)
        kf_map = sysm.atlas.last_merge_kf_map
        aligned.append((R_a, t_a, s_align, np.abs(
            c[[kf_map[k] for k in kfs]] - c[kfs]).max()))
        return out

    sysm.atlas.merge_current_into = merge
    n_old = int(old.kf_valid.sum())
    S21 = (1.0 / s, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    ok = sysm._merge_with(2, old, 2, S21)
    return dict(ok=ok, sys=sysm, aligned=aligned, n_old=n_old, expect=(R.T, -R.T @ t / s, 1 / s))


@pytest.mark.parametrize("rig", ["mono", "stereo"])
def test_merge_two_hand_built_maps(rig):
    out = {p: _two_map_system(p, rig) for p in ("jax", "torch")}
    j, t = out["jax"], out["torch"]
    assert t["ok"] and j["ok"]
    assert t["sys"].loop_closer.fix_scale == j["sys"].loop_closer.fix_scale == (rig == "stereo")
    assert t["sys"].mapper.bf == pytest.approx(j["sys"].mapper.bf)
    (Rj, tj, sj, _), (Rt, tt, st, gap) = j["aligned"][0], t["aligned"][0]
    assert gap < 1e-4      # the aligned keyframes land on their originals
    R_e, t_e, s_e = t["expect"]
    np.testing.assert_allclose(Rt, R_e, atol=1e-5)
    np.testing.assert_allclose(tt, t_e, atol=1e-5)
    assert abs(st - s_e) < 1e-6
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)
    np.testing.assert_allclose(tt, tj, atol=1e-5)
    ts, js = t["sys"], j["sys"]
    assert ts.atlas.merges == js.atlas.merges == 1
    assert ts.atlas.current is ts.atlas.maps[0]
    mt, mj = ts.map, js.map
    assert int(mt.kf_valid.sum()) == int(mj.kf_valid.sum()) == t["n_old"] + 6
    assert ts.atlas.last_merge_kf_map == js.atlas.last_merge_kf_map
    assert [e[1] for e in ts.tracker.trajectory] == [e[1] for e in js.tracker.trajectory]
    assert [e[1] for e in ts.tracker.trajectory][:6] == [20, 21, 22, 23, 24, 25]
    n = mt.n_kf
    np.testing.assert_allclose(_centres(mt, n), _centres(mj, n), atol=5e-3)


def test_sync_on_kf_passes_the_remapped_id():
    """Sync mapping: the mapper compacts the pools as it takes a keyframe
    (the pool is nearly full and two keyframes were culled), and the loop
    closer must receive the keyframe's new id, not the stale one."""
    sysm = TSlam(K_CAM, None, WH, n_features=512, seed=0, device="cpu")
    m, _, _, n_kf = build_drifted_map(tmap, max_keyframes=23)
    m.kf_valid[[5, 6]] = False
    sysm.atlas.maps = [m]
    sysm._bind_map(m)
    got = []
    inner = sysm.loop_closer.process_keyframe

    def record(kf_id, *a, **k):
        got.append((int(kf_id), int(m.kf_frame_id[kf_id]), bool(m.kf_valid[kf_id])))
        return inner(kf_id, *a, **k)

    sysm.loop_closer.process_keyframe = record
    epoch = m.remap_epoch
    sysm.tracker.on_new_keyframe(n_kf - 1)
    assert m.remap_epoch > epoch and m.n_kf == n_kf - 2
    assert got == [(n_kf - 3, n_kf - 1, True)]
    assert sysm.loop_closer.bow_filled[n_kf - 3]


def test_reloc_query_error_is_counted():
    """An exception in the BoW relocalization query is counted in
    ``stats()["reloc_query_errors"]`` with its repr; relocalization goes on
    with the recent keyframes (here: none, so it fails)."""
    from orbslam3_tpu_torch.models.frame import Frame
    sysm = TSlam(K_CAM, None, WH, n_features=512, seed=0, device="cpu")
    n = 64
    rng = np.random.default_rng(0)
    frame = Frame(0, 0.0, xy=rng.uniform(0, 300, (n, 2)).astype(np.float32),
                  angle=np.zeros(n, np.float32), octave=np.zeros(n, np.int32),
                  desc=rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32),
                  valid=np.ones(n, bool))

    def broken(desc, valid):
        raise ValueError("database unavailable")

    sysm.tracker.reloc_candidates_fn = broken
    assert sysm.tracker._relocalize(frame) is False
    st = sysm.stats()
    assert st["reloc_query_errors"] == 1
    assert "database unavailable" in st["last_reloc_query_error"]


def test_merge_essential_graph_error_is_counted(monkeypatch):
    """An exception in the essential graph of an Atlas merge's weld keeps
    the merge but is counted in ``stats()["merge_errors"]`` with its repr."""
    def broken(self, *a, **k):
        raise ValueError("essential graph failed")

    monkeypatch.setattr(TCloser, "optimize_essential_graph", broken)
    out = _two_map_system("torch")
    assert out["ok"]
    st = out["sys"].stats()
    assert st["merge_errors"] == 1
    assert "essential graph failed" in st["last_merge_error"]
    clean = TSlam(K_CAM, None, WH, n_features=512, seed=0, device="cpu").stats()
    assert clean["merge_errors"] == 0 and "last_merge_error" not in clean


def test_drifted_map_in_a_full_width_pool():
    """chip_smoke.py's full-width loop check on the CPU: the drifted map in a
    1024-feature pool (the guided projection at 2048 x 1024, SearchAndFuse
    at 4096 x 1024) through both closers. Detections, pending counts,
    candidates checked and loop edges equal exactly; the corrected centres'
    distances to the ground truth within 1e-4 of JAX's; chip_smoke.py's
    constants are JAX's decisions and its bounds hold for JAX."""
    import chip_smoke as cs
    from orbslam3_tpu.models.local_mapping import LocalMapper as JM
    j = cs.run_drifted_loop(JCloser, JM, jmap, jfeat.OrbConfig)
    t = cs.run_drifted_loop(device="cpu")
    for key in ("detections", "pending_before_detection", "loop_edges", "loops_corrected",
                "candidates_checked", "pool"):
        assert t[key] == j[key], key
    assert j["detections"][:1] == [cs.DRIFT_DETECTION] and j["loop_edges"] == cs.DRIFT_LOOP_EDGES
    np.testing.assert_allclose(t["err_after"], j["err_after"], atol=1e-4)
    np.testing.assert_allclose(t["err_before"], j["err_before"], atol=1e-6)
    assert j["err_after"][1] < cs.DRIFT_ERR_LAST and j["err_after"][0] < cs.DRIFT_ERR_MAX
    assert j["err_after"][0] < j["err_before"][0]
