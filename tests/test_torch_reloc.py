"""Relocalization in the port against the JAX package's, both on the CPU, on
tests/test_reloc_rescue.py's fixture: RoomScene(seed=2, n_clutter=4),
walk_trajectory(30, period=200), 512 features, a 5-frame keyframe cadence,
sync mapping (loop closing off on both sides, so both draw their candidates
from the recent keyframes).

1. The guided rescue (that test's scenario, run on both packages): a query
   view off the traversed path relocalizes at the base gate; with the gate
   raised above the descriptor-stage inliers it is rejected without the
   rescue rounds and recovered with them. Tolerance: that test's, the
   recovered camera centre within half the map-frame path radius of the
   true one; and the two packages' recovered centres, each mapped back to
   the scene through its own alignment, within 0.15 scene units of each
   other (the maps differ by float32 rounding in extraction and BA).
2. Lost and found through the state machine: three textureless frames lose
   tracking (fewer than ``frames_to_new_map``, so the map is kept), the walk
   resumes, and the tracker is back to OK within three frames through
   ``_relocalize``, without a new Atlas map.
"""
import numpy as np
import pytest
import torch

from conftest import dense_tracking_params
from orbslam3_tpu.models.frame import build_frame as jax_build_frame
from orbslam3_tpu.models.system import SlamSystem as JaxSlam
from orbslam3_tpu.utils.datasets import RoomScene, walk_trajectory
from orbslam3_tpu.utils.evaluation import horn_align
from orbslam3_tpu_torch.models.frame import build_frame
from orbslam3_tpu_torch.models.system import SlamSystem
from orbslam3_tpu_torch.models.tracking import TrackingParams, TrackState
from orbslam3_tpu_torch.utils.convert import config_from
from torch_port_helpers import J, render_all, torch_threads  # noqa: F401

N_FRAMES = 30


def _rescue(slam, make_frame, poses, c_q):
    """tests/test_reloc_rescue.py's scenario on one system. Returns the
    recovered camera centre in scene coordinates and the checks' evidence."""
    tr = slam.tracker
    orig_project = tr._project_and_assign
    tr._project_and_assign = lambda *a, **k: 0
    probe = make_frame(998)
    base_gate = tr.p.min_local_inliers
    ok_base = tr._relocalize(probe)
    base_inl = probe.n_matched()
    # place the gate above what ANY recent-keyframe candidate reaches on the
    # descriptor stage alone (a later candidate may beat the first success)
    rejected = False
    for attempt in range(6):
        tr.p.min_local_inliers = base_inl + 10
        again = make_frame(990 + attempt)
        if not tr._relocalize(again):
            rejected = True
            break
        base_inl = again.n_matched()
    calls = []

    def counting_project(*a, **k):
        calls.append(1)
        return orig_project(*a, **k)

    tr._project_and_assign = counting_project
    frame = make_frame(999)
    recovered = tr._relocalize(frame)
    tr._project_and_assign = orig_project
    tr.p.min_local_inliers = base_gate
    ts, _, t_wc, lost = slam.export_trajectory()
    gt_c = np.array([-R.T @ t for (R, t) in poses])
    sel = ~lost
    gt_idx = np.rint(ts[sel] * 20.0).astype(int)
    R_al, t_al, s_al = horn_align(gt_c[gt_idx], t_wc[sel], with_scale=True)
    c_est = -frame.R.T @ frame.t
    c_scene = R_al.T @ (c_est - t_al) / s_al          # map frame → scene
    return dict(ok_base=ok_base, rejected=rejected, recovered=recovered, calls=len(calls),
                base_inl=base_inl, n_matched=frame.n_matched(), c_scene=c_scene,
                err_map=float(np.linalg.norm(c_est - (s_al * R_al @ c_q + t_al))),
                s_al=float(s_al), ref_kf=tr.ref_kf,
                reloc_id=tr._last_reloc_frame_id)


@pytest.fixture(scope="module")
def built():
    scene = RoomScene(seed=2, n_clutter=4)
    poses = walk_trajectory(N_FRAMES, period=200)
    imgs = render_all(scene, poses)
    jparams = dense_tracking_params()
    jsys = JaxSlam(scene.K, None, (scene.w, scene.h), n_features=512, seed=0,
                   tracking_params=jparams, enable_loop_closing=False)
    tsys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0,
                      tracking_params=config_from(jparams, TrackingParams),
                      enable_loop_closing=False, device="cpu")
    for s in (jsys, tsys):
        for i, img in enumerate(imgs):
            s.track_monocular(img, ts=i / 20.0)
        assert s.state.name == "OK"
    R_q, t_q = poses[15]
    c_q = -R_q.T @ t_q + np.array([0.25, 0.1, 0.2])    # off the path, never keyframed
    img_q = scene.render(R_q, -R_q @ c_q)
    jfeats = jsys.tracker.extract(J(img_q))
    tfeats = tsys.tracker.extract(torch.as_tensor(img_q))
    out = {
        "jax": _rescue(jsys, lambda fid: jax_build_frame(fid, 99.0, jfeats, jsys.tracker.K,
                                                         jsys.tracker.D), poses, c_q),
        "torch": _rescue(tsys, lambda fid: build_frame(fid, 99.0, tfeats), poses, c_q),
    }
    return scene, poses, imgs, tsys, out, c_q


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_rescue_recovers_near_miss(built, side):
    r = built[4][side]
    assert r["ok_base"], "fixture sanity: reloc must work at the base gate"
    assert r["rejected"], "without the rescue the raised gate must reject"
    assert r["recovered"], (r["base_inl"], r["calls"])
    assert r["calls"] > 0, "rescue rounds never engaged"
    assert r["n_matched"] >= r["base_inl"] + 10
    assert r["err_map"] < 0.5 * 2.5 * r["s_al"], r
    assert r["ref_kf"] >= 0 and r["reloc_id"] == 999


def test_port_and_reference_recover_the_same_pose(built):
    out, c_q = built[4], built[5]
    j, t = out["jax"], out["torch"]
    assert np.linalg.norm(t["c_scene"] - j["c_scene"]) < 0.15, (t["c_scene"], j["c_scene"])
    assert np.linalg.norm(t["c_scene"] - c_q) < 0.15, (t["c_scene"], c_q)


def test_lost_then_relocalized_through_the_state_machine(built):
    scene, poses, imgs, slam = built[:4]
    tr = slam.tracker
    n_maps = len(slam.atlas.maps)
    before = tr.path_counts["reloc_frames"]
    blank = np.full((scene.h, scene.w), 128.0, np.float32)
    ts = N_FRAMES / 20.0
    for _ in range(3):
        slam.track_monocular(blank, ts=ts)
        ts += 0.05
        assert slam.state in (TrackState.LOST, TrackState.RECENTLY_LOST)
    states = []
    for img in imgs[N_FRAMES - 6: N_FRAMES - 3]:       # a stretch the map has seen
        slam.track_monocular(img, ts=ts)
        ts += 0.05
        states.append(slam.state)
    assert TrackState.OK in states, states
    assert tr.path_counts["reloc_frames"] > before
    assert len(slam.atlas.maps) == n_maps and tr.consecutive_lost == 0
    # right after a relocalization the local-map gate is the reference's 50
    assert tr._min_local_inliers() >= 50
