"""The slice end to end: the JAX SlamSystem and the port's SlamSystem with
their defaults (sync mapping, loop closing on) on test_e2e_mono.py's fixture —
RoomScene(seed=1), orbit_trajectory(32, radius=1.0, forward=0.04), 512
features, dense_tracking_params() (a fixed 5-frame keyframe cadence) — both on
the CPU. The orbit never revisits a place, so the loop closers fill their
keyframe databases and verify no candidate: the map is the mapper's alone.

Measured on this fixture (CPU, float32): JAX ATE 0.0132 scene units with 8
keyframes; the port ATE 0.0118-0.0120 (with 2 or 4 CPU threads) with 7
keyframes; both initialize at frame 6
and track every later frame; the JAX run never relocalizes.

Bounds: the port's ATE is no worse than max(1.5 x JAX ATE, JAX ATE + 0.02)
and its keyframe count within ±2 of JAX's (±1 beside the loop closer's
database rows): the two differ only by float32 rounding (pyramid resize, LM
and BA sums), which moves individual matches and keyframe culling decisions
but not the trajectory's accuracy class. The loop closers' counters
(candidates checked, loops detected and corrected, errors) are equal.
"""
import numpy as np
import pytest

from conftest import dense_tracking_params
from orbslam3_tpu.models.system import SlamSystem as JaxSlam
from orbslam3_tpu.utils.datasets import RoomScene, orbit_trajectory
from orbslam3_tpu.utils.evaluation import evaluate_trajectory
from orbslam3_tpu_torch.models.system import SlamSystem
from orbslam3_tpu_torch.models.tracking import TrackingParams, TrackState
from orbslam3_tpu_torch.utils.convert import config_from
from torch_port_helpers import render_all, torch_threads  # noqa: F401

N_FRAMES = 32


def _run(system, imgs):
    states = []
    for i, img in enumerate(imgs):
        system.track_monocular(img, ts=float(i) / 20.0)
        states.append(system.state.name)
    ts, R_wc, t_wc, lost = system.export_trajectory()
    return states, ts, t_wc, lost


@pytest.fixture(scope="module")
def runs():
    scene = RoomScene(seed=1)
    poses = orbit_trajectory(N_FRAMES, radius=1.0, forward=0.04)
    imgs = render_all(scene, poses)
    gt = np.array([-R.T @ t for R, t in poses])
    jparams = dense_tracking_params()
    jsys = JaxSlam(scene.K, None, (scene.w, scene.h), n_features=512, seed=0,
                   tracking_params=jparams)
    tsys = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0,
                      tracking_params=config_from(jparams, TrackingParams), device="cpu")
    out = {}
    for name, s in (("jax", jsys), ("torch", tsys)):
        states, ts, t_wc, lost = _run(s, imgs)
        sel = ~lost
        ate, n_assoc = evaluate_trajectory(np.arange(N_FRAMES) / 20.0, gt, ts[sel],
                                           t_wc[sel], with_scale=True)
        out[name] = dict(system=s, states=states, ate=ate, n_assoc=n_assoc,
                         n_tracked=int(sel.sum()), stats=s.stats())
    return out


def test_reference_run_needs_no_relocalization(runs):
    """The slice leaves relocalization out; that is sound only while the JAX
    run of this fixture never relocalizes."""
    tr = runs["jax"]["system"].tracker
    assert tr._last_reloc_frame_id < 0
    assert all(s == "OK" for s in runs["jax"]["states"][10:])


def test_port_initializes_and_tracks(runs):
    r = runs["torch"]
    assert r["system"].state == TrackState.OK
    assert sum(s != "OK" for s in r["states"][10:]) <= 4, r["states"]
    assert r["n_tracked"] > 0.7 * N_FRAMES
    st = r["stats"]
    assert st["triangulated"] > 0 and st["ba_runs"] >= 1
    assert st.get("culled_kf", 0) > 0
    assert st["n_map_points"] > 150
    assert r["system"].tracker.path_counts["fused"] > 0.5 * N_FRAMES


def test_port_ate_and_keyframes_match_reference(runs):
    j, t = runs["jax"], runs["torch"]
    assert t["n_assoc"] > 0.7 * N_FRAMES
    bound = max(1.5 * j["ate"], j["ate"] + 0.02)
    assert t["ate"] <= bound, (t["ate"], j["ate"])
    assert abs(t["stats"]["n_keyframes"] - j["stats"]["n_keyframes"]) <= 2


def test_trajectory_export_tum_format(runs, tmp_path):
    path = tmp_path / "traj.txt"
    runs["torch"]["system"].save_trajectory_tum(str(path))
    lines = path.read_text().strip().splitlines()
    assert len(lines) > 10
    row = [float(x) for x in lines[0].split()]
    assert len(row) == 8
    assert abs(np.linalg.norm(row[4:]) - 1.0) < 1e-4


def test_loop_closer_matches_reference(runs):
    j, t = runs["jax"], runs["torch"]
    lj, lt = j["system"].loop_closer, t["system"].loop_closer
    assert lt is not None and t["system"].tracker.reloc_candidates_fn is not None
    rows_j, rows_t = int(lj.bow_filled.sum()), int(lt.bow_filled.sum())
    assert rows_t >= 3 and abs(rows_t - rows_j) <= 1, (rows_t, rows_j)
    assert abs(t["stats"]["n_keyframes"] - j["stats"]["n_keyframes"]) <= 1
    for key in ("candidates_checked", "loops_detected", "loops_corrected"):
        assert t["stats"][key] == j["stats"][key], key
    for key in ("lc_errors", "gba_errors", "mapper_errors", "reloc_query_errors"):
        assert t["stats"][key] == 0, (key, t["stats"].get("last_" + key[:-1]))


@pytest.mark.parametrize("kw", [dict(use_viewer=True),
                                dict(tracking_params=TrackingParams(pose_starts=2))])
def test_unported_options_raise(kw):
    """The options that once raised run now. ``use_viewer=True``: the live
    viewer serves its page on a free port until shutdown. ``pose_starts=2``:
    as in the JAX package, the fused step is off and the tracker's pose
    solve is the two-start one, which gives the JAX package's pose (within
    1e-4) on a seeded problem."""
    import urllib.request
    base = dict(device="cpu")
    base.update(kw)
    K = np.array([458.0, 457.0, 376.0, 240.0], np.float32)
    s = SlamSystem(K, None, (752, 480), n_features=256, viewer_port=0, **base)
    if "use_viewer" in kw:
        url = f"http://127.0.0.1:{s.viewer.port}/"
        assert b"live viewer" in urllib.request.urlopen(url, timeout=20).read()
        s.shutdown(print_times=False)
        assert s.viewer is None
        return
    import jax.numpy as jnp
    import torch
    from orbslam3_tpu.models.tracking import TrackingParams as JaxParams
    from orbslam3_tpu.models.tracking import TrackState as JaxState
    from test_torch_pose_multistart import problem
    j = JaxSlam(K, None, (752, 480), n_features=256, tracking_params=JaxParams(pose_starts=2))
    for tr, ok in ((s.tracker, TrackState.OK), (j.tracker, JaxState.OK)):
        tr.state, tr.last_frame = ok, object()
        tr.velocity = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        assert not tr._can_fuse_track()
    args, ur, bf = problem(0, True, 150)
    rt = s.tracker.pose_opt(*(torch.as_tensor(a) for a in args), obs_ur=torch.as_tensor(ur),
                            bf=float(bf))
    rj = j.tracker.pose_opt(*(jnp.asarray(a) for a in args), jnp.asarray(ur), jnp.asarray(bf))
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), rtol=0, atol=1e-4)
    assert int(rt.n_inliers) == int(rj.n_inliers)
