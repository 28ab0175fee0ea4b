"""The rest of the port's ``SlamSystem`` facade against the JAX package's on
the CPU, on identical state and inputs. The JAX package's system is handed
a map built from the first two rendered frames of tests/test_e2e_mono.py's
orbit (RoomScene(seed=1), radius 1.0, forward 0.04; 512 features): two
keyframes at the true poses and the map points of frame 0's true depth
(``torch_port_helpers.build_reference_map``), tracking OK on frame 1 with the
true motion. The port takes over that map and tracker state
(``torch_port_helpers._snapshot`` / ``_restore``); from then on both
systems' extractors hand them the same JAX-package features of each frame.

- Localization mode on the next ``LOC_FRAMES`` frames: the same states, no
  new keyframe in either package, poses within 1e-3; the tracked map-point
  ids are those the port's last frame matched, at least 90% of them shared
  with the JAX package's, and the tracked keypoints are the JAX package's.
- ``TrackingParams.pose_starts = 7`` on the next ``MS_FRAMES`` frames, still
  in localization mode: both packages take the staged path on every frame
  (the fused step and the pooled solve are off) with the multi-start solve,
  the same states, poses within 1e-3.
- The trajectory writers (TUM, EuRoC and KITTI for every frame, TUM and
  EuRoC for the keyframes) on an identical trajectory (the JAX package's,
  copied into the port): the same lines, timestamps exact, values within
  1e-6.
- ``reset_active_map`` and ``reset``: the JAX package's counts and states.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import dense_tracking_params
from orbslam3_tpu.models import kernels as jkernels
from orbslam3_tpu.models.frame import build_frame as jax_build_frame
from orbslam3_tpu.models.system import SlamSystem as JaxSlam
from orbslam3_tpu.models.tracking import TrackState as JaxState
from orbslam3_tpu.ops import features as jfeatures
from orbslam3_tpu_torch.models import kernels as tkernels
from orbslam3_tpu_torch.models.system import SlamSystem
from orbslam3_tpu_torch.models.tracking import TrackingParams
from orbslam3_tpu_torch.ops.features import OrbFeatures
from orbslam3_tpu_torch.utils.convert import config_from
from torch_port_helpers import (T, _restore, _snapshot, build_reference_map, room_frames,
                                torch_threads)  # noqa: F401

LOC_FRAMES = 4
MS_FRAMES = 3
WRITERS = ("save_trajectory_tum", "save_trajectory_euroc", "save_trajectory_kitti",
           "save_keyframe_trajectory_tum", "save_keyframe_trajectory_euroc")


def _pose(system):
    lf = system.tracker.last_frame
    return lf.R.copy(), lf.t.copy()


def _jax_system(scene, frames, jparams, kw):
    """The JAX package's system tracking frame 1 on the two-keyframe map."""
    j = JaxSlam(scene.K, None, (scene.w, scene.h), tracking_params=jparams, **kw)
    m = build_reference_map(frames, n_kf=2)
    j.atlas.maps[0] = m
    j._bind_map(m)
    tr = j.tracker
    f0, f1 = frames[0], frames[1]
    lf = jax_build_frame(1, 1 / 20.0, jfeatures.OrbFeatures(
        **{k: jnp.asarray(f1[k]) for k in jfeatures.OrbFeatures._fields}))
    lf.R, lf.t = f1["R"].copy(), f1["t"].copy()
    lf.feat_mp = m.kf_feat_mp[1].copy()
    lf.tracked = True
    tr.last_frame = lf
    tr.velocity = ((f1["R"] @ f0["R"].T).astype(np.float32),
                   (f1["t"] - f1["R"] @ f0["R"].T @ f0["t"]).astype(np.float32))
    tr.state = JaxState.OK
    tr.ref_kf, tr.last_kf_frame_id, tr._last_kf_ts, tr.n_frames = 1, 1, 1 / 20.0, 2
    return j


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    n = 2 + LOC_FRAMES + MS_FRAMES
    scene, frames = room_frames(n)
    jparams = dense_tracking_params()
    kw = dict(n_features=512, seed=0, enable_loop_closing=False)
    j = _jax_system(scene, frames, jparams, kw)
    t = SlamSystem(scene.K, None, (scene.w, scene.h), device="cpu",
                   tracking_params=config_from(jparams, TrackingParams), **kw)
    _restore(t, _snapshot(j))
    feats = {}
    j.tracker.extract = lambda img: feats["jax"]
    t.tracker.extract = lambda img: feats["torch"]
    out = dict(jax=j, torch=t)

    def step(i):
        f = frames[i]
        feats["jax"] = jfeatures.OrbFeatures(**{k: jnp.asarray(f[k])
                                                for k in jfeatures.OrbFeatures._fields})
        feats["torch"] = OrbFeatures(**{k: T(f[k]) for k in OrbFeatures._fields})
        j.track_monocular(f["img"], ts=i / 20.0)
        t.track_monocular(f["img"], ts=i / 20.0)
        return dict(states=(j.state.name, t.state.name), poses=(_pose(j), _pose(t)),
                    n_kf=(j.map.n_kf, t.map.n_kf))

    out["kf_before_loc"] = (j.map.n_kf, t.map.n_kf)
    for s in (j, t):
        s.activate_localization_mode()
    out["loc"] = [step(i) for i in range(2, 2 + LOC_FRAMES)]
    out["tracked"] = {pkg: (s.get_tracked_map_points(), s.get_tracked_keypoints())
                      for pkg, s in (("jax", j), ("torch", t))}
    out["last_feat_mp"] = t.tracker.last_frame.feat_mp.copy()
    # the multi-start solve from here on, in both packages (still without
    # keyframes, so that no local BA parts the maps by its rounding)
    j.tracker.p.pose_starts = t.tracker.p.pose_starts = 7
    j.tracker.pose_opt = jkernels.pose_opt_kernel(cam_type=0, n_starts=7)
    t.tracker.pose_opt = tkernels.pose_opt_kernel(cam_type=0, n_starts=7)
    paths0 = dict(t.tracker.path_counts)
    out["ms"] = [step(i) for i in range(2 + LOC_FRAMES, n)]
    out["ms_paths"] = {k: t.tracker.path_counts[k] - paths0.get(k, 0)
                       for k in t.tracker.path_counts}
    for s in (j, t):
        s.deactivate_localization_mode()
    # the writers on one trajectory: the JAX package's, copied into the port
    t.tracker.trajectory = [tuple(np.array(v, copy=True) if isinstance(v, np.ndarray) else v
                                  for v in e) for e in j.tracker.trajectory]
    d = tmp_path_factory.mktemp("trajectories")
    out["files"] = {}
    for name in WRITERS:
        for pkg, s in (("jax", j), ("torch", t)):
            getattr(s, name)(str(d / f"{pkg}_{name}.txt"))
            out["files"][pkg, name] = (d / f"{pkg}_{name}.txt").read_text()
    return out


@pytest.mark.parametrize("writer", WRITERS)
def test_trajectory_writers_give_the_jax_lines(run, writer):
    jl = run["files"]["jax", writer].splitlines()
    tl = run["files"]["torch", writer].splitlines()
    assert len(tl) == len(jl) > 0
    n_ts = 0 if writer.endswith("kitti") else 1
    for a, b in zip(tl, jl):
        a, b = a.split(), b.split()
        assert a[:n_ts] == b[:n_ts] and len(a) == len(b)
        np.testing.assert_allclose(np.array(a[n_ts:], float), np.array(b[n_ts:], float),
                                   rtol=0, atol=1e-6)


def test_localization_mode_tracks_without_keyframes(run):
    assert run["kf_before_loc"][0] == run["kf_before_loc"][1]
    for i, rec in enumerate(run["loc"]):
        assert rec["states"][0] == rec["states"][1] == "OK", (i, rec["states"])
        assert rec["n_kf"] == run["kf_before_loc"], (i, rec["n_kf"])
        for a, b in zip(rec["poses"][0], rec["poses"][1]):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-3)
    assert not run["torch"].tracker.only_tracking      # deactivated again


def test_tracked_points_and_keypoints_are_the_last_frames(run):
    (jmp, jkp), (tmp, tkp) = run["tracked"]["jax"], run["tracked"]["torch"]
    fm = run["last_feat_mp"]
    assert np.array_equal(tmp, fm[fm >= 0])
    assert len(tmp) > 50 and len(np.intersect1d(tmp, jmp)) >= 0.9 * len(jmp)
    np.testing.assert_array_equal(tkp, jkp)


def test_multistart_frames_take_the_staged_path_like_jax(run):
    assert run["ms_paths"].get("staged", 0) == MS_FRAMES, run["ms_paths"]
    assert run["ms_paths"].get("fused", 0) == 0
    diffs = [max(float(np.abs(a - b).max()) for a, b in zip(*rec["poses"])) for rec in run["ms"]]
    for i, rec in enumerate(run["ms"]):
        assert rec["states"][0] == rec["states"][1] == "OK", (i, rec["states"])
    assert max(diffs) < 1e-3, diffs


def test_reset_active_map_then_reset_like_jax(run):
    out = {}
    for pkg in ("jax", "torch"):
        s = run[pkg]
        n_traj = len(s.export_trajectory()[0])
        s.reset_active_map()
        _, _, _, lost = s.export_trajectory()
        after_active = (s.map.n_kf, int(s.map.mp_valid.sum()), s.state.name,
                        len(s.atlas.maps), len(lost) == n_traj and bool(lost.all()))
        s.reset()
        after_reset = (s.map.n_kf, s.state.name, len(s.atlas.maps),
                       len(s.export_trajectory()[0]), s.mapper.map is s.map)
        out[pkg] = (after_active, after_reset)
    assert out["torch"] == out["jax"], out
    assert out["torch"] == ((0, 0, "NOT_INITIALIZED", 1, True),
                            (0, "NOT_INITIALIZED", 1, 0, True))


def test_writers_on_an_empty_log(tmp_path):
    """Before the first tracked frame every writer writes an empty file (the
    trajectory export is then shaped (0,), not (0, 3, 3))."""
    s = SlamSystem(np.array([458.654, 457.296, 376.0, 240.0], np.float32), None, (752, 480),
                   n_features=256, enable_loop_closing=False, device="cpu")
    for name in WRITERS:
        getattr(s, name)(str(tmp_path / f"{name}.txt"))
        assert (tmp_path / f"{name}.txt").read_text() == "", name


def test_time_stats_and_verbosity(run, tmp_path):
    """``print_time_stats`` and ``save_time_stats`` write the stage table of
    the run (the JAX package's format, with its stage names, e.g. the
    extraction and the staged tracking), and ``set_verbosity`` is the
    class-level switch of ``utils.verbose``, as in the JAX package."""
    import io
    from orbslam3_tpu_torch.utils import verbose
    s = run["torch"]
    buf = io.StringIO()
    s.print_time_stats(file=buf)
    s.save_time_stats(str(tmp_path / "ExecTimeMean.txt"))
    table = buf.getvalue()
    assert table == (tmp_path / "ExecTimeMean.txt").read_text()
    assert table.startswith("Stage timing") and "1.orb_extraction" in table
    assert "3.track_total" in table
    prev = verbose.get_verbosity()
    try:
        SlamSystem.set_verbosity(verbose.DEBUG)
        assert verbose.get_verbosity() == verbose.DEBUG
    finally:
        verbose.set_verbosity(prev)
