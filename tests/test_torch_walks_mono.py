"""The monocular slice end to end in the port against the JAX package, one
configuration (752x480 RoomScene frames, 512 features, a 5-frame keyframe
cadence), so that the JAX package's programs for it are built once per
module: the slice with its defaults (sync mapping, loop closing on:
``TestE2eMono``) and the headline configuration (async mapping and the
software pipeline: ``TestAsync``, with the runtime's own invariants). Each
class keeps the module it came from as its docstring, with its tolerances.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from conftest import dense_tracking_params
from orbslam3_tpu.models.system import SlamSystem as JaxSlam
from orbslam3_tpu.utils.datasets import RoomScene, orbit_trajectory
from orbslam3_tpu.utils.evaluation import evaluate_trajectory
from orbslam3_tpu_torch.models.async_runtime import AsyncRuntime
from orbslam3_tpu_torch.models.system import SlamSystem
from orbslam3_tpu_torch.models.tracking import TrackingParams, TrackState
from orbslam3_tpu_torch.ops import match_rows as mr
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


K4 = np.array([458.0, 457.0, 376.0, 240.0], np.float32)


class _FakeMapper:
    def __init__(self):
        self.stats = {}
        self.done = []

    def process_keyframe(self, kf_id, initial=False, abort_check=None):
        time.sleep(0.0005)
        if kf_id % 97 == 0:
            raise ValueError(f"keyframe {kf_id}")
        self.done.append(kf_id)
        return kf_id


class _FakeSystem:
    device = torch.device("cpu")

    def __init__(self):
        self.map = object()
        self.mapper = _FakeMapper()


class _LoopSystem:
    """What the runtime's loop thread reads of a system: the drifted map
    (tests/test_loop_closing.py's, rebuilt by torch_port_helpers), the port's
    loop closer on it, a real mapper for the background global BA."""
    device = torch.device("cpu")

    def __init__(self):
        from orbslam3_tpu_torch.models import map as tmap
        from orbslam3_tpu_torch.models.local_mapping import LocalMapper
        from orbslam3_tpu_torch.models.loop_closing import LoopCloser
        from orbslam3_tpu_torch.ops.features import OrbConfig
        from torch_port_helpers import build_drifted_map
        self.map, gt_R, gt_t, self.n_kf = build_drifted_map(tmap)
        self.gt = np.stack([-R.T @ t for R, t in zip(gt_R, gt_t)])
        K = np.array([458.0, 458.0, 376.0, 240.0], np.float32)
        self.loop_closer = LoopCloser(self.map, K, (752, 480), min_kfs=4, exclude_recent=4,
                                      fix_scale=True, device="cpu")
        self.mapper = LocalMapper(self.map, K, OrbConfig(n_features=512), device="cpu")
        self.tracker = object()


class TestE2eMono:
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

    @pytest.fixture(scope="class")
    def runs(self):
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

    def test_reference_run_needs_no_relocalization(self, runs):
        """The slice leaves relocalization out; that is sound only while the JAX
        run of this fixture never relocalizes."""
        tr = runs["jax"]["system"].tracker
        assert tr._last_reloc_frame_id < 0
        assert all(s == "OK" for s in runs["jax"]["states"][10:])

    def test_port_initializes_and_tracks(self, runs):
        r = runs["torch"]
        assert r["system"].state == TrackState.OK
        assert sum(s != "OK" for s in r["states"][10:]) <= 4, r["states"]
        assert r["n_tracked"] > 0.7 * N_FRAMES
        st = r["stats"]
        assert st["triangulated"] > 0 and st["ba_runs"] >= 1
        assert st.get("culled_kf", 0) > 0
        assert st["n_map_points"] > 150
        assert r["system"].tracker.path_counts["fused"] > 0.5 * N_FRAMES

    def test_port_ate_and_keyframes_match_reference(self, runs):
        j, t = runs["jax"], runs["torch"]
        assert t["n_assoc"] > 0.7 * N_FRAMES
        bound = max(1.5 * j["ate"], j["ate"] + 0.02)
        assert t["ate"] <= bound, (t["ate"], j["ate"])
        assert abs(t["stats"]["n_keyframes"] - j["stats"]["n_keyframes"]) <= 2

    def test_trajectory_export_tum_format(self, runs, tmp_path):
        path = tmp_path / "traj.txt"
        runs["torch"]["system"].save_trajectory_tum(str(path))
        lines = path.read_text().strip().splitlines()
        assert len(lines) > 10
        row = [float(x) for x in lines[0].split()]
        assert len(row) == 8
        assert abs(np.linalg.norm(row[4:]) - 1.0) < 1e-4

    def test_loop_closer_matches_reference(self, runs):
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
    def test_unported_options_raise(self, kw):
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


class TestAsync:
    """Async mapping + the software pipeline: the port's headline configuration
    (``mapping_mode="async"``, ``TrackingParams(pipeline=True)``, no loop closing)
    against the JAX package's run of the same configuration, both on the CPU, at
    a small size (32 rendered orbit frames, 512 features), plus the runtime's own
    invariants.

    Async mapping makes keyframe timing depend on thread scheduling, so, like
    tests/test_async.py and tests/test_pipeline.py, the run is held to quality
    bands, not to equality: it tracks, drains, reports no mapper error, and its
    ATE is no worse than max(1.5 x JAX ATE, JAX ATE + 0.02) (the end-to-end bound
    of ``TestE2eMono``). Measured on this fixture: JAX ATE 0.028
    with 10 keyframes, the port 0.009 with 8.
    """

    @pytest.fixture(scope="class")
    def runs(self):
        scene = RoomScene(seed=1, n_clutter=4)
        poses = orbit_trajectory(N_FRAMES, radius=1.0, forward=0.0)
        imgs = render_all(scene, poses)
        gt = np.array([-R.T @ t for R, t in poses])
        jparams = dense_tracking_params(pipeline=True)
        systems = {
            "jax": JaxSlam(scene.K, None, (scene.w, scene.h), n_features=512, seed=0,
                           tracking_params=jparams, enable_loop_closing=False,
                           mapping_mode="async"),
            "torch": SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512, seed=0,
                                tracking_params=config_from(jparams, TrackingParams),
                                enable_loop_closing=False, mapping_mode="async", device="cpu"),
        }
        out = {}
        for name, s in systems.items():
            infos = [s.track_monocular(img, ts=i / 20.0) for i, img in enumerate(imgs)]
            pending_before_read = len(s.tracker._pending)
            state = s.get_tracking_state()                 # flushes
            drained = s.wait_idle(timeout=300.0)
            st = s.stats()
            ts, _, t_wc, lost = s.export_trajectory()
            sel = ~lost
            ate, n_assoc = evaluate_trajectory(np.arange(N_FRAMES) / 20.0, gt, ts[sel], t_wc[sel],
                                               with_scale=True)
            s.shutdown(print_times=False)
            out[name] = dict(system=s, infos=infos, state=state, drained=drained, stats=st,
                             ate=ate, n_assoc=n_assoc, n_logged=len(ts), n_lost=int(lost.sum()),
                             pending_before_read=pending_before_read)
        return out

    def test_async_pipelined_tracks_and_drains(self, runs):
        r = runs["torch"]
        assert r["drained"]
        assert r["state"].name == "OK" == runs["jax"]["state"].name
        st = r["stats"]
        assert st.get("mapper_errors", 0) == 0, st.get("last_mapper_error")
        assert st["n_keyframes"] >= 3 and st["n_map_points"] > 100, st
        assert st["triangulated"] > 0 and st["ba_runs"] >= 1
        assert r["n_logged"] >= N_FRAMES - 5 and r["n_lost"] == 0
        counts = r["system"].tracker.path_counts
        assert counts["fused"] > 0.5 * N_FRAMES, counts

    def test_pipeline_defers_and_flushes_on_read(self, runs):
        """A dispatched frame is finalized by the next call, or by the first
        outside read of tracker state."""
        r = runs["torch"]
        assert r["pending_before_read"] == 1            # the last frame was in flight
        assert r["system"].tracker._pending == []
        assert any(i.get("pending") for i in r["infos"])
        assert r["system"].runtime is None              # shutdown joined the mapper thread

    def test_slice_ate_within_reference_band(self, runs):
        j, t = runs["jax"], runs["torch"]
        assert t["n_assoc"] >= N_FRAMES - 5
        assert t["ate"] <= max(1.5 * j["ate"], j["ate"] + 0.02), (t["ate"], j["ate"])
        assert t["ate"] < 0.08                          # tests/test_pipeline.py's band
        assert abs(t["stats"]["n_keyframes"] - j["stats"]["n_keyframes"]) <= 3

    def test_entry_points_default_to_the_card(self):
        """``device=None`` is the CUDA device; without one the constructor raises
        instead of running on the CPU, and ``device="cpu"`` still works."""
        from orbslam3_tpu_torch.models import kernels
        from orbslam3_tpu_torch.ops import features
        if torch.cuda.is_available():
            assert SlamSystem(K4, None, (752, 480), n_features=256,
                              enable_loop_closing=False).device.type == "cuda"
            s = SlamSystem(K4, None, (752, 480))                 # every default
            assert s.device.type == "cuda" and s.loop_closer.device.type == "cuda"
            return
        with pytest.raises(RuntimeError, match="CUDA"):
            SlamSystem(K4, None, (752, 480), n_features=256, enable_loop_closing=False)
        with pytest.raises(RuntimeError, match="CUDA"):
            SlamSystem(K4, None, (752, 480))                     # every default
        with pytest.raises(RuntimeError, match="CUDA"):
            features.make_extractor(480, 752, features.OrbConfig(n_features=256))
        with pytest.raises(RuntimeError, match="CUDA"):
            kernels.projection_matcher(0, 8, 1.2)
        assert kernels.projection_matcher(0, 8, 1.2, device="cpu") is \
            kernels.projection_matcher(0, 8, 1.2, device=torch.device("cpu"))
        s = SlamSystem(K4, None, (752, 480), n_features=256, enable_loop_closing=False,
                       device="cpu")
        assert s.device.type == "cpu" and s.tracker.device.type == "cpu"
        s = SlamSystem(K4, None, (752, 480), device="cpu")       # loop closing is the default
        assert s.loop_closer is not None and s.loop_closer.device.type == "cpu"
        assert s.tracker.reloc_candidates_fn == s.loop_closer.detect_relocalization_candidates

    def test_runtime_never_reports_idle_with_work_left(self):
        """Stress: four producers push keyframes with a shortened switch
        interval; whenever ``wait_idle()`` returns True, every keyframe the
        caller pushed before must have been processed or counted as an error (a
        stale idle flag would break it), and an exception in the mapper is
        counted, kept and does not stop the thread."""
        prev = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        fake = _FakeSystem()
        rt = AsyncRuntime(fake)
        pushed = []
        lock = threading.Lock()

        def produce(base):
            mine = []
            for i in range(120):
                with lock:
                    pushed.append(base + i)
                mine.append(base + i)
                rt.insert_keyframe(base + i, False)
                if i % 30 == 29:
                    assert rt.wait_idle(timeout=30.0)
                    # whatever this thread pushed before wait_idle returned True
                    # has been handled: processed, or raised and counted
                    done = set(fake.mapper.done)
                    assert all(k in done or k % 97 == 0 for k in mine)
        try:
            threads = [threading.Thread(target=produce, args=(1000 * k + 1,)) for k in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60.0)
                assert not th.is_alive()
            assert rt.wait_idle(timeout=30.0)
            n_err = fake.mapper.stats.get("mapper_errors", 0)
            assert len(fake.mapper.done) + n_err == len(pushed) == 480
            assert n_err == sum(k % 97 == 0 for k in pushed) > 0
            assert "keyframe" in fake.mapper.stats["last_mapper_error"]
            assert not rt.abort_requested() and rt.accepting()
        finally:
            rt.shutdown(timeout=30.0)
            sys.setswitchinterval(prev)
        assert not rt._mapper_thread.is_alive()

    def test_launch_counter_loses_no_update(self):
        """The kernels' launch counts are bumped from the tracker and the mapper
        thread: eight threads, shortened switch interval, exact total."""
        prev = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        before = mr.match_rows_dual.launches
        try:
            threads = [threading.Thread(
                target=lambda: [mr._launched(mr.match_rows_dual, 0) for _ in range(2000)])
                for _ in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60.0)
                assert not th.is_alive()
            assert mr.match_rows_dual.launches == before + 16000
            with pytest.raises(RuntimeError, match="cudaError 9"):
                mr._launched(mr.match_rows_dual, 9)
        finally:
            mr.match_rows_dual.launches = before
            sys.setswitchinterval(prev)

    def test_loop_thread_corrects_pauses_mapper_and_joins(self):
        """The drifted map's keyframes go through the loop-closing thread: it
        corrects the loop at keyframe 18 with the mapper paused for the
        correction and released after it, starts the background global BA, and
        ``shutdown`` joins the mapper, loop and global-BA threads."""
        sysm = _LoopSystem()
        rt = AsyncRuntime(sysm)
        lc = sysm.loop_closer
        paused = []
        inner = lc._correct_loop

        def correct(*a, **k):
            paused.append(rt._stop_requested.is_set())
            return inner(*a, **k)

        lc._correct_loop = correct
        try:
            for k in range(sysm.n_kf):
                rt.loop_queue.push((sysm.map, k))
                assert rt.wait_idle(timeout=120.0)
            gba = rt.gba
        finally:
            rt.shutdown(timeout=120.0)
        assert rt.threads_alive() == []
        assert lc.stats["loops_corrected"] == 1 and lc.loop_edges == [(18, 0)]
        assert lc.stats.get("lc_errors", 0) == 0, lc.stats.get("last_lc_error")
        assert paused == [True] and not rt._stop_requested.is_set()
        assert gba is not None and gba.applied is True and not gba.running
        assert sysm.mapper.stats["gba_runs"] == 1 and sysm.mapper.stats.get("gba_errors", 0) == 0
        m = sysm.map
        centres = np.stack([-m.kf_R[k].T @ m.kf_t[k] for k in range(sysm.n_kf)])
        errs = np.linalg.norm(centres - sysm.gt, axis=1)
        assert errs[-1] < 0.2 and errs.max() < 0.6, errs

    def test_loop_thread_error_is_counted_and_releases_the_mapper(self):
        """An exception inside the loop closer's round (here: in the
        correction, after the mapper was paused) is counted in ``lc_errors`` with
        its repr; the mapper is released and the thread goes on."""
        sysm = _LoopSystem()
        rt = AsyncRuntime(sysm)
        lc = sysm.loop_closer

        def broken(*a, **k):
            raise RuntimeError("correction failed")

        lc._correct_loop = broken
        try:
            for k in range(sysm.n_kf):
                rt.loop_queue.push((sysm.map, k))
            assert rt.wait_idle(timeout=120.0)
            assert not rt._stop_requested.is_set() and rt.accepting()
        finally:
            rt.shutdown(timeout=60.0)
        assert lc.stats["lc_errors"] >= 1 and "correction failed" in lc.stats["last_lc_error"]
        assert lc.stats["loops_corrected"] == 0 and rt.threads_alive() == []
