"""System facade: wires tracking, local mapping, loop closing and the Atlas.

Port of the visual paths of ``orbslam3_tpu/models/system.py``: ``SlamSystem``
with ``track_monocular`` (pinhole, or KB8 with ``cam_type=1``),
``track_stereo`` and ``track_rgbd`` (``bf`` = baseline·fx, ``th_depth``),
``set_fisheye_rig`` + ``track_stereo_fisheye`` (two KB8 cameras), trajectory
export and stats, loop
closing on by default (``models/loop_closing.py``: the BoW database, loop and
merge detection, Sim3 verification, essential-graph correction,
SearchAndFuse, then a global BA), BoW relocalization candidates and
relocalization into a stored Atlas map. ``mapping_mode="sync"`` runs the
mapper and the loop closer inline per keyframe (deterministic); ``"async"``
hands keyframes to the mapper thread and the loop-closing thread of
``models/async_runtime.py`` (a loop correction starts a background global
BA), and ``TrackingParams(pipeline=True)`` adds the tracker's software
pipeline. Everything that reads tracker state from outside (``state``,
``stats``, the trajectory export, ``shutdown``) first flushes the pipeline.

A rig with depth (``bf > 0``) closes loops and merges maps at a fixed scale.
``enable_imu`` turns any rig inertial: ``track_monocular_inertial`` and
``track_stereo_inertial`` hand the IMU samples since the last frame with
each frame (``track_rgbd`` and ``track_stereo_fisheye`` preintegrate the
samples queued by ``tracker.grab_imu``); the mapper initializes the IMU and
runs the inertial BAs, a bad-IMU verdict resets the active map through
``_on_bad_imu``, and on an IMU-initialized map the post-loop global pass is
FullInertialBA(7), the loop closer's essential graph has 4 degrees of
freedom and a merge welds with the inertial BA.
The rest of the facade: localization mode (tracking without keyframes),
``reset`` / ``reset_active_map``, the TUM, EuRoC and KITTI trajectory
writers (every frame, or the keyframes), the tracked map points and
keypoints, ``save_map`` / ``load_map`` (``utils/serialization.py``), the
stage-time table and ``use_viewer=True`` (``models/viewer.py``'s HTTP
viewer on ``viewer_port``; 0 takes a free port).
Every tensor lives on ``device``; ``device=None`` is the CUDA card, and there
is no fallback to the CPU.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..ops import features as feat_ops
from .async_runtime import AsyncRuntime
from .atlas import Atlas
from .local_mapping import LocalMapper
from .loop_closing import LoopCloser
from .map import MapConfig, MapState
from .tracking import Tracker, TrackingParams, TrackState
from ..utils.timing import StageTimer


def _quats(R_wc) -> np.ndarray:
    """(N,3,3) rotations → (N,4) unit quaternions (x, y, z, w)."""
    from ..ops import lie
    R = np.asarray(R_wc, np.float32).reshape(-1, 3, 3)     # an empty log is (0,)
    return lie.quat_from_mat(torch.as_tensor(R)).numpy()


class SlamSystem:
    @staticmethod
    def set_verbosity(level: int) -> None:
        """The reference's Verbose::SetTh; levels in ``utils.verbose``."""
        from ..utils import verbose
        verbose.set_verbosity(level)

    def __init__(self, K, D, wh, n_features: int = 1024,
                 tracking_params: TrackingParams | None = None,
                 map_cfg: MapConfig | None = None, seed: int = 0,
                 bf: float = 0.0, th_depth: float = 0.0,
                 enable_loop_closing: bool = True, cam_type: int = 0,
                 mapping_mode: str = "sync",
                 kf_cull_redundancy: float = 0.9,
                 use_viewer: bool = False, viewer_port: int = 8642, device=None):
        if mapping_mode not in ("sync", "async"):
            raise ValueError(f"mapping_mode must be 'sync' or 'async', got {mapping_mode!r}")
        self.device = resolve_device(device)
        self.orb_cfg = feat_ops.OrbConfig(n_features=n_features)
        cap = self.orb_cfg.total_capacity
        self.map_cfg = map_cfg or MapConfig(n_features=cap)
        if self.map_cfg.n_features != cap:
            self.map_cfg.n_features = cap
        self.timer = StageTimer()
        self.atlas = Atlas(self.map_cfg)
        self._K = np.asarray(K, np.float32)
        self._wh = wh
        self._bf = float(bf)
        self._enable_lc = bool(enable_loop_closing)
        self.merge_errors = 0
        self.last_merge_error = None
        self._kf_cull_redundancy = float(kf_cull_redundancy)
        self.cam_type = int(cam_type)
        self.tracker = Tracker(K, D, wh, self.orb_cfg, self.atlas.current,
                               params=tracking_params, seed=seed, bf=bf, th_depth=th_depth,
                               cam_type=cam_type, device=self.device)
        # async runtime: the mapper thread and its keyframe queue
        self.runtime = None
        if mapping_mode == "async":
            self.runtime = AsyncRuntime(self)
            self.tracker.mapper_accepting = self.runtime.accepting
        self._bind_map(self.atlas.current)
        self.tracker.on_tracking_lost = self._on_tracking_lost
        self.tracker.try_cross_map_reloc = self._try_cross_map_reloc
        self.frame_times: list[float] = []
        self.frame_spans: list[tuple] = []   # (t0, t1) perf_counter, per frame
        # the live viewer's threads (reference bUseViewer)
        self.viewer = None
        if use_viewer:
            from .viewer import LiveViewer
            self.viewer = LiveViewer(self, port=viewer_port)

    @property
    def map(self) -> MapState:
        return self.atlas.current

    def _bind_map(self, m):
        """(Re)bind mapper, loop closer and tracker to the active atlas map."""
        self.tracker.map = m
        self.tracker.timer = self.timer
        prev_stats = self.mapper.stats if getattr(self, "mapper", None) is not None else None
        prev_lc_stats = (self.loop_closer.stats
                         if getattr(self, "loop_closer", None) is not None else None)
        self.mapper = LocalMapper(m, self._K, self.orb_cfg, wh=self._wh,
                                  cam_type=self.cam_type, device=self.device)
        if prev_stats is not None:
            self.mapper.stats.update(prev_stats)   # counters are system-lifetime
        self.mapper.timer = self.timer
        self.mapper.kf_cull_redundancy = self._kf_cull_redundancy
        self.mapper.tracker = self.tracker
        self.mapper.inertial = self.tracker
        self.mapper.preserve_temporal_chain = self.tracker.imu_enabled
        self.mapper.on_bad_imu = self._on_bad_imu
        self.mapper.bf = self._bf
        # async mapping runs each BA phase in chunks of 3 LM iterations, as the
        # reference does (a different result from one call per phase); sync
        # keeps one call
        self.mapper.ba_chunk = 3 if self.runtime is not None else 0
        self.mapper.rig = self.tracker.rig
        self.loop_closer = None
        if self._enable_lc:
            # the reference's A.5 gates (20/15/20/50/80) are absolute counts
            # tuned for 1000+-feature budgets: scale them with the budget,
            # floored at 40%
            gs = max(min(1.0, self.orb_cfg.n_features / 1000.0), 0.4)
            # a rig with depth has a metric map: Sim3 with the scale fixed
            self.loop_closer = LoopCloser(
                m, self._K, self._wh, fix_scale=self._bf > 0, cam_type=self.cam_type,
                n_bow_matches=int(round(20 * gs)), n_bow_inliers=int(round(15 * gs)),
                n_sim3_inliers=int(round(20 * gs)), n_proj_matches=int(round(50 * gs)),
                n_proj_opt_matches=int(round(80 * gs)), device=self.device)
            self.loop_closer.timer = self.timer
            if prev_lc_stats is not None:
                self.loop_closer.stats.update(prev_lc_stats)
            # SearchAndFuse: the mapper's projection fuse
            self.loop_closer.fuse_fn = (
                lambda mp_ids, kf: self.mapper._fuse_into(np.asarray(mp_ids), int(kf), 4096))
            self.loop_closer.is_inertial = (
                lambda: getattr(self.tracker, "imu_initialized", False))
            # BoW relocalization candidates (DetectRelocalizationCandidates)
            self.tracker.reloc_candidates_fn = self.loop_closer.detect_relocalization_candidates
            # merge detection rides the loop closer's database; execution here
            self.loop_closer.stored_maps_fn = self.atlas.stored_maps
            self.loop_closer.merge_fn = self._merge_with
        else:
            self.tracker.reloc_candidates_fn = None
        self.mapper.on_poses_corrected = self._on_world_corrected
        if self.runtime is not None:
            m.on_remap["runtime"] = (
                lambda kf_remap, mp_remap, _m=m: self.runtime.on_map_remap(_m, kf_remap))

        def on_kf(kf_id, initial=False):
            if self.runtime is not None and not initial:
                # async: hand the keyframe to the mapper thread
                self.runtime.insert_keyframe(kf_id, initial)
                return
            # sync, or the bootstrap BA, which tracking needs at once; the
            # mapper may compact the pools: go on with the remapped id
            kf_id = self.mapper.process_keyframe(kf_id, initial=initial)
            if self.loop_closer is not None and not initial:
                if self.loop_closer.process_keyframe(kf_id):
                    # loop corrected → global BA (RunGlobalBundleAdjustment)
                    self.run_post_loop_gba(kf_id)
            if len(self.atlas.maps) > 1 and self.loop_closer is None:
                # merge detection rides the loop closer's database query;
                # this brute-force scan runs only without a loop closer
                self._check_map_merge(kf_id)

        self.tracker.on_new_keyframe = on_kf

    def run_post_loop_gba(self, kf_id: int, abort_check=None, propagate: bool = False) -> bool:
        """The global consistency pass after a loop correction: FullInertialBA(7)
        with zero bias priors on an IMU-initialized map (a visual global BA
        would move poses and points off the velocities and the
        preintegration chain), the visual global BA otherwise."""
        if getattr(self.tracker, "imu_initialized", False):
            self.mapper.full_inertial_ba(kf_id, iters=7, prior_g=0.0, prior_a=0.0)
            return True
        return self.mapper.global_ba(abort_check=abort_check, propagate=propagate)

    def _on_bad_imu(self):
        """Insufficient motion after the IMU init (reference mbBadImu): the
        inertial estimates are unusable, so the active map is reset. Runs in
        the mapper's context, so the reset is inline; stale queued keyframes
        are dropped by the runtime's map-identity check."""
        tr = self.tracker
        tr.imu_initialized = False
        tr.viba1_done = False
        tr.viba2_done = False
        tr.velocity_w = None
        tr.freeze_trajectory(mark_lost=True)
        cur = self.atlas.current
        idx = self.atlas.current_idx
        self.atlas.maps[idx] = MapState(self.map_cfg, map_id=cur.map_id)
        self._bind_map(self.atlas.maps[idx])
        tr.reset_for_new_map(self.atlas.maps[idx])

    def _on_world_corrected(self, R_rel, t_rel):
        """After a propagated background global BA: shift the tracker's live
        frame by the anchor correction T_f_new = T_f_old ∘ T_rel. (The motion
        model is camera-relative and needs no change.) Runs under the map
        lock."""
        lf = self.tracker.last_frame
        if lf is not None and lf.R is not None:
            R_old = lf.R.copy()
            lf.R = (R_old @ R_rel).astype(np.float32)
            lf.t = (R_old @ t_rel + lf.t).astype(np.float32)
        if self.tracker.velocity_w is not None:
            # T_rel maps the new world to the old: rotate the velocity back
            self.tracker.velocity_w = (R_rel.T @ self.tracker.velocity_w).astype(np.float32)

    def _on_tracking_lost(self):
        """Sustained loss: store the map in the Atlas and start a new one, or
        wipe it when it is too young to keep (reference CreateMapInAtlas)."""
        cur = self.atlas.current
        self.tracker.freeze_trajectory(mark_lost=cur.n_kf < 10)
        if cur.n_kf >= 10:
            new_map = self.atlas.create_new_map()
        else:
            idx = self.atlas.current_idx
            self.atlas.maps[idx] = MapState(self.map_cfg, map_id=cur.map_id)
            new_map = self.atlas.maps[idx]
        self._bind_map(new_map)
        self.tracker.reset_for_new_map(new_map)

    def _check_map_merge(self, kf_id: int) -> bool:
        """Cross-map place recognition when no loop closer is bound: verify
        the new keyframe against the stored maps' 10 newest keyframes. With a
        loop closer, merge detection is its database query over whole stored
        maps (``LoopCloser._try_merge``)."""
        cur = self.atlas.current
        closer = self.loop_closer
        if closer is None:
            closer = LoopCloser(cur, self._K, self._wh, fix_scale=self._bf > 0,
                                cam_type=self.cam_type, device=self.device)
        for old in self.atlas.stored_maps():
            for k2 in old.valid_kf_ids()[::-1][:10]:
                with cur.lock, old.lock:
                    ok, S21 = closer._verify_candidate(kf_id, int(k2), map1=cur, map2=old)
                if not ok:
                    continue
                if self._merge_with(kf_id, old, int(k2), S21):
                    return True
        return False

    def _merge_with(self, kf_id: int, old, k2: int, S21, cur_map=None,
                    cur_epoch=None) -> bool:
        """Atlas merge given a verified Sim3 between current-map ``kf_id`` and
        stored-map ``k2``: one world Sim3 moves every keyframe and map point
        of the current map into the stored map's world (the reference's
        MergeLocal window propagation factors into exactly that), the
        tracker's trajectory and live frame follow, then the weld
        (``_weld``). ``cur_map`` / ``cur_epoch`` name the map and compaction
        epoch the Sim3 was verified against; the merge is dropped if either
        changed since."""
        cur = self.atlas.current
        if cur_map is not None and cur_map is not cur:
            return False
        with cur.lock, old.lock:
            if cur_epoch is not None and cur.remap_epoch != cur_epoch:
                return False
            if not cur.kf_valid[kf_id] or not old.kf_valid[k2]:
                return False
            # S21: x_kf2 = s R x_kf1 + t (camera frames); world alignment
            # W_old = T_kf2⁻¹ ∘ S21 ∘ T_kf1 (W_cur)
            s, R21, t21 = S21
            R1, t1 = cur.kf_R[kf_id], cur.kf_t[kf_id]
            R2, t2 = old.kf_R[int(k2)], old.kf_t[int(k2)]
            R_a = R2.T @ R21 @ R1
            t_a = R2.T @ (s * (R21 @ t1) + t21 - t2)
            self.atlas.merge_current_into(old, R_a.astype(np.float32),
                                          t_a.astype(np.float32), s_align=float(s))
            kf_map = self.atlas.last_merge_kf_map
            self.tracker.remap_trajectory_for_merge(kf_map)
            self.tracker.rotate_world_state_for_merge(R_a, float(s))
            self._bind_map(self.atlas.current)
            self.tracker.map = self.atlas.current
            lf = self.tracker.last_frame
            if lf is not None and lf.R is not None:
                R_new = lf.R @ R_a.T
                t_new = float(s) * lf.t - R_new @ t_a
                lf.R, lf.t = R_new.astype(np.float32), t_new.astype(np.float32)
            self.tracker.ref_kf = int(old.valid_kf_ids()[-1])
            nk = kf_map.get(int(kf_id))
            if nk is not None:
                self._weld(nk, int(k2))
        return True

    def _weld(self, nk: int, k2: int, cap: int = 4096):
        """Fuse duplicated landmarks between the migrated keyframe ``nk`` and
        the matched old-map region around ``k2``, run a welding local BA, then
        the essential graph on the rest of the map with the welding window
        fixed and its edges measured on the pre-weld poses (the reference's
        MergeLocal)."""
        m = self.atlas.current
        mapper = self.mapper
        group2 = np.concatenate([[k2], m.best_covisible(k2, 5, min_weight=15)])
        pts2 = m.local_map_points(group2.astype(np.int32))
        mapper._fuse_into(pts2, nk, cap)
        row = m.kf_feat_mp[nk]
        pts_nk = np.unique(row[row >= 0])
        for t in group2:
            mapper._fuse_into(pts_nk, int(t), cap)
        m.refresh_map_points(pts_nk)
        meas = (m.kf_R.copy(), m.kf_t.copy())
        if getattr(self.tracker, "imu_initialized", False):
            # the inertial weld (reference MergeInertialBA): a visual weld BA
            # would move the window off its preintegration chain
            mapper.local_inertial_ba(nk)
        else:
            mapper.local_ba(nk)
        if self.loop_closer is not None and m.kf_valid[: m.n_kf].sum() > 4:
            fixed = [nk] + [int(g) for g in group2]
            try:
                self.loop_closer.optimize_essential_graph(fixed, meas=meas)
            except Exception as e:   # keep the merge, but count the defect
                self.merge_errors += 1
                self.last_merge_error = repr(e)
                from ..utils import verbose
                verbose.print_mess(f"merge essential graph failed: {e!r}", verbose.NORMAL)

    def _try_cross_map_reloc(self, frame) -> bool:
        """Relocalize into a stored map; success merges the current map into
        it (a rigid alignment from the frame's two poses)."""
        tr = self.tracker
        R_cur = t_cur = None
        if tr.last_frame is not None and tr.last_frame.R is not None:
            R_cur, t_cur = tr.last_frame.R.copy(), tr.last_frame.t.copy()
        for old in self.atlas.stored_maps():
            with old.lock:   # the caller holds the current map's lock
                if not tr._relocalize(frame, in_map=old):
                    continue
                cur = self.atlas.current
                if cur.n_kf >= 2 and R_cur is not None:
                    # world_old ← world_cur from the dual pose
                    R_a = frame.R.T @ R_cur
                    t_a = frame.R.T @ (t_cur - frame.t)
                    self.atlas.merge_current_into(old, R_a.astype(np.float32),
                                                  t_a.astype(np.float32))
                    tr.remap_trajectory_for_merge(self.atlas.last_merge_kf_map)
                    tr.rotate_world_state_for_merge(R_a)
                else:
                    tr.freeze_trajectory()
                    self.atlas.current_idx = self.atlas.maps.index(old)
                self._bind_map(self.atlas.current)
                tr.map = self.atlas.current
                tr.state = TrackState.OK
                return True
        return False

    def track_monocular(self, img: np.ndarray, ts: float) -> dict:
        t0 = time.perf_counter()
        info = self.tracker.process_frame(img, ts)
        t1 = time.perf_counter()
        self.frame_times.append(t1 - t0)
        self.frame_spans.append((t0, t1))
        return info

    def enable_imu(self, freq: float = 200.0, noise=(1.7e-4, 2e-3, 1e-5, 1e-4)):
        """Visual-inertial mode (reference IMU_MONOCULAR / IMU_STEREO, and the
        inertial RGB-D and fisheye rigs): the IMU rate and the (gyro, acc,
        gyro walk, acc walk) noise densities."""
        self.tracker.enable_imu(freq=freq, noise=noise)
        self.mapper.preserve_temporal_chain = True

    def track_monocular_inertial(self, img: np.ndarray, ts: float, imu_ts, imu_gyro,
                                 imu_acc) -> dict:
        """Monocular-inertial step: queue the IMU samples since the last
        frame, then track the image (reference System::TrackMonocular with
        vImuMeas; pinhole or KB8 through ``cam_type``)."""
        self.tracker.grab_imu(imu_ts, imu_gyro, imu_acc)
        return self.track_monocular(img, ts)

    def track_stereo_inertial(self, img_l: np.ndarray, img_r: np.ndarray, ts: float,
                              imu_ts, imu_gyro, imu_acc) -> dict:
        """Stereo-inertial step: queue the IMU samples since the last frame,
        then track the stereo pair (reference System::TrackStereo with
        vImuMeas)."""
        self.tracker.grab_imu(imu_ts, imu_gyro, imu_acc)
        return self.track_stereo(img_l, img_r, ts)

    def track_stereo(self, img_l: np.ndarray, img_r: np.ndarray, ts: float) -> dict:
        """Rectified stereo step (``bf`` = baseline·fx)."""
        t0 = time.perf_counter()
        info = self.tracker.process_stereo_frame(img_l, img_r, ts)
        t1 = time.perf_counter()
        self.frame_times.append(t1 - t0)
        self.frame_spans.append((t0, t1))
        return info

    def set_fisheye_rig(self, cam_r, R_rl, t_rl, lap_l=(0.0, 1e9), lap_r=(0.0, 1e9)):
        """Two-camera fisheye rig (reference Camera2.* + Tlr): the second
        camera's KB8 parameters, the right←left extrinsics and the lapping
        areas. The mapper's BA gains the second camera's rows."""
        self.tracker.set_fisheye_rig(cam_r, R_rl, t_rl, lap_l, lap_r)
        self._bf = self.tracker.bf
        self.mapper.bf = self.tracker.bf
        self.mapper.rig = self.tracker.rig

    def track_stereo_fisheye(self, img_l: np.ndarray, img_r: np.ndarray, ts: float) -> dict:
        """Two-camera fisheye step (reference TrackStereo with KB8 cameras)."""
        t0 = time.perf_counter()
        info = self.tracker.process_fisheye_stereo_frame(img_l, img_r, ts)
        t1 = time.perf_counter()
        self.frame_times.append(t1 - t0)
        self.frame_spans.append((t0, t1))
        return info

    def track_rgbd(self, img: np.ndarray, depth_map: np.ndarray, ts: float) -> dict:
        """RGB-D step: the depth at each keypoint becomes a virtual right
        coordinate (reference GrabImageRGBD + ComputeStereoFromRGBD)."""
        t0 = time.perf_counter()
        info = self.tracker.process_rgbd_frame(img, depth_map, ts)
        t1 = time.perf_counter()
        self.frame_times.append(t1 - t0)
        self.frame_spans.append((t0, t1))
        return info

    def wait_idle(self, timeout: float = 300.0) -> bool:
        """Drain the async mapper (nothing is ever queued in sync mode)."""
        if self.runtime is None:
            return True
        return self.runtime.wait_idle(timeout)

    def shutdown(self, timeout: float = 300.0, print_times: bool = True):
        """Finalize in-flight frames, drain and join the mapper thread, and
        print the per-stage timing table."""
        self.tracker.flush_pending()
        if self.viewer is not None:
            self.viewer.close()
            self.viewer = None
        if self.runtime is not None:
            self.runtime.shutdown(timeout)
            self.runtime = None
        if print_times and self.timer.samples:
            from ..utils import verbose
            if verbose.get_verbosity() >= verbose.NORMAL:
                self.timer.print_stats()

    @property
    def state(self) -> TrackState:
        """The tracking state after the last frame handed in (finalizes any
        frame still in the software pipeline)."""
        self.tracker.flush_pending()
        return self.tracker.state

    def get_tracking_state(self) -> TrackState:
        return self.state

    def export_trajectory(self):
        self.tracker.flush_pending()
        return self.tracker.export_trajectory()

    def print_time_stats(self, file=None):
        """The per-stage timing table (reference PrintTimeStats)."""
        self.timer.print_stats(file=file)

    def save_time_stats(self, path: str):
        """The per-stage timing table as a file (reference ExecTimeMean.txt)."""
        self.timer.save(path)

    @staticmethod
    def _write_tum(path: str, ts, R_wc, t_wc):
        """TUM format: ts tx ty tz qx qy qz qw."""
        q = _quats(R_wc)
        with open(path, "w") as f:
            for i in range(len(ts)):
                f.write(f"{ts[i]:.6f} " + " ".join(f"{v:.7f}" for v in t_wc[i])
                        + " " + " ".join(f"{v:.7f}" for v in q[i]) + "\n")

    @staticmethod
    def _write_euroc(path: str, ts, R_wc, t_wc):
        """EuRoC format: ts_ns tx ty tz qw qx qy qz."""
        q = _quats(R_wc)
        with open(path, "w") as f:
            for i in range(len(ts)):
                f.write(f"{ts[i]*1e9:.0f} " + " ".join(f"{v:.9f}" for v in t_wc[i])
                        + f" {q[i,3]:.9f} {q[i,0]:.9f} {q[i,1]:.9f} {q[i,2]:.9f}\n")

    def save_trajectory_tum(self, path: str):
        """Every frame's pose, TUM format (reference SaveTrajectoryTUM)."""
        ts, R_wc, t_wc, _ = self.export_trajectory()
        self._write_tum(path, ts, R_wc, t_wc)

    def save_trajectory_euroc(self, path: str):
        """Every frame's pose, EuRoC format (reference SaveTrajectoryEuRoC)."""
        ts, R_wc, t_wc, _ = self.export_trajectory()
        self._write_euroc(path, ts, R_wc, t_wc)

    def _keyframe_poses(self):
        """(ts, R_wc, t_wc) per valid keyframe of the active map."""
        self.tracker.flush_pending()
        m = self.map
        with m.lock:
            ids = m.valid_kf_ids()
            ts = m.kf_ts[ids].copy()
            R_cw = m.kf_R[ids].copy()
            t_cw = m.kf_t[ids].copy()
        R_wc = R_cw.transpose(0, 2, 1)
        t_wc = -np.einsum("nij,nj->ni", R_wc, t_cw)
        return ts, R_wc, t_wc

    def save_keyframe_trajectory_tum(self, path: str):
        """Keyframe poses, TUM format (reference SaveKeyFrameTrajectoryTUM)."""
        self._write_tum(path, *self._keyframe_poses())

    def save_keyframe_trajectory_euroc(self, path: str):
        """Keyframe poses, EuRoC format (reference SaveKeyFrameTrajectoryEuRoC)."""
        self._write_euroc(path, *self._keyframe_poses())

    def save_trajectory_kitti(self, path: str):
        """KITTI format: the 12 values of the 3x4 [R|t] world←camera matrix
        per frame (reference SaveTrajectoryKITTI)."""
        ts, R_wc, t_wc, _ = self.export_trajectory()
        with open(path, "w") as f:
            for i in range(len(ts)):
                M = np.concatenate([R_wc[i], t_wc[i][:, None]], axis=1)
                f.write(" ".join(f"{v:.9e}" for v in M.reshape(-1)) + "\n")

    def activate_localization_mode(self):
        """Tracking only: the map is frozen because the tracker makes no
        keyframe (reference ActivateLocalizationMode)."""
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        """Keyframes again (reference DeactivateLocalizationMode)."""
        self.tracker.only_tracking = False

    def reset(self):
        """Wipe every map of the Atlas (reference System::Reset). The async
        threads drain first; whatever they are handed afterwards is tagged
        with the new map."""
        self.tracker.flush_pending()
        self.wait_idle()
        self.atlas = Atlas(self.map_cfg)
        self._bind_map(self.atlas.current)
        self.tracker.reset_for_new_map(self.atlas.current)
        self.tracker.trajectory.clear()

    def reset_active_map(self):
        """Wipe the active map only (reference System::ResetActiveMap)."""
        self.tracker.flush_pending()
        self.wait_idle()
        self.tracker.freeze_trajectory(mark_lost=True)
        cur = self.atlas.current
        idx = self.atlas.current_idx
        self.atlas.maps[idx] = MapState(self.map_cfg, map_id=cur.map_id)
        self._bind_map(self.atlas.maps[idx])
        self.tracker.reset_for_new_map(self.atlas.maps[idx])

    def get_tracked_map_points(self) -> np.ndarray:
        """Ids of the map points matched in the last frame (reference
        GetTrackedMapPoints)."""
        self.tracker.flush_pending()
        lf = self.tracker.last_frame
        if lf is None or lf.feat_mp is None:
            return np.zeros(0, np.int64)
        mp = lf.feat_mp[lf.feat_mp >= 0]
        return mp[self.map.mp_valid[mp]]

    def get_tracked_keypoints(self) -> np.ndarray:
        """(N,2) keypoints of the last frame (reference
        GetTrackedKeyPointsUn)."""
        self.tracker.flush_pending()
        lf = self.tracker.last_frame
        if lf is None:
            return np.zeros((0, 2), np.float32)
        return lf.xy[lf.valid]

    def save_map(self, dir_path: str):
        """Write the whole Atlas to ``dir_path`` (``utils/serialization.py``)."""
        from ..utils import serialization
        self.tracker.flush_pending()
        self.wait_idle()
        serialization.save_atlas(self.atlas, dir_path)

    def load_map(self, dir_path: str):
        """Replace the Atlas by a saved one and re-bind the pipeline to it.
        The device side follows by itself: the map mirrors are keyed by the
        map object, and the new loop closer's database starts empty, as in
        the JAX package. The tracker comes back RECENTLY_LOST on a map with
        keyframes and relocalizes into it."""
        from ..utils import serialization
        self.tracker.flush_pending()
        self.wait_idle()
        self.atlas = serialization.load_atlas(dir_path, self.map_cfg)
        self._bind_map(self.atlas.current)
        self.tracker.reset_for_new_map(self.atlas.current)

    def stats(self) -> dict:
        """Counters of the run. The exceptions the threads and the tracker's
        BoW query catch (so that a failed round does not stop the pipeline)
        are counted, never hidden: ``mapper_errors``, ``lc_errors``,
        ``gba_errors``, ``reloc_query_errors`` and ``merge_errors`` (the
        essential graph of an Atlas merge), each with its last ``repr``."""
        self.tracker.flush_pending()
        ft = np.array(self.frame_times) if self.frame_times else np.zeros(1)
        out = {
            "n_frames": len(self.frame_times),
            "n_keyframes": int(self.map.kf_valid.sum()),
            "n_map_points": int(self.map.mp_valid.sum()),
            "mean_frame_ms": float(ft.mean() * 1e3),
            "median_frame_ms": float(np.median(ft) * 1e3),
            "fps": float(1.0 / max(ft.mean(), 1e-9)),
            "mapper_errors": 0, "lc_errors": 0, "gba_errors": 0,
            **self.mapper.stats,
        }
        if self.loop_closer is not None:
            out.update(self.loop_closer.stats)
        out["reloc_query_errors"] = self.tracker.reloc_query_errors
        if self.tracker.last_reloc_query_error is not None:
            out["last_reloc_query_error"] = self.tracker.last_reloc_query_error
        out["merge_errors"] = self.merge_errors
        if self.last_merge_error is not None:
            out["last_merge_error"] = self.last_merge_error
        out["stage_times"] = self.timer.stats()
        return out
