"""Tracking front end: the per-frame state machine (monocular, visual).

Port of the monocular visual path of ``orbslam3_tpu/models/tracking.py``: the
host state machine is the reference's (NOT_INITIALIZED / OK / RECENTLY_LOST /
LOST), only the device calls change. It covers monocular initialization
(two-view H/F RANSAC → initial map), the fused per-frame tracker
(``kernels.fused_track_pooled``), the staged fallback cascade (motion model
with 2x-radius retry, reference keyframe, local map), relocalization against
the keyframe database's BoW candidates and the recent keyframes (descriptor
matching → PnP RANSAC → MLPnP refinement → pose LM → guided rescue rounds)
and, failing that, into a stored Atlas map (the system's
``try_cross_map_reloc``), the software pipeline (``TrackingParams.pipeline``,
depth 1 and 2), the keyframe policy with the mapper's back-pressure gate, and
trajectory logging/export with the remapping an Atlas merge needs.

The pipeline's packed result travels to the host as a non-blocking copy into
pinned memory followed by a CUDA event; consuming a frame waits on that event
only, never on the whole device (the mapper thread may have work queued on
its own stream).

Not ported yet (ROADMAP.md): stereo/RGB-D front ends and the IMU paths
(``_track_with_prediction``).
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np
import torch

from .. import resolve_device
from ..ops import camera as cam_ops
from ..ops import features as feat_ops
from ..ops import matching as match_ops
from ..ops import pnp as pnp_ops
from ..utils import verbose
from ..utils.timing import StageTimer
from . import kernels
from .device_map import mirror_for
from .frame import Frame, build_frame
from .map import MapState, locked_current


class TrackState(Enum):
    NOT_INITIALIZED = 0
    OK = 1
    RECENTLY_LOST = 2
    LOST = 3


@dataclass
class TrackingParams:
    """The reference's tracking parameters, same names and defaults (see
    ``orbslam3_tpu/models/tracking.py`` for the rationale of each)."""
    motion_radius: float = 8.0
    local_radius: float = 3.0
    motion_ratio: float = 0.9
    refkf_ratio: float = 0.7
    local_ratio: float = 0.8
    th_high: int = 100
    th_low: int = 50
    min_motion_matches: int = 20
    min_motion_inliers: int = 10
    min_local_inliers: int = 30
    min_init_matches: int = 100
    max_frames_between_kf: int = 20
    min_frames_between_kf: int = 0
    ref_ratio: float = 0.9
    kf_interval_override: int = 0
    max_local_kfs: int = 20
    max_local_mps: int = 4096
    local_passes: int = 1
    pose_starts: int = 1
    cv_predict_min_px: float = 6.0
    pose_prior_eps: float = 3e-4
    time_recently_lost: float = 5.0
    pipeline: bool = False
    pipeline_depth: int = 1
    gate_divergence: bool = True
    gate_ema_floor: bool = True
    gate_init_split: bool = True
    gate_anchor: bool = True


class Tracker:
    def __init__(self, K: np.ndarray, D: np.ndarray | None, wh: tuple[int, int],
                 orb_cfg: feat_ops.OrbConfig, map_state: MapState,
                 params: TrackingParams | None = None, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.cam_type = 0
        self.cam_params = np.asarray(K, np.float32)
        self.K = np.asarray(K, np.float32)[:4]
        self.D = None if D is None else np.asarray(D, np.float32)
        self.wh = np.asarray(wh, np.float32)
        self.orb_cfg = orb_cfg
        self._map = map_state
        self.p = params or TrackingParams()
        if self.p.pose_starts != 1:
            raise NotImplementedError(
                "TrackingParams.pose_starts > 1 is not ported yet (ROADMAP.md, Queue 1)")
        # the only random numbers of the path: the two-view RANSAC sets, drawn
        # on the host exactly as the reference draws them
        self.rng = np.random.default_rng(seed)
        self.current_frame: Frame | None = None
        self.state = TrackState.NOT_INITIALIZED
        dev = self.device
        self.extract = feat_ops.make_extractor(int(wh[1]), int(wh[0]), orb_cfg,
                                               K=self.K, D=self.D, device=dev)
        self.match_init = kernels.init_matcher()
        self.two_view = kernels.two_view_kernel(sigma_n=1.0 / float(self.K[0]))
        self.pose_opt = kernels.pose_opt_kernel(cam_type=self.cam_type)
        self._cam_key = tuple(float(v) for v in self.cam_params)
        self._wh_key = (float(wh[0]), float(wh[1]))
        # a deeper pipeline predicts further ahead: widen the search windows
        depth = max(1, int(self.p.pipeline_depth))
        r_scale = 1.0 + 0.5 * (depth - 1)
        self.fused_track = kernels.fused_track_pooled(
            self.cam_type, orb_cfg.n_levels, orb_cfg.scale,
            self._cam_key, self._wh_key, 0.0,
            float(self.p.motion_radius * r_scale), float(self.p.local_radius * r_scale),
            float(self.p.motion_ratio), float(self.p.local_ratio),
            int(self.p.th_high), device=dev)
        self.pose_opt_pooled = kernels.pose_opt_pooled(
            self.cam_type, self._cam_key, 0.0, orb_cfg.n_levels, orb_cfg.scale,
            device=dev)
        self._ur_dev = torch.full((orb_cfg.total_capacity,), -1.0,
                                  dtype=torch.float32, device=dev)

        # bumped on whole-world transforms (the reference's IMU alignment):
        # a pipelined dispatch in flight across one is dropped at consume
        self.world_epoch = 0
        self.init_frame: Frame | None = None
        self.last_frame: Frame | None = None
        self._pending: list = []   # in-flight pipelined frames (FIFO, ≤ depth)
        self.velocity: tuple[np.ndarray, np.ndarray] | None = None  # T_cl
        self.ref_kf: int = -1
        self.last_kf_frame_id: int = -1
        self._last_kf_ts: float = -1e18
        self._last_reloc_frame_id: int = -(10 ** 9)
        self.frames_since_reloc = 0
        self.n_frames = 0
        self.inlier_ema: float | None = None
        # frames tracked by the fused step (first try / synchronous retry
        # after a pipelined miss) / sent down the staged cascade / recovered
        # by _relocalize
        self.path_counts = {"fused": 0, "fused_retry": 0, "staged": 0, "reloc_frames": 0}
        # Atlas hooks (set by the system): sustained loss, and relocalization
        # into a stored map (a success merges the current map into it)
        self.on_tracking_lost = None
        self.try_cross_map_reloc = None
        # BoW relocalization-candidate provider, bound by the system to the
        # loop closer's keyframe database: fn(desc, valid) → keyframe ids.
        # A query that raises is counted here and relocalization goes on
        # with the recent keyframes
        self.reloc_candidates_fn = None
        self.reloc_query_errors = 0
        self.last_reloc_query_error: str | None = None
        # async back-pressure: callable → bool (the mapper's queue<3 gate)
        self.mapper_accepting = None
        self.consecutive_lost = 0
        self.frames_to_new_map = 20
        # per-frame trajectory log: (ts, ref_kf, R_cr, t_cr, lost)
        self.trajectory: list = []
        self.on_new_keyframe = None
        self.inv_sigma2 = self.map.inv_level_sigma2
        self.timer = StageTimer()
        self.map.on_remap["tracker"] = self._on_map_remap

    # ------------------------------------------------------------------
    # pool compaction protocol
    # ------------------------------------------------------------------
    @property
    def map(self) -> MapState:
        return self._map

    @map.setter
    def map(self, m: MapState):
        old = getattr(self, "_map", None)
        if old is not None and old is not m:
            old.on_remap.pop("tracker", None)
        self._map = m
        m.on_remap["tracker"] = self._on_map_remap

    def _on_map_remap(self, kf_remap: np.ndarray, mp_remap: np.ndarray):
        """Map pools were compacted: remap every kf/mp id this tracker holds."""
        if self.ref_kf >= 0:
            r = int(kf_remap[self.ref_kf])
            if r < 0:
                valid = self.map.valid_kf_ids()
                r = int(valid[-1]) if len(valid) else -1
            self.ref_kf = r
        new_traj = []
        for (ts, k, Rcr, tcr, lost) in self.trajectory:
            if k >= 0:
                k2 = int(kf_remap[k])
                if k2 < 0:
                    new_traj.append((ts, -1, None, None, True))
                    continue
                k = k2
            new_traj.append((ts, k, Rcr, tcr, lost))
        self.trajectory = new_traj
        for f in {id(f): f for f in (self.last_frame, self.current_frame,
                                     self.init_frame) if f is not None}.values():
            if f.feat_mp is not None:
                pos = f.feat_mp >= 0
                f.feat_mp[pos] = mp_remap[f.feat_mp[pos]]

    def _mirror(self, m: MapState):
        return mirror_for(m, self.device).sync(m)

    def _dev(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def _timestamp_guard(self, ts: float):
        """Backwards time or a >1 s gap abandons the current tracking episode."""
        lf = self.last_frame
        if lf is None or self.state == TrackState.NOT_INITIALIZED:
            return
        if ts < lf.ts or ts - lf.ts > 1.0:
            if self.on_tracking_lost is not None:
                self.on_tracking_lost()
            self.velocity = None
            self.last_frame = None

    def process_frame(self, img: np.ndarray, ts: float) -> dict:
        if self.p.pipeline:
            return self._process_frame_pipelined(img, ts)
        self._timestamp_guard(ts)
        fid = self.n_frames
        self.n_frames += 1
        with self.timer.stage("1.orb_extraction"):
            img_t = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
            frame = build_frame(fid, ts, self.extract(img_t))
        with locked_current(self):
            if self.state == TrackState.NOT_INITIALIZED:
                ok = self._monocular_init(frame)
                info = {"state": self.state.name, "init": ok}
            else:
                with self.timer.stage("3.track_total"):
                    ok = self._track(frame)
                info = {"state": self.state.name,
                        "inliers": frame.n_matched() if ok else 0}
            self._log_trajectory(frame, tracked=ok)
        self.last_frame = frame
        return info

    # ------------------------------------------------------------------
    # the software pipeline
    # ------------------------------------------------------------------
    def _process_frame_pipelined(self, img: np.ndarray, ts: float) -> dict:
        """Software pipeline (``TrackingParams.pipeline``): extract frame N
        and dispatch its fused tracking at once; its packed result is read at
        the start of call N+depth, so the device's tail and the copy to the
        host overlap the caller's time between frames and the next frame's
        extraction. Returns the info of the frame finalized in this call."""
        fid = self.n_frames
        self.n_frames += 1
        with self.timer.stage("1.orb_extraction"):
            img_t = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
            frame = build_frame(fid, ts, self.extract(img_t))
        return self._pipeline_step(frame, ts)

    def _pipeline_step(self, frame: Frame, ts: float) -> dict:
        """Flush the oldest in-flight frame, then dispatch this frame's fused
        tracking (or fall back to the staged cascade)."""
        depth = max(1, int(self.p.pipeline_depth))
        info_prev = None
        if len(self._pending) >= depth:
            info_prev = self._flush_one()
        self._timestamp_guard(ts)
        with locked_current(self):
            if self.state == TrackState.NOT_INITIALIZED:
                info_prev = self.flush_pending() or info_prev
                ok = self._monocular_init(frame)
                self._log_trajectory(frame, tracked=ok)
                self.last_frame = frame
                return {"state": self.state.name, "init": ok}
            if self._can_fuse_track():
                with self.timer.stage("3f.fused_dispatch"):
                    pend = self._fused_dispatch(frame)
                if pend is not None:
                    self._pending.append(pend)
                    return info_prev if info_prev is not None else {
                        "state": self.state.name, "pending": True}
            # the staged path needs a fully consumed state: drain the pipeline
            info_prev = self.flush_pending() or info_prev
            with self.timer.stage("3.track_total"):
                ok = self._track(frame, allow_fused=False)
            self._log_trajectory(frame, tracked=ok)
            self.last_frame = frame
            return {"state": self.state.name,
                    "inliers": frame.n_matched() if ok else 0}

    def flush_pending(self) -> dict | None:
        """Finalize ALL in-flight pipelined frames (no-op without any). Must
        run before tracker state is read from outside: the system calls it
        from stats(), state, shutdown() and the trajectory export."""
        info = None
        while self._pending:
            info = self._flush_one() or info
        return info

    def _flush_one(self) -> dict | None:
        if not self._pending:
            return None
        pend = self._pending.pop(0)
        frame = pend["frame"]
        with locked_current(self):
            if (pend["map"] is not self.map
                    or pend["map"].remap_epoch != pend["epoch"]
                    or pend["wepoch"] != self.world_epoch):
                # dispatched against a map that was replaced, compacted or
                # re-aligned since: its candidate ids mean nothing now
                return None
            self.current_frame = frame
            with self.timer.stage("3g.fused_consume"):
                ok = self._fused_consume(pend)
            if ok:
                self.path_counts["fused"] += 1
            if not ok and self._can_fuse_track():
                # stale-candidate miss (a deep pipeline dispatches with lagged
                # candidate sets): one synchronous fused retry with CURRENT
                # candidates before the staged cascade
                frame.feat_mp[:] = -1
                with self.timer.stage("3g.fused_retry"):
                    ok = self._track_fused(frame)
                if ok:
                    self.path_counts["fused_retry"] += 1
            if ok:
                self._post_track(frame, True)
            else:
                frame.feat_mp[:] = -1
                ok = self._track(frame, allow_fused=False)
            self._log_trajectory(frame, tracked=ok)
            self.last_frame = frame
            return {"state": self.state.name,
                    "inliers": frame.n_matched() if ok else 0}

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    def _monocular_init(self, frame: Frame) -> bool:
        p = self.p
        if frame.n_valid < p.min_init_matches:
            self.init_frame = None
            return False
        if self.init_frame is None:
            self.init_frame = frame
            return False
        f0, f1 = self.init_frame, frame
        idx, _, ok = self.match_init(
            f0.dev.desc, f0.dev.valid, f0.dev.xy, f0.dev.angle,
            f1.dev.desc, f1.dev.valid, f1.dev.xy, f1.dev.angle)
        okn = ok.cpu().numpy()
        idxn = idx.cpu().numpy().astype(np.int64)
        if okn.sum() < p.min_init_matches:
            self.init_frame = frame
            return False
        fx, fy, cx, cy = self.K[:4]
        x1 = (f0.xy - [cx, cy]) / [fx, fy]
        x2 = (f1.xy[idxn] - [cx, cy]) / [fx, fy]
        rand_sets = self._rand_sets(np.nonzero(okn)[0], iters=200, k=8)
        res = self.two_view(self._dev(x1, torch.float32), self._dev(x2, torch.float32),
                            self._dev(okn), self._dev(rand_sets))
        if not bool(res.success):
            return False
        good = res.good.cpu().numpy() & okn
        if good.sum() < p.min_init_matches // 2:
            return False
        R21 = res.R.cpu().numpy()
        t21 = res.t.cpu().numpy()
        pts = res.pts.cpu().numpy()
        # scale so median depth (in cam1) = 1
        med = float(np.median(pts[good, 2]))
        if med <= 0:
            return False
        self._create_initial_map(f0, f1, R21, t21 / med, pts / med, good, idxn)
        return True

    def _create_initial_map(self, f0, f1, R21, t21, pts, good, idxn):
        m = self.map
        gi = np.nonzero(good)[0]
        f0_assign = np.full(len(f0.valid), -1, np.int32)
        f1_assign = np.full(len(f1.valid), -1, np.int32)
        k0 = m.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                            f0.ts, f0.frame_id, f0.xy, f0.angle, f0.octave,
                            f0.desc, f0.valid)
        k1 = m.add_keyframe(R21.astype(np.float32), t21.astype(np.float32),
                            f1.ts, f1.frame_id, f1.xy, f1.angle, f1.octave,
                            f1.desc, f1.valid)
        xyz = pts[gi]
        normals = xyz / np.maximum(np.linalg.norm(xyz, axis=1, keepdims=True), 1e-9)
        dist = np.linalg.norm(xyz, axis=1)
        sf = m.scale_factors
        maxd = dist * sf[f0.octave[gi]]
        mind = maxd / sf[-1]
        ids = m.add_map_points(xyz, f0.desc[gi], k1, normals, mind, maxd, first_kf=k0)
        f0_assign[gi] = ids
        f1_assign[idxn[gi]] = ids
        m.kf_feat_mp[k0] = f0_assign
        m.kf_feat_mp[k1] = f1_assign
        # initial global BA over the two bootstrap keyframes
        if self.on_new_keyframe is not None:
            self.on_new_keyframe(k1, initial=True)
        f1.R = m.kf_R[k1].copy()
        f1.t = m.kf_t[k1].copy()
        f1.feat_mp = m.kf_feat_mp[k1].copy()
        self.ref_kf = k1
        self.last_kf_frame_id = f1.frame_id
        self._last_kf_ts = f1.ts
        self.velocity = None
        self.state = TrackState.OK

    def _rand_sets(self, valid_idx: np.ndarray, iters: int, k: int) -> np.ndarray:
        if len(valid_idx) < k:
            return np.zeros((iters, k), np.int32)
        return self.rng.choice(valid_idx, size=(iters, k), replace=True).astype(np.int32)

    # ------------------------------------------------------------------
    # tracking
    # ------------------------------------------------------------------
    def _last_track_healthy(self) -> bool:
        """Was the last frame tracked with a healthy inlier count? Gates the
        anchored motion model and the weak last-pose prior."""
        lf = self.last_frame
        if lf is None or not lf.tracked:
            return False
        if not self.p.gate_anchor:
            return True
        return lf.n_matched() >= max(20, int(0.06 * self.orb_cfg.total_capacity))

    def _check_replaced_in_last_frame(self):
        """Forward fused-away map-point ids in the last frame to their
        replacements (reference Tracking::CheckReplacedInLastFrame)."""
        lf = self.last_frame
        if lf is None:
            return
        m = self.map
        fm = lf.feat_mp
        pos = np.nonzero(fm >= 0)[0]
        if len(pos) == 0:
            return
        ids = fm[pos]
        if m.mp_valid[ids].all():
            return
        fwd = ids.copy()
        for _ in range(4):
            b = ~m.mp_valid[fwd] & (m.mp_replaced[fwd] >= 0)
            if not b.any():
                break
            fwd[b] = m.mp_replaced[fwd[b]]
        fwd[~m.mp_valid[fwd]] = -1
        fm[pos] = fwd
        live = np.nonzero(fm >= 0)[0]
        order = live[np.argsort(fm[live], kind="stable")]
        v = fm[order]
        dup = np.zeros(len(order), bool)
        dup[1:] = v[1:] == v[:-1]
        fm[order[dup]] = -1

    def _can_fuse_track(self) -> bool:
        return (self.state == TrackState.OK and self.last_frame is not None
                and self.p.local_passes == 1 and self.velocity is not None)

    def _track(self, frame: Frame, allow_fused: bool = True) -> bool:
        self.current_frame = frame
        self._check_replaced_in_last_frame()
        self._n1_last = None
        ok = False
        if allow_fused and self._can_fuse_track():
            with self.timer.stage("3f.fused_track"):
                ok = self._track_fused(frame)
            if ok:
                self.path_counts["fused"] += 1
        if not ok and self.state == TrackState.OK:
            frame.feat_mp[:] = -1
            self.path_counts["staged"] += 1
            with self.timer.stage("3a.pose_prediction"):
                if self.velocity is not None and self.last_frame is not None:
                    ok = self._track_motion_model(frame)
                if not ok:
                    ok = self._track_reference_kf(frame)
        elif not ok:
            # lost: relocalize against the BoW candidates and the recent
            # keyframes, then into a stored map (which merges it back)
            ok = self._relocalize(frame)
            if not ok and self.try_cross_map_reloc is not None:
                ok = self.try_cross_map_reloc(frame)

        if ok and not getattr(frame, "_fused_done", False):
            with self.timer.stage("3b.track_local_map"):
                ok = self._track_local_map(frame)
            if (ok and self.p.gate_divergence and self._n1_last is not None
                    and self._n1_last < max(10, 0.1 * self.n_local_inliers)):
                ok = False
        self._post_track(frame, ok)
        return ok

    def _relocalize(self, frame: Frame, n_candidates: int = 8,
                    in_map: MapState | None = None) -> bool:
        """Try recent keyframes as relocalization anchors: descriptor-match
        the keyframe's map-point features to the frame (ratio 0.75), PnP
        RANSAC + MLPnP refinement for the initial pose (the keyframe's own
        pose is the fallback seed), pose LM, and for a near miss the guided
        rescue: two projection rounds (radius 10, then 3), each followed by a
        re-optimization. Accepts at ``min_local_inliers``."""
        m = in_map if in_map is not None else self.map
        cands = list(m.valid_kf_ids()[::-1][:n_candidates])
        if self.reloc_candidates_fn is not None and in_map is None:
            # BoW inverted-file candidates first when a database is bound;
            # recent keyframes remain the fallback anchors
            try:
                bow_cands = self.reloc_candidates_fn(frame.desc, frame.valid)
                cands = [int(c) for c in bow_cands] + \
                    [c for c in cands if int(c) not in set(map(int, bow_cands))]
            except Exception as e:   # keep reloc alive, but count the defect
                self.reloc_query_errors += 1
                self.last_reloc_query_error = repr(e)
                verbose.print_mess(f"relocalization candidate query failed: {e!r}",
                                   verbose.NORMAL)
        dev = frame.dev
        for k in cands:
            k = int(k)
            has_mp = m.kf_feat_valid[k] & (m.kf_feat_mp[k] >= 0)
            if has_mp.sum() < 15:
                continue
            idx, _, ok = match_ops.search_by_descriptor(
                self._dev(m.kf_feat_desc[k].view(np.int32)), self._dev(has_mp),
                dev.desc, dev.valid, max_dist=match_ops.TH_LOW, ratio=0.75)
            okn = ok.cpu().numpy()
            if okn.sum() < 15:
                continue
            idxn = idx.cpu().numpy()
            frame.feat_mp[:] = -1
            src = np.nonzero(okn)[0]
            frame.feat_mp[idxn[src]] = m.kf_feat_mp[k][src]
            frame.R = m.kf_R[k].copy()
            frame.t = m.kf_t[k].copy()
            matched = np.nonzero(frame.feat_mp >= 0)[0]
            if len(matched) >= 10:
                self._pnp_seed(frame, m, matched)
            inl = self._optimize_frame_pose(frame, in_map=m)
            if 10 <= inl < self.p.min_local_inliers:
                group = np.concatenate([[k], m.best_covisible(k, 10, min_weight=15)])
                mps = m.local_map_points(group.astype(np.int32))
                for radius in (10.0, 3.0):
                    if len(mps) == 0:
                        break
                    added = self._project_and_assign(
                        frame, mps, 2048, radius=radius, ratio=0.9,
                        max_dist=match_ops.TH_HIGH, in_map=m)
                    if added == 0:
                        continue
                    inl = self._optimize_frame_pose(frame, in_map=m)
                    if inl >= self.p.min_local_inliers:
                        break
            if inl >= self.p.min_local_inliers:
                self.ref_kf = k
                self.frames_since_reloc = 0
                self._last_reloc_frame_id = frame.frame_id
                self.path_counts["reloc_frames"] += 1
                return True
        return False

    def _pnp_seed(self, frame: Frame, m: MapState, matched: np.ndarray) -> None:
        """PnP RANSAC over the frame's matches + MLPnP refinement on its
        inliers; overwrites the frame pose when RANSAC succeeds. The 128
        six-point sets come from the tracker's host generator."""
        xw = self._dev(m.mp_xyz[frame.feat_mp[matched]].astype(np.float32))
        rays = cam_ops.unproject(self.cam_type, self._dev(self.cam_params),
                                 self._dev(frame.xy[matched]))
        rand = self.rng.integers(0, len(matched), (128, 6)).astype(np.int32)
        inv_s2 = self.inv_sigma2[frame.octave[matched]].astype(np.float32)
        focal = float(self.K[0])
        res = pnp_ops.pnp_ransac(
            xw, rays, torch.ones(len(matched), dtype=torch.bool, device=self.device),
            self._dev(rand), self._dev(inv_s2), focal=focal)
        if not bool(res.success):
            return
        Rr, tr = pnp_ops.mlpnp_refine(xw, rays, self._dev(inv_s2 * focal ** 2),
                                      res.inliers, res.R, res.t)
        Rr, tr = Rr.cpu().numpy(), tr.cpu().numpy()
        if np.isfinite(Rr).all() and np.isfinite(tr).all():
            frame.R, frame.t = Rr, tr
        else:
            frame.R, frame.t = res.R.cpu().numpy(), res.t.cpu().numpy()

    def _post_track(self, frame: Frame, ok: bool) -> None:
        """State-machine epilogue: motion model, keyframe policy, loss."""
        if ok:
            self.state = TrackState.OK
            frame.tracked = True
            inl_now = float(getattr(self, "n_local_inliers", 0) or 0)
            if inl_now > 0:
                self.inlier_ema = (inl_now if self.inlier_ema is None
                                   else 0.9 * self.inlier_ema + 0.1 * inl_now)
            if (self.last_frame is not None and self.last_frame.tracked
                    and self.last_frame.R is not None):
                Rl, tl = self.last_frame.R, self.last_frame.t
                Rli, tli = Rl.T, -Rl.T @ tl
                self.velocity = (frame.R @ Rli, frame.R @ tli + frame.t)
            else:
                self.velocity = None
            with self.timer.stage("4.new_kf_decision"):
                need_kf = self._need_new_keyframe(frame)
            if need_kf:
                with self.timer.stage("4b.new_kf_creation"):
                    self._create_new_keyframe(frame)
            self.consecutive_lost = 0
        else:
            self.velocity = None
            self.inlier_ema = None
            self.state = (TrackState.RECENTLY_LOST if self.map.n_kf > 10
                          else TrackState.LOST)
            self.consecutive_lost += 1
            if (self.consecutive_lost >= self.frames_to_new_map
                    and self.on_tracking_lost is not None):
                self.on_tracking_lost()
                self.consecutive_lost = 0

    def reset_for_new_map(self, new_map: MapState):
        """Re-point the tracker at a fresh map."""
        self.map = new_map
        self.state = (TrackState.NOT_INITIALIZED if new_map.n_kf == 0
                      else TrackState.RECENTLY_LOST)
        self.init_frame = None
        self.velocity = None
        self.ref_kf = int(new_map.valid_kf_ids()[-1]) if new_map.n_kf else -1
        self.inlier_ema = None

    def _predict_pose(self, frame: Frame):
        """Constant-velocity prediction, anchored at the last pose when the
        predicted image motion is below ``cv_predict_min_px`` (see the
        reference for the scale-drift rationale)."""
        Rv, tv = self.velocity
        Rl, tl = self.last_frame.R, self.last_frame.t
        steps = max(1, int(frame.frame_id - self.last_frame.frame_id))
        Rp, tp = Rl, tl
        for _ in range(min(steps, 4)):
            Rp, tp = Rv @ Rp, Rv @ tp + tv
        Rp = Rp.astype(np.float32)
        tp = tp.astype(np.float32)
        thresh = self.p.cv_predict_min_px
        if not self._last_track_healthy():
            thresh = 0.0
        if thresh > 0.0:
            c_p = -Rp.T @ tp
            c_l = -Rl.T @ tl
            zmed = self._last_matched_depth()
            ang = np.arccos(np.clip((np.trace(Rv) - 1.0) / 2.0, -1.0, 1.0))
            px = float(self.K[0]) * (
                float(ang) + float(np.linalg.norm(c_p - c_l)) / max(zmed, 1e-6))
            if px < thresh:
                Rp, tp = Rl.copy(), tl.copy()
        frame.R = Rp
        frame.t = tp

    def _last_matched_depth(self) -> float:
        """Median depth of the last frame's matched map points (in its cam)."""
        lf = self.last_frame
        if lf is None or lf.R is None:
            return 1.0
        mp = lf.feat_mp[lf.feat_mp >= 0]
        mp = mp[self.map.mp_valid[mp]] if len(mp) else mp
        if len(mp) == 0:
            return 1.0
        z = (self.map.mp_xyz[mp] @ lf.R.T + lf.t)[:, 2]
        z = z[z > 1e-6]
        return float(np.median(z)) if len(z) else 1.0

    def _project_and_assign(self, frame: Frame, mp_ids: np.ndarray, cap: int,
                            radius: float, ratio: float, max_dist: int,
                            view_cos: float = 0.5, count_visible: bool = False,
                            in_map: MapState | None = None) -> int:
        """Pooled frustum+projection matcher: uploads pose + one id vector,
        reads one packed buffer."""
        m = in_map if in_map is not None else self.map
        mp_ids = np.asarray(mp_ids, np.int32)[:cap]
        mp_ids = mp_ids[m.mp_valid[mp_ids]]
        n = len(mp_ids)
        ids = np.full(cap, -1, np.int32)
        ids[:n] = mp_ids
        pose = np.empty(12, np.float32)
        pose[0:9] = frame.R.reshape(-1)
        pose[9:12] = frame.t
        fn = kernels.projection_assign_pooled(
            self.cam_type, self.orb_cfg.n_levels, self.orb_cfg.scale,
            self._cam_key, self._wh_key, float(radius), float(ratio), int(max_dist),
            float(view_cos), device=self.device)
        mpf, mpu = self._mirror(m)
        dev = frame.dev
        out = fn(self._dev(pose), self._dev(ids), mpf, mpu,
                 dev.xy, dev.desc, dev.octave, dev.valid).cpu().numpy()
        idxn = out[:cap]
        nw = (cap + 31) // 32
        okn = kernels.unpack_bits_host(out[cap: cap + nw], cap)
        sel = np.nonzero(okn)[0]
        sel = sel[sel < n]
        free = frame.feat_mp[idxn[sel]] < 0
        sel = sel[free]
        frame.feat_mp[idxn[sel]] = ids[sel]
        if count_visible:
            vis = kernels.unpack_bits_host(out[cap + nw: cap + 2 * nw], cap)[:n]
            m.mp_visible[ids[:n][vis]] += 1
        return len(sel)

    def _optimize_frame_pose(self, frame: Frame, in_map: MapState | None = None) -> int:
        """Pose-only LM; the weak prior is anchored at the LAST tracked pose
        (TrackingParams.pose_prior_eps). Pooled (world points gathered on the
        device by the frame's assignment) against the tracker's own map; with
        ``in_map`` (relocalization) the points are gathered on the host."""
        m = in_map if in_map is not None else self.map
        matched = frame.feat_mp >= 0
        lf = self.last_frame
        use_prior = (lf is not None and lf is not frame and lf.tracked
                     and lf.R is not None and self.p.pose_prior_eps > 0.0
                     and self._last_track_healthy())
        pR, pt = (lf.R, lf.t) if use_prior else (frame.R, frame.t)
        eps = self.p.pose_prior_eps if use_prior else 0.0
        if in_map is not None:
            pts = np.zeros((len(frame.feat_mp), 3), np.float32)
            pts[matched] = m.mp_xyz[frame.feat_mp[matched]]
            dev = frame.dev
            res = self.pose_opt(
                self._dev(frame.R), self._dev(frame.t), self._dev(pts), dev.xy,
                self._dev(self.inv_sigma2[frame.octave].astype(np.float32)),
                self._dev(matched) & dev.valid, self._dev(self.cam_params),
                obs_ur=self._ur_dev, bf=0.0, prior_R=self._dev(np.asarray(pR, np.float32)),
                prior_t=self._dev(np.asarray(pt, np.float32)), prior_eps=float(eps))
            frame.R = res.R.cpu().numpy()
            frame.t = res.t.cpu().numpy()
            inl = res.inlier.cpu().numpy()
            frame.feat_mp[matched & ~inl] = -1
            return int(inl.sum())
        pose_in = np.empty(25, np.float32)
        pose_in[0:9] = frame.R.reshape(-1)
        pose_in[9:12] = frame.t
        pose_in[12:21] = np.asarray(pR).reshape(-1)
        pose_in[21:24] = pt
        pose_in[24] = eps
        mpf, _ = self._mirror(m)
        dev = frame.dev
        out = self.pose_opt_pooled(
            self._dev(pose_in), self._dev(frame.feat_mp), mpf,
            dev.xy, dev.octave, dev.valid, self._ur_dev).cpu().numpy()
        Rn = out[0:9].view(np.float32).reshape(3, 3).copy()
        tn = out[9:12].view(np.float32).copy()
        if not (np.isfinite(Rn).all() and np.isfinite(tn).all()):
            return 0
        frame.R = Rn
        frame.t = tn
        N = len(frame.feat_mp)
        inl = kernels.unpack_bits_host(out[13: 13 + (N + 31) // 32], N)
        frame.feat_mp[matched & ~inl] = -1
        return int(out[12])

    def _track_fused(self, frame: Frame) -> bool:
        """One fused device step (kernels.fused_track_pooled): both matching
        stages and both pose LMs; falls back (False) on thin matches."""
        pend = self._fused_dispatch(frame)
        if pend is None:
            return False
        return self._fused_consume(pend)

    def _fused_dispatch(self, frame: Frame):
        """Host prep + uploads + the fused step. Returns a pending record for
        :meth:`_fused_consume`, or None when the fused path does not apply."""
        p = self.p
        m = self.map
        lf = self.last_frame
        if self.ref_kf < 0 or not m.kf_valid[self.ref_kf]:
            vk = m.valid_kf_ids()
            if len(vk) == 0:
                return None
            self.ref_kf = int(vk[-1])
        self._predict_pose(frame)
        self._check_replaced_in_last_frame()
        last_mps = lf.feat_mp[lf.feat_mp >= 0]
        ids_last = np.unique(last_mps)
        ids_last = ids_last[m.mp_valid[ids_last]]
        if len(ids_last) < p.min_motion_matches:
            return None
        kfs = np.unique(np.concatenate(
            [[self.ref_kf], m.best_covisible(self.ref_kf, p.max_local_kfs - 1)]
        )).astype(np.int64)
        loc_ids = m.local_map_points(kfs)
        loc_ids = loc_ids[~np.isin(loc_ids, ids_last)]
        cap_l = self.orb_cfg.total_capacity
        cap_c = p.max_local_mps
        ids_last = ids_last[:cap_l]
        loc_ids = loc_ids[:cap_c]
        ids_packed = np.full(cap_l + cap_c, -1, np.int32)
        ids_packed[: len(ids_last)] = ids_last
        ids_packed[cap_l: cap_l + len(loc_ids)] = loc_ids
        mpf, mpu = self._mirror(m)
        dev = frame.dev
        use_prior = (lf.tracked and lf.R is not None and p.pose_prior_eps > 0.0
                     and self._last_track_healthy())
        pR, pt = (lf.R, lf.t) if use_prior else (frame.R, frame.t)
        pose_in = np.empty(25, np.float32)
        pose_in[0:9] = frame.R.reshape(-1)
        pose_in[9:12] = frame.t
        pose_in[12:21] = np.asarray(pR).reshape(-1)
        pose_in[21:24] = pt
        pose_in[24] = p.pose_prior_eps if use_prior else 0.0
        out_dev = self.fused_track(
            self._dev(pose_in), self._dev(ids_packed), mpf, mpu,
            dev.xy, dev.desc, dev.octave, dev.valid, self._ur_dev, cl=cap_l)
        # start the packed result on its way to the host: a non-blocking copy
        # into pinned memory and an event behind it. Consuming waits on that
        # event alone, not on whatever else the device has queued.
        ready = None
        if out_dev.is_cuda:
            host = torch.empty(out_dev.shape, dtype=out_dev.dtype, pin_memory=True)
            host.copy_(out_dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            out_dev = host
        return {"frame": frame, "out": out_dev, "ready": ready, "ids": ids_packed,
                "n_loc": len(loc_ids), "cap_l": cap_l, "cap_c": cap_c, "map": m,
                "epoch": m.remap_epoch, "wepoch": self.world_epoch}

    def _fused_consume(self, pend) -> bool:
        p = self.p
        m = pend["map"]
        frame = pend["frame"]
        cap_l = pend["cap_l"]
        cap_c = pend["cap_c"]
        ids_packed = pend["ids"]
        nc = pend["n_loc"]
        loc_ids = ids_packed[cap_l: cap_l + nc]
        N = self.orb_cfg.total_capacity
        if pend["ready"] is not None:
            pend["ready"].synchronize()
        out = pend["out"].numpy()
        Rn = out[0:9].view(np.float32).reshape(3, 3).copy()
        tn = out[9:12].view(np.float32).copy()
        n1 = int(out[12])
        inl = int(out[13])
        if n1 < p.min_motion_matches or inl < self._min_local_inliers():
            return False
        if self.p.gate_divergence and n1 < max(10, 0.1 * inl):
            # aliasing-divergence signature (see the reference)
            return False
        if not (np.isfinite(Rn).all() and np.isfinite(tn).all()):
            return False
        frame.R = Rn
        frame.t = tn
        al = out[14: 14 + N]
        ac = out[14 + N: 14 + 2 * N]
        off = 14 + 2 * N
        frustum_bits = out[off: off + (cap_c + 31) // 32]
        frame.feat_mp[:] = -1
        sel_l = al >= 0
        frame.feat_mp[sel_l] = ids_packed[al[sel_l]]
        sel_c = (ac >= 0) & (ac < nc)
        frame.feat_mp[sel_c] = ids_packed[cap_l + ac[sel_c]]
        # found/visible counters (reference IncreaseFound/IncreaseVisible)
        vis = kernels.unpack_bits_host(frustum_bits, cap_c)[:nc]
        m.mp_visible[loc_ids[vis]] += 1
        found = frame.feat_mp[frame.feat_mp >= 0]
        m.mp_found[found] += 1
        m.mp_visible[found] += 1
        # reference keyframe ← most-shared observer of the matches
        kf_idx, _ = m.observations_of(np.unique(found))
        if len(kf_idx):
            self.ref_kf = int(np.argmax(np.bincount(kf_idx, minlength=m.n_kf)))
        self.n_local_inliers = inl
        frame._fused_done = True
        return True

    def _min_local_inliers(self) -> int:
        """Reference TrackLocalMap acceptance plus the adaptive floor at 20%
        of the running inlier average."""
        if 0 <= self.n_frames - 1 - self._last_reloc_frame_id < self.p.max_frames_between_kf:
            return max(self.p.min_local_inliers, 50)
        base = self.p.min_local_inliers
        ema = self.inlier_ema
        if self.p.gate_ema_floor and ema is not None and ema > 3.0 * base:
            return max(base, int(0.2 * ema))
        return base

    def _track_motion_model(self, frame: Frame) -> bool:
        p = self.p
        self._predict_pose(frame)
        last_mps = self.last_frame.feat_mp
        mp_ids = np.unique(last_mps[last_mps >= 0])
        mp_ids = mp_ids[self.map.mp_valid[mp_ids]]
        if len(mp_ids) == 0:
            return False
        cap = self.orb_cfg.total_capacity
        n = self._project_and_assign(frame, mp_ids, cap, p.motion_radius,
                                     p.motion_ratio, p.th_high)
        if n < p.min_motion_matches:
            frame.feat_mp[:] = -1
            n = self._project_and_assign(frame, mp_ids, cap, 2 * p.motion_radius,
                                         p.motion_ratio, p.th_high)
        if n < p.min_motion_matches:
            return False
        inl = self._optimize_frame_pose(frame)
        ok = inl >= p.min_motion_inliers
        if ok:
            self._n1_last = inl
        return ok

    def _track_reference_kf(self, frame: Frame) -> bool:
        p = self.p
        if self.ref_kf < 0:
            return False
        m = self.map
        k = self.ref_kf
        idx, _, ok = self.match_init(
            self._dev(m.kf_feat_desc[k].view(np.int32)),
            self._dev(m.kf_feat_valid[k] & (m.kf_feat_mp[k] >= 0)),
            self._dev(m.kf_feat_xy[k]), self._dev(m.kf_feat_angle[k]),
            frame.dev.desc, frame.dev.valid, frame.dev.xy, frame.dev.angle)
        okn = ok.cpu().numpy()
        idxn = idx.cpu().numpy()
        if okn.sum() < 15:
            return False
        frame.feat_mp[:] = -1
        src = np.nonzero(okn)[0]
        frame.feat_mp[idxn[src]] = m.kf_feat_mp[k][src]
        frame.R = (self.last_frame.R.copy() if self.last_frame.R is not None
                   else m.kf_R[k].copy())
        frame.t = (self.last_frame.t.copy() if self.last_frame.t is not None
                   else m.kf_t[k].copy())
        inl = self._optimize_frame_pose(frame)
        return inl >= p.min_motion_inliers

    def _track_local_map(self, frame: Frame) -> bool:
        p = self.p
        m = self.map
        mps = frame.feat_mp[frame.feat_mp >= 0]
        if len(mps) == 0:
            return False
        kf_idx, _ = m.observations_of(mps)
        if len(kf_idx) == 0:
            return False
        counts = np.bincount(kf_idx, minlength=m.n_kf)
        local_kfs = np.argsort(-counts)[: p.max_local_kfs]
        local_kfs = local_kfs[counts[local_kfs] > 0]
        self.ref_kf = int(local_kfs[0])
        local_mps = m.local_map_points(local_kfs)
        new_mps = local_mps[~np.isin(local_mps, mps)]
        self._project_and_assign(frame, new_mps, p.max_local_mps,
                                 p.local_radius, p.local_ratio, p.th_high,
                                 count_visible=True)
        inl = self._optimize_frame_pose(frame)
        for _ in range(max(0, self.p.local_passes - 1)):
            frame.feat_mp[:] = -1
            self._project_and_assign(frame, local_mps, p.max_local_mps,
                                     p.local_radius, p.local_ratio, p.th_high)
            inl = self._optimize_frame_pose(frame)
        found = frame.feat_mp[frame.feat_mp >= 0]
        m.mp_found[found] += 1
        m.mp_visible[found] += 1
        self.n_local_inliers = inl
        return inl >= self._min_local_inliers()

    # ------------------------------------------------------------------
    # keyframe policy
    # ------------------------------------------------------------------
    def _need_new_keyframe(self, frame: Frame) -> bool:
        """Reference NeedNewKeyFrame for a monocular visual rig: the
        c1a/c1b/c2 conditions, the reloc guard, or the fixed-interval cadence
        of ``kf_interval_override``."""
        p = self.p
        m = self.map
        if self.ref_kf < 0:
            return False
        if p.kf_interval_override > 0:
            ref_mps0 = m.kf_feat_mp[self.ref_kf]
            ref_mps0 = ref_mps0[ref_mps0 >= 0]
            ref_mps0 = ref_mps0[m.mp_valid[ref_mps0]]
            if len(ref_mps0):
                min_obs0 = 3 if int(m.kf_valid[: m.n_kf].sum()) > 2 else 2
                ref_mps0 = ref_mps0[m.obs_count(ref_mps0) >= min_obs0]
            n_ref0 = max(len(ref_mps0), 1)
            n_tr = frame.n_matched()
            c1 = frame.frame_id >= self.last_kf_frame_id + p.kf_interval_override
            c2 = (n_tr < p.ref_ratio * n_ref0) and n_tr > 15
            if not (c1 or c2):
                return False
            return self.mapper_accepting is None or self.mapper_accepting()
        n_kfs = int(m.kf_valid[: m.n_kf].sum())
        if (frame.frame_id < self._last_reloc_frame_id + p.max_frames_between_kf
                and n_kfs > p.max_frames_between_kf):
            return False
        ref_mps = m.kf_feat_mp[self.ref_kf]
        ref_mps = ref_mps[ref_mps >= 0]
        ref_mps = ref_mps[m.mp_valid[ref_mps]]
        min_obs = 3 if n_kfs > 2 else 2
        if len(ref_mps):
            ref_mps = ref_mps[m.obs_count(ref_mps) >= min_obs]
        n_ref = max(len(ref_mps), 1)
        n_tracked = getattr(self, "n_local_inliers", frame.n_matched())
        th_ref = 0.4 if n_kfs < 2 else p.ref_ratio
        idle = self.mapper_accepting is None or self.mapper_accepting()
        c1a = frame.frame_id >= self.last_kf_frame_id + p.max_frames_between_kf
        c1b = frame.frame_id >= self.last_kf_frame_id + p.min_frames_between_kf and idle
        c2 = (n_tracked < th_ref * n_ref) and n_tracked > 15
        # a busy mapper never gets a monocular keyframe queued on top
        return bool((c1a or c1b) and c2 and idle)

    def _create_new_keyframe(self, frame: Frame):
        m = self.map
        k = m.add_keyframe(frame.R, frame.t, frame.ts, frame.frame_id,
                           frame.xy, frame.angle, frame.octave, frame.desc,
                           frame.valid, feat_mp=frame.feat_mp.copy(),
                           ur=frame.ur, depth=frame.depth, uvr=frame.uvr)
        self.ref_kf = k
        self.last_kf_frame_id = frame.frame_id
        self._last_kf_ts = frame.ts
        if self.on_new_keyframe is not None:
            # the live frame keeps its own pose; corrections reach it through
            # the map points (see the reference)
            self.on_new_keyframe(k, initial=False)

    # ------------------------------------------------------------------
    # trajectory
    # ------------------------------------------------------------------
    def _log_trajectory(self, frame: Frame, tracked: bool):
        if frame.R is None or self.ref_kf < 0:
            self.trajectory.append((frame.ts, -1, None, None, True))
            return
        m = self.map
        k = self.ref_kf
        Rr, tr = m.kf_R[k], m.kf_t[k]
        Rri, tri = Rr.T, -Rr.T @ tr
        self.trajectory.append((frame.ts, k, frame.R @ Rri, frame.R @ tri + frame.t,
                                not tracked))

    def freeze_trajectory(self, mark_lost: bool = False):
        """Convert map-relative entries into absolute poses before the tracker
        leaves the map they reference (k = -2 entries store T_cw directly)."""
        m = self.map
        out = []
        for (ts, k, Rcr, tcr, lost) in self.trajectory:
            if k >= 0 and Rcr is not None and m.kf_valid[k]:
                Rr, tr_ = m.kf_R[k], m.kf_t[k]
                out.append((ts, -2, (Rcr @ Rr).astype(np.float32),
                            (Rcr @ tr_ + tcr).astype(np.float32), lost or mark_lost))
            elif k >= 0 and Rcr is not None:
                out.append((ts, -1, None, None, True))
            else:
                out.append((ts, k, Rcr, tcr, lost))
        self.trajectory = out

    def remap_trajectory_for_merge(self, kf_map: dict):
        """After an Atlas merge: relative entries reference the pre-merge
        current map; rewrite them to the migrated keyframe ids so they keep
        receiving corrections in the merged map."""
        out = []
        for (ts, k, Rcr, tcr, lost) in self.trajectory:
            if k >= 0:
                nk = kf_map.get(int(k))
                if nk is None:
                    out.append((ts, -1, None, None, True))
                    continue
                k = nk
            out.append((ts, k, Rcr, tcr, lost))
        self.trajectory = out

    def reanchor_trajectory(self, k: int):
        """Re-anchor logged frames whose reference keyframe is about to be
        culled onto its spanning-tree parent (or the nearest surviving one)."""
        m = self.map
        if not any(e[1] == k and e[2] is not None for e in self.trajectory):
            return
        valid = [int(v) for v in m.valid_kf_ids() if int(v) != k]
        if not valid:
            return
        par = int(m.kf_parent[k])
        if par >= 0 and par != k and m.kf_valid[par]:
            r2 = par
        else:
            ts_k = float(m.kf_ts[k])
            r2 = min(valid, key=lambda v: abs(float(m.kf_ts[v]) - ts_k))
        R_k, t_k = m.kf_R[k], m.kf_t[k]
        R_2, t_2 = m.kf_R[r2], m.kf_t[r2]
        R_k2 = R_k @ R_2.T
        t_k2 = t_k - R_k2 @ t_2
        for i, (ts_, kk, Rcr, tcr, lost_) in enumerate(self.trajectory):
            if kk == k and Rcr is not None:
                self.trajectory[i] = (ts_, r2, (Rcr @ R_k2).astype(np.float32),
                                      (Rcr @ t_k2 + tcr).astype(np.float32), lost_)

    def export_trajectory(self):
        """Compose logged relative poses with the (BA-corrected) keyframe
        poses. Returns (ts (F,), R_wc (F,3,3), t_wc (F,3), lost (F,))."""
        m = self.map
        out_ts, out_R, out_t, lost = [], [], [], []
        for ts, k, Rcr, tcr, is_lost in self.trajectory:
            if Rcr is None or k == -1:
                continue
            if k == -2:
                Rcw, tcw = Rcr, tcr
            else:
                Rr, tr = m.kf_R[k], m.kf_t[k]
                Rcw = Rcr @ Rr
                tcw = Rcr @ tr + tcr
            out_ts.append(ts)
            out_R.append(Rcw.T)
            out_t.append(-Rcw.T @ tcw)
            lost.append(is_lost)
        return (np.array(out_ts), np.array(out_R), np.array(out_t),
                np.array(lost, bool))
