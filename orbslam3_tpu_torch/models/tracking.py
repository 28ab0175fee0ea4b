"""Tracking front end: the per-frame state machine (visual sensors).

Port of the visual paths of ``orbslam3_tpu/models/tracking.py``: the host
state machine is the reference's (NOT_INITIALIZED / OK / RECENTLY_LOST /
LOST), only the device calls change. It covers the front ends (monocular,
rectified stereo, RGB-D, the two-camera fisheye rig; pinhole or KB8
cameras), monocular initialization (two-view H/F RANSAC → initial map) and
stereo initialization (one frame's depths), close-point spawning at each
keyframe of a rig with depth, the fused per-frame tracker
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
its own stream). The pipelined stereo front end keeps each frame's right-x
vector on the device for the fused step and brings it home the same way.

Visual-inertial (any rig, after ``enable_imu``): IMU samples
queue per frame (``grab_imu``) and are preintegrated on the device between
frames and between keyframes; the inertial-only initialization
(``try_imu_init``) gravity-aligns the world and gives per-keyframe
velocities and biases; afterwards a frame is tracked by the fused
visual-inertial step (``kernels.fused_track_vi_pooled``: IMU prediction,
both matching stages, the visual LM and the 15-dim pose-inertial solve
with the marginal prior carried from frame to frame), or by the staged
cascade from the IMU prediction, and a lost frame dead-reckons on the IMU
for ``time_recently_lost`` seconds. Every front end preintegrates
(monocular, stereo, RGB-D, the fisheye rig); a monocular rig's first init
also fixes the scale and rescales the map, the live frames and the logged
trajectory.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np
import torch

from .. import resolve_device
from ..ops import camera as cam_ops
from ..ops import features as feat_ops
from ..ops import imu as imu_ops
from ..ops import imu_init as imu_init_ops
from ..ops import matching as match_ops
from ..ops import pnp as pnp_ops
from ..ops import stereo as stereo_ops
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
                 bf: float = 0.0, th_depth: float = 0.0, cam_type: int = 0,
                 device=None):
        # cam_type: 0 = pinhole (K = fx fy cx cy, D = radtan), 1 = Kannala-
        # Brandt-8 fisheye (K = fx fy cx cy k0..k3; keypoints stay raw and
        # every projection goes through the model)
        self.device = resolve_device(device)
        self.cam_type = int(cam_type)
        self.cam_params = np.asarray(K, np.float32)
        self.K = np.asarray(K, np.float32)[:4]
        self.D = None if (D is None or self.cam_type != 0) else np.asarray(D, np.float32)
        # stereo / RGB-D: bf = baseline·fx; th_depth = the close/far point
        # threshold in map units (the reference's ThDepth times the baseline)
        self.bf = float(bf)
        self.th_depth = float(th_depth)
        # two-camera fisheye rig (set_fisheye_rig)
        self.rig = None
        self.wh = np.asarray(wh, np.float32)
        self.orb_cfg = orb_cfg
        self._map = map_state
        self.p = params or TrackingParams()
        # localization mode (reference mbOnlyTracking): track against the map
        # but never make a keyframe
        self.only_tracking = False
        # the only random numbers of the path: the two-view RANSAC sets, drawn
        # on the host exactly as the reference draws them
        self.rng = np.random.default_rng(seed)
        self.current_frame: Frame | None = None
        self.state = TrackState.NOT_INITIALIZED
        dev = self.device
        self.extract = feat_ops.make_extractor(
            int(wh[1]), int(wh[0]), orb_cfg,
            K=self.K if self.cam_type == 0 else None, D=self.D, device=dev)
        self.match_init = kernels.init_matcher()
        self.two_view = kernels.two_view_kernel(sigma_n=1.0 / float(self.K[0]))
        self.pose_opt = kernels.pose_opt_kernel(cam_type=self.cam_type,
                                                n_starts=self.p.pose_starts)
        self._cam_key = tuple(float(v) for v in self.cam_params)
        self._wh_key = (float(wh[0]), float(wh[1]))
        # a deeper pipeline predicts further ahead: widen the search windows
        depth = max(1, int(self.p.pipeline_depth))
        r_scale = 1.0 + 0.5 * (depth - 1)
        self.fused_track = kernels.fused_track_pooled(
            self.cam_type, orb_cfg.n_levels, orb_cfg.scale,
            self._cam_key, self._wh_key, self.bf,
            float(self.p.motion_radius * r_scale), float(self.p.local_radius * r_scale),
            float(self.p.motion_ratio), float(self.p.local_ratio),
            int(self.p.th_high), device=dev)
        self.pose_opt_pooled = kernels.pose_opt_pooled(
            self.cam_type, self._cam_key, self.bf, orb_cfg.n_levels, orb_cfg.scale,
            device=dev)
        # the right-x vector of a frame without one (monocular): all −1
        self._no_ur = torch.full((orb_cfg.total_capacity,), -1.0,
                                 dtype=torch.float32, device=dev)
        self._sf_dev = None

        # --- IMU state (visual-inertial; reference Tracking's IMU queue,
        # PreintegrateIMU and PredictStateIMU) ---
        self.imu_enabled = False
        self.imu_freq = 200.0
        self.imu_noise = (1.7e-4, 2e-3, 1e-5, 1e-4)  # (gyro, acc, gyro walk, acc walk)
        self.imu_queue: list = []       # (ts, gyro(3), acc(3)) tuples
        self.imu_initialized = False
        # staging (reference mbIMU_BA1 / mbIMU_BA2 and mTinit)
        self.imu_init_ts = 0.0
        self.viba1_done = False
        self.viba2_done = False
        self.last_scale_refine_ts = 0.0
        self.imu_bias_g = np.zeros(3, np.float32)
        self.imu_bias_a = np.zeros(3, np.float32)
        self.velocity_w: np.ndarray | None = None   # body velocity in world
        # frame-to-frame marginal prior (reference ConstraintPoseImu): 15x15
        # information on the last frame's state; None anchors it rigidly
        self.pose_prior_H: np.ndarray | None = None
        self.pose_prior_dT: float | None = None
        self.kf_preints: dict = {}       # kf_id -> PreintState since the previous keyframe
        self.preint_since_kf = None
        self.frame_preint = None
        # does frame_preint span the last frame gap (set on the host by
        # _preintegrate_frame, so the fused-VI gate reads nothing back)
        self._frame_preint_covers = False
        self._frame_preint_dT = 0.0      # its dT, mirrored on the host
        self._fused_track_vi = None      # built on the first visual-inertial fused frame
        self.lost_ts: float | None = None   # ts of the OK → lost transition
        # bumped on whole-world transforms (the IMU alignment, the inertial
        # BAs): a pipelined dispatch in flight across one is dropped at consume
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
        self.path_counts = {"fused": 0, "fused_retry": 0, "staged": 0, "fused_vi": 0,
                            "reloc_frames": 0}
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
        self.kf_preints = {int(kf_remap[k]): v for k, v in self.kf_preints.items()
                           if kf_remap[k] >= 0}
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
    # IMU (visual-inertial)
    # ------------------------------------------------------------------
    def enable_imu(self, freq: float = 200.0, noise=(1.7e-4, 2e-3, 1e-5, 1e-4)):
        """Visual-inertial mode (reference IMU_MONOCULAR / IMU_STEREO, and the
        inertial RGB-D and fisheye-rig front ends): the IMU rate and the
        (gyro, acc, gyro walk, acc walk) noise densities."""
        self.imu_enabled = True
        self.imu_freq = freq
        self.imu_noise = noise

    def grab_imu(self, ts, gyro, acc):
        """Queue IMU samples (reference Tracking::GrabImuData)."""
        for t, w, a in zip(np.atleast_1d(ts), np.atleast_2d(gyro), np.atleast_2d(acc)):
            self.imu_queue.append((float(t), np.asarray(w, np.float32),
                                   np.asarray(a, np.float32)))

    def _preintegrate_frame(self, ts_prev: float, ts_cur: float, cap: int = 128):
        """Preintegrate the queued samples in (ts_prev, ts_cur] on the device
        (reference PreintegrateIMU); returns a PreintState or None. The buffer
        holds the (at most ``cap``) samples themselves: the reference
        package's padded slots are masked steps that leave the state as it was."""
        eps = 1e-6  # float timestamp jitter must not drop boundary samples
        take = [s for s in self.imu_queue if ts_prev + eps < s[0] <= ts_cur + eps]
        self.imu_queue = [s for s in self.imu_queue if s[0] > ts_cur + eps]
        self._frame_preint_covers = False
        if not take:
            return None
        n = min(len(take), cap)
        # the interval's length, summed on the host in the device's order
        dT = np.float32(0.0)
        t_prev = ts_prev
        for t, _, _ in take[:n]:
            dT = np.float32(dT + np.float32(t - t_prev))
            t_prev = t
        self._frame_preint_dT = float(dT)
        # host-side coverage check (the samples' span against the frame gap)
        self._frame_preint_covers = (
            abs((take[n - 1][0] - ts_prev) - (ts_cur - ts_prev)) < 0.02)
        buf = np.zeros((n + 1, 7), np.float32)    # [acc(3) | gyro(3) | dt], then the biases
        t_last = ts_prev
        for i, (t, w, a) in enumerate(take[:n]):
            buf[i, 0:3] = a
            buf[i, 3:6] = w
            buf[i, 6] = t - t_last
            t_last = t
        buf[n, 0:3] = self.imu_bias_g
        buf[n, 3:6] = self.imu_bias_a
        d = self._dev(buf)
        ng, na, wg, wa = self.imu_noise
        return imu_ops.preintegrate(d[:n, 0:3], d[:n, 3:6], d[:n, 6], None, d[n, 0:3],
                                    d[n, 3:6], ng, na, wg, wa, self.imu_freq)

    def _accumulate_preint(self, st):
        """Accumulate the per-frame preintegration into the since-last-keyframe
        block (the reference keeps mpImuPreintegratedFromLastKF beside the
        per-frame one)."""
        if st is None:
            return
        if self.preint_since_kf is None:
            self.preint_since_kf = st
        else:
            self.preint_since_kf = imu_ops.compose(self.preint_since_kf, st)

    def _preintegrate_step(self, ts: float):
        """The front ends' per-frame preintegration: from the last consumed
        frame to this one, into the frame's and the keyframe's blocks."""
        if self.imu_enabled and self.last_frame is not None:
            with self.timer.stage("0.imu_preintegration"):
                self.frame_preint = self._preintegrate_frame(self.last_frame.ts, ts)
                self._accumulate_preint(self.frame_preint)

    def _predict_pose_imu(self, frame: Frame, allow_untracked: bool = False) -> bool:
        """IMU state propagation as the pose prediction (reference
        PredictStateIMU). ``allow_untracked`` propagates from a last frame
        whose own pose was only an IMU prediction (RECENTLY_LOST
        dead-reckoning); the propagated velocity is then kept, so the chain
        goes on across lost frames."""
        lf = self.last_frame
        if (self.frame_preint is None or lf is None or self.velocity_w is None
                or lf.R is None or (not lf.tracked and not allow_untracked)):
            return False
        R_wb = lf.R.T
        p_wb = -lf.R.T @ lf.t
        R2, p2, v2 = imu_ops.predict_state(
            self._dev(R_wb), self._dev(p_wb), self._dev(self.velocity_w), self.frame_preint,
            self._dev(self.imu_bias_g), self._dev(self.imu_bias_a))
        R2 = R2.cpu().numpy()
        p2 = p2.cpu().numpy()
        frame.R = R2.T.astype(np.float32)
        frame.t = (-R2.T @ p2).astype(np.float32)
        if allow_untracked:
            self.velocity_w = v2.cpu().numpy().astype(np.float32)
        return True

    def try_imu_init(self, min_kfs: int = 8, prior_g: float | None = None,
                     prior_a: float | None = None, refine: bool = False,
                     fix_bias: bool = False) -> bool:
        """Inertial-only MAP: gravity + scale + biases + velocities (reference
        InitializeIMU). The first call gravity-aligns (and for a monocular
        rig rescales) the map; ``refine`` re-estimates on an initialized map
        with the given priors; ``fix_bias`` pins the biases with huge priors.
        Same gates as the reference package: a contiguous preintegration
        chain subsampled to >= 0.25 s links, >= 4 links, the scale range, and
        for a monocular first init the time span and split-sample checks."""
        m = self.map
        if not self.imu_enabled or (self.imu_initialized and not refine):
            return False
        if refine and not self.imu_initialized:
            return False
        kfs = [int(k) for k in m.valid_kf_ids()]
        chain0 = [k for k in kfs if k in self.kf_preints or k == kfs[0]]
        if len(chain0) < min_kfs:
            return False
        # every link's dT in one read-back (a composed link's dT is the
        # float32 sum, as compose adds it)
        dts = dict(zip(chain0[1:], torch.stack(
            [self.kf_preints[k].dT for k in chain0[1:]]).cpu().numpy()))
        # contiguity: a link is usable only when its preintegration window
        # matches the keyframe time gap
        contig = [True] * len(chain0)
        for i in range(1, len(chain0)):
            dt_kf = float(m.kf_ts[chain0[i]] - m.kf_ts[chain0[i - 1]])
            contig[i] = abs(float(dts[chain0[i]]) - dt_kf) < 0.015
        # subsample to >= 0.25 s links, composing the preintegrations across
        # the skipped keyframes (short links bury gravity and scale in noise)
        chain, pre = [chain0[0]], []
        acc_pre, acc_dt = None, np.float32(0.0)
        for i in range(1, len(chain0)):
            if not contig[i]:
                acc_pre, acc_dt = None, np.float32(0.0)
                chain, pre = [chain0[i]], []   # restart after a gap
                continue
            p_i = self.kf_preints[chain0[i]]
            if acc_pre is None:
                acc_pre, acc_dt = p_i, dts[chain0[i]]
            else:
                acc_pre = imu_ops.compose(acc_pre, p_i)
                acc_dt = np.float32(acc_dt + dts[chain0[i]])
            if float(acc_dt) >= 0.25 - 1e-6:
                chain.append(chain0[i])
                pre.append(acc_pre)
                acc_pre, acc_dt = None, np.float32(0.0)
        if len(chain) < 4:
            return False
        # monocular first-init time-span gate (the scale is not observable
        # below ~2 s of travel)
        if (self.bf <= 0 and not refine
                and float(m.kf_ts[chain[-1]] - m.kf_ts[chain[0]]) < 2.2):
            return False
        R_wb = np.stack([m.kf_R[k].T for k in chain]).astype(np.float32)
        p_wb = np.stack([-m.kf_R[k].T @ m.kf_t[k] for k in chain]).astype(np.float32)
        pair_ok = torch.ones(len(pre), dtype=torch.bool, device=self.device)
        stack = {a: torch.stack([getattr(s, a) for s in pre])
                 for a in ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa")}
        cov = torch.stack([s.C[:9, :9] for s in pre])
        if prior_g is None:
            prior_g = 1e2
        if prior_a is None:
            prior_a = 1e10 if self.bf <= 0 else 1e5
        if fix_bias:
            prior_g = prior_a = 1e12

        def solve(valid, opt_scale):
            return imu_init_ops.inertial_init(
                self._dev(R_wb), self._dev(p_wb), stack["dT"], stack["dR"], stack["dV"],
                stack["dP"], stack["JRg"], stack["JVg"], stack["JVa"], stack["JPg"],
                stack["JPa"], valid, cov=cov, opt_scale=opt_scale, iters=40,
                prior_g=prior_g, prior_a=prior_a)
        res = solve(pair_ok, self.bf <= 0)
        s = float(res.scale)
        s_lo, s_hi = (0.02, 50.0) if not refine else (0.5, 2.0)
        if not (s_lo < s < s_hi) or not np.isfinite(s):
            return False
        sub_span_ok = (len(pre) >= 6 and float(m.kf_ts[chain[(2 * len(pre)) // 3]]
                                               - m.kf_ts[chain[0]]) >= 2.0)
        if self.bf <= 0 and not refine and sub_span_ok and self.p.gate_init_split:
            # split-sample consistency: the first-2/3 and last-2/3 sub-chains
            # must agree on the scale within 2x
            n_sub = max(4, (2 * len(pre)) // 3)
            sub_scales = []
            for mask_sel in (slice(0, n_sub), slice(len(pre) - n_sub, None)):
                mask = torch.zeros(len(pre), dtype=torch.bool, device=self.device)
                mask[mask_sel] = True
                sub_scales.append(float(solve(pair_ok & mask, True).scale))
            ratio = max(sub_scales) / max(min(sub_scales), 1e-9)
            if not np.isfinite(ratio) or ratio > 2.0:
                return False
        Rwg = res.Rwg.cpu().numpy()
        if refine:
            # a refinement on a gravity-aligned map stays a small correction
            ang = np.arccos(np.clip((np.trace(Rwg) - 1.0) / 2.0, -1.0, 1.0))
            if ang > 0.35:
                return False
        # world' = s · Rgw · world with Rgw = Rwg⁻¹ (gravity → -z)
        kfs_all = m.valid_kf_ids()
        mps = m.valid_mp_ids()
        Rn, tn, pn = imu_init_ops.apply_scaled_rotation(
            self._dev(m.kf_R[kfs_all]), self._dev(m.kf_t[kfs_all]), self._dev(m.mp_xyz[mps]),
            self._dev(Rwg.T), torch.tensor(s, dtype=torch.float32, device=self.device))
        m.kf_R[kfs_all] = Rn.cpu().numpy()
        m.kf_t[kfs_all] = tn.cpu().numpy()
        m.mp_xyz[mps] = pn.cpu().numpy()
        m.touch()
        # the live frames and the velocity follow into the new world: the
        # last frame and the in-flight current one (in the synchronous path
        # the init runs inside the current frame's keyframe creation; a stale
        # current frame makes the next IMU prediction dead-reckon from the
        # old world: a guaranteed one-frame LOST right after init)
        for fr in {id(f): f for f in (self.last_frame, self.current_frame)
                   if f is not None and f.R is not None}.values():
            fr.R = (fr.R @ Rwg).astype(np.float32)
            fr.t = (fr.t * s).astype(np.float32)
        # logged relative poses are scale-covariant: their translations follow
        # (frozen k = -2 entries belong to a retired map)
        self.trajectory = [
            e if (e[1] == -2 or e[3] is None) else
            (e[0], e[1], e[2], (e[3] * s).astype(np.float32), e[4])
            for e in self.trajectory]
        vels = res.vels.cpu().numpy()
        # per-keyframe velocities: solved ones for the chain, finite
        # differences of the corrected poses for the rest
        ctr = -np.einsum("kij,ki->kj", m.kf_R[kfs_all].transpose(0, 2, 1), m.kf_t[kfs_all])
        tss = m.kf_ts[kfs_all]
        if len(kfs_all) >= 2:
            dt = np.maximum(np.gradient(tss), 1e-3)
            m.kf_vel[kfs_all] = (np.gradient(ctr, axis=0) / dt[:, None]).astype(np.float32)
        v_chain = (s * (vels @ Rwg)).astype(np.float32)   # s·Rwgᵀ·v, rowwise
        m.kf_vel[np.asarray(chain)] = v_chain
        bg = res.bg.cpu().numpy().astype(np.float32)
        ba = res.ba.cpu().numpy().astype(np.float32)
        m.kf_bias_g[kfs_all] = bg
        m.kf_bias_a[kfs_all] = ba
        if self.velocity_w is not None or not refine:
            self.velocity_w = v_chain[-1]
        self.imu_bias_g = bg
        self.imu_bias_a = ba
        self.velocity = None       # the constant-velocity model is void across the rescale
        self.pose_prior_H = None   # the marginal prior's frame changed under it
        self.world_epoch += 1      # drop pipelined dispatches from the old world
        if not self.imu_initialized:
            self.imu_init_ts = float(m.kf_ts[kfs[-1]])
        self.imu_initialized = True
        return True

    # ------------------------------------------------------------------
    def _timestamp_guard(self, ts: float):
        """Backwards time or a >1 s gap abandons the current tracking episode
        (and every preintegration spanning it)."""
        lf = self.last_frame
        if lf is None or self.state == TrackState.NOT_INITIALIZED:
            return
        if ts < lf.ts or ts - lf.ts > 1.0:
            if self.on_tracking_lost is not None:
                self.on_tracking_lost()
            self.frame_preint = None
            self.preint_since_kf = None
            self.velocity = None
            self.velocity_w = None
            self.pose_prior_H = None
            self.last_frame = None

    def process_frame(self, img: np.ndarray, ts: float) -> dict:
        if self.p.pipeline:
            return self._process_frame_pipelined(img, ts)
        self._timestamp_guard(ts)
        fid = self.n_frames
        self.n_frames += 1
        self._preintegrate_step(ts)
        with self.timer.stage("1.orb_extraction"):
            frame = build_frame(fid, ts, self.extract(self._upload(img)))
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
            frame = build_frame(fid, ts, self.extract(self._upload(img)))
        return self._pipeline_step(frame, ts)

    def _pipeline_step(self, frame: Frame, ts: float) -> dict:
        """Flush the oldest in-flight frame, then dispatch this frame's fused
        tracking (or fall back to the staged cascade)."""
        depth = max(1, int(self.p.pipeline_depth))
        info_prev = None
        if len(self._pending) >= depth:
            info_prev = self._flush_one()
        self._timestamp_guard(ts)
        # the preintegration spans [last consumed frame, this frame]: at depth
        # 1 the previous frame is consumed by now, so the fused visual-inertial
        # dispatch links consecutive frames as the staged path does
        self._preintegrate_step(ts)
        with locked_current(self):
            if self.state == TrackState.NOT_INITIALIZED:
                info_prev = self.flush_pending() or info_prev
                self._ensure_stereo_host(frame)
                ok = self._stereo_init(frame) if self.bf > 0 else self._monocular_init(frame)
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
            self._ensure_stereo_host(frame)
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
                self._ensure_stereo_host(frame)
                ok = self._track(frame, allow_fused=False)
            self._log_trajectory(frame, tracked=ok)
            self.last_frame = frame
            return {"state": self.state.name,
                    "inliers": frame.n_matched() if ok else 0}

    # ------------------------------------------------------------------
    # stereo, RGB-D and two-camera fisheye front ends
    # ------------------------------------------------------------------
    def _scale_factors_dev(self) -> torch.Tensor:
        if self._sf_dev is None:
            self._sf_dev = self._dev(self.map.scale_factors.astype(np.float32))
        return self._sf_dev

    def _upload(self, img) -> torch.Tensor:
        return torch.as_tensor(np.asarray(img, np.float32), device=self.device)

    def _stereo_device(self, img_l, img_r):
        """Both eyes' extraction, the row-constrained descriptor matching and
        the SAD subpixel refinement, all on the device (the reference runs the
        two extractions in two threads, then ComputeStereoMatches). Returns
        (left features, ur, ok) as device tensors."""
        with self.timer.stage("1.orb_extraction"):
            il, ir = self._upload(img_l), self._upload(img_r)
            fl = self.extract(il)
            fr = self.extract(ir)
        with self.timer.stage("2.stereo_match"):
            ur, _, ok = stereo_ops.stereo_match(
                fl.xy, fl.desc, fl.octave, fl.valid, fr.xy, fr.desc, fr.octave, fr.valid,
                self._scale_factors_dev(), self.bf, 0.1)
            # subpixel disparity (integer keypoints alone give z²/bf-level depth noise)
            ur, ok = stereo_ops.subpixel_refine(il, ir, fl.xy, ur, ok)
        return fl, ur, ok

    def _process_stereo_pipelined(self, img_l, img_r, ts: float) -> dict:
        fid = self.n_frames
        self.n_frames += 1
        fl, ur, ok = self._stereo_device(img_l, img_r)
        disp = fl.xy[:, 0] - ur
        frame = build_frame(fid, ts, fl)
        # the right-x vector stays on the device for the fused step; its host
        # mirror is read back only where host code needs depth
        frame._ur_dev = torch.where(ok & (disp > 0.1), ur, -1.0)
        return self._pipeline_step(frame, ts)

    def process_stereo_frame(self, img_l: np.ndarray, img_r: np.ndarray,
                             ts: float) -> dict:
        """Stereo front end: extract both eyes, match along rows, then run the
        common tracking path with depth available (reference GrabImageStereo +
        the Frame stereo constructor). With ``TrackingParams.pipeline`` (and
        no fisheye rig) it runs the software pipeline."""
        if self.p.pipeline and self.rig is None:
            return self._process_stereo_pipelined(img_l, img_r, ts)
        self._timestamp_guard(ts)
        fid = self.n_frames
        self.n_frames += 1
        self._preintegrate_step(ts)
        fl, ur, ok = self._stereo_device(img_l, img_r)
        frame = build_frame(fid, ts, fl)
        with self.timer.stage("2.stereo_match"):
            okn = ok.cpu().numpy()
            urn = ur.cpu().numpy()
            disp = frame.xy[:, 0] - urn
            okn = okn & (disp > 0.1)
            frame.ur = np.where(okn, urn, -1.0).astype(np.float32)
            frame.depth = np.where(okn, self.bf / np.maximum(disp, 1e-6),
                                   -1.0).astype(np.float32)
        return self._track_with_depth(frame)

    def _track_with_depth(self, frame: Frame, **info_extra) -> dict:
        """Initialize from the frame's depths or track it (the stereo, RGB-D
        and fisheye-rig front ends share this)."""
        with locked_current(self):
            if self.state == TrackState.NOT_INITIALIZED:
                done = self._stereo_init(frame)
                info = {"state": self.state.name, "init": done, **info_extra}
            else:
                with self.timer.stage("3.track_total"):
                    done = self._track(frame)
                info = {"state": self.state.name,
                        "inliers": frame.n_matched() if done else 0}
            self._log_trajectory(frame, tracked=done)
        self.last_frame = frame
        return info

    def set_fisheye_rig(self, cam_r, R_rl, t_rl, lap_l=(0.0, 1e9), lap_r=(0.0, 1e9)):
        """Configure a two-camera fisheye rig (reference Camera2.* + Tlr, the
        lapping areas Camera.lappingBegin/End). Without a stereo ``bf`` the
        rig's is ‖t_rl‖·fx; the pooled steps are rebuilt with it (their cache
        is keyed by bf)."""
        self.rig = {k: np.array(v, np.float32) for k, v in (
            ("cam_r", cam_r), ("R_rl", R_rl), ("t_rl", t_rl), ("lap_l", lap_l),
            ("lap_r", lap_r))}
        if self.bf <= 0:
            self.bf = float(np.linalg.norm(t_rl) * self.cam_params[0])
        self.fused_track = kernels.fused_track_pooled(
            self.cam_type, self.orb_cfg.n_levels, self.orb_cfg.scale,
            self._cam_key, self._wh_key, float(self.bf),
            float(self.p.motion_radius), float(self.p.local_radius),
            float(self.p.motion_ratio), float(self.p.local_ratio),
            int(self.p.th_high), device=self.device)
        self.pose_opt_pooled = kernels.pose_opt_pooled(
            self.cam_type, self._cam_key, float(self.bf),
            self.orb_cfg.n_levels, self.orb_cfg.scale, device=self.device)

    def process_fisheye_stereo_frame(self, img_l: np.ndarray, img_r: np.ndarray,
                                     ts: float) -> dict:
        """Two-camera fisheye front end (reference Frame two-camera
        constructor + ComputeStereoFishEyeMatches): extract both eyes, match
        in the lapping areas, triangulate through the KB8 models. The depth
        drives the close-point machinery; there is no rectified right
        coordinate, so the right eye's pixel of each match is kept for BA's
        second-camera rows, which hold the metric scale."""
        if self.rig is None:
            raise RuntimeError("call set_fisheye_rig first")
        self._timestamp_guard(ts)
        fid = self.n_frames
        self.n_frames += 1
        self._preintegrate_step(ts)
        with self.timer.stage("1.orb_extraction"):
            fl = self.extract(self._upload(img_l))
            fr = self.extract(self._upload(img_r))
        frame = build_frame(fid, ts, fl)
        rig = self.rig
        with self.timer.stage("2.stereo_match"):
            idx, ok, z, _ = stereo_ops.fisheye_stereo_match(
                fl.xy, fl.desc, fl.octave, fl.valid, fr.xy, fr.desc, fr.octave, fr.valid,
                self._dev(self.cam_params), self._dev(rig["cam_r"]), self._dev(rig["R_rl"]),
                self._dev(rig["t_rl"]), self._dev(rig["lap_l"]), self._dev(rig["lap_r"]),
                self._dev(self.map.level_sigma2.astype(np.float32)), 0.7, 50)
            okn = ok.cpu().numpy()
            idxn = idx.cpu().numpy()
            frame.depth = np.where(okn, z.cpu().numpy(), -1.0).astype(np.float32)
            xy_r = fr.xy.cpu().numpy()
            frame.uvr = np.where(okn[:, None], xy_r[idxn], -1.0).astype(np.float32)
        return self._track_with_depth(frame, n_stereo=int(okn.sum()))

    def process_rgbd_frame(self, img: np.ndarray, depth_map: np.ndarray,
                           ts: float) -> dict:
        """RGB-D front end: the depth sampled at each keypoint becomes a
        virtual right coordinate ur = u − bf/z (reference
        ComputeStereoFromRGBD). Sampled on the host, as the JAX package does."""
        self._timestamp_guard(ts)
        fid = self.n_frames
        self.n_frames += 1
        self._preintegrate_step(ts)
        with self.timer.stage("1.orb_extraction"):
            frame = build_frame(fid, ts, self.extract(self._upload(img)))
        xi = np.clip(np.round(frame.xy[:, 0]).astype(int), 0, depth_map.shape[1] - 1)
        yi = np.clip(np.round(frame.xy[:, 1]).astype(int), 0, depth_map.shape[0] - 1)
        z = depth_map[yi, xi].astype(np.float32)
        ok = frame.valid & (z > 0)
        frame.depth = np.where(ok, z, -1.0).astype(np.float32)
        frame.ur = np.where(ok, frame.xy[:, 0] - self.bf / np.maximum(z, 1e-6),
                            -1.0).astype(np.float32)
        return self._track_with_depth(frame)

    def _frame_ur_dev(self, frame: Frame) -> torch.Tensor:
        """The frame's right-x vector on the device for the pooled steps: the
        pipelined stereo front end's (never read back for this), an upload of
        the host mirror, or the all −1 vector of a monocular rig."""
        ur_dev = getattr(frame, "_ur_dev", None)
        if ur_dev is not None:
            return ur_dev
        if self.bf <= 0:
            return self._no_ur
        return self._dev(frame.ur)

    def _stage_ur_host(self, frame: Frame, ready=None) -> None:
        """Start a pipelined stereo frame's device ur on its way to pinned host
        memory: a non-blocking copy followed by ``ready`` (or a new event) on
        the tracker's stream. Nothing waits here."""
        ur_dev = getattr(frame, "_ur_dev", None)
        if ur_dev is None or getattr(frame, "_ur_host", None) is not None:
            return
        if not ur_dev.is_cuda:
            frame._ur_host = (ur_dev, None)
            return
        host = torch.empty(ur_dev.shape, dtype=ur_dev.dtype, pin_memory=True)
        host.copy_(ur_dev, non_blocking=True)
        if ready is None:
            ready = torch.cuda.Event()
            ready.record()
        frame._ur_host = (host, ready)

    def _ensure_stereo_host(self, frame: Frame) -> None:
        """Materialize the host ur/depth of a pipelined stereo frame (kept on
        the device for the fused step; stereo init, keyframe creation's
        close-point spawning and the staged fallback need the numpy mirrors).
        Waits on the frame's own read-back event, never on the device."""
        if getattr(frame, "_ur_dev", None) is None:
            return
        self._stage_ur_host(frame)
        host, ready = frame._ur_host
        if ready is not None:
            ready.synchronize()
        urn = host.numpy().copy()
        disp = frame.xy[:, 0] - urn
        okn = (urn >= 0) & (disp > 0.1)
        frame.ur = np.where(okn, urn, -1.0).astype(np.float32)
        frame.depth = np.where(okn, self.bf / np.maximum(disp, 1e-6), -1.0).astype(np.float32)
        frame._ur_dev = None
        frame._ur_host = None

    def _stereo_init(self, frame: Frame) -> bool:
        """Instant map from one frame's depths (reference
        StereoInitialization: > 500 keypoints, a point per valid depth; at
        least 50 depths guard a degenerate start). Hands no keyframe to the
        mapper, as the JAX package does."""
        if frame.n_valid < 500:
            return False
        m = self.map
        frame.R = np.eye(3, dtype=np.float32)
        frame.t = np.zeros(3, np.float32)
        k0 = m.add_keyframe(frame.R, frame.t, frame.ts, frame.frame_id,
                            frame.xy, frame.angle, frame.octave, frame.desc,
                            frame.valid, ur=frame.ur, depth=frame.depth, uvr=frame.uvr)
        sel = np.nonzero(frame.valid & (frame.depth > 0))[0]
        if len(sel) < 50:
            m.kf_valid[k0] = False
            m.n_kf -= 1
            return False
        z = frame.depth[sel]
        xyz = (self._backproject(frame.xy[sel]) * z[:, None]).astype(np.float32)
        dist = np.linalg.norm(xyz, axis=1)
        normals = xyz / np.maximum(dist[:, None], 1e-9)
        sf = m.scale_factors
        maxd = dist * sf[frame.octave[sel]]
        mind = maxd / sf[-1]
        ids = m.add_map_points(xyz, frame.desc[sel], k0, normals, mind, maxd, first_kf=k0)
        m.kf_feat_mp[k0, sel] = ids
        m.mp_visible[ids] = 1
        m.mp_found[ids] = 1
        frame.feat_mp = m.kf_feat_mp[k0].copy()
        self.ref_kf = k0
        self.last_kf_frame_id = frame.frame_id
        self._last_kf_ts = frame.ts
        self.velocity = None
        self.state = TrackState.OK
        frame.tracked = True
        return True

    def _backproject(self, xy: np.ndarray) -> np.ndarray:
        """Pixels → unit-z rays through the camera model (pinhole or KB8)."""
        return cam_ops.unproject(self.cam_type, self._dev(self.cam_params),
                                 self._dev(np.asarray(xy, np.float32))).cpu().numpy()

    def _spawn_close_points(self, frame: Frame, kf_id: int, max_new: int = 100):
        """Close-depth point spawning at keyframe creation (reference
        CreateNewKeyFrame: unmatched features sorted by depth, points up to
        ThDepth or at least the 100 closest)."""
        m = self.map
        sel = np.nonzero(frame.valid & (frame.depth > 0) & (frame.feat_mp < 0))[0]
        if len(sel) == 0:
            return
        order = sel[np.argsort(frame.depth[sel])]
        close = order[frame.depth[order] < self.th_depth]
        if len(close) < max_new:
            close = order[:max_new]
        if len(close) == 0:
            return
        z = frame.depth[close]
        Rwc = frame.R.T
        c = -Rwc @ frame.t
        xc = self._backproject(frame.xy[close]) * z[:, None]
        xyz = (xc @ Rwc.T + c).astype(np.float32)
        dirs = xyz - c
        dist = np.linalg.norm(dirs, axis=1)
        normals = dirs / np.maximum(dist[:, None], 1e-9)
        sf = m.scale_factors
        maxd = dist * sf[frame.octave[close]]
        mind = maxd / sf[-1]
        ids = m.add_map_points(xyz, frame.desc[close], kf_id, normals, mind, maxd,
                               first_kf=kf_id)
        m.kf_feat_mp[kf_id, close] = ids
        m.mp_visible[ids] = 1
        m.mp_found[ids] = 1
        frame.feat_mp[close] = ids

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
        if self.cam_type == 0:
            fx, fy, cx, cy = self.K[:4]
            x1 = (f0.xy - [cx, cy]) / [fx, fy]
            x2 = (f1.xy[idxn] - [cx, cy]) / [fx, fy]
        else:
            # fisheye: normalized coordinates through the camera model
            x1 = self._backproject(f0.xy)[:, :2]
            x2 = self._backproject(f1.xy[idxn])[:, :2]
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
        # IMU accumulated before the map existed is dropped (the reference
        # resets the from-last-keyframe preintegrator at initialization)
        self.preint_since_kf = None
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
        if not (self.state == TrackState.OK and self.last_frame is not None
                and self.p.local_passes == 1 and self.p.pose_starts == 1):
            return False
        if self.imu_initialized:
            # the visual-inertial fused step needs a per-frame preintegration
            # spanning exactly the frame gap and a tracked previous state
            lf = self.last_frame
            return (self.frame_preint is not None and self._frame_preint_covers
                    and lf.tracked and lf.R is not None and self.velocity_w is not None)
        return self.velocity is not None

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
                if self.imu_initialized and self._predict_pose_imu(frame):
                    ok = self._track_with_prediction(frame)
                if not ok and self.velocity is not None and self.last_frame is not None:
                    ok = self._track_motion_model(frame)
                if not ok:
                    ok = self._track_reference_kf(frame)
        elif not ok:
            if (self.state == TrackState.RECENTLY_LOST and self.imu_initialized
                    and self.lost_ts is not None
                    and frame.ts - self.lost_ts <= self.p.time_recently_lost):
                # IMU dead-reckoning stands in for relocalization for up to
                # time_recently_lost seconds
                ok = self._track_recently_lost_imu(frame)
            if not ok:
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
            # world body velocity for the IMU prediction: finite differences
            # only before the IMU init; afterwards it is a state of the
            # visual-inertial solve
            if (self.imu_enabled and not self.imu_initialized
                    and self.last_frame is not None
                    and self.last_frame.tracked and self.last_frame.R is not None):
                dt = frame.ts - self.last_frame.ts
                if dt > 1e-6:
                    c_now = -frame.R.T @ frame.t
                    c_last = -self.last_frame.R.T @ self.last_frame.t
                    self.velocity_w = ((c_now - c_last) / dt).astype(np.float32)
            if (self.last_frame is not None and self.last_frame.tracked
                    and self.last_frame.R is not None):
                Rl, tl = self.last_frame.R, self.last_frame.t
                Rli, tli = Rl.T, -Rl.T @ tl
                self.velocity = (frame.R @ Rli, frame.R @ tli + frame.t)
            else:
                self.velocity = None
            with self.timer.stage("4.new_kf_decision"):
                need_kf = not self.only_tracking and self._need_new_keyframe(frame)
            if need_kf:
                with self.timer.stage("4b.new_kf_creation"):
                    self._create_new_keyframe(frame)
            self.consecutive_lost = 0
        else:
            self.velocity = None
            self.pose_prior_H = None
            self.inlier_ema = None
            if self.state == TrackState.OK:
                self.lost_ts = frame.ts
            self.state = (TrackState.RECENTLY_LOST if self.map.n_kf > 10
                          else TrackState.LOST)
            self.consecutive_lost += 1
            # with an initialized IMU the loss window is time-based (the
            # reference's time_recently_lost); visual-only gives up after
            # frames_to_new_map frames
            if self.imu_initialized and self.lost_ts is not None:
                new_map_due = frame.ts - self.lost_ts > self.p.time_recently_lost
            else:
                new_map_due = self.consecutive_lost >= self.frames_to_new_map
            if new_map_due and self.on_tracking_lost is not None:
                self.on_tracking_lost()
                self.consecutive_lost = 0

    def reset_for_new_map(self, new_map: MapState):
        """Re-point the tracker at a fresh map."""
        self.map = new_map
        self.state = (TrackState.NOT_INITIALIZED if new_map.n_kf == 0
                      else TrackState.RECENTLY_LOST)
        self.init_frame = None
        self.velocity = None
        self.lost_ts = None
        self.ref_kf = int(new_map.valid_kf_ids()[-1]) if new_map.n_kf else -1
        self.kf_preints = {}
        self.preint_since_kf = None
        self.pose_prior_H = None
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
        # visual-inertial frame optimization once IMU-initialized (reference
        # TrackLocalMap → PoseInertialOptimizationLastFrame)
        if (self.imu_initialized and in_map is None and self.frame_preint is not None
                and lf is not None and lf.tracked and lf.R is not None
                and self.velocity_w is not None
                and abs(self._frame_preint_dT - (frame.ts - lf.ts)) < 0.02):
            mp = frame.feat_mp.copy()
            pts = np.zeros((len(mp), 3), np.float32)
            pts[matched] = m.mp_xyz[mp[matched]]
            snap_R = None if frame.R is None else frame.R.copy()
            snap_t = None if frame.t is None else frame.t.copy()
            inl = self._optimize_frame_pose_vi(frame, pts, matched,
                                               self.inv_sigma2[frame.octave])
            if inl >= 15 or (0 <= inl and matched.sum() < 30):
                return inl
            if inl >= 0:
                # the inertial solve collapsed despite plentiful visual
                # matches (stale prior or velocity): drop the marginal prior
                # and fall through to the visual-only solve for this frame
                self.pose_prior_H = None
                frame.feat_mp = mp
                matched = frame.feat_mp >= 0
                if snap_R is not None:
                    frame.R = snap_R
                    frame.t = snap_t
        use_prior = (lf is not None and lf is not frame and lf.tracked
                     and lf.R is not None and self.p.pose_prior_eps > 0.0
                     and self._last_track_healthy())
        pR, pt = (lf.R, lf.t) if use_prior else (frame.R, frame.t)
        eps = self.p.pose_prior_eps if use_prior else 0.0
        if in_map is not None or self.p.pose_starts != 1:
            # host-gathered points: relocalization, and the multi-start solve
            # (which has no pooled form)
            pts = np.zeros((len(frame.feat_mp), 3), np.float32)
            pts[matched] = m.mp_xyz[frame.feat_mp[matched]]
            dev = frame.dev
            res = self.pose_opt(
                self._dev(frame.R), self._dev(frame.t), self._dev(pts), dev.xy,
                self._dev(self.inv_sigma2[frame.octave].astype(np.float32)),
                self._dev(matched) & dev.valid, self._dev(self.cam_params),
                obs_ur=self._dev(frame.ur), bf=self.bf,
                prior_R=self._dev(np.asarray(pR, np.float32)),
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
            dev.xy, dev.octave, dev.valid, self._frame_ur_dev(frame)).cpu().numpy()
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

    def _scaled_prior(self, dT_now: float) -> np.ndarray:
        """The carried marginal prior in the walk units of this frame
        interval: its bias blocks were built for ``pose_prior_dT``, and
        information transforms as D·H·D with D = sqrt(dT_now / dT_prev) on
        the bias coordinates."""
        pH = self.pose_prior_H
        dT_prev = self.pose_prior_dT
        if dT_prev is not None and abs(dT_prev - dT_now) > 1e-6:
            d = np.ones(15, np.float32)
            d[9:15] = np.sqrt(dT_now / max(dT_prev, 1e-3))
            pH = pH * d[:, None] * d[None, :]
        return pH

    def _optimize_frame_pose_vi(self, frame: Frame, pts, matched, inv_s2) -> int:
        """Visual-inertial frame pose + velocity + bias optimization against
        the last frame's state through the per-frame preintegration
        (reference PoseInertialOptimizationLastFrame), one packed read-back.
        Returns the inlier count, or -1 when the solve is not finite."""
        from ..ops import vi_ba as vi_ops
        pre = self.frame_preint
        lf = self.last_frame
        bg, ba = self._dev(self.imu_bias_g), self._dev(self.imu_bias_a)
        dR_c, dV_c, dP_c = imu_ops.corrected_delta(pre, bg, ba)
        prior = None
        if self.pose_prior_H is not None:
            prior = self._dev(self._scaled_prior(max(self._frame_preint_dT, 1e-3)),
                              torch.float32)
        v = self._dev(self.velocity_w)
        res = vi_ops.pose_inertial_optimize(
            self._dev(frame.R), self._dev(frame.t), v, self._dev(lf.R.T),
            self._dev(-lf.R.T @ lf.t), v, bg, ba, pre.dT, dR_c, dV_c, dP_c,
            pre.JRg, pre.JVg, pre.JVa, pre.JPg, pre.JPa, pre.C[:9, :9],
            self._dev(pts), frame.dev.xy, self._dev(np.asarray(inv_s2, np.float32)),
            self._dev(matched) & frame.dev.valid, self._dev(self.cam_params),
            cam_type=self.cam_type, sigma_gw=float(self.imu_noise[2]),
            sigma_aw=float(self.imu_noise[3]), prior_H=prior)
        out = torch.cat([
            kernels.f32_bits(torch.cat([res.R.reshape(-1), res.t, res.v, res.bg, res.ba,
                                        res.H_marg.reshape(-1)])),
            res.n_inliers.to(torch.int32)[None],
            kernels._pack_bits_i32(res.inlier)]).cpu().numpy()
        Rn = out[0:9].view(np.float32).reshape(3, 3).copy()
        tn = out[9:12].view(np.float32).copy()
        if not (np.isfinite(Rn).all() and np.isfinite(tn).all()):
            self.pose_prior_H = None
            return -1
        frame.R = Rn
        frame.t = tn
        self.velocity_w = out[12:15].view(np.float32).copy()
        bgn = out[15:18].view(np.float32)
        ban = out[18:21].view(np.float32)
        if np.isfinite(bgn).all() and np.isfinite(ban).all():
            # frame-rate bias tracking through the random-walk chain
            self.imu_bias_g = bgn.copy()
            self.imu_bias_a = ban.copy()
        # the marginalized information goes on to the next frame
        Hm = out[21:246].view(np.float32).reshape(15, 15)
        if np.isfinite(Hm).all():
            self.pose_prior_H = Hm.copy()
            self.pose_prior_dT = max(self._frame_preint_dT, 1e-3)
        else:
            self.pose_prior_H = None
        n_inl = int(out[246])
        N = len(frame.feat_mp)
        inl = kernels.unpack_bits_host(out[247: 247 + (N + 31) // 32], N)
        frame.feat_mp[matched & ~inl] = -1
        return n_inl

    def _track_recently_lost_imu(self, frame: Frame) -> bool:
        """Dead-reckon on the IMU while RECENTLY_LOST and try to re-acquire
        visually (the reference substitutes the predicted state for
        relocalization for up to time_recently_lost). A frame that does not
        re-acquire keeps the predicted pose, so the chain and the exported
        trajectory stay continuous."""
        if not self._predict_pose_imu(frame, allow_untracked=True):
            return False
        m = self.map
        p = self.p
        if self.ref_kf < 0 or not m.kf_valid[self.ref_kf]:
            return False
        kfs = np.unique(np.concatenate(
            [[self.ref_kf], m.best_covisible(self.ref_kf, 10)])).astype(np.int64)
        mps = m.local_map_points(kfs)
        if len(mps) == 0:
            return False
        # a wider window than motion-model tracking: the prediction has drifted
        n = self._project_and_assign(frame, mps, p.max_local_mps, 2.0 * p.motion_radius,
                                     p.motion_ratio, p.th_high)
        if n < p.min_motion_matches:
            return False
        inl = self._optimize_frame_pose(frame)
        return inl >= p.min_motion_inliers

    def _track_with_prediction(self, frame: Frame) -> bool:
        """Track against the last frame's points from an already-set
        predicted pose (the IMU prediction: reference TrackWithMotionModel
        after PredictStateIMU)."""
        p = self.p
        last_mps = self.last_frame.feat_mp
        mp_ids = np.unique(last_mps[last_mps >= 0])
        mp_ids = mp_ids[self.map.mp_valid[mp_ids]]
        if len(mp_ids) == 0:
            return False
        n = self._project_and_assign(frame, mp_ids, self.orb_cfg.total_capacity,
                                     p.motion_radius, p.motion_ratio, p.th_high)
        if n < p.min_motion_matches:
            return False
        inl = self._optimize_frame_pose(frame)
        return inl >= p.min_motion_inliers

    def _frame_gap(self, frame: Frame) -> float:
        lf = self.last_frame
        return float(frame.ts - lf.ts) if lf is not None else 0.05

    def _get_fused_track_vi(self):
        """The visual-inertial fused step, built on the first frame that
        needs it."""
        if self._fused_track_vi is None:
            depth = max(1, int(self.p.pipeline_depth))
            r_scale = 1.0 + 0.5 * (depth - 1)
            self._fused_track_vi = kernels.fused_track_vi_pooled(
                self.cam_type, self.orb_cfg.n_levels, self.orb_cfg.scale,
                self._cam_key, self._wh_key, float(self.bf),
                float(self.p.motion_radius * r_scale), float(self.p.local_radius * r_scale),
                float(self.p.motion_ratio), float(self.p.local_ratio), int(self.p.th_high),
                float(self.imu_noise[2]), float(self.imu_noise[3]), device=self.device)
        return self._fused_track_vi

    def _track_fused(self, frame: Frame) -> bool:
        """One fused device step (kernels.fused_track_pooled, or
        fused_track_vi_pooled once IMU-initialized): both matching stages and
        the pose solves; falls back (False) on thin matches."""
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
        vi = self.imu_initialized
        if not vi:
            self._predict_pose(frame)
        else:
            # the IMU prediction runs inside the fused step; the host seed is
            # the last pose, so that a fused miss falls back from a sane pose
            frame.R = lf.R.copy()
            frame.t = lf.t.copy()
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
        if vi:
            # the previous body state, the biases and the carried marginal
            # prior (reference PredictStateIMU inputs + ConstraintPoseImu)
            st = np.empty(247, np.float32)
            R1_wb = lf.R.T
            st[0:9] = R1_wb.reshape(-1)
            st[9:12] = -R1_wb @ lf.t
            st[12:15] = self.velocity_w
            st[15:18] = self.imu_bias_g
            st[18:21] = self.imu_bias_a
            if self.pose_prior_H is not None:
                st[21:246] = self._scaled_prior(max(self._frame_gap(frame), 1e-3)).reshape(-1)
            else:
                # no carried prior (first frame after a keyframe or a world
                # transform): the previous state is anchored rigidly, as the
                # staged path's fixed previous state
                st[21:246] = (1e10 * np.eye(15, dtype=np.float32)).reshape(-1)
            st[246] = p.pose_prior_eps
            out_dev = self._get_fused_track_vi()(
                self._dev(st), self._dev(ids_packed), mpf, mpu, dev.xy, dev.desc,
                dev.octave, dev.valid, self._frame_ur_dev(frame), self.frame_preint, cl=cap_l)
        else:
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
                dev.xy, dev.desc, dev.octave, dev.valid, self._frame_ur_dev(frame), cl=cap_l)
        # start the packed result (and a pipelined stereo frame's ur, which
        # the keyframe policy reads) on its way to the host: non-blocking
        # copies into pinned memory and one event behind them. Consuming
        # waits on that event alone, not on whatever else the device has queued.
        ready = None
        if out_dev.is_cuda:
            host = torch.empty(out_dev.shape, dtype=out_dev.dtype, pin_memory=True)
            host.copy_(out_dev, non_blocking=True)
            ready = torch.cuda.Event()
            self._stage_ur_host(frame, ready)
            ready.record()
            out_dev = host
        return {"frame": frame, "out": out_dev, "ready": ready, "ids": ids_packed,
                "n_loc": len(loc_ids), "cap_l": cap_l, "cap_c": cap_c, "map": m,
                "epoch": m.remap_epoch, "wepoch": self.world_epoch, "vi": vi,
                "dT": max(self._frame_gap(frame), 1e-3)}

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
        nw_f = (cap_c + 31) // 32
        frustum_bits = out[off: off + nw_f]
        if pend["vi"]:
            # adopt the inertial state: velocity, biases and the 15-dim
            # marginal prior for the next frame
            off_vi = off + nw_f + (N + 31) // 32
            vi_f = out[off_vi: off_vi + 234].view(np.float32)
            v, bgn, ban = vi_f[0:3], vi_f[3:6], vi_f[6:9]
            Hm = vi_f[9:234].reshape(15, 15)
            if not np.isfinite(v).all():
                return False
            self.velocity_w = v.copy()
            if np.isfinite(bgn).all() and np.isfinite(ban).all():
                self.imu_bias_g = bgn.copy()
                self.imu_bias_a = ban.copy()
            if np.isfinite(Hm).all():
                self.pose_prior_H = Hm.copy()
                self.pose_prior_dT = pend["dT"]
            else:
                self.pose_prior_H = None
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
        if pend["vi"]:
            self.path_counts["fused_vi"] += 1
        return True

    def _min_local_inliers(self) -> int:
        """Reference TrackLocalMap acceptance plus the adaptive floor at 20%
        of the running inlier average."""
        if 0 <= self.n_frames - 1 - self._last_reloc_frame_id < self.p.max_frames_between_kf:
            return max(self.p.min_local_inliers, 50)
        if self.imu_initialized:
            return 15
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
        """Reference NeedNewKeyFrame for a visual rig: the c1a/c1b/c1c/c2
        conditions with the close-point triggers of a rig with depth, the
        reloc guard, or the fixed-interval cadence of
        ``kf_interval_override``."""
        p = self.p
        m = self.map
        if self.ref_kf < 0:
            return False
        last_kf_ts = float(m.kf_ts[self.ref_kf])
        if self.last_kf_frame_id >= 0:
            # the reference keyframe may be an older covisible one
            last_kf_ts = max(last_kf_ts, self._last_kf_ts)
        # before the IMU init the inertial cadence is a keyframe every 0.25 s
        if self.imu_enabled and not self.imu_initialized:
            return frame.ts - last_kf_ts >= 0.25
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
        idle = self.mapper_accepting is None or self.mapper_accepting()
        # close-point triggers (stereo / RGB-D)
        is_mono = self.bf <= 0
        need_close = False
        if not is_mono and self.th_depth > 0:
            self._ensure_stereo_host(frame)      # pipelined stereo: depth is lazy
            close = (frame.depth > 0) & (frame.depth < self.th_depth)
            n_tracked_close = int((close & (frame.feat_mp >= 0)).sum())
            n_untracked_close = int((close & (frame.feat_mp < 0)).sum())
            need_close = (n_tracked_close < 100) and (n_untracked_close > 70)
        th_ref = 0.75
        if n_kfs < 2:
            th_ref = 0.4
        elif is_mono and not self.imu_enabled:
            th_ref = p.ref_ratio
        elif self.rig is not None:
            th_ref = 0.75
        elif self.imu_enabled and is_mono:
            th_ref = 0.75 if n_tracked > 350 else 0.9
        c1a = frame.frame_id >= self.last_kf_frame_id + p.max_frames_between_kf
        c1b = frame.frame_id >= self.last_kf_frame_id + p.min_frames_between_kf and idle
        c1c = not is_mono and not self.imu_enabled and (n_tracked < 0.25 * n_ref or need_close)
        c2 = (n_tracked < th_ref * n_ref or need_close) and n_tracked > 15
        # the inertial temporal and rescue triggers
        c3 = self.imu_enabled and (frame.ts - last_kf_ts >= 0.5)
        c4 = (self.imu_enabled and is_mono
              and (15 < n_tracked < 75 or self.state == TrackState.RECENTLY_LOST))
        # a busy mapper gets no keyframe queued on top (the < 3 queue gate of
        # a rig with depth lives in mapper_accepting)
        return bool((((c1a or c1b or c1c) and c2) or c3 or c4) and idle)

    def _create_new_keyframe(self, frame: Frame):
        m = self.map
        self._ensure_stereo_host(frame)
        k = m.add_keyframe(frame.R, frame.t, frame.ts, frame.frame_id,
                           frame.xy, frame.angle, frame.octave, frame.desc,
                           frame.valid, feat_mp=frame.feat_mp.copy(),
                           ur=frame.ur, depth=frame.depth, uvr=frame.uvr)
        if self.bf > 0:
            self._spawn_close_points(frame, k)
            m.kf_feat_mp[k] = frame.feat_mp
        if self.imu_enabled and self.preint_since_kf is not None:
            self.kf_preints[k] = self.preint_since_kf
            self.preint_since_kf = None
            if self.device.type == "cuda":
                # the mapper's thread reads it on its own stream: settle the
                # tracker stream's work first (nothing else is queued on it
                # at a keyframe's creation)
                torch.cuda.current_stream().synchronize()
        # after a keyframe the mapper re-optimizes the window: the
        # frame-to-frame marginal prior is stale
        self.pose_prior_H = None
        if self.imu_enabled and self.velocity_w is not None:
            m.kf_vel[k] = self.velocity_w
            m.kf_bias_g[k] = self.imu_bias_g
            m.kf_bias_a[k] = self.imu_bias_a
        self.ref_kf = k
        self.last_kf_frame_id = frame.frame_id
        self._last_kf_ts = frame.ts
        # the IMU init and the visual-inertial BA staging run in the mapper;
        # a tracker with no mapper wired initializes here
        if self.imu_enabled and not self.imu_initialized and self.on_new_keyframe is None:
            self.try_imu_init()
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
        # the preintegration chain follows the migrated keyframe ids (its
        # deltas are body-frame quantities: the ids change, the values do not)
        if self.kf_preints:
            self.kf_preints = {kf_map[int(k)]: v for k, v in self.kf_preints.items()
                               if int(k) in kf_map}

    def rotate_world_state_for_merge(self, R_align: np.ndarray, s_align: float = 1.0):
        """Rotate and scale the tracker's world-frame inertial state into the
        merge target's world (x_old = s·R_a·x_cur + t_a)."""
        if self.velocity_w is not None:
            self.velocity_w = (s_align * (R_align @ self.velocity_w)).astype(np.float32)

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
