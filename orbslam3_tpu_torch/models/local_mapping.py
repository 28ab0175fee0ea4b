"""Local mapping: keyframe processing, triangulation, fuse, local BA, culling.

Port of the visual path of ``orbslam3_tpu/models/local_mapping.py``
(reference LocalMapping::Run: ProcessNewKeyFrame → MapPointCulling →
CreateNewMapPoints → SearchInNeighbors → LocalBundleAdjustment →
KeyFrameCulling) as host code over the port's device steps. It serves the
synchronous system (called inline per keyframe) and the asynchronous one
(called from the mapper thread): every step gathers and writes back under the
map lock and waits for the device outside it, so the tracker is never stalled
behind a mapper round trip; ``abort_check`` skips local BA and keyframe
culling while newer keyframes wait. Every visual BA runs through
``_run_ba``: with ``ba_chunk <= 0`` (the synchronous system) one two-phase
``ba_ops.local_ba``; with ``ba_chunk = n > 0`` (the asynchronous system sets
3, as the reference does) each phase as chunks of at most n LM iterations,
each chunk restarting the damping at 1e-4 and re-linearizing, with the state
kept on the device between chunks and the chi2 classification after each
phase. The two schedules give different results on the same problem, so the
async mapper runs the reference's async schedule. Global BA (``global_ba``,
after a loop correction) keeps the reference's schedule: phase 1, then
chunks of 2 LM iterations with an abort check between them; on a mesh of two
or more shards (``mesh``, a device list from ``parallel.make_mesh``) a map of
64 keyframes or more without a second camera takes the landmark-sharded
solve of ``parallel/sharded_ba.py`` instead, as one abort granule whose
observations all count as inliers. ``_fuse_into`` is the loop closer's SearchAndFuse
and the merge's weld. A rig with depth (stereo, RGB-D) adds the right-column
rows to BA (``bf``) and keeps close points in keyframe culling (the tracker's
``th_depth``); a two-camera fisheye rig (``rig``) adds the second camera's
rows. On a visual-inertial map (``inertial``, the tracker, with its IMU on)
the mapper drives the IMU staging after each round (``_inertial_stage``:
the inertial-only initialization followed by a whole-map inertial BA, the
bad-IMU check, VIBA1 and VIBA2, the monocular scale refinement), replaces
local BA by the joint landmark + pose / velocity / bias BA over the last
``vi_window`` keyframes once initialized (``local_inertial_ba``), and keeps
the temporal chain in keyframe culling (composing the preintegrations across
a culled keyframe).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native, resolve_device
from ..ops import ba as ba_ops
from ..ops import imu as imu_ops
from ..ops import vi_ba as vi_ops
from ..parallel import sharded_ba as sb
from ..utils.timing import StageTimer
from . import kernels
from .device_map import kf_pool_for, mirror_for
from .map import MapState


class LocalMapper:
    def __init__(self, map_state: MapState, K: np.ndarray, orb_cfg,
                 wh=(752, 480), ba_window: int = 16, ba_max_fixed: int = 8,
                 ba_point_cap: int = 4096, cam_type: int = 0, device=None):
        self.map = map_state
        self.device = resolve_device(device)
        self.K = np.asarray(K, np.float32)
        self.wh = np.asarray(wh, np.float32)
        self.orb_cfg = orb_cfg
        self.cam_type = int(cam_type)
        self.bf = 0.0      # set by the system for stereo / RGB-D / fisheye rigs
        # two-camera rig (dict with cam_r / R_rl / t_rl): second-camera BA rows
        self.rig = None
        self.ba_window = ba_window
        self.ba_max_fixed = ba_max_fixed
        self.ba_point_cap = ba_point_cap
        self.recent_mp: list[tuple[int, np.ndarray]] = []  # (created_at_kf, ids)
        self.stats = {"triangulated": 0, "culled_mp": 0, "ba_runs": 0}
        # Tracker backref: trajectory re-anchoring when a keyframe is culled
        self.tracker = None
        # inertial: the tracker (it owns the biases and the preintegrations),
        # bound by the system; the IMU staging runs here, as in the
        # reference's LocalMapping thread
        self.inertial = None
        self.preserve_temporal_chain = False
        self.vi_window = 10
        # bad-IMU hook (reference mbBadImu: the system resets the active map)
        self.on_bad_imu = None
        self.kf_cull_redundancy = 0.9
        self.timer = StageTimer()
        # fn(R_rel, t_rel) after a propagated global BA, under the map lock:
        # the system shifts the tracker's live frame by the anchor correction
        self.on_poses_corrected = None
        # LM iterations per chunk of a BA phase (0: one call per BA); the
        # system sets 3 under async mapping
        self.ba_chunk = 0
        # the global BA's shards (``parallel.make_mesh``); None: every
        # visible device of the mapper's type, resolved at the first global BA
        self.mesh = None
        self._K_dev = torch.as_tensor(self.K, device=self.device)
        self._fuse_match = None
        map_state.on_remap["mapper"] = self._on_map_remap

    def _on_map_remap(self, kf_remap: np.ndarray, mp_remap: np.ndarray):
        """Map pools compacted: remap held ids (under the map lock)."""
        out = []
        for created_kf, ids in self.recent_mp:
            ids = mp_remap[ids]
            ids = ids[ids >= 0]
            ck = int(kf_remap[created_kf])
            if ck < 0:
                ck = int(np.searchsorted(np.nonzero(kf_remap >= 0)[0], created_kf))
            if len(ids):
                out.append((ck, ids.astype(np.int32)))
        self.recent_mp = out

    def _dev(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def process_keyframe(self, kf_id: int, initial: bool = False,
                         abort_check=None) -> int:
        """One mapper round. ``abort_check`` is the reference's
        run-BA-only-when-idle rule: local BA and keyframe culling run only if
        it is None or returns False (no newer keyframe queued, no stop
        requested). Returns the keyframe's id, remapped if the mapper
        compacted the pools."""
        m = self.map
        with m.lock:
            kf_id = m.maybe_compact(kf_id)
            with self.timer.stage("5.kf_insert"):
                m.refresh_map_points(
                    np.unique(m.kf_feat_mp[kf_id][m.kf_feat_mp[kf_id] >= 0]))
                # spanning-tree parent = most-covisible earlier keyframe
                if m.kf_parent[kf_id] < 0:
                    covis = m.covisibility_row(kf_id)
                    covis[kf_id:] = 0
                    if covis.max() >= 15:
                        m.kf_parent[kf_id] = int(np.argmax(covis))
                    else:
                        earlier = [int(v) for v in m.valid_kf_ids() if v < kf_id]
                        if earlier:
                            m.kf_parent[kf_id] = earlier[-1]
            if initial:
                # initial map: global BA over the 2 bootstrap keyframes
                self.local_ba(kf_id, iters=(10, 20))
                self._renormalize_initial_scale(kf_id)
                return kf_id
            with self.timer.stage("6.mp_culling"):
                self.cull_map_points(kf_id)
        # triangulation, fuse and BA manage their own locking: they gather
        # and enqueue under the map lock and wait for the device outside it.
        # Pool indices stay stable meanwhile: compaction runs only in this
        # thread (maybe_compact above).
        with self.timer.stage("7.mp_creation"):
            self.create_new_map_points(kf_id)
        with self.timer.stage("8.fuse"):
            self.search_in_neighbors(kf_id)
        if abort_check is None or not abort_check():
            with self.timer.stage("9.local_ba"):
                if self.inertial is not None and self.inertial.imu_initialized:
                    # LocalInertialBA replaces the visual local BA once the
                    # map is IMU-initialized
                    self.local_inertial_ba(kf_id)
                else:
                    self.local_ba(kf_id)
            with m.lock, self.timer.stage("10.kf_culling"):
                self.cull_keyframes(kf_id)
        if self.inertial is not None and self.inertial.imu_enabled:
            with m.lock:
                self._inertial_stage(kf_id)
        return kf_id

    def _renormalize_initial_scale(self, kf_id: int):
        """After init BA, re-fix median depth to 1."""
        m = self.map
        mps = m.valid_mp_ids()
        if len(mps) == 0:
            return
        depths = (m.mp_xyz[mps] @ m.kf_R[0].T + m.kf_t[0])[:, 2]
        med = np.median(depths)
        if med <= 1e-6:
            return
        m.mp_xyz[mps] /= med
        for k in range(m.n_kf):
            m.kf_t[k] /= med
        m.touch()

    # ------------------------------------------------------------------
    def cull_map_points(self, kf_id: int):
        """Reference MapPointCulling: cull recent points with found/visible <
        0.25 or too few observations 2 KFs after creation."""
        m = self.map
        survivors = []
        to_cull = []
        for created_kf, ids in self.recent_mp:
            ids = ids[m.mp_valid[ids]]
            if len(ids) == 0:
                continue
            age = kf_id - created_kf
            bad = m.mp_found[ids] / np.maximum(m.mp_visible[ids], 1) < 0.25
            if age >= 2:
                bad |= m.obs_count(ids) <= 2
            to_cull.append(ids[bad])
            keep = ids[~bad]
            if age < 3 and len(keep):
                survivors.append((created_kf, keep))
        self.recent_mp = survivors
        if to_cull:
            allc = np.concatenate(to_cull)
            m.remove_map_points(allc)
            self.stats["culled_mp"] += len(allc)

    # ------------------------------------------------------------------
    def create_new_map_points(self, kf_id: int, n_neighbors: int = 10):
        """Reference CreateNewMapPoints: epipolar search + triangulation
        against the best covisible keyframes, all in one device call."""
        m = self.map
        with m.lock:
            disp = self._dispatch_triangulation(kf_id, n_neighbors)
        if disp is None:
            return
        out_dev, nb_ids, c1, cap_new = disp
        out = out_dev.cpu().numpy()              # the wait, outside the lock
        with m.lock:
            self._apply_triangulation(kf_id, out, nb_ids, c1, cap_new)

    def _dispatch_triangulation(self, kf_id: int, n_neighbors: int):
        m = self.map
        neighbors = m.best_covisible(kf_id, n_neighbors, min_weight=15)
        if len(neighbors) == 0 and m.n_kf >= 2:
            neighbors = np.array([kf_id - 1], np.int32)
        R1, t1 = m.kf_R[kf_id], m.kf_t[kf_id]
        c1 = -R1.T @ t1
        un1 = m.kf_feat_valid[kf_id] & (m.kf_feat_mp[kf_id] < 0)
        if un1.sum() < 10:
            return None
        keep = []
        for k2 in neighbors:
            k2 = int(k2)
            R2, t2 = m.kf_R[k2], m.kf_t[k2]
            baseline = np.linalg.norm(c1 - (-R2.T @ t2))
            mps2 = m.kf_feat_mp[k2]
            mps2 = mps2[mps2 >= 0]
            if len(mps2):
                depths = (m.mp_xyz[mps2] @ R2.T + t2)[:, 2]
                med = np.median(depths[depths > 0]) if (depths > 0).any() else 1.0
                if baseline / max(med, 1e-9) < 0.01:
                    continue
            elif baseline < 1e-6:
                continue
            un2 = m.kf_feat_valid[k2] & (m.kf_feat_mp[k2] < 0)
            if un2.sum() < 10:
                continue
            keep.append((k2, un2))
        if not keep:
            return None
        B = 16 if len(keep) > 8 else 8
        N = m.cfg.n_features
        nb_ids = np.full(B, -1, np.int32)
        un2_all = np.zeros((B, N), bool)
        for i, (k2, un2) in enumerate(keep):
            nb_ids[i] = k2
            un2_all[i] = un2
        poses2 = np.zeros((B, 12), np.float32)
        poses2[: len(keep), 0:9] = m.kf_R[nb_ids[: len(keep)]].reshape(-1, 9)
        poses2[: len(keep), 9:12] = m.kf_t[nb_ids[: len(keep)]]
        pose1 = np.concatenate([R1.reshape(-1), t1]).astype(np.float32)
        pool_xy, pool_desc, pool_oct = kf_pool_for(m, self.device).sync(
            m, [kf_id] + [k for k, _ in keep])
        cap_new = 2048
        fn = kernels.triangulation_batched(
            self.cam_type, self.orb_cfg.n_levels, self.orb_cfg.scale,
            tuple(float(v) for v in self.K), cap_new=cap_new,
            max_dist=50, sigma_n=1.0 / float(self.K[0]), device=self.device)
        out_dev = fn(self._dev(pose1), pool_xy[kf_id], pool_desc[kf_id], pool_oct[kf_id],
                     self._dev(un1), self._dev(nb_ids), self._dev(nb_ids >= 0),
                     self._dev(poses2), self._dev(un2_all), pool_xy, pool_desc, pool_oct)
        return out_dev, nb_ids, c1, cap_new

    def _apply_triangulation(self, kf_id: int, out, nb_ids, c1, cap_new):
        m = self.map
        count = int(out[0])
        if count == 0:
            return
        f1 = out[1: 1 + cap_new][:count]
        f2 = out[1 + cap_new: 1 + 2 * cap_new][:count]
        b = out[1 + 2 * cap_new: 1 + 3 * cap_new][:count]
        xw = np.stack([out[1 + (3 + i) * cap_new: 1 + (4 + i) * cap_new][:count].view(np.float32)
                       for i in range(3)], axis=1)
        # a feature may triangulate against several neighbours — keep the
        # first (neighbours are covisibility-ranked)
        _, first = np.unique(f1, return_index=True)
        first = np.sort(first)
        f1, f2, b, xw = f1[first], f2[first], b[first], xw[first]
        good = np.isfinite(xw).all(axis=1)
        f1, f2, b, xw = f1[good], f2[good], b[good], xw[good]
        if len(f1) == 0:
            return
        dirs = xw - c1
        dist = np.linalg.norm(dirs, axis=1)
        normals = dirs / np.maximum(dist[:, None], 1e-9)
        sf = m.scale_factors
        maxd = dist * sf[m.kf_feat_octave[kf_id, f1]]
        mind = maxd / sf[-1]
        ids = m.add_map_points(xw.astype(np.float32), m.kf_feat_desc[kf_id, f1], kf_id,
                               normals, mind, maxd, first_kf=kf_id)
        m.kf_feat_mp[kf_id, f1] = ids
        m.kf_feat_mp[nb_ids[b], f2] = ids
        m.mp_visible[ids] = 1
        m.mp_found[ids] = 1
        self.recent_mp.append((kf_id, ids))
        self.stats["triangulated"] += len(ids)

    # ------------------------------------------------------------------
    def search_in_neighbors(self, kf_id: int, n_neighbors: int = 10, cap: int = 4096):
        """Reference SearchInNeighbors + ORBmatcher::Fuse: project the new
        keyframe's points into its covisible neighbours and the neighbours'
        points into it, all targets in one device call; a match merges with
        the feature's point (keep the more observed) or claims the feature."""
        m = self.map
        with m.lock:
            neighbors = [int(k) for k in m.best_covisible(kf_id, n_neighbors, min_weight=15)]
            if not neighbors:
                return
            kf_mps = m.kf_feat_mp[kf_id]
            kf_mps = np.unique(kf_mps[kf_mps >= 0])
            kf_mps = kf_mps[m.mp_valid[kf_mps]]
            neigh_mps = m.local_map_points(np.asarray(neighbors, np.int32))
            targets = neighbors + [kf_id]
            T = 16 if len(targets) > 12 else 12
            C = cap
            tgt_ids = np.full(T, -1, np.int32)
            tgt_ids[: len(targets)] = targets
            tgt_poses = np.zeros((T, 12), np.float32)
            tgt_poses[: len(targets), 0:9] = m.kf_R[targets].reshape(-1, 9)
            tgt_poses[: len(targets), 9:12] = m.kf_t[targets]
            N = m.cfg.n_features
            tgt_fvalid = np.zeros((T, N), bool)
            tgt_fvalid[: len(targets)] = m.kf_feat_valid[targets]
            cand_ids = np.full((T, C), -1, np.int32)
            for i in range(len(neighbors)):
                cand_ids[i, : min(len(kf_mps), C)] = kf_mps[:C]
            cand_ids[len(targets) - 1, : min(len(neigh_mps), C)] = neigh_mps[:C]
            fn = kernels.fuse_batched(
                self.cam_type, self.orb_cfg.n_levels, self.orb_cfg.scale,
                tuple(float(v) for v in self.K),
                (float(self.wh[0]), float(self.wh[1])), cap_cand=C, device=self.device)
            mpf, mpu = mirror_for(m, self.device).sync(m)
            pool_xy, pool_desc, pool_oct = kf_pool_for(m, self.device).sync(m, targets)
            cap_out = 4096
            out_dev = fn(self._dev(tgt_ids), self._dev(tgt_poses), self._dev(tgt_fvalid),
                         self._dev(cand_ids), mpf, mpu, pool_xy, pool_desc, pool_oct)
        out = out_dev.cpu().numpy()              # the wait, outside the lock
        with m.lock:
            count = int(out[0])
            if count:
                t_i = out[1: 1 + cap_out][:count]
                c_i = out[1 + cap_out: 1 + 2 * cap_out][:count]
                f_i = out[1 + 2 * cap_out: 1 + 3 * cap_out][:count]
                self._apply_fuse_matches(tgt_ids[t_i], cand_ids[t_i, c_i], f_i)
            m.refresh_map_points(kf_mps)

    def _apply_fuse_matches(self, tgt_kf: np.ndarray, mp_src: np.ndarray,
                            feat_tgt: np.ndarray):
        """Merge/claim bookkeeping for batched fuse matches (reference
        MapPoint::Replace semantics: keep the more-observed point)."""
        m = self.map
        obs_cnt = m.obs_count()
        replaced: dict[int, int] = {}
        rep_old: list[int] = []
        rep_new: list[int] = []
        for mp, t, ft in zip(mp_src, tgt_kf, feat_tgt):
            mp = int(mp)
            mp = replaced.get(mp, mp)
            if mp < 0 or not m.mp_valid[mp]:
                continue
            existing = int(m.kf_feat_mp[t, ft])
            existing = replaced.get(existing, existing)
            if existing == mp:
                continue
            if existing < 0 or not m.mp_valid[existing]:
                m.kf_feat_mp[t, ft] = mp
                continue
            if obs_cnt[mp] >= obs_cnt[existing]:
                old, new = existing, mp
            else:
                old, new = mp, existing
            if replaced.get(old, old) != old:
                continue
            replaced[old] = new
            rep_old.append(old)
            rep_new.append(new)
        if rep_old:
            m.replace_map_points(np.asarray(rep_old, np.int64), np.asarray(rep_new, np.int64))

    def _fuse_into(self, mp_ids: np.ndarray, target_kf: int, cap: int):
        """Project ``mp_ids`` into one keyframe and fuse (the reference's
        ORBmatcher::Fuse at radius 3, TH_LOW, no ratio test): one
        ``match_rows`` launch over ``cap`` rows; a match claims the feature
        or merges with its point (the more observed one survives). Runs under
        the map lock (the loop correction's and the merge's)."""
        m = self.map
        if self._fuse_match is None:
            self._fuse_match = kernels.projection_matcher(
                self.cam_type, self.orb_cfg.n_levels, self.orb_cfg.scale, device=self.device)
        mp_ids = mp_ids[m.mp_valid[mp_ids]][:cap]
        if len(mp_ids) == 0:
            return
        n = len(mp_ids)
        pad = cap - n

        def pk(a, fill=0.0):
            out = a[mp_ids]
            if pad:
                out = np.concatenate([out, np.full((pad,) + out.shape[1:], fill, out.dtype)])
            return self._dev(out.view(np.int32) if out.dtype == np.uint32 else out)

        valid = np.zeros(cap, bool)
        valid[:n] = True
        idx, ok, _, _, _ = self._fuse_match(
            pk(m.mp_xyz), pk(m.mp_desc), pk(m.mp_normal), pk(m.mp_min_dist),
            pk(m.mp_max_dist, 1.0), self._dev(valid),
            self._dev(m.kf_R[target_kf]), self._dev(m.kf_t[target_kf]), self._K_dev,
            self._dev(m.kf_feat_xy[target_kf]),
            self._dev(m.kf_feat_desc[target_kf].view(np.int32)),
            self._dev(m.kf_feat_octave[target_kf]), self._dev(m.kf_feat_valid[target_kf]),
            self._dev(self.wh),
            3.0,      # fuse radius 3·scale (the reference's Fuse th=3)
            1.0,      # no ratio test in Fuse
            50,       # TH_LOW
            0.5)
        okn = ok.cpu().numpy()[:n]
        idxn = idx.cpu().numpy()[:n]
        src = np.nonzero(okn)[0]
        if len(src) == 0:
            return
        mp_src = mp_ids[src]
        feat_tgt = idxn[src]
        cur = m.kf_feat_mp[target_kf, feat_tgt]
        obs_cnt = m.obs_count()
        for mp, ft, existing in zip(mp_src, feat_tgt, cur):
            if existing == mp:
                continue
            if existing < 0:
                m.kf_feat_mp[target_kf, ft] = mp
            else:
                if not m.mp_valid[existing]:
                    m.kf_feat_mp[target_kf, ft] = mp
                    continue
                # merge: keep the more-observed point (MapPoint::Replace)
                if obs_cnt[mp] >= obs_cnt[existing]:
                    m.replace_map_points(np.asarray([existing]), np.asarray([mp]))
                else:
                    m.replace_map_points(np.asarray([mp]), np.asarray([existing]))

    # ------------------------------------------------------------------
    def cull_keyframes(self, kf_id: int, redundancy: float | None = None,
                       max_cull_per_run: int = 20):
        """Reference KeyFrameCulling: a covisible keyframe >= 90% of whose
        map points are seen by >= 3 other keyframes at the same or finer
        scale is removed (the first two keyframes always stay); the counts run
        in the native C++ kernel, worst first, recomputed after each removal."""
        if redundancy is None:
            redundancy = self.kf_cull_redundancy
        m = self.map
        tr = self.tracker
        inertial = (self.inertial is not None and self.inertial.imu_enabled
                    and self.preserve_temporal_chain)
        # in inertial mode nothing is culled while the map holds <= 21
        # keyframes (the IMU init needs the dense temporal chain)
        if inertial and len(m.valid_kf_ids()) <= 21:
            return
        # a rig with depth counts only close points (the reference's ThDepth)
        th_depth = float(getattr(tr, "th_depth", 0.0) or 0.0) if self.bf > 0 else 0.0

        def redundancy_counts(cands):
            red_tot = native.kf_redundancy(
                m.kf_feat_mp[: m.n_kf], m.kf_valid[: m.n_kf],
                m.kf_feat_octave[: m.n_kf], m.kf_feat_depth[: m.n_kf],
                th_depth, cands, m.cfg.max_map_points)
            if red_tot is not None:
                return red_tot
            # numpy fallback: scale-unaware approximation
            obs = m.obs_count()
            red = np.zeros(len(cands), np.int32)
            tot = np.zeros(len(cands), np.int32)
            for i, k in enumerate(cands):
                row = m.kf_feat_mp[k]
                mps = row[row >= 0]
                mps = mps[m.mp_valid[mps]]
                tot[i] = len(mps)
                red[i] = int((obs[mps] > 3).sum())
            return red, tot

        n_culled = 0
        while n_culled < max_cull_per_run:
            candidates = np.asarray(
                [int(k) for k in m.best_covisible(kf_id, m.n_kf, min_weight=15)
                 if k > 1 and k != kf_id and m.kf_valid[k]], np.int32)
            if len(candidates) == 0:
                return
            red, tot = redundancy_counts(candidates)
            frac = red / np.maximum(tot, 1)
            frac[tot < 20] = 0.0
            culled_this_round = False
            for i in np.argsort(-frac):
                k = int(candidates[i])
                if tot[i] < 20 or red[i] <= redundancy * tot[i]:
                    break
                if self._cull_one_keyframe(k, inertial):
                    n_culled += 1
                    culled_this_round = True
                    break
            if not culled_this_round:
                return

    def _cull_one_keyframe(self, k: int, inertial: bool) -> bool:
        """Apply the temporal-chain guards of an inertial map, then remove
        keyframe ``k``."""
        m = self.map
        if inertial:
            tr = self.inertial
            valid = m.valid_kf_ids()
            pos = np.searchsorted(valid, k)
            # never the first, nor the head of the temporal chain (the
            # reference's mnId > mnId-2 guard)
            if pos == 0 or pos >= len(valid) - 3:
                return False
            prev_k = int(valid[pos - 1])
            next_k = int(valid[pos + 1])
            limit = 3.0 if tr.viba2_done else 0.5
            if float(m.kf_ts[next_k] - m.kf_ts[prev_k]) > limit:
                return False
            # merge the preintegration chain across the culled keyframe
            pk = tr.kf_preints.get(k)
            pn = tr.kf_preints.get(next_k)
            if pk is not None and pn is not None:
                tr.kf_preints[next_k] = imu_ops.compose(pk, pn)
            tr.kf_preints.pop(k, None)
        if self.tracker is not None:
            self.tracker.reanchor_trajectory(k)
        m.remove_keyframe(k)
        self.stats["culled_kf"] = self.stats.get("culled_kf", 0) + 1
        return True

    # ------------------------------------------------------------------
    def local_ba(self, kf_id: int, iters: tuple[int, int] = (5, 10)):
        """Reference LocalBundleAdjustment: window = keyframe + covisibles,
        fixed = other observers (min 2), two-phase schedule, one packed read
        of the result, outlier observations erased."""
        m = self.map
        with m.lock:
            prob_data = self._gather_local_ba(kf_id)
        if prob_data is None:
            return
        prob, all_kfs, fixed_mask, pts, o_src_kf, o_src_feat, n_obs = prob_data
        # the solve runs on the gathered snapshot, outside the lock
        res = self._run_ba(prob, iters)
        Kb = int(prob.R.shape[0])
        Pb = int(prob.pts.shape[0])
        Ob = int(prob.obs_kf.shape[0])
        buf = kernels.ba_result_packer()(res.R, res.t, res.pts,
                                         res.obs_inlier).cpu().numpy()
        Rn = buf[0: Kb * 9].view(np.float32).reshape(Kb, 3, 3)[: len(all_kfs)]
        tn = buf[Kb * 9: Kb * 12].view(np.float32).reshape(Kb, 3)[: len(all_kfs)]
        ptsn = buf[Kb * 12: Kb * 12 + Pb * 3].view(np.float32).reshape(Pb, 3)
        inl = kernels.unpack_bits_host(buf[Kb * 12 + Pb * 3:], Ob)[: n_obs]
        with m.lock:
            for i, k in enumerate(all_kfs):
                if not fixed_mask[i] and m.kf_valid[k]:
                    m.kf_R[k] = Rn[i]
                    m.kf_t[k] = tn[i]
            keep = m.mp_valid[pts]
            m.mp_xyz[pts[keep]] = ptsn[: len(pts)][keep]
            m.touch()
            bad = ~inl & (o_src_feat >= 0)
            if bad.any():
                m.kf_feat_mp[o_src_kf[bad], o_src_feat[bad]] = -1
        self.stats["ba_runs"] += 1

    def _gather_local_ba(self, kf_id: int):
        m = self.map
        window = [kf_id] + [int(k) for k in m.best_covisible(kf_id, self.ba_window - 1,
                                                             min_weight=15)]
        window = list(dict.fromkeys(window))
        pts = m.local_map_points(np.asarray(window, np.int32))[: self.ba_point_cap]
        if len(pts) < 20 or len(window) < 2:
            return None
        kf_idx, feat_idx = m.observations_of(pts)
        obs_mp_global = m.kf_feat_mp[kf_idx, feat_idx]
        outside = np.setdiff1d(np.unique(kf_idx), np.asarray(window))
        fixed_kfs = [int(k) for k in outside[: self.ba_max_fixed]]
        all_kfs = window + fixed_kfs
        fixed_mask = np.zeros(len(all_kfs), bool)
        fixed_mask[len(window):] = True
        # at least 2 fixed cameras: fewer leaves monocular BA a free scale gauge
        n_need = 2 - int(fixed_mask.sum())
        if n_need > 0:
            for idx in np.argsort([m.kf_frame_id[k] for k in all_kfs]):
                if n_need == 0:
                    break
                if not fixed_mask[idx]:
                    fixed_mask[idx] = True
                    n_need -= 1
        kf_lut = np.full(m.cfg.max_keyframes, -1, np.int32)
        kf_lut[np.asarray(all_kfs)] = np.arange(len(all_kfs))
        mp_lut = np.full(m.cfg.max_map_points, -1, np.int32)
        mp_lut[pts] = np.arange(len(pts))
        (o_kf, o_mp, o_uv, o_ur, o_is2, o_cam, o_src_kf,
         o_src_feat) = self._gather_obs(kf_idx, feat_idx, obs_mp_global, kf_lut, mp_lut)
        # the reference's size buckets: same padded shapes, same problem caps
        Kb = self._bucket(len(all_kfs), [4, 8, 12, 16, 24, 32])
        Pb = self._bucket(len(pts), [256, 512, 1024, 2048, 4096])
        Ob = self._bucket(len(o_kf), [1024, 2048, 4096, 8192, 16384, 32768])
        if Kb is None or Pb is None or Ob is None:
            return None

        def pad(a, n, fill=0):
            out = np.full((n,) + a.shape[1:], fill, a.dtype)
            out[: len(a)] = a
            return self._dev(out)

        R_pad = np.zeros((Kb, 3, 3), np.float32)
        R_pad[:] = np.eye(3)
        R_pad[: len(all_kfs)] = m.kf_R[all_kfs]
        prob = ba_ops.BAProblem(
            R=self._dev(R_pad),
            t=pad(m.kf_t[all_kfs], Kb),
            pts=pad(m.mp_xyz[pts], Pb),
            obs_kf=pad(o_kf.astype(np.int32), Ob),
            obs_mp=pad(o_mp.astype(np.int32), Ob),
            obs_uv=pad(o_uv.astype(np.float32), Ob),
            obs_inv_sigma2=pad(o_is2.astype(np.float32), Ob, 1.0),
            obs_valid=pad(np.ones(len(o_kf), bool), Ob, False),
            fixed_pose=pad(fixed_mask, Kb, True),
            obs_ur=pad(o_ur.astype(np.float32), Ob, -1.0),
            bf=self.bf,
            **self._rig_fields(o_cam, Ob),
        )
        return prob, all_kfs, fixed_mask, pts, o_src_kf, o_src_feat, len(o_kf)

    def _gather_obs(self, kf_idx, feat_idx, obs_mp, kf_lut, mp_lut):
        """BA observation rows of the observations whose keyframe and point
        are both in the problem, followed on a rig by the second camera's
        (ToBody) rows for the stereo-matched features. Returns (kf, mp, uv,
        ur, inv_sigma2, cam, src_kf, src_feat); a second-camera row's
        src_feat is -1, so an outlier verdict never erases the (left)
        observation."""
        m = self.map
        sel = (kf_lut[kf_idx] >= 0) & (mp_lut[obs_mp] >= 0)
        kf, ft = kf_idx[sel], feat_idx[sel]
        rows = [kf_lut[kf], mp_lut[obs_mp[sel]], m.kf_feat_xy[kf, ft], m.kf_feat_ur[kf, ft],
                m.inv_level_sigma2[m.kf_feat_octave[kf, ft]], np.zeros(len(kf), np.int32),
                kf, ft]
        if self.rig is None:
            return rows
        uvr = m.kf_feat_uvr[kf, ft]
        has_r = uvr[:, 0] >= 0
        n_r = int(has_r.sum())
        second = [rows[0][has_r], rows[1][has_r], uvr[has_r], np.full(n_r, -1.0, np.float32),
                  rows[4][has_r], np.ones(n_r, np.int32), kf[has_r],
                  np.full(n_r, -1, ft.dtype)]
        return [np.concatenate([a, b]) for a, b in zip(rows, second)]

    def _rig_fields(self, o_cam, Ob):
        """The second camera's BAProblem fields (none for a one-camera rig)."""
        if self.rig is None:
            return {}
        out = np.zeros(Ob, np.int32)
        out[: len(o_cam)] = o_cam
        return dict(obs_cam=self._dev(out),
                    cam_params2=self._dev(self.rig["cam_r"].astype(np.float32)),
                    R_rl=self._dev(self.rig["R_rl"].astype(np.float32)),
                    t_rl=self._dev(self.rig["t_rl"].astype(np.float32)))

    # ------------------------------------------------------------------
    # inertial
    # ------------------------------------------------------------------
    def _inertial_stage(self, kf_id: int):
        """IMU initialization staging (reference LocalMapping::Run's inertial
        block): InitializeIMU followed by a whole-map inertial BA → the
        bad-IMU check → VIBA1 at mTinit > 5 s (priors 1, 1e5) → VIBA2 at
        > 15 s (priors 0, 0) → scale-refinement passes every ~10 s while the
        map holds <= 100 keyframes (monocular only)."""
        tr = self.inertial
        m = self.map
        if not tr.imu_enabled:
            return
        if not tr.imu_initialized:
            with self.timer.stage("15.imu_init"):
                done = tr.try_imu_init()
            if done:
                # the reference's InitializeIMU ends with FullInertialBA(100);
                # the joint BA is also the scale estimator here
                self.full_inertial_ba(kf_id, iters=30, prior_g=1e2,
                                      prior_a=1e10 if self.bf <= 0 else 1e5)
            return
        ts = float(m.kf_ts[kf_id])
        tinit = ts - tr.imu_init_ts
        # bad IMU: within 10 s of the init and before VIBA2, near-zero travel
        # over the last three keyframes means an under-excited init
        valid = m.valid_kf_ids()
        if (not tr.viba2_done and tinit < 10.0 and len(valid) >= 3
                and self.on_bad_imu is not None):
            c = [-m.kf_R[k].T @ m.kf_t[k] for k in (int(valid[-3]), int(valid[-2]),
                                                    int(valid[-1]))]
            dist = float(np.linalg.norm(c[2] - c[1])) + float(np.linalg.norm(c[1] - c[0]))
            if dist < 0.02:
                self.stats["bad_imu_resets"] = self.stats.get("bad_imu_resets", 0) + 1
                self.on_bad_imu()
                return
        # VIBA1 / VIBA2: whole-map inertial BAs with annealed bias priors
        if not tr.viba1_done and tinit > 5.0:
            self.full_inertial_ba(kf_id, iters=12, prior_g=1.0, prior_a=1e5)
            self.stats["viba1"] = 1
            tr.viba1_done = True
        elif not tr.viba2_done and tinit > 15.0:
            self.full_inertial_ba(kf_id, iters=12, prior_g=0.0, prior_a=0.0)
            self.stats["viba2"] = 1
            tr.viba2_done = True
        elif (self.bf <= 0 and tr.viba2_done and m.n_kf <= 100
              and ts - max(tr.imu_init_ts + 15.0, tr.last_scale_refine_ts) > 10.0):
            tr.last_scale_refine_ts = ts
            self.full_inertial_ba(kf_id, iters=8, prior_g=1e2, prior_a=1e5)
            self.stats["scale_refines"] = self.stats.get("scale_refines", 0) + 1

    def local_inertial_ba(self, kf_id: int, iters: int = 8):
        """Local inertial BA (reference LocalInertialBA: a temporal window of
        ``vi_window`` keyframes linked by preintegration edges plus the
        visual edges, the window's first keyframe fixed with its velocity and
        biases) as one joint landmark + pose / velocity / bias Schur solve."""
        with self.timer.stage("9i.local_inertial_ba"):
            self._run_vi_joint(kf_id, window=self.vi_window, iters=iters,
                               fix_vel_bias_of_fixed=True)

    def full_inertial_ba(self, kf_id: int, iters: int = 12, prior_g: float = 1e2,
                         prior_a: float = 1e5, abort_check=None):
        """Whole-map joint inertial BA (reference FullInertialBA): every
        valid keyframe, the first pose fixed, bias priors on the first
        keyframe. A whole-map solve can rescale and re-gravity the world: a
        pipelined dispatch in flight is dropped at consume (the tracker's
        ``world_epoch``)."""
        with self.timer.stage("16.full_inertial_ba"):
            n = len(self.map.valid_kf_ids())
            self._run_vi_joint(kf_id, window=n, iters=iters, fix_vel_bias_of_fixed=False,
                               prior_g=prior_g, prior_a=prior_a, abort_check=abort_check)
        if self.inertial is not None:
            self.inertial.world_epoch += 1

    def _run_vi_joint(self, kf_id: int, window: int, iters: int,
                      fix_vel_bias_of_fixed: bool, prior_g: float = 0.0,
                      prior_a: float = 0.0, abort_check=None):
        tr = self.inertial
        m = self.map
        with m.lock:
            snap_epoch = m.remap_epoch
            data = self._gather_vi_joint(kf_id, window)
        if data is None:
            return
        win, n_win, pts, o_src_kf, o_src_feat, n_obs, args = data
        if abort_check is not None and abort_check():
            return
        # the solve runs on the gathered snapshot, outside the lock
        res = vi_ops.vi_joint_ba(**args, cam_type=self.cam_type, iters=iters,
                                 prior_g=prior_g, prior_a=prior_a,
                                 fix_vel_bias_of_fixed=fix_vel_bias_of_fixed)
        Kb = int(args["R0"].shape[0])
        Pb = int(args["pts0"].shape[0])
        Ob = int(args["obs_kf"].shape[0])
        buf = kernels.f32_bits(torch.cat([
            res.R.reshape(-1), res.t.reshape(-1), res.vels.reshape(-1), res.bg.reshape(-1),
            res.ba.reshape(-1), res.pts.reshape(-1)]))
        buf = torch.cat([buf, kernels._pack_bits_i32(res.obs_inlier)]).cpu().numpy()
        f = buf[: Kb * 21 + Pb * 3].view(np.float32)
        Rn = f[0: Kb * 9].reshape(Kb, 3, 3)
        tn = f[Kb * 9: Kb * 12].reshape(Kb, 3)
        vn = f[Kb * 12: Kb * 15].reshape(Kb, 3)
        bgn = f[Kb * 15: Kb * 18].reshape(Kb, 3)
        ban = f[Kb * 18: Kb * 21].reshape(Kb, 3)
        ptsn = f[Kb * 21: Kb * 21 + Pb * 3].reshape(Pb, 3)
        inl = kernels.unpack_bits_host(buf[Kb * 21 + Pb * 3:], Ob)[: n_obs]
        if not (np.isfinite(Rn).all() and np.isfinite(tn).all() and np.isfinite(ptsn).all()):
            return
        if abort_check is not None and abort_check():
            # aborted while the solve ran: no write-back
            return
        fixed = args["fixed_pose"].cpu().numpy()
        with m.lock:
            if m.remap_epoch != snap_epoch:
                # the pools were compacted while the solve ran: stale ids
                return
            for i, k in enumerate(win):
                if i >= n_win or fixed[i] or not m.kf_valid[k]:
                    continue
                m.kf_R[k] = Rn[i]
                m.kf_t[k] = tn[i]
                m.kf_vel[k] = vn[i]
                if np.isfinite(bgn[i]).all() and np.isfinite(ban[i]).all():
                    m.kf_bias_g[k] = bgn[i]
                    m.kf_bias_a[k] = ban[i]
            keep = m.mp_valid[pts]
            m.mp_xyz[pts[keep]] = ptsn[: len(pts)][keep]
            m.touch()
            # the tracker predicts with the last keyframe's bias
            if np.isfinite(bgn[n_win - 1]).all():
                tr.imu_bias_g = bgn[n_win - 1].copy()
                tr.imu_bias_a = ban[n_win - 1].copy()
            bad = ~inl & (o_src_feat >= 0)
            if bad.any():
                m.kf_feat_mp[o_src_kf[bad], o_src_feat[bad]] = -1
        self.stats["vi_ba_runs"] = self.stats.get("vi_ba_runs", 0) + 1

    def _gather_vi_joint(self, kf_id: int, window: int):
        """The temporal window, its preintegration chain, the landmarks and
        the visual observations of the joint inertial BA, padded to the
        reference package's buckets and uploaded."""
        tr = self.inertial
        m = self.map
        kfs = [int(k) for k in m.valid_kf_ids() if k <= kf_id]
        win = kfs[-window:]
        n_win = len(win)
        if n_win < 3:
            return None
        Kb = self._bucket(n_win, [5, 10, 15, 25, 50, 100, 200, 400])
        if Kb is None:
            win = win[-400:]
            n_win = len(win)
            Kb = 400
        # the preintegration chain (pair i links win[i] → win[i+1])
        zero = imu_ops.init_state(device=self.device)
        links = [tr.kf_preints.get(k) for k in win[1:]]
        present = [p for p in links if p is not None]
        # every link's dT in one read-back
        dts = iter(torch.stack([p.dT for p in present]).cpu().numpy() if present else [])
        pre, pair_ok = [], []
        for i in range(1, n_win):
            k = win[i]
            p = links[i - 1]
            dt_kf = float(m.kf_ts[k] - m.kf_ts[win[i - 1]])
            if p is not None and abs(float(next(dts)) - dt_kf) < 0.02:
                pre.append(p)
                pair_ok.append(True)
            else:
                pre.append(zero)
                pair_ok.append(False)
        if not any(pair_ok):
            return None
        while len(pre) < Kb - 1:
            pre.append(zero)
            pair_ok.append(False)
        # the landmarks the window observes
        pts = m.local_map_points(np.asarray(win, np.int32))[: self.ba_point_cap]
        if len(pts) < 20:
            return None
        kf_idx, feat_idx = m.observations_of(pts)
        obs_mp_global = m.kf_feat_mp[kf_idx, feat_idx]
        kf_lut = np.full(m.cfg.max_keyframes, -1, np.int32)
        kf_lut[np.asarray(win)] = np.arange(n_win)
        mp_lut = np.full(m.cfg.max_map_points, -1, np.int32)
        mp_lut[pts] = np.arange(len(pts))
        sel = (kf_lut[kf_idx] >= 0) & (mp_lut[obs_mp_global] >= 0)
        o_kf = kf_lut[kf_idx[sel]]
        o_mp = mp_lut[obs_mp_global[sel]]
        o_uv = m.kf_feat_xy[kf_idx[sel], feat_idx[sel]]
        o_ur = m.kf_feat_ur[kf_idx[sel], feat_idx[sel]]
        o_is2 = m.inv_level_sigma2[m.kf_feat_octave[kf_idx[sel], feat_idx[sel]]]
        o_src_kf = kf_idx[sel]
        o_src_feat = feat_idx[sel]
        Pb = self._bucket(len(pts), [256, 512, 1024, 2048, 4096])
        Ob = self._bucket(len(o_kf), [1024, 2048, 4096, 8192, 16384, 32768])
        if Pb is None or Ob is None:
            return None

        def pad(a, n, fill=0):
            out = np.full((n,) + a.shape[1:], fill, a.dtype)
            out[: len(a)] = a
            return self._dev(out)

        R_pad = np.tile(np.eye(3, dtype=np.float32), (Kb, 1, 1))
        R_pad[:n_win] = m.kf_R[win]
        fixed = np.ones(Kb, bool)
        fixed[1:n_win] = False
        stack = {a: torch.stack([getattr(s, a) for s in pre])
                 for a in ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa")}
        args = dict(
            R0=self._dev(R_pad), t0=pad(m.kf_t[win], Kb), vels0=pad(m.kf_vel[win], Kb),
            bg0=pad(m.kf_bias_g[win], Kb), ba0=pad(m.kf_bias_a[win], Kb),
            fixed_pose=self._dev(fixed), pts0=pad(m.mp_xyz[pts], Pb),
            obs_kf=pad(o_kf.astype(np.int32), Ob), obs_mp=pad(o_mp.astype(np.int32), Ob),
            obs_uv=pad(o_uv.astype(np.float32), Ob),
            obs_ur=pad(o_ur.astype(np.float32), Ob, -1.0),
            obs_inv_sigma2=pad(o_is2.astype(np.float32), Ob, 1.0),
            obs_valid=pad(np.ones(len(o_kf), bool), Ob, False), bf=float(self.bf),
            **stack, pre_cov=torch.stack([s.C[:9, :9] for s in pre]),
            pair_valid=self._dev(np.asarray(pair_ok)),
            cam_params=self._dev(np.asarray(tr.cam_params, np.float32)))
        return np.asarray(win, np.int64), n_win, pts, o_src_kf, o_src_feat, len(o_kf), args

    # ------------------------------------------------------------------
    def global_ba(self, iters: tuple[int, int] = (4, 6), abort_check=None,
                  propagate: bool = False) -> bool:
        """Full-map BA (the reference's GlobalBundleAdjustemnt after a loop
        closure). The reference's schedule: phase 1 of ``iters[0]`` LM
        iterations with the outlier classification, then ``iters[1]``
        iterations in chunks of 2, each chunk a fresh LM start, with
        ``abort_check`` polled before phase 1 and before every chunk (an
        abort writes nothing back). The result is dropped if the pools were
        compacted meanwhile. With ``propagate=True`` keyframes and map points
        created while the BA ran are corrected through an anchor keyframe
        (the reference's spanning-tree propagation) and ``on_poses_corrected``
        receives the anchor correction. Returns True if results were
        applied."""
        with self.timer.stage("14.global_ba"):
            return self._global_ba(iters, abort_check, propagate)

    def _global_ba(self, iters, abort_check, propagate) -> bool:
        m = self.map
        with m.lock:
            kfs = [int(k) for k in m.valid_kf_ids()]
            if len(kfs) < 3:
                return False
            snap_epoch = m.remap_epoch
            snap_n_kf = m.n_kf
            old_R = m.kf_R.copy()
            old_t = m.kf_t.copy()
            pts = m.valid_mp_ids()[: self.ba_point_cap]
            kf_idx, feat_idx = m.observations_of(pts)
            obs_mp_global = m.kf_feat_mp[kf_idx, feat_idx]
            kf_lut = np.full(m.cfg.max_keyframes, -1, np.int32)
            kf_lut[np.asarray(kfs)] = np.arange(len(kfs))
            mp_lut = np.full(m.cfg.max_map_points, -1, np.int32)
            mp_lut[pts] = np.arange(len(pts))
            o_kf, o_mp, o_uv, o_ur, o_is2, o_cam, _, _ = self._gather_obs(
                kf_idx, feat_idx, obs_mp_global, kf_lut, mp_lut)
            pts_xyz = m.mp_xyz[pts].copy()

        Kb = self._bucket(len(kfs), [16, 32, 64, 96, 128, 192, 256, 384, 512])
        Pb = self._bucket(len(pts), [1024, 2048, 4096])
        Ob = self._bucket(len(o_kf), [4096, 8192, 16384, 32768, 65536])
        if Kb is None or Pb is None or Ob is None:
            return False

        def pad(a, n, fill=0):
            out = np.full((n,) + a.shape[1:], fill, a.dtype)
            out[: len(a)] = a
            return self._dev(out)

        R_pad = np.zeros((Kb, 3, 3), np.float32)
        R_pad[:] = np.eye(3)
        R_pad[: len(kfs)] = old_R[kfs]
        fixed_mask = np.zeros(len(kfs), bool)
        fixed_mask[:2] = True
        prob = ba_ops.BAProblem(
            R=self._dev(R_pad), t=pad(old_t[kfs], Kb), pts=pad(pts_xyz, Pb),
            obs_kf=pad(o_kf.astype(np.int32), Ob), obs_mp=pad(o_mp.astype(np.int32), Ob),
            obs_uv=pad(o_uv.astype(np.float32), Ob),
            obs_inv_sigma2=pad(o_is2.astype(np.float32), Ob, 1.0),
            obs_valid=pad(np.ones(len(o_kf), bool), Ob, False),
            fixed_pose=pad(fixed_mask, Kb, True),
            obs_ur=pad(o_ur.astype(np.float32), Ob, -1.0), bf=self.bf,
            **self._rig_fields(o_cam, Ob))
        if abort_check is not None and abort_check():
            return False
        # a mesh of two or more shards: the landmark-sharded solve replaces
        # both phases (one abort granule, every observation an inlier)
        res = self._try_sharded_global_ba(kfs, pts_xyz, o_kf, o_mp, o_uv, o_is2,
                                          old_R, old_t, fixed_mask, iters)
        if res is None:
            res = self._run_ba(prob, (iters[0], 0))
            prob = prob._replace(R=res.R, t=res.t, pts=res.pts,
                                 obs_valid=prob.obs_valid & res.obs_inlier)
            done = 0
            while done < iters[1]:
                if abort_check is not None and abort_check():
                    return False
                res = self._run_ba(prob, (2, 0))
                prob = prob._replace(R=res.R, t=res.t, pts=res.pts)
                done += 2
        Kn = len(kfs)
        Kb, Pb = res.R.shape[0], res.pts.shape[0]
        buf = kernels.ba_result_packer()(res.R, res.t, res.pts, res.obs_inlier).cpu().numpy()
        Rn = buf[0: Kb * 9].view(np.float32).reshape(Kb, 3, 3)[:Kn]
        tn = buf[Kb * 9: Kb * 12].view(np.float32).reshape(Kb, 3)[:Kn]
        ptsn = buf[Kb * 12: Kb * 12 + Pb * 3].view(np.float32).reshape(Pb, 3)[: len(pts)]

        with m.lock:
            if m.remap_epoch != snap_epoch:
                # pools compacted while the solve ran: the gathered ids are
                # stale, drop the result (a later GBA redoes the work)
                return False
            for i, k in enumerate(kfs):
                if not fixed_mask[i] and m.kf_valid[k]:
                    m.kf_R[k] = Rn[i]
                    m.kf_t[k] = tn[i]
            in_ba = np.zeros(m.cfg.max_map_points, bool)
            keep = m.mp_valid[pts]
            m.mp_xyz[pts[keep]] = ptsn[keep]
            m.touch()
            in_ba[pts[keep]] = True
            if propagate:
                self._propagate_gba(kfs, snap_n_kf, old_R, old_t, in_ba)
        self.stats["gba_runs"] = self.stats.get("gba_runs", 0) + 1
        return True

    def _propagate_gba(self, kfs, snap_n_kf, old_R, old_t, in_ba):
        """Keyframes created during the global BA: T_k_new = T_k_old ∘
        (T_a_old⁻¹ ∘ T_a_new) with anchor a = the spanning-tree parent when it
        was in the BA's snapshot, else the most covisible snapshot keyframe;
        map points the BA did not solve keep their position in their
        reference keyframe's camera frame. Under the map lock."""
        m = self.map
        in_snap = np.zeros(m.cfg.max_keyframes, bool)
        in_snap[np.asarray(kfs)] = True
        Ra_rel = old_R[kfs[-1]].T @ m.kf_R[kfs[-1]]
        ta_rel = old_R[kfs[-1]].T @ (m.kf_t[kfs[-1]] - old_t[kfs[-1]])
        for k in range(snap_n_kf, m.n_kf):
            old_R[k] = m.kf_R[k]
            old_t[k] = m.kf_t[k]
            if not m.kf_valid[k]:
                continue
            pa = int(m.kf_parent[k])
            if 0 <= pa < len(in_snap) and in_snap[pa] and m.kf_valid[pa]:
                a = pa
            else:
                w = m.covisibility_row(k)
                w[~in_snap[: len(w)]] = 0
                a = int(np.argmax(w)) if w.max() > 0 else kfs[-1]
            Ra_rel = old_R[a].T @ m.kf_R[a]
            ta_rel = old_R[a].T @ (m.kf_t[a] - old_t[a])
            m.kf_R[k] = (old_R[k] @ Ra_rel).astype(np.float32)
            m.kf_t[k] = (old_R[k] @ ta_rel + old_t[k]).astype(np.float32)
        all_mp = m.valid_mp_ids()
        rest = all_mp[~in_ba[all_mp]]
        if len(rest):
            ref = np.clip(m.mp_ref_kf[rest], 0, m.cfg.max_keyframes - 1)
            x_cam = np.einsum("nij,nj->ni", old_R[ref], m.mp_xyz[rest]) + old_t[ref]
            x_new = np.einsum("nij,nj->ni", m.kf_R[ref].transpose(0, 2, 1),
                              x_cam - m.kf_t[ref])
            m.mp_xyz[rest] = x_new.astype(np.float32)
            m.touch()
        if self.on_poses_corrected is not None:
            self.on_poses_corrected(Ra_rel.astype(np.float32), ta_rel.astype(np.float32))

    def _try_sharded_global_ba(self, kfs, pts_xyz, o_kf, o_mp, o_uv, o_is2,
                               old_R, old_t, fixed_mask, iters, min_kfs: int = 64):
        """The landmark-sharded full LM solve (``parallel/sharded_ba.py``) of
        a global BA, or None where the single-device path runs: a mesh of
        one shard, fewer than ``min_kfs`` keyframes, or a second camera (the
        sharded solve carries one camera's rows). The observations are
        reordered into shards, so the result reports every observation as
        an inlier and nothing is erased (the next local BA reclassifies)."""
        if self.mesh is None:
            self.mesh = sb.make_mesh(device=self.device.type)
        if len(self.mesh) < 2 or len(kfs) < min_kfs or self.rig is not None:
            return None
        n_sh = len(self.mesh)
        n_pts_pad, _, out_mp, out_valid, outs = sb.partition_by_landmark(
            o_mp.astype(np.int64), len(pts_xyz), n_sh,
            {"kf": o_kf.astype(np.int32), "uv": o_uv.astype(np.float32),
             "w": o_is2.astype(np.float32)})
        pts_pad = np.zeros((n_pts_pad, 3), np.float32)
        pts_pad[: len(pts_xyz)] = pts_xyz
        solver = sb.make_sharded_ba_solver(self.mesh, n_kf=len(kfs), cam_type=self.cam_type,
                                           iters1=iters[0], iters2=iters[1])
        dev = self.mesh[0]
        on = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        R, t, pts, _ = solver(on(old_R[kfs]), on(old_t[kfs]), on(fixed_mask), on(pts_pad),
                              on(outs["kf"]), on(out_mp), on(outs["uv"]),
                              on(outs["w"] * out_valid), on(self.K))
        self.stats["sharded_gba_runs"] = self.stats.get("sharded_gba_runs", 0) + 1
        n_obs = len(o_kf)
        return ba_ops.BAResult(R=R, t=t, pts=pts[: len(pts_xyz)],
                               obs_inlier=torch.ones(n_obs, dtype=torch.bool, device=dev),
                               chi2=torch.zeros((), device=dev),
                               n_inlier=torch.tensor(n_obs, dtype=torch.int32, device=dev))

    def _run_ba(self, prob, iters):
        """A two-phase visual BA of ``iters = (iters1, iters2)`` LM
        iterations: one ``ba_ops.local_ba`` when ``ba_chunk <= 0``, else
        ``_run_ba_chunked``."""
        chunk = int(self.ba_chunk or 0)
        if chunk <= 0:
            return ba_ops.local_ba(prob, self._K_dev, cam_type=self.cam_type,
                                   chi2_th=ba_ops.CHI2_MONO, iters1=iters[0], iters2=iters[1])
        return self._run_ba_chunked(prob, iters, chunk)

    def _run_ba_chunked(self, prob, iters, chunk):
        """The two-phase schedule as chunks of at most ``chunk`` LM
        iterations (the reference's async mapper: tracking work interleaves
        between chunks). Each chunk re-linearizes at its start and restarts
        the damping at 1e-4; the state stays on the device between chunks;
        the chi2 classification runs after each phase that iterated."""
        p = prob
        inlier = torch.ones(p.obs_kf.shape[0], dtype=torch.bool, device=p.pts.device)
        chi2 = None
        for phase_iters in iters:
            done = 0
            while done < int(phase_iters):
                n = min(chunk, int(phase_iters) - done)
                R, t, pts = ba_ops.ba_iterate(p, n, inlier, self._K_dev, self.cam_type,
                                              ba_ops.CHI2_MONO)
                p = p._replace(R=R, t=t, pts=pts)
                done += n
            if phase_iters:
                inlier, chi2 = ba_ops.classify_inliers(p, self._K_dev, self.cam_type,
                                                       ba_ops.CHI2_MONO)
        if chi2 is None:
            inlier, chi2 = ba_ops.classify_inliers(p, self._K_dev, self.cam_type,
                                                   ba_ops.CHI2_MONO)
        return ba_ops.BAResult(R=p.R, t=p.t, pts=p.pts, obs_inlier=inlier,
                               chi2=torch.sum(torch.where(inlier, chi2, 0.0)),
                               n_inlier=torch.sum(inlier, dtype=torch.int32))

    @staticmethod
    def _bucket(n: int, buckets):
        for b in buckets:
            if n <= b:
                return b
        return None
