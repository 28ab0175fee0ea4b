"""Map data model: fixed-capacity structure-of-arrays pools with validity masks.

Replaces the reference's pointer-graph map (KeyFrame/MapPoint objects with
mutex-guarded mutable links — reference include/KeyFrame.h, include/MapPoint.h,
include/Map.h) with flat arrays sized at construction:

- KeyFrame pool: poses, per-feature SoA (the reference's ``Frame`` feature set,
  include/Frame.h), and the feature→map-point assignment ``kf_feat_mp`` which
  *is* the observation store (the reference's ``mvpMapPoints`` per KeyFrame and
  ``MapPoint::mObservations`` are the same relation stored twice; we store it
  once and derive both views).
- MapPoint pool: positions, distinctive descriptors, viewing normals, scale
  ranges, found/visible counters (reference include/MapPoint.h:63-95).
- Covisibility (reference KeyFrame::UpdateConnections src/KeyFrame.cc:471-523)
  is not an explicitly maintained edge list: it is *derived* from
  ``kf_feat_mp`` on demand — host numpy for small queries, or an incidence
  matmul on the MXU for bulk queries. No mutexes: the SLAM driver mutates the
  pools single-threaded on host; device kernels see read-only snapshots.

Capacities are framework config; slots are append-only with validity masks.
Culling clears masks; freed slots are reclaimed by **compaction** (``compact``:
an order-preserving remap of both pools announced to registered consumers via
``on_remap`` callbacks) and the pools **grow** when compaction cannot free
enough — so, like the reference (whose SetBadFlag/culling actually frees
memory, reference src/KeyFrame.cc:746, src/LocalMapping.cc:430), the map
survives unbounded-length sequences in bounded memory.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace as dc_replace

import numpy as np


from contextlib import contextmanager


@contextmanager
def locked_current(holder):
    """Acquire the CURRENT map's lock of an object whose ``.map`` attribute may
    be rebound by another thread (Atlas merge / new-map spawn). Re-checks the
    binding after acquisition so the held lock always matches ``holder.map``
    (the async analogue of the reference's per-map mMutexMapUpdate use).

    Lock-wait time is recorded to the attribution timeline when one is active
    (tracker-blocked-on-mapper is a first-class latency suspect)."""
    from ..utils import timing as _timing
    t0 = time.perf_counter()
    while True:
        m = holder.map
        m.lock.acquire()
        if m is holder.map:
            tl = _timing.GLOBAL_TIMELINE
            if tl is not None:
                t1 = time.perf_counter()
                if t1 - t0 > 5e-4:
                    tl.record("lock_wait", t0, t1)
            try:
                yield m
            finally:
                m.lock.release()
            return
        m.lock.release()


@dataclass
class MapConfig:
    max_keyframes: int = 512
    max_map_points: int = 32768
    n_features: int = 1088       # per-KF feature capacity (extractor total_capacity)
    n_levels: int = 8
    scale: float = 1.2


class MapState:
    """One SLAM map (the reference's ``Map``; an Atlas holds several)."""

    def __init__(self, cfg: MapConfig, map_id: int = 0):
        self.cfg = cfg
        self.map_id = map_id
        # the map-update lock (the reference's per-map Map::mMutexMapUpdate,
        # include/Map.h:111): in async mode the tracker holds it through the
        # Track() core, the mapper during gather/write-back, the loop closer
        # during corrections. Reentrant so sync mode nests freely.
        self.lock = threading.RLock()
        K, N, P = cfg.max_keyframes, cfg.n_features, cfg.max_map_points

        # --- keyframe pool ---
        self.kf_valid = np.zeros(K, bool)
        self.kf_R = np.zeros((K, 3, 3), np.float32)      # world→cam
        self.kf_t = np.zeros((K, 3), np.float32)
        self.kf_ts = np.zeros(K, np.float64)
        self.kf_frame_id = np.zeros(K, np.int64)         # source frame index
        self.kf_feat_xy = np.zeros((K, N, 2), np.float32)   # undistorted, level-0 px
        self.kf_feat_angle = np.zeros((K, N), np.float32)
        self.kf_feat_octave = np.zeros((K, N), np.int32)
        self.kf_feat_desc = np.zeros((K, N, 8), np.uint32)
        self.kf_feat_valid = np.zeros((K, N), bool)
        self.kf_feat_mp = np.full((K, N), -1, np.int32)  # map-point id or -1
        # stereo (right x-coordinate, <0 ⇒ mono observation) and depth
        self.kf_feat_ur = np.full((K, N), -1.0, np.float32)
        self.kf_feat_depth = np.full((K, N), -1.0, np.float32)
        # two-camera (fisheye) rigs: right-eye pixel of the stereo match
        # (<0 ⇒ none; reference keeps full right-eye keypoint sets — here the
        # right observation of each matched left feature, enough for the
        # ToBody BA residuals that anchor metric scale)
        self.kf_feat_uvr = np.full((K, N, 2), -1.0, np.float32)
        # inertial per-KF state (reference KeyFrame::mVw / bias accessors,
        # include/KeyFrame.h:191-226); written once IMU-initialized
        self.kf_vel = np.zeros((K, 3), np.float32)
        self.kf_bias_g = np.zeros((K, 3), np.float32)
        self.kf_bias_a = np.zeros((K, 3), np.float32)
        # spanning tree (reference KeyFrame::mpParent, include/KeyFrame.h:
        # 626-676): parent = most-covisible earlier keyframe, assigned by the
        # mapper after the first covisibility update; -1 = root. Used for
        # essential-graph skeleton edges, GBA correction propagation and
        # trajectory re-anchoring past culled keyframes.
        self.kf_parent = np.full(K, -1, np.int32)
        self.n_kf = 0

        # --- map-point pool ---
        self.mp_valid = np.zeros(P, bool)
        self.mp_xyz = np.zeros((P, 3), np.float32)
        self.mp_desc = np.zeros((P, 8), np.uint32)
        self.mp_normal = np.zeros((P, 3), np.float32)
        self.mp_min_dist = np.zeros(P, np.float32)
        self.mp_max_dist = np.zeros(P, np.float32)
        self.mp_ref_kf = np.full(P, -1, np.int32)
        self.mp_first_kf = np.full(P, -1, np.int32)
        self.mp_visible = np.zeros(P, np.int32)
        self.mp_found = np.zeros(P, np.int32)
        # forwarding pointer set by fuse replacement (reference
        # MapPoint::Replace stores mpReplaced, src/MapPoint.cc:254):
        # live frames resolve fused-away ids to their successors instead of
        # silently losing them (Tracking::CheckReplacedInLastFrame)
        self.mp_replaced = np.full(P, -1, np.int32)
        self.n_mp = 0

        # compaction/growth protocol: consumers holding kf/mp ids register a
        # callback under a stable key (tracker, mapper, loop closer, runtime);
        # compact() calls each with (kf_remap, mp_remap) LUTs (old id → new id,
        # -1 = slot was culled) AFTER the pools have been rewritten, all under
        # the map lock. ``remap_epoch`` lets cross-thread consumers detect a
        # remap between their lock windows and drop stale-id work.
        self.on_remap: dict[str, object] = {}
        self.remap_epoch = 0
        self.n_compactions = 0
        self.n_grows = 0
        # device-mirror invalidation counter (models/device_map.py): bumped by
        # every mutation of mirrored per-point state (xyz/desc/normal/scale
        # range/validity). Mutators in this class call touch(); external
        # writers (BA write-back, loop corrections, gravity rescale) must too.
        self.device_version = 0

        # scale pyramid constants
        s = np.array([cfg.scale ** i for i in range(cfg.n_levels)], np.float32)
        self.level_sigma2 = s * s
        self.inv_level_sigma2 = 1.0 / (s * s)
        self.scale_factors = s

    def touch(self):
        """Invalidate device mirrors (call after mutating mirrored state)."""
        self.device_version += 1

    _KF_ARRAYS = ("kf_valid", "kf_R", "kf_t", "kf_ts", "kf_frame_id",
                  "kf_feat_xy", "kf_feat_angle", "kf_feat_octave",
                  "kf_feat_desc", "kf_feat_valid", "kf_feat_mp", "kf_feat_ur",
                  "kf_feat_depth", "kf_feat_uvr", "kf_vel", "kf_bias_g",
                  "kf_bias_a", "kf_parent")
    _MP_ARRAYS = ("mp_valid", "mp_xyz", "mp_desc", "mp_normal", "mp_min_dist",
                  "mp_max_dist", "mp_ref_kf", "mp_first_kf", "mp_visible",
                  "mp_found", "mp_replaced")

    # ------------------------------------------------------------------
    # pool lifecycle: compaction + growth (bounded-memory long runs)
    # ------------------------------------------------------------------
    def compact(self):
        """Reclaim culled slots: rewrite both pools in creation order (so every
        ordering invariant — temporal KF order, recency-by-id — survives),
        remap all internal id references, and notify registered consumers.
        MUST be called under ``self.lock`` and only from the thread that owns
        map mutation for in-flight ids (the mapper); cross-thread consumers
        detect the remap via ``remap_epoch``. Returns (kf_remap, mp_remap)."""
        K_cap, P_cap = self.cfg.max_keyframes, self.cfg.max_map_points
        old_n_kf, old_n_mp = self.n_kf, self.n_mp
        kf_keep = np.nonzero(self.kf_valid[:old_n_kf])[0]
        mp_keep = np.nonzero(self.mp_valid[:old_n_mp])[0]
        kf_remap = np.full(K_cap, -1, np.int32)
        kf_remap[kf_keep] = np.arange(len(kf_keep), dtype=np.int32)
        mp_remap = np.full(P_cap, -1, np.int32)
        mp_remap[mp_keep] = np.arange(len(mp_keep), dtype=np.int32)
        nk, npt = len(kf_keep), len(mp_keep)

        for name in self._KF_ARRAYS:
            a = getattr(self, name)
            a[:nk] = a[kf_keep]
        self.kf_valid[nk:old_n_kf] = False
        self.kf_feat_mp[nk:old_n_kf] = -1
        self.kf_feat_valid[nk:old_n_kf] = False
        for name in self._MP_ARRAYS:
            a = getattr(self, name)
            a[:npt] = a[mp_keep]
        self.mp_valid[npt:old_n_mp] = False
        self.mp_replaced[npt:old_n_mp] = -1   # slots will be re-issued
        self.n_kf, self.n_mp = nk, npt

        # remap value references: feature→point assignments (mp ids) ...
        fm = self.kf_feat_mp[:nk]
        pos = fm >= 0
        fm[pos] = mp_remap[fm[pos]]
        # ... and point→keyframe anchors (kf ids); a dangling anchor (its KF
        # culled after remove_keyframe reassignment raced nothing — defensive)
        # re-anchors to the nearest surviving KF by original id order
        for name in ("mp_ref_kf", "mp_first_kf"):
            a = getattr(self, name)[:npt]
            ok = a >= 0
            new = np.where(ok, kf_remap[np.clip(a, 0, K_cap - 1)], -1)
            dang = ok & (new < 0)
            if dang.any() and nk:
                near = np.searchsorted(kf_keep, a[dang])
                new[dang] = np.clip(near, 0, nk - 1)
            a[:] = new
        # replacement-forwarding targets are mp ids (drop if target culled)
        rep = self.mp_replaced[:npt]
        okr = rep >= 0
        rep[okr] = mp_remap[np.clip(rep[okr], 0, P_cap - 1)]
        # spanning-tree parents are kf ids too; a culled parent falls back to
        # the nearest surviving predecessor (its compacted position)
        pa = self.kf_parent[:nk]
        ok = pa >= 0
        newp = np.where(ok, kf_remap[np.clip(pa, 0, K_cap - 1)], -1)
        dang = ok & (newp < 0)
        if dang.any() and nk:
            near = np.searchsorted(kf_keep, pa[dang]) - 1
            newp[dang] = np.clip(near, -1, nk - 1)
        # no self-parenting after fallback
        newp = np.where(newp == np.arange(nk), -1, newp)
        self.kf_parent[:nk] = newp

        self.remap_epoch += 1
        self.n_compactions += 1
        self.touch()
        for cb in list(self.on_remap.values()):
            cb(kf_remap, mp_remap)
        return kf_remap, mp_remap

    def grow(self, grow_kf: bool = True, grow_mp: bool = True):
        """Double pool capacities (id-preserving). The backstop when culling +
        compaction cannot keep up; keeps long runs alive at the cost of larger
        host arrays (device kernels bucket independently, so no recompiles)."""
        K_cap, P_cap = self.cfg.max_keyframes, self.cfg.max_map_points
        newK = K_cap * 2 if grow_kf else K_cap
        newP = P_cap * 2 if grow_mp else P_cap
        if grow_kf:
            for name in self._KF_ARRAYS:
                a = getattr(self, name)
                fill = (-1 if name in ("kf_feat_mp", "kf_parent")
                        else (-1.0 if name in ("kf_feat_ur", "kf_feat_depth",
                                               "kf_feat_uvr") else 0))
                b = np.full((newK,) + a.shape[1:], fill, a.dtype)
                b[:K_cap] = a
                setattr(self, name, b)
        if grow_mp:
            for name in self._MP_ARRAYS:
                a = getattr(self, name)
                fill = (-1 if name in ("mp_ref_kf", "mp_first_kf",
                                       "mp_replaced") else 0)
                b = np.full((newP,) + a.shape[1:], fill, a.dtype)
                b[:P_cap] = a
                setattr(self, name, b)
        self.cfg = dc_replace(self.cfg, max_keyframes=newK, max_map_points=newP)
        self.n_grows += 1
        self.touch()
        # growth preserves ids; announce with identity LUTs so capacity-sized
        # consumer state (e.g. the BoW database) resizes
        kf_id = np.arange(newK, dtype=np.int32)
        mp_id = np.arange(newP, dtype=np.int32)
        self.remap_epoch += 1
        for cb in list(self.on_remap.values()):
            cb(kf_id, mp_id)

    def maybe_compact(self, kf_id: int = -1, frac: float = 0.85) -> int:
        """Compact when either pool is nearly full; grow if compaction left it
        still nearly full (culling not keeping up). Under ``self.lock``; call
        from the mapper with its in-flight keyframe id — the remapped id is
        returned."""
        need_kf = self.n_kf > frac * self.cfg.max_keyframes
        need_mp = self.n_mp > frac * self.cfg.max_map_points
        if not (need_kf or need_mp):
            return kf_id
        kf_remap, _ = self.compact()
        if kf_id >= 0:
            kf_id = int(kf_remap[kf_id])
        if (self.n_kf > frac * self.cfg.max_keyframes
                or self.n_mp > frac * self.cfg.max_map_points):
            self.grow(grow_kf=self.n_kf > frac * self.cfg.max_keyframes,
                      grow_mp=self.n_mp > frac * self.cfg.max_map_points)
        return kf_id

    # ------------------------------------------------------------------
    # keyframes
    # ------------------------------------------------------------------
    def add_keyframe(self, R, t, ts, frame_id, xy, angle, octave, desc, fvalid,
                     feat_mp=None, ur=None, depth=None, uvr=None) -> int:
        if self.n_kf >= self.cfg.max_keyframes:
            # id-preserving growth (compaction is the mapper's job; growing
            # here keeps the tracker's add path safe from any thread)
            self.grow(grow_kf=True, grow_mp=False)
        k = self.n_kf
        self.kf_valid[k] = True
        self.kf_R[k] = R
        self.kf_t[k] = t
        self.kf_ts[k] = ts
        self.kf_frame_id[k] = frame_id
        n = xy.shape[0]
        self.kf_feat_xy[k, :n] = xy
        self.kf_feat_angle[k, :n] = angle
        self.kf_feat_octave[k, :n] = octave
        self.kf_feat_desc[k, :n] = desc
        self.kf_feat_valid[k, :n] = fvalid
        if feat_mp is not None:
            self.kf_feat_mp[k, :n] = feat_mp
        if ur is not None:
            self.kf_feat_ur[k, :n] = ur
        if depth is not None:
            self.kf_feat_depth[k, :n] = depth
        if uvr is not None:
            self.kf_feat_uvr[k, :n] = uvr
        self.n_kf += 1
        return k

    def remove_keyframe(self, k: int):
        """Cull a keyframe (reference KeyFrame::SetBadFlag src/KeyFrame.cc:746):
        detach its observations and re-parent its spanning-tree children
        (reference :758-888 picks the best covisible parent candidate; here
        children inherit the culled node's parent — the grandparent — which
        preserves connectivity and temporal ordering)."""
        self.kf_valid[k] = False
        children = np.nonzero(self.kf_parent[: self.n_kf] == k)[0]
        gp = int(self.kf_parent[k])
        for c in children:
            self.kf_parent[c] = gp if gp != c else -1
        self.kf_parent[k] = -1
        mps = self.kf_feat_mp[k]
        obs = mps[mps >= 0]
        self.kf_feat_mp[k] = -1
        # points anchored to the culled KF re-anchor to the nearest surviving
        # KF (reference reassigns mpRefKF to the first remaining observer)
        dang = np.nonzero(self.mp_valid[: self.n_mp]
                          & (self.mp_ref_kf[: self.n_mp] == k))[0]
        if len(dang):
            valid = self.valid_kf_ids()
            if len(valid):
                near = int(valid[np.argmin(np.abs(
                    self.kf_ts[valid] - self.kf_ts[k]))])
                self.mp_ref_kf[dang] = near
        # refresh descriptors/normals of affected points
        if len(obs):
            self.refresh_map_points(np.unique(obs))

    # ------------------------------------------------------------------
    # map points
    # ------------------------------------------------------------------
    def add_map_points(self, xyz, desc, ref_kf: int, normals, min_dist, max_dist,
                       first_kf: int | None = None) -> np.ndarray:
        m = xyz.shape[0]
        while self.n_mp + m > self.cfg.max_map_points:
            self.grow(grow_kf=False, grow_mp=True)
        p0 = self.n_mp
        ids = np.arange(p0, p0 + m, dtype=np.int32)
        self.mp_valid[ids] = True
        self.mp_xyz[ids] = xyz
        self.mp_desc[ids] = desc
        self.mp_normal[ids] = normals
        self.mp_min_dist[ids] = min_dist
        self.mp_max_dist[ids] = max_dist
        self.mp_ref_kf[ids] = ref_kf
        self.mp_first_kf[ids] = ref_kf if first_kf is None else first_kf
        self.n_mp = p0 + m
        self.touch()
        return ids

    def remove_map_points(self, ids: np.ndarray):
        """Cull points: invalidate + detach all observations (reference
        MapPoint::SetBadFlag)."""
        if len(ids) == 0:
            return
        self.mp_valid[ids] = False
        sel = np.isin(self.kf_feat_mp[: self.n_kf], ids)
        self.kf_feat_mp[: self.n_kf][sel] = -1
        self.touch()

    def replace_map_points(self, old_ids: np.ndarray, new_ids: np.ndarray):
        """Fuse: redirect observations of old→new with per-KF de-duplication
        (reference MapPoint::Replace). Native C++ kernel (..native)."""
        if len(old_ids) == 0:
            return
        from .. import native
        lut = np.arange(self.cfg.max_map_points, dtype=np.int32)
        lut[old_ids] = new_ids
        self.mp_valid[old_ids] = False
        self.mp_replaced[old_ids] = new_ids
        native.replace_points(self.kf_feat_mp[: self.n_kf], lut,
                              self.cfg.max_map_points)
        self.touch()

    # ------------------------------------------------------------------
    # derived relations
    # ------------------------------------------------------------------
    def observations_of(self, mp_ids: np.ndarray):
        """(kf_idx, feat_idx) arrays of observations of the given points.
        Native C++ kernel (..native)."""
        from .. import native
        return native.observations_of(
            self.kf_feat_mp[: self.n_kf], self.kf_valid[: self.n_kf],
            np.asarray(mp_ids, np.int64), self.cfg.max_map_points)

    def obs_count(self, mp_ids: np.ndarray | None = None) -> np.ndarray:
        """Number of (valid-KF) observations per map point."""
        from .. import native
        cnt = native.obs_counts(self.kf_feat_mp[: self.n_kf],
                                self.kf_valid[: self.n_kf],
                                self.cfg.max_map_points)
        return cnt if mp_ids is None else cnt[mp_ids]

    def covisibility_row(self, kf_id: int) -> np.ndarray:
        """Shared-map-point counts between kf_id and every other KF (the
        reference's covisibility weights, threshold 15 at src/KeyFrame.cc:524).
        Native C++ kernel (..native)."""
        from .. import native
        return native.covisibility_row(
            self.kf_feat_mp[: self.n_kf], self.kf_valid[: self.n_kf],
            int(kf_id), self.cfg.max_map_points)

    def best_covisible(self, kf_id: int, n: int, min_weight: int = 15) -> np.ndarray:
        w = self.covisibility_row(kf_id)
        order = np.argsort(-w)
        order = order[w[order] >= min_weight]
        return order[:n].astype(np.int32)

    def local_map_points(self, kf_ids: np.ndarray) -> np.ndarray:
        """Union of map points observed by the given KFs."""
        fm = self.kf_feat_mp[kf_ids]
        mps = np.unique(fm[fm >= 0])
        return mps[self.mp_valid[mps]].astype(np.int32)

    def refresh_map_points(self, mp_ids: np.ndarray):
        """Recompute distinctive descriptor, normal and scale-invariance range
        (reference MapPoint::ComputeDistinctiveDescriptors + UpdateNormalAndDepth).
        Native C++ kernel (..native.refresh_points) — this is the
        mapper's host-hot path; numpy fallback below."""
        from .. import native
        mp_ids = np.asarray(mp_ids, np.int64)
        if len(mp_ids) == 0:
            return
        self.touch()
        alive = native.refresh_points(
            self.kf_feat_mp[: self.n_kf], self.kf_valid[: self.n_kf],
            self.kf_feat_desc[: self.n_kf], self.kf_feat_octave[: self.n_kf],
            self.kf_R[: self.n_kf], self.kf_t[: self.n_kf],
            mp_ids, self.mp_xyz, self.scale_factors,
            self.mp_desc, self.mp_normal, self.mp_min_dist, self.mp_max_dist)
        if alive is not None:
            self.mp_valid[mp_ids[~alive]] = False
            return
        kf_idx, feat_idx = self.observations_of(mp_ids)
        if len(kf_idx) == 0:
            self.mp_valid[mp_ids[self.obs_count(mp_ids) == 0]] = False
            return
        mp_of_obs = self.kf_feat_mp[kf_idx, feat_idx]
        for mp in mp_ids:
            sel = mp_of_obs == mp
            if not sel.any():
                self.mp_valid[mp] = False
                continue
            ks = kf_idx[sel]
            fs = feat_idx[sel]
            descs = self.kf_feat_desc[ks, fs]
            # min-median Hamming distance descriptor
            x = descs[:, None, :] ^ descs[None, :, :]
            d = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)  # (k,k) Hamming
            best = np.argmin(np.median(d, axis=1))
            self.mp_desc[mp] = descs[best]
            # normal = mean of viewing directions; scale range from ref obs.
            # center c = -R^T t (this fallback shipped round 1 computing -R t —
            # wrong normals/scale ranges; caught by the native-parity probe)
            centers = -np.einsum("kji,kj->ki", self.kf_R[ks], self.kf_t[ks])
            dirs = self.mp_xyz[mp] - centers
            nrm = np.linalg.norm(dirs, axis=1, keepdims=True)
            dirs = dirs / np.maximum(nrm, 1e-9)
            self.mp_normal[mp] = dirs.mean(0) / max(np.linalg.norm(dirs.mean(0)), 1e-9)
            ref = len(ks) - 1
            dist = float(nrm[ref, 0])
            lvl = int(self.kf_feat_octave[ks[ref], fs[ref]])
            sf = float(self.scale_factors[lvl])
            self.mp_max_dist[mp] = dist * sf
            self.mp_min_dist[mp] = dist * sf / float(self.scale_factors[-1])

    # convenience
    def valid_kf_ids(self) -> np.ndarray:
        return np.nonzero(self.kf_valid[: self.n_kf])[0].astype(np.int32)

    def valid_mp_ids(self) -> np.ndarray:
        return np.nonzero(self.mp_valid[: self.n_mp])[0].astype(np.int32)
