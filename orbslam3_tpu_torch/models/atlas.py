"""Atlas: multi-map management with loss-triggered map spawning and merging.

Rebuilds the reference ``Atlas`` (reference include/Atlas.h:46-130,
src/Atlas.cc: set of Maps + current map, CreateNewMap on tracking loss
src/Tracking.cc:2914 CreateMapInAtlas) and the merge entry point (reference
LoopClosing::MergeLocal2 src/LoopClosing.cc:2210: rigid transform of the
current map into the matched old map, then element migration).

Host-side: maps are independent SoA pools; merging concatenates pools after a
rigid/Sim3 alignment obtained from cross-map relocalization.
"""
from __future__ import annotations

import numpy as np

from .map import MapConfig, MapState


class Atlas:
    def __init__(self, cfg: MapConfig):
        self.cfg = cfg
        self.maps: list[MapState] = [MapState(cfg, map_id=0)]
        self.current_idx = 0
        self.merges = 0

    @property
    def current(self) -> MapState:
        return self.maps[self.current_idx]

    def create_new_map(self) -> MapState:
        """Store the active map and open a fresh one (reference CreateMapInAtlas)."""
        m = MapState(self.cfg, map_id=len(self.maps))
        self.maps.append(m)
        self.current_idx = len(self.maps) - 1
        return m

    def stored_maps(self) -> list[MapState]:
        return [m for i, m in enumerate(self.maps)
                if i != self.current_idx and m.n_kf > 0]

    def merge_current_into(self, old_map: MapState, R_align: np.ndarray,
                           t_align: np.ndarray, s_align: float = 1.0) -> MapState:
        """Merge the current map into `old_map` after the Sim3 alignment
        world_old = s·R·world_cur + t (reference MergeLocal2: rigid map
        transform + migration of keyframes and map points). The old→new
        keyframe id mapping is left in ``self.last_merge_kf_map`` for the
        caller's welding pass (reference MergeLocal's welding BA)."""
        cur = self.current
        kf_off_ids = {}
        # weld anchor for re-parenting the migrated spanning tree: the old
        # map's newest keyframe BEFORE migration
        old_anchor = (int(old_map.valid_kf_ids()[-1])
                      if old_map.n_kf and old_map.kf_valid[: old_map.n_kf].any()
                      else -1)
        # migrate keyframes
        for k in np.nonzero(cur.kf_valid[: cur.n_kf])[0]:
            R_cw = cur.kf_R[k]
            t_cw = cur.kf_t[k]
            # x_c = R x_w + t with x_w = (R_a x_w' + t_a... invert alignment:
            # x_w_cur = R_a⁻¹ (x_w_old − t_a)/s → new pose:
            R_new = R_cw @ R_align.T
            t_new = s_align * t_cw - R_new @ t_align
            nk = old_map.add_keyframe(
                R_new.astype(np.float32), t_new.astype(np.float32),
                float(cur.kf_ts[k]), int(cur.kf_frame_id[k]),
                cur.kf_feat_xy[k], cur.kf_feat_angle[k], cur.kf_feat_octave[k],
                cur.kf_feat_desc[k], cur.kf_feat_valid[k],
                ur=cur.kf_feat_ur[k], depth=cur.kf_feat_depth[k],
                uvr=cur.kf_feat_uvr[k])
            # inertial state rides along (reference MergeLocal2 migrates the
            # full KeyFrame incl. velocity/bias and the mPrevKF chain,
            # src/LoopClosing.cc:2210-2442): world velocity rotates+scales
            # into the target world; biases are body-frame, copied as-is
            old_map.kf_vel[nk] = (s_align * cur.kf_vel[k] @ R_align.T).astype(
                np.float32)
            old_map.kf_bias_g[nk] = cur.kf_bias_g[k]
            old_map.kf_bias_a[nk] = cur.kf_bias_a[k]
            kf_off_ids[int(k)] = nk
        # spanning-tree parents migrate within the merged block; the block
        # root attaches to the old map's newest keyframe (the reference
        # re-parents the merged tree at the weld, src/LoopClosing.cc:2381)
        for k_old, k_new in kf_off_ids.items():
            pa = int(cur.kf_parent[k_old])
            old_map.kf_parent[k_new] = kf_off_ids.get(pa, old_anchor)
        # migrate map points
        mp_ids = cur.valid_mp_ids()
        if len(mp_ids):
            xyz_new = (s_align * cur.mp_xyz[mp_ids] @ R_align.T + t_align)
            ref_new = np.array([kf_off_ids.get(int(r), old_map.valid_kf_ids()[0])
                                for r in cur.mp_ref_kf[mp_ids]], np.int32)
            new_ids = old_map.add_map_points(
                xyz_new.astype(np.float32), cur.mp_desc[mp_ids],
                int(ref_new[0]),
                (cur.mp_normal[mp_ids] @ R_align.T).astype(np.float32),
                cur.mp_min_dist[mp_ids] * s_align,
                cur.mp_max_dist[mp_ids] * s_align)
            old_map.mp_ref_kf[new_ids] = ref_new
            lut = dict(zip(mp_ids.tolist(), new_ids.tolist()))
            # rewrite feature→point assignments on the migrated keyframes
            for k_old, k_new in kf_off_ids.items():
                fm = cur.kf_feat_mp[k_old]
                out = np.full_like(fm, -1)
                pos = fm >= 0
                out[pos] = [lut.get(int(v), -1) for v in fm[pos]]
                old_map.kf_feat_mp[k_new] = out
        # retire the merged map
        cur.kf_valid[:] = False
        cur.mp_valid[:] = False
        cur.touch()
        old_map.touch()
        self.current_idx = self.maps.index(old_map)
        self.merges += 1
        self.last_merge_kf_map = kf_off_ids
        return old_map
