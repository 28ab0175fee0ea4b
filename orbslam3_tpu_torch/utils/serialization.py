"""Atlas / map save & load — the SLAM checkpoint.

A copy of ``orbslam3_tpu/utils/serialization.py`` on the port's host map
(``models/map.py`` is itself a copy), so the two packages read each other's
files: one compressed npz per map (the ``_ARRAYS`` pools, the counters and
the map's configuration) plus an Atlas manifest (``atlas.json``: the current
map, the map count and the merge count). IMU fields are not saved, as in the
JAX package. The reference scaffolds SaveMap/LoadMap but never wires them.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..models.map import MapConfig, MapState

_ARRAYS = [
    "kf_valid", "kf_R", "kf_t", "kf_ts", "kf_frame_id", "kf_parent",
    "kf_feat_xy", "kf_feat_angle", "kf_feat_octave", "kf_feat_desc",
    "kf_feat_valid", "kf_feat_mp", "kf_feat_ur", "kf_feat_depth",
    "mp_valid", "mp_xyz", "mp_desc", "mp_normal", "mp_min_dist",
    "mp_max_dist", "mp_ref_kf", "mp_first_kf", "mp_visible", "mp_found",
]


def save_map(m: MapState, path: str):
    arrays = {name: getattr(m, name) for name in _ARRAYS}
    np.savez_compressed(
        path, n_kf=m.n_kf, n_mp=m.n_mp, map_id=m.map_id,
        cfg=json.dumps({
            "max_keyframes": m.cfg.max_keyframes,
            "max_map_points": m.cfg.max_map_points,
            "n_features": m.cfg.n_features,
            "n_levels": m.cfg.n_levels,
            "scale": m.cfg.scale,
        }), **arrays)


def load_map(path: str) -> MapState:
    z = np.load(path, allow_pickle=False)
    cfg = MapConfig(**json.loads(str(z["cfg"])))
    m = MapState(cfg, map_id=int(z["map_id"]))
    m.n_kf = int(z["n_kf"])
    m.n_mp = int(z["n_mp"])
    for name in _ARRAYS:
        if name in z:
            getattr(m, name)[:] = z[name]
    return m


def save_atlas(atlas, dir_path: str):
    """Reference System::SaveAtlas equivalent (never wired there; real here)."""
    os.makedirs(dir_path, exist_ok=True)
    manifest = {"current": atlas.current_idx, "n_maps": len(atlas.maps),
                "merges": atlas.merges}
    for i, m in enumerate(atlas.maps):
        save_map(m, os.path.join(dir_path, f"map_{i}.npz"))
    with open(os.path.join(dir_path, "atlas.json"), "w") as f:
        json.dump(manifest, f)


def load_atlas(dir_path: str, cfg: MapConfig):
    from ..models.atlas import Atlas
    with open(os.path.join(dir_path, "atlas.json")) as f:
        manifest = json.load(f)
    atlas = Atlas(cfg)
    atlas.maps = [load_map(os.path.join(dir_path, f"map_{i}.npz"))
                  for i in range(manifest["n_maps"])]
    atlas.current_idx = manifest["current"]
    atlas.merges = manifest.get("merges", 0)
    return atlas
