"""Device-resident mirror of the map-point pool and the keyframe feature pool.

Port of ``orbslam3_tpu/models/device_map.py``. The host ``MapState`` stays the
source of truth; the per-point state the tracking steps read every frame is
mirrored as torch tensors on the system's device and re-uploaded only when
the map mutates (``MapState.device_version``).

Packing layout (two buffers, one upload each):
- ``mpf`` (P, 8) float32: xyz (3), normal (3), min_dist, max_dist
- ``mpu`` (P, 9) int32:   desc (8, bit patterns of the host's uint32), valid
"""
from __future__ import annotations

import weakref

import numpy as np
import torch


def _bucket(n: int, lo: int = 4096) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


class DeviceKfPool:
    """Device-resident per-keyframe feature arrays (xy, desc, octave).

    Immutable per keyframe, so each row uploads once; rows are synced lazily
    by id and pool compaction (``MapState.remap_epoch``) drops the cache. The
    buffers are updated in place (index assignment) rather than copied."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._map_ref = None
        self._epoch = -1
        self._have: set[int] = set()
        self._cap = 0
        self._n_feat = 0
        self.xy = None      # (Kc, N, 2) f32
        self.desc = None    # (Kc, N, 8) int32
        self.octave = None  # (Kc, N) int32

    def sync(self, m, kf_ids) -> tuple:
        n_feat = m.cfg.n_features
        if (self._map_ref is not m or self._epoch != m.remap_epoch
                or self._n_feat != n_feat):
            self._map_ref = m
            self._epoch = m.remap_epoch
            self._have = set()
            self._n_feat = n_feat
            self._cap = 0
        need = [int(k) for k in kf_ids if int(k) not in self._have]
        top = max([int(k) for k in kf_ids], default=-1)
        if top >= self._cap:
            cap = _bucket(top + 1, 64)
            dev = self.device
            xy = torch.zeros((cap, n_feat, 2), dtype=torch.float32, device=dev)
            desc = torch.zeros((cap, n_feat, 8), dtype=torch.int32, device=dev)
            octv = torch.zeros((cap, n_feat), dtype=torch.int32, device=dev)
            if self._cap and self._have:
                xy[: self._cap] = self.xy
                desc[: self._cap] = self.desc
                octv[: self._cap] = self.octave
            self.xy, self.desc, self.octave = xy, desc, octv
            self._cap = cap
        if need:
            idx = torch.as_tensor(need, dtype=torch.int64, device=self.device)
            self.xy[idx] = torch.as_tensor(m.kf_feat_xy[need], device=self.device)
            self.desc[idx] = torch.as_tensor(m.kf_feat_desc[need].view(np.int32),
                                             device=self.device)
            self.octave[idx] = torch.as_tensor(m.kf_feat_octave[need], device=self.device)
            self._have.update(need)
        return self.xy, self.desc, self.octave


class DeviceMapMirror:
    """Mirrors one MapState's point pool on one device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._map_ref = None
        self._ver = -1
        self._cap = 0
        self.mpf = None   # (P,8) f32
        self.mpu = None   # (P,9) int32

    def sync(self, m) -> tuple:
        """Return (mpf, mpu) for ``m``, uploading only if the map mutated
        since the last sync (or the mirror tracked another map)."""
        ver = m.device_version
        if (self._map_ref is m and ver == self._ver
                and self._cap >= m.n_mp):
            return self.mpf, self.mpu
        n = m.n_mp
        cap = self._cap if (self._map_ref is m and self._cap >= n and
                            self._cap > 0) else _bucket(max(n, 1))
        f = np.zeros((cap, 8), np.float32)
        u = np.zeros((cap, 9), np.int32)
        f[:n, 0:3] = m.mp_xyz[:n]
        f[:n, 3:6] = m.mp_normal[:n]
        f[:n, 6] = m.mp_min_dist[:n]
        f[:n, 7] = np.maximum(m.mp_max_dist[:n], 1e-6)
        u[:n, 0:8] = m.mp_desc[:n].view(np.int32)
        u[:n, 8] = m.mp_valid[:n]
        self.mpf = torch.as_tensor(f, device=self.device)
        self.mpu = torch.as_tensor(u, device=self.device)
        self._cap = cap
        self._map_ref = m
        self._ver = ver
        return self.mpf, self.mpu


# ---------------------------------------------------------------------------
# Shared per-map registries: tracker and mapper reuse ONE mirror and ONE
# keyframe pool per (MapState, device), weakly keyed by the map so retired
# maps free their device memory with the host object.
# ---------------------------------------------------------------------------
_MIRRORS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_KF_POOLS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def mirror_for(m, device) -> DeviceMapMirror:
    by_dev = _MIRRORS.setdefault(m, {})
    key = str(torch.device(device))
    if key not in by_dev:
        by_dev[key] = DeviceMapMirror(device)
    return by_dev[key]


def kf_pool_for(m, device) -> DeviceKfPool:
    by_dev = _KF_POOLS.setdefault(m, {})
    key = str(torch.device(device))
    if key not in by_dev:
        by_dev[key] = DeviceKfPool(device)
    return by_dev[key]
