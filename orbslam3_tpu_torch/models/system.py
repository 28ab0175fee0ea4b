"""System facade: wires tracking + local mapping for the monocular rig.

Port of the monocular visual path of ``orbslam3_tpu/models/system.py``:
``SlamSystem(..., enable_loop_closing=False)`` with ``track_monocular``,
trajectory export and stats. ``mapping_mode="sync"`` runs the mapper inline
per keyframe (deterministic); ``"async"`` hands keyframes to the mapper
thread of ``models/async_runtime.py``, and ``TrackingParams(pipeline=True)``
adds the tracker's software pipeline. Everything that reads tracker state
from outside (``state``, ``stats``, the trajectory export, ``shutdown``)
first flushes the pipeline.

Every tensor lives on ``device``; ``device=None`` is the CUDA card, and there
is no fallback to the CPU. Options this port does not have yet (loop closing,
stereo/RGB-D, KB8 end to end, the viewer) raise ``NotImplementedError`` naming
the ROADMAP item.
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
from .map import MapConfig, MapState
from .tracking import Tracker, TrackingParams, TrackState
from ..utils.timing import StageTimer


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to orbslam3_tpu_torch yet "
                              f"(ROADMAP.md, Queue 1: {item})")


class SlamSystem:
    def __init__(self, K, D, wh, n_features: int = 1024,
                 tracking_params: TrackingParams | None = None,
                 map_cfg: MapConfig | None = None, seed: int = 0,
                 bf: float = 0.0, th_depth: float = 0.0,
                 enable_loop_closing: bool = True, cam_type: int = 0,
                 mapping_mode: str = "sync",
                 kf_cull_redundancy: float = 0.9,
                 use_viewer: bool = False, device=None):
        if enable_loop_closing:
            _not_ported("loop closing", "loop closing, vocabulary, Sim3 and merge")
        if mapping_mode not in ("sync", "async"):
            raise ValueError(f"mapping_mode must be 'sync' or 'async', got {mapping_mode!r}")
        if bf or th_depth:
            _not_ported("stereo / RGB-D", "stereo, RGB-D and KB8 end to end")
        if cam_type != 0:
            _not_ported("the KB8 camera end to end", "stereo, RGB-D and KB8 end to end")
        if use_viewer:
            _not_ported("the viewer", "map save and load, the viewer, the example drivers")
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
        self._kf_cull_redundancy = float(kf_cull_redundancy)
        self.cam_type = 0
        self.tracker = Tracker(K, D, wh, self.orb_cfg, self.atlas.current,
                               params=tracking_params, seed=seed, device=self.device)
        # async runtime: the mapper thread and its keyframe queue
        self.runtime = None
        if mapping_mode == "async":
            self.runtime = AsyncRuntime(self)
            self.tracker.mapper_accepting = self.runtime.accepting
        self._bind_map(self.atlas.current)
        self.tracker.on_tracking_lost = self._on_tracking_lost
        self.frame_times: list[float] = []
        self.frame_spans: list[tuple] = []   # (t0, t1) perf_counter, per frame

    @property
    def map(self) -> MapState:
        return self.atlas.current

    def _bind_map(self, m):
        """(Re)bind mapper and tracker to the active atlas map."""
        self.tracker.map = m
        self.tracker.timer = self.timer
        prev_stats = self.mapper.stats if getattr(self, "mapper", None) is not None else None
        self.mapper = LocalMapper(m, self._K, self.orb_cfg, wh=self._wh, device=self.device)
        if prev_stats is not None:
            self.mapper.stats.update(prev_stats)   # counters are system-lifetime
        self.mapper.timer = self.timer
        self.mapper.kf_cull_redundancy = self._kf_cull_redundancy
        self.mapper.tracker = self.tracker
        if self.runtime is not None:
            m.on_remap["runtime"] = (
                lambda kf_remap, mp_remap, _m=m: self.runtime.on_map_remap(_m, kf_remap))

        def on_kf(kf_id, initial=False):
            if self.runtime is not None and not initial:
                # async: hand the keyframe to the mapper thread
                self.runtime.insert_keyframe(kf_id, initial)
                return
            # sync, or the bootstrap BA, which tracking needs at once; the
            # mapper may compact the pools and remap the id
            self.mapper.process_keyframe(kf_id, initial=initial)

        self.tracker.on_new_keyframe = on_kf

    def _on_tracking_lost(self):
        """Sustained loss: store the map in the Atlas and start a new one, or
        wipe it when it is too young to keep (reference CreateMapInAtlas).
        Merging a stored map back waits for the loop closer."""
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

    def track_monocular(self, img: np.ndarray, ts: float) -> dict:
        t0 = time.perf_counter()
        info = self.tracker.process_frame(img, ts)
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

    def save_trajectory_tum(self, path: str):
        """TUM format: ts tx ty tz qx qy qz qw."""
        from ..ops import lie
        ts, R_wc, t_wc, _ = self.export_trajectory()
        q = lie.quat_from_mat(torch.as_tensor(np.asarray(R_wc, np.float32))).numpy()
        with open(path, "w") as f:
            for i in range(len(ts)):
                f.write(f"{ts[i]:.6f} " + " ".join(f"{v:.7f}" for v in t_wc[i])
                        + " " + " ".join(f"{v:.7f}" for v in q[i]) + "\n")

    def stats(self) -> dict:
        self.tracker.flush_pending()
        ft = np.array(self.frame_times) if self.frame_times else np.zeros(1)
        return {
            "n_frames": len(self.frame_times),
            "n_keyframes": int(self.map.kf_valid.sum()),
            "n_map_points": int(self.map.mp_valid.sum()),
            "mean_frame_ms": float(ft.mean() * 1e3),
            "median_frame_ms": float(np.median(ft) * 1e3),
            "fps": float(1.0 / max(ft.mean(), 1e-9)),
            **self.mapper.stats,
            "stage_times": self.timer.stats(),
        }
