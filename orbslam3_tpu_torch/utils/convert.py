"""State carried across from the JAX package.

``map_state_from_arrays`` builds the port's ``MapState`` from the numpy
arrays of a reference ``MapState`` (``vars(m)``), the way weight conversion
hands one model to two implementations; ``loop_closer_state_from`` does the
same for a loop closer's keyframe database and loop state; ``config_from``
converts the config dataclasses, whose field names and defaults the port
keeps; ``rig_from`` converts a two-camera fisheye rig; ``preint_state_from``
a preintegration state given as arrays and ``tracker_inertial_state_from``
a tracker's inertial state (the map's per-keyframe velocities and biases
come across with the map's arrays).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..models.map import MapConfig, MapState
from ..ops.imu import PreintState


def config_from(obj, cls):
    """Convert a reference config dataclass (``OrbConfig``, ``MapConfig``,
    ``TrackingParams``) to the port's class of the same fields."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(obj).items() if k in names})


RIG_KEYS = ("cam_r", "R_rl", "t_rl", "lap_l", "lap_r")


def rig_from(rig: dict) -> dict:
    """The port's two-camera rig (``Tracker.rig`` / ``LocalMapper.rig``) from
    a reference rig dict: the second camera's KB8 parameters, the right←left
    extrinsics and the two lapping intervals, as float32 numpy copies."""
    missing = [k for k in RIG_KEYS if k not in rig]
    if missing:
        raise KeyError(f"rig lacks {missing}")
    return {k: np.array(rig[k], np.float32, copy=True) for k in RIG_KEYS}


def map_state_from_arrays(arrays: dict, cfg) -> MapState:
    """Port ``MapState`` holding copies of a reference map's arrays and
    counters. ``arrays`` is ``vars(m)`` of the reference map (locks,
    callbacks and configs in it are ignored); ``cfg`` is a port or reference
    ``MapConfig``."""
    if not isinstance(cfg, MapConfig):
        cfg = config_from(cfg, MapConfig)
    m = MapState(cfg, map_id=int(arrays.get("map_id", 0)))
    for name, val in arrays.items():
        if isinstance(val, np.ndarray):
            setattr(m, name, val.copy())
        elif name in ("n_kf", "n_mp", "remap_epoch", "n_compactions", "n_grows",
                      "device_version"):
            setattr(m, name, int(val))
    return m


def loop_closer_state_from(src, dst):
    """Carry a reference ``LoopCloser``'s state into the port's ``dst`` as
    numpy copies: the sparse BoW rows (``bow_ids``, ``bow_w``,
    ``bow_filled``), the pending verification (its S21 as (float, (3,3),
    (3,)) arrays), the loop edges, the last loop keyframe and the RANSAC
    generator's state, so both closers go on from one database and draw the
    same samples. The port's device copy of the database is rebuilt at its
    next query. Returns ``dst``."""
    dst.bow_ids = np.array(src.bow_ids, np.int32, copy=True)
    dst.bow_w = np.array(src.bow_w, np.float32, copy=True)
    dst.bow_filled = np.array(src.bow_filled, bool, copy=True)
    if src.pending is None:
        dst.pending = None
    else:
        p = dict(src.pending)
        s, R, t = p["S21"]
        p["S21"] = (float(s), np.array(R, np.float32), np.array(t, np.float32))
        dst.pending = p
    dst.loop_edges = [(int(a), int(b)) for (a, b) in src.loop_edges]
    dst.last_loop_kf = int(src.last_loop_kf)
    dst.rng.bit_generator.state = src.rng.bit_generator.state
    dst._db_invalidate()
    return dst


INERTIAL_KEYS = ("imu_enabled", "imu_freq", "imu_noise", "imu_initialized", "imu_init_ts",
                 "viba1_done", "viba2_done", "last_scale_refine_ts", "imu_bias_g",
                 "imu_bias_a", "velocity_w", "pose_prior_H", "pose_prior_dT", "world_epoch")


def preint_state_from(src, device=None) -> PreintState:
    """The port's ``PreintState`` from a reference one (or any object or
    mapping with its twelve fields as arrays), float32 on ``device``
    (``resolve_device``: ``None`` is the card and raises without one)."""
    import torch
    from .. import resolve_device
    device = resolve_device(device)
    get = src.get if isinstance(src, dict) else (lambda k: getattr(src, k))
    return PreintState(**{k: torch.as_tensor(np.array(get(k), np.float32, copy=True),
                                             device=device)
                          for k in PreintState._fields})


def tracker_inertial_state_from(src, dst, device=None):
    """Carry a reference ``Tracker``'s inertial state into the port's ``dst``:
    the IMU settings and staging flags, the biases, the world velocity, the
    carried marginal prior, the keyframe preintegrations (``kf_preints``),
    the running blocks (``preint_since_kf``, ``frame_preint``) and the IMU
    queue, as copies, the tensors on ``device`` (``None``: ``dst``'s device,
    or the card through ``resolve_device`` when ``dst`` has none). Returns
    ``dst``."""
    from .. import resolve_device
    device = resolve_device(getattr(dst, "device", None) if device is None else device)
    for k in INERTIAL_KEYS:
        v = getattr(src, k, None)
        setattr(dst, k, np.array(v, np.float32, copy=True) if isinstance(v, np.ndarray) else v)
    dst.kf_preints = {int(k): preint_state_from(v, device) for k, v in src.kf_preints.items()}
    for k in ("preint_since_kf", "frame_preint"):
        v = getattr(src, k, None)
        setattr(dst, k, None if v is None else preint_state_from(v, device))
    dst._frame_preint_covers = bool(getattr(src, "_frame_preint_covers", False))
    dst._frame_preint_dT = (float(np.asarray(dst.frame_preint.dT.cpu()))
                            if dst.frame_preint is not None else 0.0)
    dst.imu_queue = [(float(t), np.array(w, np.float32), np.array(a, np.float32))
                     for (t, w, a) in src.imu_queue]
    return dst
