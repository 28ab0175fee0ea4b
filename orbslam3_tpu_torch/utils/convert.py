"""State carried across from the JAX package.

``map_state_from_arrays`` builds the port's ``MapState`` from the numpy
arrays of a reference ``MapState`` (``vars(m)``), the way weight conversion
hands one model to two implementations; ``loop_closer_state_from`` does the
same for a loop closer's keyframe database and loop state; ``config_from``
converts the config dataclasses, whose field names and defaults the port
keeps.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..models.map import MapConfig, MapState


def config_from(obj, cls):
    """Convert a reference config dataclass (``OrbConfig``, ``MapConfig``,
    ``TrackingParams``) to the port's class of the same fields."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(obj).items() if k in names})


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
