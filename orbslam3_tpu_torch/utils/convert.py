"""State carried across from the JAX package.

``map_state_from_arrays`` builds the port's ``MapState`` from the numpy
arrays of a reference ``MapState`` (``vars(m)``), the way weight conversion
hands one model to two implementations; ``config_from`` converts the config
dataclasses, whose field names and defaults the port keeps.
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
