"""Map and Atlas save/load (``orbslam3_tpu_torch/utils/serialization.py``)
against the JAX package's, both ways, on the CPU: a map and a two-map Atlas
(merge count included) that the JAX package saves load in the port, and the
port's files load in the JAX package, every array bit-equal to the source
and to the other package's load; plus tests/test_serialization.py's
stage-timer case on the port's ``StageTimer``. Tolerance: none."""
import numpy as np
import pytest

from test_serialization import _toy_map
from orbslam3_tpu.models.atlas import Atlas as JAtlas
from orbslam3_tpu.models.map import MapConfig as JMapConfig
from orbslam3_tpu.utils import serialization as jser
from orbslam3_tpu_torch.models.atlas import Atlas as TAtlas
from orbslam3_tpu_torch.models.map import MapConfig as TMapConfig
from orbslam3_tpu_torch.utils import serialization as tser
from orbslam3_tpu_torch.utils.convert import map_state_from_arrays
from orbslam3_tpu_torch.utils.timing import StageTimer

CFG = dict(max_keyframes=16, max_map_points=256, n_features=64)
COUNTERS = ("n_kf", "n_mp", "map_id")


def _arrays(m) -> dict:
    return {k: v for k, v in vars(m).items() if isinstance(v, np.ndarray)}


def _assert_same_map(a, b, names=None):
    """Every array of ``a`` bit-equal (dtype and shape included) to ``b``'s,
    the counters and the configuration equal."""
    for k in COUNTERS:
        assert getattr(a, k) == getattr(b, k), k
    for f in ("max_keyframes", "max_map_points", "n_features", "n_levels", "scale"):
        assert getattr(a.cfg, f) == getattr(b.cfg, f), f
    aa, bb = _arrays(a), _arrays(b)
    for k in (names or sorted(aa)):
        assert aa[k].dtype == bb[k].dtype and aa[k].shape == bb[k].shape, k
        assert np.array_equal(aa[k], bb[k]), k


def _port_map(jmap):
    """The port's MapState holding a copy of a JAX-package map."""
    arrays = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in vars(jmap).items()
              if isinstance(v, (np.ndarray, int))}
    return map_state_from_arrays(arrays, jmap.cfg)


def test_the_array_list_is_the_jax_packages():
    assert tser._ARRAYS == jser._ARRAYS


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_map_loads_bit_equal_in_both_packages(tmp_path, writer):
    jm = _toy_map(0)
    path = str(tmp_path / "map.npz")
    (jser.save_map(jm, path) if writer == "jax" else tser.save_map(_port_map(jm), path))
    tj, tt = jser.load_map(path), tser.load_map(path)
    _assert_same_map(tt, tj)                       # the two loads: every array
    _assert_same_map(tt, jm, names=jser._ARRAYS)   # the saved pools: as the source
    assert np.array_equal(tt.covisibility_row(0), jm.covisibility_row(0))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_atlas_loads_bit_equal_in_both_packages(tmp_path, writer):
    jatlas = JAtlas(JMapConfig(**CFG))
    jatlas.maps[0] = _toy_map(1)
    jatlas.create_new_map()
    jatlas.maps[1] = _toy_map(2)
    jatlas.maps[1].map_id = 1
    jatlas.current_idx = 1
    jatlas.merges = 3
    d = str(tmp_path / "atlas")
    if writer == "jax":
        jser.save_atlas(jatlas, d)
    else:
        tatlas = TAtlas(TMapConfig(**CFG))
        tatlas.maps = [_port_map(m) for m in jatlas.maps]
        tatlas.current_idx, tatlas.merges = jatlas.current_idx, jatlas.merges
        tser.save_atlas(tatlas, d)
    aj, at = jser.load_atlas(d, JMapConfig(**CFG)), tser.load_atlas(d, TMapConfig(**CFG))
    assert (len(at.maps), at.current_idx, at.merges) == (2, 1, 3)
    assert (len(aj.maps), aj.current_idx, aj.merges) == (2, 1, 3)
    for mt, mj, src in zip(at.maps, aj.maps, jatlas.maps):
        _assert_same_map(mt, mj)
        _assert_same_map(mt, src, names=jser._ARRAYS)


def test_stage_timer():
    t = StageTimer()
    with t.stage("extract"):
        pass
    t.add("ba", 0.01)
    s = t.stats()
    assert "extract" in s and s["ba"]["mean_ms"] == 10.0
