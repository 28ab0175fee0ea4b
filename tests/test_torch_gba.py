"""Global BA of the port (``LocalMapper.global_ba`` and the async runtime's
``BackgroundGBA``) against the JAX package's, both on the CPU, on
tests/test_gba_propagation.py's drifted corridor map (rebuilt here in numpy).

Both packages run the reference's schedule (phase 1 of ``iters[0]`` LM
iterations, then chunks of 2), so the results are held to each other:
keyframe centres within 2e-3 and map points within 5e-3 scene units (float32
Schur LM over 12 keyframes and 400 points, 10 iterations, summed in another
order). The propagation case is tests/test_gba_propagation.py's own bound.
"""
import threading

import numpy as np
import pytest

from orbslam3_tpu.models import map as jmap
from orbslam3_tpu.models.local_mapping import LocalMapper as JMapper
from orbslam3_tpu.ops import features as jfeat
from orbslam3_tpu_torch.models import map as tmap
from orbslam3_tpu_torch.models.async_runtime import BackgroundGBA
from orbslam3_tpu_torch.models.local_mapping import LocalMapper as TMapper
from orbslam3_tpu_torch.ops import ba as tba, features as tfeat
from torch_port_helpers import torch_threads  # noqa: F401

K_CAM = np.asarray([458.0, 458.0, 376.0, 240.0], np.float32)


def _project(R, t, pts):
    pc = pts @ R.T + t
    z = np.maximum(pc[:, 2], 1e-6)
    return np.stack([458 * pc[:, 0] / z + 376, 458 * pc[:, 1] / z + 240], -1), pc[:, 2] > 0.5


def drifted_line_map(mod, n_kf: int = 12, step: float = 1.2):
    """A corridor of ``n_kf`` keyframes ``step`` apart whose drift grows
    along the chain (tests/test_gba_propagation.py's fixture at its 12 and
    1.2); ``mod`` is either package's ``models.map``."""
    rng = np.random.default_rng(0)
    n_pts = 400
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(6, 14, n_pts) + rng.uniform(0, 10, n_pts)], -1)
    pts[:, 2] += np.linspace(0, 10, n_pts)
    desc = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
    m = mod.MapState(mod.MapConfig(max_keyframes=max(64, 2 * n_kf), max_map_points=4096,
                                   n_features=256))
    gt_t = []
    for k in range(n_kf):
        R = np.eye(3, dtype=np.float32)
        t_gt = np.asarray([0, 0, -step * k], np.float32)
        gt_t.append(t_gt)
        drift = np.asarray([0.4, 0.0, 0.0], np.float32) * (k / (n_kf - 1)) ** 2
        uv, ok = _project(R, t_gt, pts)
        inb = ok & (uv[:, 0] > 5) & (uv[:, 0] < 747) & (uv[:, 1] > 5) & (uv[:, 1] < 475)
        sel = np.nonzero(inb)[0][:256]
        m.add_keyframe(R, t_gt + drift, float(k), k, uv[sel].astype(np.float32),
                       np.zeros(len(sel), np.float32), np.zeros(len(sel), np.int32),
                       desc[sel], np.ones(len(sel), bool), feat_mp=sel.astype(np.int32))
    m.add_map_points(pts.astype(np.float32), desc, 0,
                     np.tile([0, 0, -1.0], (n_pts, 1)).astype(np.float32),
                     np.full(n_pts, 0.5, np.float32), np.full(n_pts, 60.0, np.float32))
    return m, np.asarray(gt_t)


def _mappers():
    mj, gt = drifted_line_map(jmap)
    mt, _ = drifted_line_map(tmap)
    jm = JMapper(mj, K_CAM, jfeat.OrbConfig(n_features=256), wh=(752, 480))
    tm = TMapper(mt, K_CAM, tfeat.OrbConfig(n_features=256), wh=(752, 480), device="cpu")
    return jm, tm, gt


def _centres(m):
    return np.stack([-m.kf_R[k].T @ m.kf_t[k] for k in range(m.n_kf)])


@pytest.mark.parametrize("iters", [(4, 6), (4, 10)])
def test_global_ba_matches_reference(iters):
    jm, tm, _ = _mappers()
    before = _centres(tm.map)
    assert jm.global_ba(iters=iters) and tm.global_ba(iters=iters)
    mj, mt = jm.map, tm.map
    np.testing.assert_allclose(_centres(mt), _centres(mj), atol=2e-3)
    np.testing.assert_allclose(mt.mp_xyz[: mt.n_mp], mj.mp_xyz[: mj.n_mp], atol=5e-3)
    np.testing.assert_array_equal(mt.kf_R[:2], mj.kf_R[:2])      # the two fixed keyframes
    assert np.abs(_centres(mt) - before).max() > 0.05              # the BA moved the chain
    assert tm.stats["gba_runs"] == jm.stats["gba_runs"] == 1
    assert "14.global_ba" in tm.timer.samples


def test_midrun_keyframes_propagate_via_covisible_anchor():
    """tests/test_gba_propagation.py on the port: a keyframe inserted while
    the BA runs (through the abort hook) lands with its covisible
    neighbour's small correction, not the far end's large one, and the
    live-frame hook receives the anchor correction."""
    _, tm, gt_t = _mappers()
    m = tm.map
    inserted, corrected = {}, []
    tm.on_poses_corrected = lambda R, t: corrected.append((R, t))
    calls = {"n": 0}

    def insert_midrun():
        calls["n"] += 1
        if calls["n"] == 2 and not inserted:
            src = 1
            inserted["id"] = m.add_keyframe(
                m.kf_R[src].copy(), m.kf_t[src].copy(), 99.0, 99, m.kf_feat_xy[src],
                m.kf_feat_angle[src], m.kf_feat_octave[src], m.kf_feat_desc[src],
                m.kf_feat_valid[src], feat_mp=m.kf_feat_mp[src].copy())
        return False

    assert tm.global_ba(iters=(6, 8), abort_check=insert_midrun, propagate=True)
    k_new = inserted["id"]
    assert np.linalg.norm(m.kf_t[k_new] - m.kf_t[1]) < 0.05
    assert np.linalg.norm(m.kf_t[11] - (gt_t[11] + [0.4, 0, 0])) > 0.2
    assert len(corrected) == 1 and np.isfinite(corrected[0][0]).all()


class _System:
    """What BackgroundGBA reads of a system: the map, mapper and tracker."""

    def __init__(self, mapper):
        self.map = mapper.map
        self.mapper = mapper
        self.tracker = object()


def test_aborted_background_gba_writes_nothing(monkeypatch):
    """Abort after the first LM phase: the run returns without touching the
    map, counts no run and no error."""
    _, tm, _ = _mappers()
    m = tm.map
    snap = {k: getattr(m, k).copy() for k in ("kf_R", "kf_t", "mp_xyz", "kf_feat_mp")}
    gba = BackgroundGBA(_System(tm))
    real = tba.local_ba
    first_done = threading.Event()

    def local_ba_then_abort(*a, **k):
        out = real(*a, **k)
        gba.abort()
        first_done.set()
        return out

    monkeypatch.setattr(tba, "local_ba", local_ba_then_abort)
    gba.start()
    gba.join(120.0)
    assert first_done.is_set() and not gba.running and gba.applied is False
    for k, v in snap.items():
        np.testing.assert_array_equal(getattr(m, k), v)
    assert tm.stats.get("gba_runs", 0) == 0 and tm.stats.get("gba_errors", 0) == 0


def test_background_gba_applies_and_counts_errors():
    """A run that is not aborted applies its result; one that raises is
    counted in ``gba_errors`` with its repr, and the thread ends."""
    _, tm, _ = _mappers()
    before = _centres(tm.map)
    gba = BackgroundGBA(_System(tm))
    gba.start()
    gba.join(120.0)
    assert gba.applied is True and tm.stats["gba_runs"] == 1
    assert np.abs(_centres(tm.map) - before).max() > 0.05

    class _Broken(_System):
        pass

    broken = _Broken(tm)
    broken.mapper = type("M", (), {"stats": {}, "global_ba": lambda *a, **k: 1 / 0})()
    gba = BackgroundGBA(broken)
    gba.start()
    gba.join(30.0)
    assert not gba.running and gba.applied is False
    assert broken.mapper.stats["gba_errors"] == 1
    assert "ZeroDivisionError" in broken.mapper.stats["last_gba_error"]
