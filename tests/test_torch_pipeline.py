"""The tracker's software pipeline in the port (``TrackingParams.pipeline``)
with synchronous mapping, at depth 1 and depth 2 (two frames in flight: the
search windows widen by 1.5x and a synchronous fused retry bridges a
stale-candidate miss), against the JAX package's runs of the same
configurations on the same 16 rendered frames, both on the CPU.

The pipelined tracker reads candidate sets that lag by the pipeline's depth,
so, as tests/test_pipeline.py does for the JAX package, each run is held to
quality bands: it tracks, loses nothing, and its ATE is no worse than
max(1.5 x JAX ATE, JAX ATE + 0.02) (the end-to-end bound of
tests/test_torch_e2e_mono.py); keyframes and the tracker's path counts stay
within a stated band of the JAX run's.

One equality the port can state exactly is kept beside that: with synchronous
mapping and depth 1 a pipelined frame is consumed before the next one is
dispatched, so the tracker computes exactly what the unpipelined tracker
computes, in the same order: trajectories, keyframes and map points must be
EQUAL (CPU tensors: no atomics, one summation order).
"""
import numpy as np
import pytest

from conftest import dense_tracking_params
from orbslam3_tpu.models.system import SlamSystem as JaxSlam
from orbslam3_tpu.utils.datasets import RoomScene, orbit_trajectory
from orbslam3_tpu.utils.evaluation import evaluate_trajectory, horn_align
from orbslam3_tpu_torch.models.system import SlamSystem
from orbslam3_tpu_torch.models.tracking import TrackingParams
from orbslam3_tpu_torch.utils.convert import config_from
from torch_port_helpers import render_all, torch_threads  # noqa: F401

N = 16
KF_BAND = 2        # keyframes: |port - JAX|
PATH_BAND = 3      # frames per tracking path: |port - JAX|


@pytest.fixture(scope="module")
def runs():
    """{(package, depth): record}; depth 0 is the port's unpipelined run."""
    scene = RoomScene(seed=1, n_clutter=4)
    poses = orbit_trajectory(N, radius=1.0, forward=0.0)
    imgs = render_all(scene, poses)
    gt = np.array([-R.T @ t for R, t in poses])
    out = {}
    for package, depth in (("jax", 1), ("jax", 2), ("torch", 0), ("torch", 1), ("torch", 2)):
        jparams = dense_tracking_params(pipeline=depth > 0, pipeline_depth=max(depth, 1))
        common = dict(n_features=512, seed=0, enable_loop_closing=False, mapping_mode="sync")
        if package == "jax":
            slam = JaxSlam(scene.K, None, (scene.w, scene.h), tracking_params=jparams, **common)
        else:
            slam = SlamSystem(scene.K, None, (scene.w, scene.h), device="cpu",
                              tracking_params=config_from(jparams, TrackingParams), **common)
        for i, img in enumerate(imgs):
            slam.track_monocular(img, ts=i / 20.0)
        pending = len(slam.tracker._pending)
        traj = slam.export_trajectory()                  # flushes
        ts, _, t_wc, lost = traj
        ate, n_assoc = evaluate_trajectory(np.arange(N) / 20.0, gt, ts, t_wc, with_scale=True)
        out[package, depth] = dict(
            system=slam, pending_before_read=pending, pending_after_read=len(slam.tracker._pending),
            traj=traj, state=slam.get_tracking_state().name, stats=slam.stats(),
            paths=dict(slam.tracker.path_counts), ate=float(ate), n_assoc=int(n_assoc),
            n_logged=len(ts), n_lost=int(lost.sum()))
    out["gt"] = gt
    return out


def test_depth1_sync_mapping_equals_unpipelined(runs):
    plain, piped = runs["torch", 0], runs["torch", 1]
    assert (plain["pending_before_read"], piped["pending_before_read"]) == (0, 1)
    assert piped["pending_after_read"] == 0          # the read flushed the frame in flight
    for x, y in zip(plain["traj"], piped["traj"]):
        np.testing.assert_array_equal(x, y)
    sa, sb = plain["stats"], piped["stats"]
    assert (sa["n_keyframes"], sa["n_map_points"]) == (sb["n_keyframes"], sb["n_map_points"])
    assert plain["paths"] == piped["paths"]
    assert "3f.fused_dispatch" in sb["stage_times"] and "3g.fused_consume" in sb["stage_times"]


@pytest.mark.parametrize("depth", [1, 2])
def test_pipelined_quality_within_reference_band(runs, depth):
    j, t = runs["jax", depth], runs["torch", depth]
    assert t["pending_before_read"] == depth == j["pending_before_read"]
    assert t["pending_after_read"] == 0
    assert t["state"] == "OK" == j["state"]
    assert t["stats"]["n_map_points"] > 100
    assert t["n_logged"] >= N - 4 - depth and t["n_lost"] == 0 == j["n_lost"]
    assert t["n_assoc"] >= N - 4 - depth
    assert t["ate"] <= max(1.5 * j["ate"], j["ate"] + 0.02), (t["ate"], j["ate"])
    assert t["ate"] < 0.08                           # tests/test_pipeline.py's band
    assert abs(t["stats"]["n_keyframes"] - j["stats"]["n_keyframes"]) <= KF_BAND
    for path in ("fused", "fused_retry", "staged"):
        assert abs(t["paths"].get(path, 0) - j["paths"].get(path, 0)) <= PATH_BAND, (
            path, t["paths"], j["paths"])
    assert t["paths"]["fused"] + t["paths"].get("fused_retry", 0) > 0.5 * N, t["paths"]


@pytest.mark.parametrize("depth", [1, 2])
def test_pipelined_trajectory_follows_the_reference(runs, depth):
    """Frame by frame: both packages log the same frames, and after each
    trajectory is aligned to the ground truth by its own similarity the
    port's camera centres lie within 0.03 m of the JAX package's (the scene is
    6 m deep; JAX's own ATE here is 0.011-0.013)."""
    j, t = runs["jax", depth], runs["torch", depth]
    ts_j, _, c_j, _ = j["traj"]
    ts_t, _, c_t, _ = t["traj"]
    np.testing.assert_allclose(ts_t, ts_j, atol=1e-6)
    gt = runs["gt"][np.rint(ts_j * 20.0).astype(int)]
    aligned = []
    for c in (c_j, c_t):
        R, tr, s = horn_align(c, gt, with_scale=True)
        aligned.append(s * c @ R.T + tr)
    assert np.abs(aligned[0] - aligned[1]).max() < 0.03
