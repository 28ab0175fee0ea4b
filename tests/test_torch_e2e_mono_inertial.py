"""Monocular-inertial end to end, the port against the JAX package on the
CPU: tests/test_e2e_inertial.py's fixture (RoomScene(seed=4) at 752x480, 512
features, dense_tracking_params(), its strongly excited orbit with a 200 Hz
IMU stream, camera = body, gravity along the world's +y; the port's stream
computed with the port's so3_log), sync mapping, loop closing off.

The cut: the fixture's 64 frames are cut to MI_FRAMES = 61, the fewest that
cover both packages' IMU init (the 2.2 s span gate holds it back to frame
44 at the earliest; the JAX package initializes at frame 54, the port at
frame 57) and 4 frames after the later one.

Why the free runs are not held frame for frame: the two packages part at
frame 1 on pyramid rounding, and this fixture is chaotic at that level: the
JAX package's tracking dips at frames 17-19 (136, 73, 43 inliers) where the
port's holds (285, 276, 266), and the port loses frames 34-50 where the JAX
package does not. Handed the JAX package's state and features at frame 16,
the port takes the JAX package's dip to within 2 inliers, so the free runs'
maps differ by rounding, not by a port fault, and
their init frames (54 and 57) and scales (2.886 and 4.044: each relative to
its own map's arbitrary monocular scale) differ with them. So the parity of
the monocular init is held on identical inputs: the port continues from
the JAX package's state after MI_HANDOFF frames (map, tracker and inertial
state through ``utils.convert``) on the JAX package's features and IMU
samples, and must initialize on the JAX package's frame with its scale
within 1e-3 relative and its poses through the init frame within 1e-3
(the init frame's pose is rescaled and gravity-aligned with the init's
scale and rotation; the frames after it are not held: the whole-map
inertial BA of the init and the local inertial BAs on a monocular map part
the packages by 1e-2 within two keyframes).

The free runs: both initialize; the port's metric ATE (no scale alignment:
the IMU fixes the scale) no worse than max(1.5 x JAX, JAX + 0.02) and its
scale consistency ate < 4 max(ate_s, 0.02) (tests/test_e2e_inertial.py's
rule); every error counter 0; the inertial BAs ran. The pipelined front end
(TrackingParams(pipeline=True), depth 1) continues from the same handed-over
state and must initialize on the same frame, with the next frame in
flight, and the same scale (at depth 1 each frame is consumed on the next
call with the same computations). Neither package's fused visual-inertial step
accepts a frame of this fixture after the init (its few inliers, 23-77, and
a relocalization within 20 frames put the frames below the acceptance
floor of 50), so the fused step is held at bf = 0 by
tests/test_torch_vi_fused.py."""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import ERROR_COUNTS, MI_FRAMES, MI_HANDOFF, torch_threads  # noqa: F401
from torch_port_helpers import mono_inertial_handoff, mono_inertial_inputs, mono_inertial_run


@pytest.fixture(scope="module")
def runs():
    j = mono_inertial_run("jax", MI_FRAMES, snapshot_at=MI_HANDOFF)
    scene, _, frames, _ = mono_inertial_inputs(MI_FRAMES)
    extract = j["extract"]
    snap = j.pop("snapshot")
    n_h = min(MI_FRAMES, (j["init_frame"] or MI_HANDOFF) + 1)

    def handoff(pipeline):
        return mono_inertial_handoff(snap, scene, frames, lambda img: extract(jnp.asarray(img)),
                                     n_h, pipeline=pipeline)
    out = dict(jax=j, torch=mono_inertial_run("torch", MI_FRAMES), handoff=handoff(False),
               handoff_pipe=handoff(True))
    yield out
    jax.clear_caches()
    gc.collect()


def test_both_initialize_the_imu(runs):
    j, t = runs["jax"], runs["torch"]
    assert j["init_frame"] is not None and t["init_frame"] is not None, (j["imu"], t["imu"])
    # the 2.2 s span gate: no monocular init before frame 44
    assert 44 <= t["init_frame"] < MI_FRAMES - 3 and j["init_frame"] >= 44
    assert 0.02 < t["init_scale"] < 50 and t["stats"].get("vi_ba_runs", 0) >= 1


def test_handed_the_jax_state_the_port_initializes_alike(runs):
    """On identical inputs from frame MI_HANDOFF on, the port initializes on
    the JAX package's frame with its scale, and the tracked poses agree."""
    j, h = runs["jax"], runs["handoff"]
    assert h["init_frame"] == j["init_frame"], (h["imu"], j["imu"])
    assert abs(h["init_scale"] - j["init_scale"]) <= 1e-3 * j["init_scale"], (
        h["init_scale"], j["init_scale"])
    for i, pose in enumerate(h["poses"]):
        want = j["poses"][MI_HANDOFF + i]
        assert (pose is None) == (want is None), i
        if pose is not None:
            np.testing.assert_allclose(pose[0], want[0], rtol=0, atol=1e-3)
            np.testing.assert_allclose(pose[1], want[1], rtol=0, atol=1e-3)
    assert h["states"] == j["states"][MI_HANDOFF: MI_HANDOFF + len(h["states"])]


def test_metric_ate_by_the_rule(runs):
    j, t = runs["jax"], runs["torch"]
    assert t["n_assoc"] > 0.7 * MI_FRAMES
    assert t["ate"] <= max(1.5 * j["ate"], j["ate"] + 0.02), (t["ate"], j["ate"])
    assert t["ate"] < 4.0 * max(t["ate_s"], 0.02), (t["ate"], t["ate_s"])


def test_error_counters(runs):
    for key in ERROR_COUNTS:
        assert runs["torch"]["stats"].get(key, 0) == 0, (key, runs["torch"]["stats"])
    tr = runs["torch"]["system"].tracker
    assert tr.imu_initialized and tr.velocity_w is not None and tr.kf_preints


def test_pipelined_front_end_initializes_alike(runs):
    """The software pipeline (depth 1) through the monocular init on the
    JAX package's state and features: the init comes on the JAX package's
    frame, while the next frame is in flight, with its scale; the tracker
    ends initialized and tracking, with no error counted."""
    j, p = runs["jax"], runs["handoff_pipe"]
    assert p["init_frame"] == j["init_frame_tracked"] == j["init_frame"], (p, j["imu"])
    assert abs(p["init_scale"] - j["init_scale"]) <= 1e-3 * j["init_scale"]
    assert p["imu"][-1] and p["states"][-1] == j["states"][MI_HANDOFF + len(p["states"]) - 1]
    for key in ERROR_COUNTS:
        assert p["stats"].get(key, 0) == 0, key
