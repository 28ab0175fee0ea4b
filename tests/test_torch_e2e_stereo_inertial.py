"""Stereo-inertial end to end, the port against the JAX package on the CPU:
tests/test_e2e_stereo_inertial.py's fixture (36 rendered stereo pairs with a
200 Hz IMU stream, sync mapping, the tracker's pipeline off), then 11 frames
more with the pipeline on, which the port tracks through the fused
visual-inertial step (``kernels.fused_track_vi_pooled``). The 11 pipelined
frames are what the budget allows past the IMU init (frame 35 in both
packages: the init needs 8 keyframes 0.25 s apart); the fixture's 36 frames
are its own.

Tolerances: the IMU-init frame equal; metric ATE (no scale alignment: stereo
and the IMU fix the scale) no worse than max(1.5 x JAX, JAX + 0.02), over
the fixture's frames and over all; keyframe counts within ±2; every error
counter 0."""
import gc

import jax
import pytest

from torch_port_helpers import ERROR_COUNTS, SI_SYNC_FRAMES, torch_threads  # noqa: F401
from torch_port_helpers import stereo_inertial_runs


@pytest.fixture(scope="module")
def runs():
    out = stereo_inertial_runs()
    yield out
    # the JAX package's fused visual-inertial step is among its largest
    # programs: drop the compiled programs with this module (the JAX
    # package's tests do the same per test)
    jax.clear_caches()
    gc.collect()


def test_imu_initializes_on_the_same_frame(runs):
    j, t = runs["jax"], runs["torch"]
    assert t["imu"][-1] and j["imu"][-1], (t["imu"], j["imu"])
    assert t["init_frame"] == j["init_frame"], (t["init_frame"], j["init_frame"])
    assert t["init_frame"] < SI_SYNC_FRAMES
    assert all(s == "OK" for s in t["states"]), t["states"]


def test_metric_ate_by_the_rule(runs):
    j, t = runs["jax"], runs["torch"]
    assert t["n_sync"] > 0.7 * SI_SYNC_FRAMES
    assert t["ate_sync"] <= max(1.5 * j["ate_sync"], j["ate_sync"] + 0.02), (
        t["ate_sync"], j["ate_sync"])
    assert t["ate"] <= max(1.5 * j["ate"], j["ate"] + 0.02), (t["ate"], j["ate"])
    # tests/test_e2e_stereo_inertial.py's own bound
    assert t["ate_sync"] < 0.1


def test_pipelined_frames_ride_the_fused_vi_step(runs):
    """At least 8 of the 11 pipelined frames on ``fused_track_vi_pooled``;
    the JAX package's run of the same configuration takes its fused
    visual-inertial step as often, within one frame."""
    j, t = runs["jax"], runs["torch"]
    assert t["paths_sync"]["fused_vi"] == 0       # the init came on the last sync frame
    assert t["paths"]["fused_vi"] >= 8, t["paths"]
    assert abs(t["paths"]["fused_vi"] - j["paths"]["fused_vi"]) <= 1, (t["paths"], j["paths"])


def test_keyframes_and_error_counters(runs):
    j, t = runs["jax"]["stats"], runs["torch"]["stats"]
    assert abs(t["n_keyframes"] - j["n_keyframes"]) <= 2, (t["n_keyframes"], j["n_keyframes"])
    for key in ERROR_COUNTS:
        assert t.get(key, 0) == 0, (key, t.get("last_" + key[:-1]))
    # the inertial BAs ran in the port's mapper: the BA at the init and the
    # local inertial BAs after it
    assert t.get("vi_ba_runs", 0) >= 2, t
    tr = runs["torch"]["system"].tracker
    assert tr.velocity_w is not None and tr.kf_preints
