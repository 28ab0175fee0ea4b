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
counter 0.

The 11 pipelined frames are ``slow``-marked (about 45% of the JAX
package's walk: the JAX package builds its fused visual-inertial step and
runs a local inertial BA per keyframe); run them with ``python -m pytest -m
slow tests/test_torch_e2e_stereo_inertial.py``. The fixture's 36 frames
stay in tier-1. Tier-1 holds the fused step on this front end against the
JAX package on identical inputs:
``test_torch_vi_facade.py::test_inertial_front_end_rides_the_fused_vi_step[stereo]``
(``track_stereo_inertial`` handed the JAX package's state on a seeded
initialized IMU) and ``test_torch_vi_fused.py`` (the fused step and the
mapper's inertial stages on a frozen map)."""
import gc

import jax
import pytest

from torch_port_helpers import ERROR_COUNTS, SI_SYNC_FRAMES, torch_threads  # noqa: F401
from torch_port_helpers import stereo_inertial_pipelined, stereo_inertial_runs


@pytest.fixture(scope="module")
def runs():
    out = stereo_inertial_runs()
    yield out
    # the JAX package's fused visual-inertial step is among its largest
    # programs: drop the compiled programs with this module (the JAX
    # package's tests do the same per test)
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def pipelined(runs):
    """The same systems through the 11 pipelined frames (only the slow
    tests ask for them)."""
    return stereo_inertial_pipelined(runs)


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
    # tests/test_e2e_stereo_inertial.py's own bound
    assert t["ate_sync"] < 0.1


def test_keyframes_and_error_counters(runs):
    j, t = runs["jax"]["stats"], runs["torch"]["stats"]
    assert abs(t["n_keyframes"] - j["n_keyframes"]) <= 2, (t["n_keyframes"], j["n_keyframes"])
    for key in ERROR_COUNTS:
        assert t.get(key, 0) == 0, (key, t.get("last_" + key[:-1]))
    # the inertial BA at the init ran in the port's mapper
    assert t.get("vi_ba_runs", 0) >= 1, t
    tr = runs["torch"]["system"].tracker
    assert tr.velocity_w is not None and tr.kf_preints


@pytest.mark.slow
def test_pipelined_frames_ride_the_fused_vi_step(runs, pipelined):
    """At least 8 of the 11 pipelined frames on ``fused_track_vi_pooled``;
    the JAX package's run of the same configuration takes its fused
    visual-inertial step as often, within one frame."""
    j, t = pipelined["jax"], pipelined["torch"]
    assert runs["torch"]["paths_sync"]["fused_vi"] == 0   # the init came on the last sync frame
    assert t["paths"]["fused_vi"] >= 8, t["paths"]
    assert abs(t["paths"]["fused_vi"] - j["paths"]["fused_vi"]) <= 1, (t["paths"], j["paths"])


@pytest.mark.slow
def test_pipelined_frames_by_the_rule(pipelined):
    """Over all 47 frames: every pipelined frame tracked, the metric ATE by
    the rule, keyframe counts within ±2, no error counted, and the local
    inertial BAs after the init ran in the port's mapper."""
    j, t = pipelined["jax"], pipelined["torch"]
    assert all(s == "OK" for s in t["states"]), t["states"]
    assert t["ate"] <= max(1.5 * j["ate"], j["ate"] + 0.02), (t["ate"], j["ate"])
    js, ts = j["stats"], t["stats"]
    assert abs(ts["n_keyframes"] - js["n_keyframes"]) <= 2, (ts["n_keyframes"],
                                                             js["n_keyframes"])
    for key in ERROR_COUNTS:
        assert ts.get(key, 0) == 0, (key, ts.get("last_" + key[:-1]))
    assert ts.get("vi_ba_runs", 0) >= 2, ts
