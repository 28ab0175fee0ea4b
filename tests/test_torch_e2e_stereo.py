"""Stereo and RGB-D end to end: the JAX SlamSystem and the port's on
tests/test_e2e_stereo.py's fixtures, both on the CPU with the same rendered
frames — RoomScene(seed=2) (stereo, baseline 0.11, right eye from
scene.stereo_pose) and RoomScene(seed=3) (RGB-D, the renderer's depth), each
orbit_trajectory(14, radius=0.6, forward=0.03), 512 features, bf = 0.11·fx,
th_depth = 0.11·40, dense_tracking_params() (no software pipeline), loop
closing on (the default).

Bounds (torch_port_helpers.check_depth_rig_*): both initialize on frame 0;
the port's metric ATE is no worse than max(1.5 x JAX, JAX + 0.02); keyframe
counts within ±2; every thread and query error count 0.
"""
import pytest

from torch_port_helpers import (check_depth_rig_ate, check_depth_rig_init,
                                check_depth_rig_keyframes_and_errors, depth_rig_runs,
                                torch_threads)  # noqa: F401


@pytest.fixture(scope="module", params=["stereo", "rgbd"])
def runs(request):
    return depth_rig_runs(request.param)


def test_initializes_on_the_same_frame(runs):
    check_depth_rig_init(runs)


def test_metric_ate_within_reference(runs):
    check_depth_rig_ate(runs)


def test_keyframes_and_errors(runs):
    check_depth_rig_keyframes_and_errors(runs)
