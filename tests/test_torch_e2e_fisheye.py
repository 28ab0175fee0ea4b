"""The two-camera KB8 fisheye rig end to end: the JAX SlamSystem and the port's on
tests/test_e2e_fisheye.py's two-camera rig (seed 8, right eye at R_rl = exp([0, 0.008, 0]),
t_rl = (−0.101, 0, 0), lapping areas the whole width, orbit of radius 0.5,
set_fisheye_rig + track_stereo_fisheye) at its settings, both on the CPU with the same rendered
frames (RoomScene at 512x512 through the TUM-VI-like KB8 model, 512 features,
dense_tracking_params(), cam_type=1, loop closing off), on the first 16 frames of its 24-frame
orbit in both packages (the file's time budget under the tier-1 run; the run itself is
``torch_port_helpers.fisheye_runs``).

Bounds: the port's ATE (metric) is no worse than max(1.5 x JAX, JAX + 0.02);
its tracked-frame count is within 2 of JAX's; its thread and query error counts are 0;
every frame finds at least 50 stereo depths.
"""
import pytest

from torch_port_helpers import (check_fisheye_ate, check_fisheye_errors_and_rig,
                                check_fisheye_tracking, fisheye_runs, torch_threads)  # noqa: F401


@pytest.fixture(scope="module")
def runs():
    return fisheye_runs("rig")


def test_tracks_like_reference(runs):
    check_fisheye_tracking(runs)


def test_ate_within_reference(runs):
    check_fisheye_ate(runs)


def test_errors_and_rig(runs):
    check_fisheye_errors_and_rig(runs)
