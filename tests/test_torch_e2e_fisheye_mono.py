"""Monocular KB8 fisheye end to end: the JAX SlamSystem and the port's on
tests/test_e2e_fisheye.py's monocular run (seed 6, orbit of radius 0.6,
track_monocular with cam_type=1; the first frames bootstrap the map) at its
settings, both on the CPU with the same rendered frames (RoomScene at 512x512
through the TUM-VI-like KB8 model, 512 features, dense_tracking_params(),
cam_type=1, loop closing off), on the first 16 frames of its 24-frame orbit in
both packages (the file's time budget under the tier-1 run; the run itself is
``torch_port_helpers.fisheye_runs``).

Bounds: the port's ATE (scale-aligned) is no worse than max(1.5 x JAX, JAX + 0.02);
its tracked-frame count is within 2 of JAX's; its thread and query error counts are 0.
"""
import pytest

from torch_port_helpers import (check_fisheye_ate, check_fisheye_errors_and_rig,
                                check_fisheye_tracking, fisheye_runs, torch_threads)  # noqa: F401


@pytest.fixture(scope="module")
def runs():
    return fisheye_runs("mono")


def test_tracks_like_reference(runs):
    check_fisheye_tracking(runs)


def test_ate_within_reference(runs):
    check_fisheye_ate(runs)


def test_errors(runs):
    check_fisheye_errors_and_rig(runs)
