"""The keyframe policy of a rig with depth (``kf_interval_override=0``: the
reference's c1a/c1b/c1c/c2 conditions with the close-point triggers), the
JAX SlamSystem against the port's on tests/test_e2e_stereo.py's stereo and
RGB-D fixtures, both on the CPU with the same rendered frames.

After a stereo initialization the map has one keyframe, whose points have one
observation each, so no point passes the reference-points filter and only the
close-point trigger (fewer than 100 tracked and more than 70 untracked
features closer than th_depth) can make a keyframe. With the fixtures' 40
baselines (4.4 m) about 5 features of this 6 m deep room are close and the
trigger never fires in 14 frames; at 50 baselines (5.5 m) it fires in both
packages (JAX: stereo at frames 9 and 12, RGB-D at frame 13), so the policy
runs here at 50. The stereo case runs the software pipeline at depth 1, so
the policy reads each tracked frame's depth back from the fused step's copy.
Bounds as in tests/test_torch_e2e_stereo.py (torch_port_helpers.check_depth_rig_*),
and the policy made a keyframe after the first in both packages.
"""
import pytest

from torch_port_helpers import (check_depth_rig_ate, check_depth_rig_init,
                                check_depth_rig_keyframes_and_errors, depth_rig_runs,
                                torch_threads)  # noqa: F401


@pytest.fixture(scope="module", params=["stereo", "rgbd"])
def runs(request):
    params = dict(kf_interval_override=0)
    if request.param == "stereo":
        params.update(pipeline=True, pipeline_depth=1)
    return depth_rig_runs(request.param, th_depth_baselines=50.0, **params)


def test_initializes_on_the_same_frame(runs):
    check_depth_rig_init(runs)


def test_metric_ate_within_reference(runs):
    check_depth_rig_ate(runs)


def test_keyframes_and_errors(runs):
    check_depth_rig_keyframes_and_errors(runs)
    for name in ("jax", "torch"):
        assert runs[name]["stats"]["n_keyframes"] >= 2, (name, runs[name]["stats"])
