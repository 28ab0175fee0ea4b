"""The pipelined stereo front end (``TrackingParams(pipeline=True)``, the
configuration of bench.py's stereo rig) at pipeline depth 1 and 2, the JAX
SlamSystem against the port's on tests/test_e2e_stereo.py's stereo fixture,
both on the CPU with the same rendered frames and sync mapping.

The port keeps each frame's right-x vector on the device for the fused step
and reads it back only where host code needs depth; at depth 2 two frames
are in flight, each with its own vector. Bounds as in
tests/test_torch_e2e_stereo.py (torch_port_helpers.check_depth_rig_*), and
the pipeline holds ``depth`` frames after the last call in both packages and
tracks through the fused path.
"""
import pytest

from torch_port_helpers import (check_depth_rig_ate, check_depth_rig_init,
                                check_depth_rig_keyframes_and_errors, depth_rig_runs,
                                torch_threads)  # noqa: F401


@pytest.fixture(scope="module", params=[1, 2])
def runs(request):
    return depth_rig_runs("stereo", pipeline=True, pipeline_depth=request.param)


def test_initializes_on_the_same_frame(runs):
    check_depth_rig_init(runs)
    depth = runs["params"]["pipeline_depth"]
    assert runs["jax"]["in_flight"] == runs["torch"]["in_flight"] == depth
    assert runs["torch"]["paths"]["fused"] >= 8, runs["torch"]["paths"]


def test_metric_ate_within_reference(runs):
    check_depth_rig_ate(runs)


def test_keyframes_and_errors(runs):
    check_depth_rig_keyframes_and_errors(runs)
