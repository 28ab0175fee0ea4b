"""Loop closure inside a full SLAM run, the port against the JAX package:
tests/test_loop_full_slam.py's walk (RoomScene(seed=7) at 376x240, 256
features, a 112-frame closed path walked 1.6 times, a 3-keyframe local
window, no redundancy culling, sync mapping, loop closing on), driven through
chip_smoke.run_loop_walk for both packages on the CPU.

Both must close the loop with the whole chain (a pending verification before
the first detection, a correction, fewer map points just after it, the loop
edge kept), the port ending with state OK (the JAX package's run ends
RECENTLY_LOST: it loses its last frames after its second correction), and the
port's ATE is held to max(1.5 x JAX, JAX + 0.02), the end-to-end rule of the
other e2e tests. Slow: the two walks take several minutes on the CPU, like the
JAX test it mirrors.
"""
import numpy as np
import pytest

import chip_smoke as cs
from orbslam3_tpu.models.system import SlamSystem as JaxSlam
from orbslam3_tpu.models.tracking import TrackingParams as JaxParams
from torch_port_helpers import torch_threads  # noqa: F401

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def walks():
    scene, poses, imgs = cs.render_loop_walk(False, cs.LOOP_FRAMES)
    out = {}
    for name, kw in (("jax", dict(system_cls=JaxSlam, params_cls=JaxParams)),
                     ("torch", dict(device="cpu"))):
        slam, rec = cs.run_loop_walk(scene, poses, imgs, 256, "sync", **kw)
        out[name] = rec
    return out


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_loop_closes_with_the_whole_chain(walks, pkg):
    r = walks[pkg]
    assert r["loop"]["loops_corrected"] >= 1, r["loop"]
    assert r["pending_before_detection"], r
    pre, post = r["map_points_around_correction"]
    assert post < pre
    assert len(r["loop_edges"]) >= 1
    assert r["loop"]["lc_errors"] == r["loop"]["gba_errors"] == 0
    if pkg == "torch":
        assert r["state"] == "OK"


def test_port_ate_within_reference_band(walks):
    j, t = walks["jax"], walks["torch"]
    assert np.isfinite(t["ate"]) and t["tracked"] >= 0.9
    assert t["ate"] <= max(1.5 * j["ate"], j["ate"] + 0.02), (t["ate"], j["ate"])
