"""The KB8 fisheye camera in the port against the JAX package, one
configuration (512x512, 512 features, ``cam_type=1``), so that the JAX
package's programs for it are built once per module: the two-camera
fisheye rig end to end (``TestE2eFisheye``), monocular KB8 end to end
(``TestE2eFisheyeMono``) and a two-camera rig carried into the port with
the BA problem its mapper gathers (``TestRig``). Each class keeps the
module it came from as its docstring, with its tolerances.
"""
import numpy as np
import pytest

from orbslam3_tpu.models import map as jmap
from orbslam3_tpu.models.local_mapping import LocalMapper as JaxMapper
from orbslam3_tpu.ops.features import OrbConfig as JaxOrbConfig
from orbslam3_tpu_torch.models.local_mapping import LocalMapper
from orbslam3_tpu_torch.ops.features import OrbConfig
from orbslam3_tpu_torch.utils.convert import map_state_from_arrays, rig_from
from torch_port_helpers import (N, build_drifted_map, check_fisheye_ate,  # noqa: F401
                                check_fisheye_errors_and_rig, check_fisheye_tracking,
                                fisheye_runs, torch_threads)

K = np.array([458.654, 457.296, 376.0, 240.0], np.float32)
RIG = {"cam_r": np.array([457.0, 456.0, 377.0, 239.0], np.float64),
       "R_rl": np.eye(3), "t_rl": np.array([-0.11, 0.0, 0.0]),
       "lap_l": (0.0, 751.0), "lap_r": (0.0, 751.0)}


class TestE2eFisheye:
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

    @pytest.fixture(scope="class")
    def runs(self):
        return fisheye_runs("rig")

    def test_tracks_like_reference(self, runs):
        check_fisheye_tracking(runs)

    def test_ate_within_reference(self, runs):
        check_fisheye_ate(runs)

    def test_errors_and_rig(self, runs):
        check_fisheye_errors_and_rig(runs)


class TestE2eFisheyeMono:
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

    @pytest.fixture(scope="class")
    def runs(self):
        return fisheye_runs("mono")

    def test_tracks_like_reference(self, runs):
        check_fisheye_tracking(runs)

    def test_ate_within_reference(self, runs):
        check_fisheye_ate(runs)

    def test_errors(self, runs):
        check_fisheye_errors_and_rig(runs)


class TestRig:
    """A two-camera fisheye rig carried from the JAX package into the port
    (``utils/convert.rig_from``), and the BA problem each package's mapper
    gathers over the same map with it: every BAProblem field equal, the rig
    fields (obs_cam, cam_params2, R_rl, t_rl) included. Tolerance: none, the
    gather is index arithmetic and copies of float32 arrays."""

    def test_rig_and_ba_gather_match_reference(self):
        m, _, _, n_kf = build_drifted_map(jmap)
        rng = np.random.default_rng(0)
        for k in range(n_kf):                  # right-eye pixels for half the features
            has = rng.random(m.kf_feat_uvr.shape[1]) < 0.5
            m.kf_feat_uvr[k, has] = (m.kf_feat_xy[k, has] - [30.0, 0.0]).astype(np.float32)
        tmap = map_state_from_arrays(vars(m), m.cfg)
        n_feat = m.cfg.n_features
        jm = JaxMapper(m, K, JaxOrbConfig(n_features=n_feat))
        tm = LocalMapper(tmap, K, OrbConfig(n_features=n_feat), device="cpu")
        jm.rig = {k: np.asarray(v, np.float32) for k, v in RIG.items()}
        jm.bf = tm.bf = float(0.11 * K[0])
        tm.rig = rig_from(jm.rig)
        for key in RIG:
            np.testing.assert_array_equal(tm.rig[key], jm.rig[key])
            assert tm.rig[key].dtype == np.float32
        gj = jm._gather_local_ba(n_kf // 2)
        gt = tm._gather_local_ba(n_kf // 2)
        pj, pt = gj[0], gt[0]
        assert pt.obs_cam is not None and int(N(pt.obs_cam).sum()) > 100
        for field in pj._fields:
            a, b = getattr(pt, field), getattr(pj, field)
            if b is None:
                assert a is None, field
                continue
            np.testing.assert_array_equal(np.asarray(N(a)), np.asarray(b), err_msg=field)
        for a, b in zip(gt[1:], gj[1:]):       # window, fixed mask, points, sources, count
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
