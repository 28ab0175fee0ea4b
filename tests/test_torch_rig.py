"""A two-camera fisheye rig carried from the JAX package into the port
(``utils/convert.rig_from``), and the BA problem each package's mapper
gathers over the same map with it: every BAProblem field equal, the rig
fields (obs_cam, cam_params2, R_rl, t_rl) included. Tolerance: none, the
gather is index arithmetic and copies of float32 arrays."""
import numpy as np

from orbslam3_tpu.models import map as jmap
from orbslam3_tpu.models.local_mapping import LocalMapper as JaxMapper
from orbslam3_tpu.ops.features import OrbConfig as JaxOrbConfig
from orbslam3_tpu_torch.models.local_mapping import LocalMapper
from orbslam3_tpu_torch.ops.features import OrbConfig
from orbslam3_tpu_torch.utils.convert import map_state_from_arrays, rig_from
from torch_port_helpers import N, build_drifted_map, torch_threads  # noqa: F401

K = np.array([458.654, 457.296, 376.0, 240.0], np.float32)
RIG = {"cam_r": np.array([457.0, 456.0, 377.0, 239.0], np.float64),
       "R_rl": np.eye(3), "t_rl": np.array([-0.11, 0.0, 0.0]),
       "lap_l": (0.0, 751.0), "lap_r": (0.0, 751.0)}


def test_rig_and_ba_gather_match_reference():
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
