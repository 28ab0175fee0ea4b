"""The landmark-sharded BA of the port (``parallel/sharded_ba.py``) and the
mapper's sharded global-BA branch against the JAX package's, both on the
CPU: JAX on the conftest's 8 virtual devices, the port on
``make_mesh(8, device="cpu")`` (8 logical shards of the CPU).

Tolerances: one Gauss-Newton step agrees within 1e-6 in rotation entries,
1e-5 in translation and 5e-5 in points, the full solve within 1e-5 / 1e-5 /
1e-4 with equal inlier masks (float32 Schur products and a sum over 8
shards, in another order); against the single-device ``ops/ba.local_ba``
the bounds of tests/test_sharded_ba.py. The mapper's branch is held to the
JAX package's with test_torch_gba.py's bounds (keyframe centres within 2e-3,
points within 5e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.models import map as jmap
from orbslam3_tpu.models.local_mapping import LocalMapper as JMapper
from orbslam3_tpu.ops import ba as jba
from orbslam3_tpu.ops import features as jfeat
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu.parallel import sharded_ba as jsb
from orbslam3_tpu_torch.models import map as tmap
from orbslam3_tpu_torch.models.local_mapping import LocalMapper as TMapper
from orbslam3_tpu_torch.ops import ba as tba
from orbslam3_tpu_torch.ops import features as tfeat
from orbslam3_tpu_torch.parallel import sharded_ba as tsb
from test_sharded_ba import K_CAM, make_problem
from test_torch_gba import _centres, drifted_line_map
from torch_port_helpers import N, T, torch_threads  # noqa: F401

N_SHARDS = 8


def test_make_mesh_on_the_cpu():
    assert jax.device_count() == N_SHARDS
    assert tsb.make_mesh(device="cpu") == [torch.device("cpu")]
    assert tsb.make_mesh(N_SHARDS, device="cpu") == [torch.device("cpu")] * N_SHARDS


@pytest.mark.parametrize("n_shards", [1, 3, N_SHARDS])
def test_partition_by_landmark_is_the_reference(n_shards):
    """Uneven observation counts per shard, a landmark count that does not
    divide: every output equal element for element."""
    rng = np.random.default_rng(n_shards)
    n_pts = 203
    obs_mp = rng.integers(0, n_pts, 1500) ** 2 // n_pts
    arrays = {"kf": rng.integers(0, 40, 1500).astype(np.int32),
              "uv": rng.normal(size=(1500, 2)).astype(np.float32)}
    want = jsb.partition_by_landmark(obs_mp, n_pts, n_shards, arrays)
    got = tsb.partition_by_landmark(obs_mp, n_pts, n_shards, arrays)
    assert got[:2] == want[:2]
    for a, b in zip(got[2:4], want[2:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[4].keys() == want[4].keys()
    for k in want[4]:
        np.testing.assert_array_equal(got[4][k], want[4][k])


@pytest.fixture(scope="module")
def problem():
    """tests/test_sharded_ba.py's loop problem at 32 keyframes x 256 points,
    perturbed as its 256-keyframe case, partitioned over 8 shards."""
    n_kf, n_pts = 32, 256
    R_gt, t_gt, pts_gt, obs_kf, obs_mp, obs_uv = make_problem(
        n_kf=n_kf, n_pts=n_pts, seed=3, loop=True)
    rng = np.random.default_rng(4)
    R0, t0 = R_gt.copy(), t_gt.copy()
    for k in range(2, n_kf):
        R0[k] = np.asarray(jlie.so3_exp(jnp.asarray(
            rng.normal(0, 0.01, 3).astype(np.float32)))) @ R_gt[k]
        t0[k] = t_gt[k] + rng.normal(0, 0.03, 3)
    pts0 = (pts_gt + rng.normal(0, 0.03, pts_gt.shape)).astype(np.float32)
    fixed = np.zeros(n_kf, bool)
    fixed[:2] = True
    n_pts_pad, _, local_mp, valid, outs = jsb.partition_by_landmark(
        obs_mp, n_pts, N_SHARDS, {"kf": obs_kf, "uv": obs_uv})
    pts_pad = np.zeros((n_pts_pad, 3), np.float32)
    pts_pad[:n_pts] = pts0
    args = (R0, t0, fixed, pts_pad, outs["kf"], local_mp, outs["uv"],
            valid.astype(np.float32), K_CAM)
    return dict(args=args, t_gt=t_gt, n_kf=n_kf, n_pts=n_pts, obs_kf=obs_kf, obs_mp=obs_mp,
                obs_uv=obs_uv, R0=R0, t0=t0, pts0=pts0, fixed=fixed)


def test_sharded_step_matches_reference(problem):
    args = problem["args"]
    want = jsb.make_sharded_ba_step(jsb.make_mesh(), problem["n_kf"])(
        *[jnp.asarray(a) for a in args], jnp.asarray(1e-4, jnp.float32))
    got = tsb.make_sharded_ba_step(tsb.make_mesh(N_SHARDS, device="cpu"), problem["n_kf"])(
        *[T(a) for a in args], 1e-4)
    for g, w, tol in zip(got, want, (1e-6, 1e-5, 5e-5)):
        np.testing.assert_allclose(N(g), np.asarray(w), rtol=0, atol=tol)
    np.testing.assert_array_equal(N(got[0])[:2], problem["R0"][:2])
    assert np.abs(N(got[1]) - problem["t0"]).max() > 1e-3        # the step moved the poses


def test_sharded_solver_matches_reference_and_single_device(problem):
    args = problem["args"]
    Rj, tj, pj, ij = jsb.make_sharded_ba_solver(jsb.make_mesh(), problem["n_kf"],
                                                iters1=4, iters2=4)(
        *[jnp.asarray(a) for a in args])
    Rt, tt, pt, it = tsb.make_sharded_ba_solver(tsb.make_mesh(N_SHARDS, device="cpu"),
                                                problem["n_kf"], iters1=4, iters2=4)(
        *[T(a) for a in args])
    np.testing.assert_allclose(N(Rt), np.asarray(Rj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(N(tt), np.asarray(tj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(N(pt), np.asarray(pj), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(N(it), np.asarray(ij))

    # the port's single-device solve of the same problem (tests/test_sharded_ba.py)
    O = len(problem["obs_kf"])
    prob = tba.BAProblem(
        R=T(problem["R0"]), t=T(problem["t0"]), pts=T(problem["pts0"]),
        obs_kf=T(problem["obs_kf"]), obs_mp=T(problem["obs_mp"]), obs_uv=T(problem["obs_uv"]),
        obs_inv_sigma2=torch.ones(O), obs_valid=torch.ones(O, dtype=torch.bool),
        fixed_pose=T(problem["fixed"]), obs_ur=torch.full((O,), -1.0))
    ref = tba.local_ba(prob, T(K_CAM), iters1=4, iters2=4)
    err_ref = np.abs(N(ref.t) - problem["t_gt"]).max()
    err_sh = np.abs(N(tt) - problem["t_gt"]).max()
    assert err_sh < 0.02, err_sh
    assert abs(err_sh - err_ref) < 5e-3, (err_sh, err_ref)
    assert np.abs(N(tt) - N(ref.t)).max() < 1e-2
    assert int(it.sum()) > 0.9 * O


def _corridor_mappers(n_kf):
    """test_torch_gba.py's drifted corridor with ``n_kf`` keyframes over the
    same length; the port's mapper on 8 logical CPU shards."""
    step = 1.2 * 11 / (n_kf - 1)
    mj, gt = drifted_line_map(jmap, n_kf, step)
    mt, _ = drifted_line_map(tmap, n_kf, step)
    jm = JMapper(mj, K_CAM, jfeat.OrbConfig(n_features=256), wh=(752, 480))
    tm = TMapper(mt, K_CAM, tfeat.OrbConfig(n_features=256), wh=(752, 480), device="cpu")
    tm.mesh = tsb.make_mesh(N_SHARDS, device="cpu")
    return jm, tm


@pytest.mark.parametrize("n_kf,sharded", [(64, 1), (63, 0)])
def test_mapper_sharded_global_ba_matches_reference(n_kf, sharded):
    """At 64 keyframes both packages take the sharded branch (and report
    every observation an inlier: nothing is erased); at 63 neither does."""
    jm, tm = _corridor_mappers(n_kf)
    before = _centres(tm.map)
    feat_mp = tm.map.kf_feat_mp.copy()
    assert jm.global_ba() and tm.global_ba()
    assert jm.stats.get("sharded_gba_runs", 0) == tm.stats.get("sharded_gba_runs", 0) == sharded
    assert jm.stats["gba_runs"] == tm.stats["gba_runs"] == 1
    mj, mt = jm.map, tm.map
    np.testing.assert_allclose(_centres(mt), _centres(mj), atol=2e-3)
    np.testing.assert_allclose(mt.mp_xyz[: mt.n_mp], mj.mp_xyz[: mj.n_mp], atol=5e-3)
    np.testing.assert_array_equal(mt.kf_R[:2], mj.kf_R[:2])
    np.testing.assert_array_equal(mt.kf_feat_mp, feat_mp)
    assert np.abs(_centres(mt) - before).max() > 0.05
