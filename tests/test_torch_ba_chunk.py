"""The async mapper's chunked BA (``LocalMapper.ba_chunk``, ``_run_ba``,
``_run_ba_chunked``) against the JAX package's, both on the CPU.

The asynchronous system of both packages sets ``ba_chunk = 3``: every BA
phase runs as chunks of at most 3 LM iterations, each chunk restarting the
damping at 1e-4, so a (5, 10) schedule is 3+2 | 3+3+3+1 iterations. That is
a different solve from one call per phase (``ba_chunk = 0``, the synchronous
system), and each problem below shows it: the chunked solve is held to the
JAX package's chunked solve within 2e-5 in keyframe translation and in the
rotation matrices' entries (float32 Schur LM, sums in another order) with the same inlier
count, and it lies at least ten times that tolerance away from the port's
one-call solve (which is held to the JAX package's one-call solve within
test_torch_solvers.py::test_local_ba's 2e-4).
"""
import functools

import jax
import numpy as np
import pytest

from orbslam3_tpu.models import map as jmap
from orbslam3_tpu.models.local_mapping import LocalMapper as JMapper
from orbslam3_tpu.models.system import SlamSystem as JSystem
from orbslam3_tpu.ops import ba as jba
from orbslam3_tpu.ops import features as jfeat
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu_torch.models import map as tmap
from orbslam3_tpu_torch.models.local_mapping import LocalMapper as TMapper
from orbslam3_tpu_torch.models.system import SlamSystem as TSystem
from orbslam3_tpu_torch.ops import ba as tba
from orbslam3_tpu_torch.ops import features as tfeat
from torch_port_helpers import J, N, T, random_pose, torch_threads  # noqa: F401

K = np.array([458.654, 457.296, 376.0, 240.0], np.float32)
TOL = 2e-5
# compiled once for the module: both problems share the shapes
JAX_LOCAL_BA = jax.jit(jba.local_ba, static_argnames=("iters1", "iters2"))


def _problem(seed, n_kf=6, n_pt=200):
    """A local-BA problem with large start errors (rotations ~0.08 rad,
    translations ~0.3, points ~0.5 off), 0.7 px noise and 4% gross
    outliers."""
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.uniform(-3, 3, (n_pt, 2)), rng.uniform(4, 9, (n_pt, 1))], 1)
    poses = [(np.eye(3), np.zeros(3))] + [random_pose(rng, 0.04, 0.3) for _ in range(n_kf - 1)]
    kf, mp, uv = [], [], []
    for k, (R, t) in enumerate(poses):
        xc = X.astype(np.float32) @ R.astype(np.float32).T + t.astype(np.float32)
        proj = np.stack([K[0] * xc[:, 0] / xc[:, 2] + K[2], K[1] * xc[:, 1] / xc[:, 2] + K[3]], -1)
        for p in range(n_pt):
            if rng.random() < 0.85:
                kf.append(k)
                mp.append(p)
                uv.append(proj[p] + rng.normal(0, 0.7, 2))
    uv = np.asarray(uv, np.float32)
    uv[::25] += 40.0
    O = len(kf)
    R0 = np.stack([p[0] for p in poses]).astype(np.float32)
    t0 = np.stack([p[1] for p in poses]).astype(np.float32)
    for k in range(2, n_kf):
        R0[k] = np.asarray(jlie.so3_exp(J(rng.normal(0, 0.08, 3).astype(np.float32)))) @ R0[k]
        t0[k] += rng.normal(0, 0.3, 3)
    pts = (X + rng.normal(0, 0.5, X.shape)).astype(np.float32)
    fixed = np.zeros(n_kf, bool)
    fixed[:2] = True
    return dict(R=R0, t=t0, pts=pts, obs_kf=np.asarray(kf, np.int32),
                obs_mp=np.asarray(mp, np.int32), obs_uv=uv,
                obs_inv_sigma2=np.ones(O, np.float32), obs_valid=np.ones(O, bool),
                fixed_pose=fixed, obs_ur=np.full(O, -1.0, np.float32))


@functools.lru_cache(maxsize=1)
def _jax_mapper():
    """One JAX mapper for the module, so that its chunk programs compile once."""
    return JMapper(jmap.MapState(jmap.MapConfig(n_features=256)), K,
                   jfeat.OrbConfig(n_features=256))


# seed 15: both schedules converge, to solutions 5.8e-4 apart; seed 28: the
# chunked schedule's damping restarts leave phase 1 with every step
# rejected, so it classifies every observation as an outlier, while one call
# per phase converges
@pytest.mark.parametrize("seed", [15, 28])
def test_chunked_local_ba_matches_reference(seed):
    arrays = _problem(seed)
    pj = jba.BAProblem(bf=0.0, **{k: J(v) for k, v in arrays.items()})
    pt = tba.BAProblem(bf=0.0, **{k: T(v) for k, v in arrays.items()})
    jm = _jax_mapper()
    tm = TMapper(tmap.MapState(tmap.MapConfig(n_features=256)), K,
                 tfeat.OrbConfig(n_features=256), device="cpu")
    rj = jm._run_ba_chunked(pj, (5, 10), 3)
    tm.ba_chunk = 3
    rt = tm._run_ba(pt, (5, 10))
    np.testing.assert_allclose(N(rt.t), N(rj.t), rtol=0, atol=TOL)
    np.testing.assert_allclose(N(rt.R), N(rj.R), rtol=0, atol=TOL)
    assert int(rt.n_inlier) == int(rj.n_inlier)
    np.testing.assert_array_equal(N(rt.R)[:2], arrays["R"][:2])     # the fixed keyframes

    # one call per phase is another solve: the chunked one must not be it
    tm.ba_chunk = 0
    r0 = tm._run_ba(pt, (5, 10))
    assert np.abs(N(r0.t) - N(rj.t)).max() > 10 * TOL
    rj0 = JAX_LOCAL_BA(pj, J(K), iters1=5, iters2=10)
    np.testing.assert_allclose(N(r0.t), N(rj0.t), rtol=0, atol=2e-4)  # as test_local_ba


@pytest.mark.parametrize("mode,chunk", [("sync", 0), ("async", 3)])
def test_system_sets_ba_chunk(mode, chunk):
    """Both packages' SlamSystem: 3 under async mapping, 0 under sync, and
    the same again after the active map is reset (the mapper is rebuilt)."""
    kw = dict(n_features=256, enable_loop_closing=False, mapping_mode=mode)
    js = JSystem(K, np.zeros(5, np.float32), (376, 240), **kw)
    ts = TSystem(K, np.zeros(5, np.float32), (376, 240), device="cpu", **kw)
    try:
        assert js.mapper.ba_chunk == chunk and ts.mapper.ba_chunk == chunk
        old = ts.mapper
        ts.reset_active_map()
        assert ts.mapper is not old and ts.mapper.ba_chunk == chunk
    finally:
        js.shutdown(print_times=False)
        ts.shutdown(print_times=False)
