"""Multi-start pose optimization (``ops/pose_opt.py::pose_optimize_multistart``)
against the JAX package's on the CPU.

Seeded problems with a depth-axis false minimum: 45% of the observations
come from a camera shifted 0.5 along the viewing axis, and the prior sits
there, so the LM from the prior locks into the false basin and a shifted
start escapes it. Mono and stereo rows, an even and an odd count of valid
depths (the shift scale is ``jnp.nanmedian``'s, the mean of the two middle
values on an even count), ``n_starts`` 2, 7 (the tracker's) and 9 (all
the shifts). Each chosen case has one start
whose Huber cost is lower than every other start's by more than 1, so the
winner is decided by the data and not by rounding. Tolerance: the same
winning start as JAX (JAX's pose is within 1e-4 of exactly one of the port's
starts, the port's winner), the pose within 1e-4.

End to end, the tracker with ``TrackingParams(pose_starts=7)`` is held by
tests/test_torch_system_api.py on a state handed over from the JAX package
(the staged path every frame, poses within 1e-3), and the two-start tracker
by tests/test_torch_walks_mono.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import pose_opt as jpo
from orbslam3_tpu_torch.ops import pose_opt as tpo
from torch_port_helpers import J, T, torch_threads  # noqa: F401

K = np.array([458.654, 457.296, 376.0, 240.0], np.float32)


def problem(seed: int, stereo: bool, n_valid: int, n: int = 160):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(2.5, 8, n)], -1).astype(np.float32)
    t_false = np.array([0.02, -0.01, 0.5], np.float32)
    xc = pts + np.where((rng.random(n) < 0.45)[:, None], t_false, 0.0)
    uv = (xc[:, :2] / xc[:, 2:] * K[:2] + K[2:] + rng.normal(0, 0.7, (n, 2))).astype(np.float32)
    inv_s2 = (1 / 1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[rng.permutation(n)[:n_valid]] = True
    ur, bf = np.full(n, -1.0, np.float32), 0.0
    if stereo:
        bf = 40.0
        s = rng.random(n) < 0.5
        ur[s] = (uv[s, 0] - bf / xc[s, 2] + rng.normal(0, 0.7, s.sum())).astype(np.float32)
    t0 = (t_false + rng.normal(0, 0.01, 3)).astype(np.float32)
    return (np.eye(3, dtype=np.float32), t0, pts, uv, inv_s2, valid, K), ur, np.float32(bf)


CASES = [(0, False, 151, 9), (0, True, 150, 2), (0, True, 150, 9), (6, False, 150, 7),
         (6, False, 150, 2), (6, True, 151, 9), (6, True, 151, 7), (3, True, 150, 7),
         (1, True, 151, 2), (3, False, 151, 9)]
# one compiled program per start count
_jax_multistart = jax.jit(jpo.pose_optimize_multistart, static_argnames=("n_starts",))


@pytest.mark.parametrize("seed,stereo,n_valid,n_starts", CASES)
def test_same_winning_start_and_pose_as_jax(seed, stereo, n_valid, n_starts):
    args, ur, bf = problem(seed, stereo, n_valid)
    jres = _jax_multistart(*(J(a) for a in args), obs_ur=J(ur), bf=J(bf), n_starts=n_starts)
    starts, costs = tpo.multistart_solves(*(T(a) for a in args), obs_ur=T(ur), bf=float(bf),
                                          n_starts=n_starts)
    tres = tpo.pose_optimize_multistart(*(T(a) for a in args), obs_ur=T(ur), bf=float(bf),
                                        n_starts=n_starts)
    c = np.sort(costs.numpy())
    assert c[1] - c[0] > 1.0, "fixture: the winner must be decided by the data"
    win = int(torch.argmin(costs))
    jR, jt = np.asarray(jres.R), np.asarray(jres.t)
    near = [i for i in range(n_starts)
            if np.abs(starts.t[i].numpy() - jt).max() < 1e-4
            and np.abs(starts.R[i].numpy() - jR).max() < 1e-4]
    assert near == [win], (near, win, costs)
    np.testing.assert_allclose(tres.R.numpy(), jR, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tres.t.numpy(), jt, rtol=0, atol=1e-4)
    assert int(tres.n_inliers) == int(jres.n_inliers)
    np.testing.assert_array_equal(tres.inlier.numpy(), np.asarray(jres.inlier))


@pytest.mark.parametrize("n", [1, 2, 7, 8])
def test_shift_scale_is_jax_nanmedian(n):
    rng = np.random.default_rng(n)
    x = rng.uniform(1, 9, 11).astype(np.float32)
    x[rng.permutation(11)[: 11 - n]] = np.nan
    assert float(tpo._nanmedian_as_jax(T(x))) == float(jnp.nanmedian(J(x)))
    assert np.isnan(float(tpo._nanmedian_as_jax(T(np.full(4, np.nan, np.float32)))))
