"""Parity of the port's IMU preintegration (ops/imu.py) and inertial-only
initialization (ops/imu_init.py) with the JAX package on the CPU, on the
inputs of tests/test_imu.py and tests/test_imu_init.py.

Tolerances: preintegrated deltas, Jacobians and covariances within 1e-5
relative to each array's scale (float32 over 100-200 steps of the same
update order); inertial_init's scale within 1e-3 relative, gravity rotation
within 1e-3, biases within 1e-4 absolute and velocities within 1e-3 of their
scale (a 45-step damped Gauss-Newton in float32: the two packages' solves
round differently from the first step on)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import J, N, T, torch_threads  # noqa: F401
from torch_port_helpers import imu_simulation as simulate
from orbslam3_tpu.ops import imu as jimu
from orbslam3_tpu.ops import imu_init as jinit
from orbslam3_tpu_torch.ops import imu as timu
from orbslam3_tpu_torch.ops import imu_init as tinit

# the JAX side compiled once per static configuration
_jax_init = jax.jit(jinit.inertial_init,
                    static_argnames=("opt_scale", "iters", "prior_g", "prior_a"))
NOISE = dict(noise_gyro=1.7e-4, noise_acc=2e-3, walk_gyro=2e-5, walk_acc=3e-3, freq=200.0)


def _signals(n=100, dt=0.005, seed=0, valid_every=1):
    rng = np.random.default_rng(seed)
    ts = np.arange(n) * dt
    acc = np.stack([[np.sin(3 * t) * 2, np.cos(2 * t), 9.5 + 0.3 * np.sin(t)] for t in ts])
    gyro = np.stack([[0.4 * np.sin(5 * t), -0.2, 0.3 * np.cos(4 * t)] for t in ts])
    acc = (acc + rng.normal(0, 0.01, acc.shape)).astype(np.float32)
    gyro = gyro.astype(np.float32)
    dts = np.full(n, dt, np.float32)
    valid = np.zeros(n, bool)
    valid[::valid_every] = True
    return acc, gyro, dts, valid


def _both(acc, gyro, dts, valid, bg=(0.0, 0.0, 0.0), ba=(0.0, 0.0, 0.0)):
    bg = np.asarray(bg, np.float32)
    ba = np.asarray(ba, np.float32)
    sj = jimu.preintegrate(J(acc), J(gyro), J(dts), J(valid), J(bg), J(ba), **NOISE)
    st = timu.preintegrate(T(acc), T(gyro), T(dts), T(valid), T(bg), T(ba), **NOISE)
    return sj, st


def _close(a, b, rel=1e-5, floor=1e-7):
    a, b = N(a).astype(np.float64), N(b).astype(np.float64)
    scale = max(np.abs(a).max(), floor)
    assert np.abs(a - b).max() <= rel * scale + floor, (np.abs(a - b).max(), scale)


def _state_close(sj, st, rel=1e-5):
    for name in jimu.PreintState._fields:
        _close(getattr(sj, name), getattr(st, name), rel=rel)


@pytest.mark.parametrize("case", ["dense", "masked", "biased"])
def test_preintegrate_matches_jax(case):
    if case == "masked":
        # every third slot invalid: a masked step leaves the state as it was
        acc, gyro, dts, valid = _signals(n=120, valid_every=3)
        sj, st = _both(acc, gyro, dts, valid)
        _, s_valid = _both(acc[valid], gyro[valid], dts[valid], np.ones(valid.sum(), bool))
        for name in timu.PreintState._fields:
            assert torch.equal(getattr(st, name), getattr(s_valid, name)), name
        assert abs(float(st.dT) - 0.005 * valid.sum()) < 1e-6
    else:
        acc, gyro, dts, valid = _signals()
        kw = dict(bg=(0.01, -0.02, 0.015), ba=(0.05, 0.02, -0.04)) if case == "biased" else {}
        sj, st = _both(acc, gyro, dts, valid, **kw)
    _state_close(sj, st)
    # the covariance is PSD in the port too
    C = N(st.C).astype(np.float64)[:9, :9]
    assert np.all(np.linalg.eigvalsh(C) > -1e-12)


def test_compose_corrected_predict_residual_match_jax():
    acc, gyro, dts, valid = _signals(n=100, seed=1)
    sj1, st1 = _both(acc[:60], gyro[:60], dts[:60], valid[:60])
    sj2, st2 = _both(acc[60:], gyro[60:], dts[60:], valid[60:])
    _state_close(jimu.compose(sj1, sj2), timu.compose(st1, st2))
    db_g = np.array([0.01, -0.02, 0.015], np.float32)
    db_a = np.array([0.05, 0.02, -0.04], np.float32)
    for a, b in zip(jimu.corrected_delta(sj1, J(db_g), J(db_a)),
                    timu.corrected_delta(st1, T(db_g), T(db_a))):
        _close(a, b)
    R1 = np.asarray(jnp.eye(3))
    p1 = np.array([0.2, -0.1, 0.4], np.float32)
    v1 = np.array([0.3, -0.1, 0.05], np.float32)
    pj = jimu.predict_state(J(R1), J(p1), J(v1), sj1, J(db_g), J(db_a))
    pt = timu.predict_state(T(R1), T(p1), T(v1), st1, T(db_g), T(db_a))
    for a, b in zip(pj, pt):
        _close(a, b)
    v2 = np.array([0.35, -0.05, 0.1], np.float32)
    rj = jimu.inertial_residual(J(R1), J(p1), J(v1), pj[0], pj[1], J(v2), J(db_g),
                                J(db_a), sj1)
    rt = timu.inertial_residual(T(R1), T(p1), T(v1), pt[0], pt[1], T(v2), T(db_g),
                                T(db_a), st1)
    _close(rj, rt, rel=1e-4, floor=1e-6)
    # at the predicted state the residual vanishes (tests/test_imu.py's check)
    r0 = timu.inertial_residual(T(R1), T(p1), T(v1), *pt, T(db_g), T(db_a), st1)
    assert float(r0.abs().max()) < 1e-4


def _stack(preints, attr):
    return np.stack([np.asarray(getattr(s, attr), np.float32) for s in preints])


@pytest.mark.parametrize("opt_scale", [True, False], ids=["scale_free", "scale_fixed"])
def test_inertial_init_matches_jax(opt_scale):
    R_map, p_map, preints, _, scale_gt, bg_gt, _, _ = simulate(
        scale=0.25 if opt_scale else 1.0)
    Kn = len(R_map)
    names = ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa")
    arrs = [_stack(preints, a) for a in names]
    cov = np.stack([np.asarray(s.C, np.float32)[:9, :9] for s in preints])
    valid = np.ones(Kn - 1, bool)
    kw = dict(opt_scale=opt_scale, iters=40, prior_a=1e2 if opt_scale else 1e5)
    rj = _jax_init(J(R_map), J(p_map), *[J(a) for a in arrs], J(valid), cov=J(cov), **kw)
    rt = tinit.inertial_init(T(R_map), T(p_map), *[T(a) for a in arrs], T(valid),
                             cov=T(cov), **kw)
    assert abs(float(rt.scale) - float(rj.scale)) <= 1e-3 * float(rj.scale)
    assert np.abs(N(rt.Rwg) - N(rj.Rwg)).max() < 1e-3
    assert np.abs(N(rt.bg) - N(rj.bg)).max() < 1e-4
    assert np.abs(N(rt.ba) - N(rj.ba)).max() < 1e-3
    v_scale = np.abs(N(rj.vels)).max()
    assert np.abs(N(rt.vels) - N(rj.vels)).max() < 1e-3 * v_scale
    if opt_scale:
        # and both recover the simulated truth (tests/test_imu_init.py's gate)
        assert abs(float(rt.scale) - scale_gt) / scale_gt < 0.03
        assert np.abs(N(rt.bg) - bg_gt).max() < 2e-3
    else:
        assert float(rt.scale) == 1.0


def test_inertial_init_invalid_pair_keeps_every_pair():
    """One invalid pair makes jnp.median NaN, so the robust cut keeps every
    valid pair (nan → 1e12): the port's median keeps the quirk."""
    R_map, p_map, preints, *_ = simulate(seed=1)
    Kn = len(R_map)
    names = ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa")
    arrs = [_stack(preints, a) for a in names]
    cov = np.stack([np.asarray(s.C, np.float32)[:9, :9] for s in preints])
    valid = np.ones(Kn - 1, bool)
    valid[3] = False
    kw = dict(opt_scale=True, iters=40, prior_a=1e2)
    rj = _jax_init(J(R_map), J(p_map), *[J(a) for a in arrs], J(valid), cov=J(cov), **kw)
    rt = tinit.inertial_init(T(R_map), T(p_map), *[T(a) for a in arrs], T(valid),
                             cov=T(cov), **kw)
    assert abs(float(rt.scale) - float(rj.scale)) <= 1e-3 * float(rj.scale)
    assert np.abs(N(rt.bg) - N(rj.bg)).max() < 1e-4


def test_apply_scaled_rotation_matches_jax():
    rng = np.random.default_rng(1)
    from orbslam3_tpu_torch.ops import lie
    R = torch.stack([lie.so3_exp(T(rng.normal(0, 0.3, 3).astype(np.float32)))
                     for _ in range(5)]).numpy()
    t = rng.normal(0, 1, (5, 3)).astype(np.float32)
    pts = rng.normal(0, 2, (30, 3)).astype(np.float32)
    Rgw = lie.so3_exp(T(np.float32([0.1, -0.05, 0.0]))).numpy()
    oj = jinit.apply_scaled_rotation(J(R), J(t), J(pts), J(Rgw), jnp.float32(2.5))
    ot = tinit.apply_scaled_rotation(T(R), T(t), T(pts), T(Rgw), torch.tensor(2.5))
    for a, b in zip(oj, ot):
        _close(a, b, rel=1e-6)


def test_jitted_reference_is_bit_identical():
    """The JAX package's preintegration and relocalization PnP, which the
    port's module fixture (``torch_port_helpers.jax_host_calls``) runs
    jitted, and the so3_log that the e2e fixtures' IMU streams run jitted,
    give bit for bit what their eager calls give, so the reference runs are
    unchanged."""
    from orbslam3_tpu.ops import lie as jlie
    from torch_port_helpers import jitted
    raw = jimu.preintegrate.__wrapped__            # the fixture's wrapper
    acc, gyro, dts, valid = _signals(n=40, valid_every=3)
    args = (J(acc), J(gyro), J(dts), J(valid), jnp.zeros(3), jnp.full(3, 0.01))
    noise = (1.7e-4, 2e-3, 1e-5, 1e-4, 200.0)
    eager, fast = raw(*args, *noise), jimu.preintegrate(*args, *noise)
    for k in eager._fields:
        assert np.array_equal(np.asarray(getattr(eager, k)), np.asarray(getattr(fast, k))), k
    R = jlie.so3_exp(J(np.random.default_rng(0).normal(0, 1, (64, 3)).astype(np.float32)))
    eager_log = np.asarray(jlie.so3_log(R))
    with jitted(jlie, "so3_log"):
        assert hasattr(jlie.so3_log, "__wrapped__")
        assert np.array_equal(np.asarray(jlie.so3_log(R)), eager_log)
    assert not hasattr(jlie.so3_log, "__wrapped__")
    # relocalization's PnP: RANSAC on host-drawn 6-point sets, then MLPnP
    from orbslam3_tpu.ops import pnp as jpnp
    rng = np.random.default_rng(1)
    xw = rng.uniform([-2, -2, 3], [2, 2, 8], (60, 3)).astype(np.float32)
    rays = np.concatenate([xw[:, :2] / xw[:, 2:] + rng.normal(0, 1e-3, (60, 2)),
                           np.ones((60, 1))], 1).astype(np.float32)
    args = (J(xw), J(rays), jnp.ones(60, bool),
            J(rng.integers(0, 60, (128, 6)).astype(np.int32)), jnp.ones(60, jnp.float32))
    for fn, call in (("pnp_ransac", lambda f: f(*args, focal=458.0)),
                     ("mlpnp_refine", lambda f: f(args[0], args[1], jnp.full(60, 458.0 ** 2),
                                                  args[2], jnp.eye(3), jnp.zeros(3)))):
        wrapped = getattr(jpnp, fn)
        a, b = call(wrapped.__wrapped__), call(wrapped)
        for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            assert np.array_equal(np.asarray(x), np.asarray(y)), fn
