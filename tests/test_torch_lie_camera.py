"""ops/lie.py and ops/camera.py: the port against the JAX package on the same
float32 inputs.

Tolerance: rtol = atol = 1e-5 (a few float32 ulps of O(1) quantities: the
two libraries evaluate sin/cos/arccos/atan2 with different polynomial
kernels and sum in different orders). Pixel outputs (O(100)) use rtol 1e-5.
"""
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import camera as jcam
from orbslam3_tpu.ops import lie as jlie
from orbslam3_tpu_torch.ops import camera as tcam
from orbslam3_tpu_torch.ops import lie as tlie
from torch_port_helpers import J, N, T, torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _rot_vectors(rng, n=64):
    w = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    w[:4] *= 1e-6                                  # Taylor branches
    w[4:8] = w[4:8] / np.linalg.norm(w[4:8], axis=1, keepdims=True) * 3.12  # near pi
    return w


@pytest.mark.parametrize("fn", ["hat", "so3_exp", "so3_right_jacobian",
                                "so3_right_jacobian_inv", "mat_from_quat"])
def test_unary_maps(fn):
    rng = np.random.default_rng(0)
    x = _rot_vectors(rng)
    if fn == "mat_from_quat":
        x = rng.normal(size=(64, 4)).astype(np.float32)
    np.testing.assert_allclose(N(getattr(tlie, fn)(T(x))), N(getattr(jlie, fn)(J(x))), **TOL)


def test_so3_log_and_quaternion_roundtrip():
    rng = np.random.default_rng(1)
    R = np.asarray(jlie.so3_exp(J(_rot_vectors(rng))))
    np.testing.assert_allclose(N(tlie.so3_log(T(R))), N(jlie.so3_log(J(R))), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(N(tlie.quat_from_mat(T(R))) ** 2,
                               N(jlie.quat_from_mat(J(R))) ** 2, **TOL)
    np.testing.assert_allclose(N(tlie.normalize_rotation(T(R))),
                               N(jlie.normalize_rotation(J(R))), rtol=1e-4, atol=1e-4)


def test_se3_and_sim3():
    rng = np.random.default_rng(2)
    xi = rng.normal(0, 0.5, (32, 6)).astype(np.float32)
    xi[:2] *= 1e-6
    R, t = tlie.se3_exp(T(xi))
    Rj, tj = jlie.se3_exp(J(xi))
    np.testing.assert_allclose(N(R), N(Rj), **TOL)
    np.testing.assert_allclose(N(t), N(tj), **TOL)
    np.testing.assert_allclose(N(tlie.se3_log(R, t)), N(jlie.se3_log(Rj, tj)), rtol=1e-4, atol=1e-4)
    x = rng.normal(size=(32, 3)).astype(np.float32)
    np.testing.assert_allclose(N(tlie.se3_apply(R, t, T(x))), N(jlie.se3_apply(Rj, tj, J(x))), **TOL)
    Ri, ti = tlie.se3_inverse(R, t)
    Rij, tij = jlie.se3_inverse(Rj, tj)
    np.testing.assert_allclose(N(ti), N(tij), **TOL)
    xs = rng.normal(0, 0.3, (32, 7)).astype(np.float32)
    xs[:3, 6] = 0.0                                 # sigma → 0 branch
    s, Rs, ts = tlie.sim3_exp(T(xs))
    sj, Rsj, tsj = jlie.sim3_exp(J(xs))
    for a, b in ((s, sj), (Rs, Rsj), (ts, tsj)):
        np.testing.assert_allclose(N(a), N(b), **TOL)
    np.testing.assert_allclose(N(tlie.sim3_log(s, Rs, ts)), N(jlie.sim3_log(sj, Rsj, tsj)),
                               rtol=1e-3, atol=1e-3)


def test_pinhole_and_radtan():
    rng = np.random.default_rng(3)
    K = np.array([458.654, 457.296, 367.215, 248.375], np.float32)
    D = np.array([-0.283, 0.0739, 0.0002, 1.76e-05, 0.0], np.float32)
    xc = np.concatenate([rng.uniform(-2, 2, (64, 2)), rng.uniform(1, 8, (64, 1))], 1).astype(np.float32)
    np.testing.assert_allclose(N(tcam.pinhole_project(T(K), T(xc))),
                               N(jcam.pinhole_project(J(K), J(xc))), rtol=1e-5)
    np.testing.assert_allclose(N(tcam.pinhole_project_jac(T(K), T(xc))),
                               N(jcam.pinhole_project_jac(J(K), J(xc))), rtol=1e-5, atol=1e-4)
    uv = rng.uniform([0, 0], [752, 480], (64, 2)).astype(np.float32)
    np.testing.assert_allclose(N(tcam.pinhole_unproject(T(K), T(uv))),
                               N(jcam.pinhole_unproject(J(K), J(uv))), **TOL)
    np.testing.assert_allclose(N(tcam.pinhole_undistort_pixels(T(K), T(D), T(uv))),
                               N(jcam.pinhole_undistort_pixels(J(K), J(D), J(uv))), rtol=1e-5)
    xn = rng.uniform(-0.6, 0.6, (64, 2)).astype(np.float32)
    np.testing.assert_allclose(N(tcam.radtan_distort(T(D), T(xn))),
                               N(jcam.radtan_distort(J(D), J(xn))), **TOL)


def test_kb8():
    rng = np.random.default_rng(4)
    P = np.array([190.98, 190.97, 254.93, 256.90, 0.0034, 0.0008, -0.0012, 0.0002], np.float32)
    xc = np.concatenate([rng.uniform(-2, 2, (64, 2)), rng.uniform(0.5, 4, (64, 1))], 1).astype(np.float32)
    np.testing.assert_allclose(N(tcam.kb8_project(T(P), T(xc))), N(jcam.kb8_project(J(P), J(xc))),
                               rtol=1e-5)
    np.testing.assert_allclose(N(tcam.kb8_project_jac(T(P), T(xc))),
                               N(jcam.kb8_project_jac(J(P), J(xc))), rtol=1e-4, atol=1e-3)
    uv = rng.uniform([0, 0], [512, 512], (64, 2)).astype(np.float32)
    np.testing.assert_allclose(N(tcam.kb8_unproject(T(P), T(uv))),
                               N(jcam.kb8_unproject(J(P), J(uv))), rtol=1e-4, atol=1e-4)
