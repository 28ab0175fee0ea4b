"""The multi-stream tracking frontend of the port
(``parallel/frontend_batch.py``) and ``entry.dryrun_multichip`` against the
JAX package's, both on the CPU: JAX's frontend on the conftest's 8 virtual
devices, the port's on ``make_mesh(8, device="cpu")``, one stream per shard.

Two problems at tests/test_frontend_batch.py's sizes (8 streams, 96x128,
128 features over 3 levels, 256 map points): that file's own, on which no
map point passes the viewing-angle gate (its normals face away from the
camera), and one whose map points are each stream's own features at random
depths, seen from a perturbed pose, so that every stream matches and moves.
Every stream is held to JAX's batched frontend within the pose-LM parity
tests' 1e-4 (rotation entries, translation) with equal inlier counts (the
matcher is exact), and to the port's single-stream frame step
(``entry.make_frame_step``) within 1e-6 with equal inlier counts (the batched
pose LM sums in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import features as jfeat
from orbslam3_tpu.parallel import sharded_ba as jsb
from orbslam3_tpu.parallel.frontend_batch import make_batched_frontend as jax_frontend
from orbslam3_tpu_torch.entry import dryrun_multichip, make_frame_step
from orbslam3_tpu_torch.ops import features as tfeat
from orbslam3_tpu_torch.ops import lie as tlie
from orbslam3_tpu_torch.parallel import sharded_ba as tsb
from orbslam3_tpu_torch.parallel.frontend_batch import make_batched_frontend
from torch_port_helpers import N, T, torch_threads  # noqa: F401

S, H, W, N_MP = 8, 96, 128, 256
CFG = dict(n_features=128, n_levels=3)
K_ROW = np.array([100.0, 100.0, 64.0, 48.0], np.float32)


def _reference_problem():
    """tests/test_frontend_batch.py's inputs."""
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, (S, H, W)).astype(np.float32)
    R0 = np.tile(np.eye(3, dtype=np.float32), (S, 1, 1))
    t0 = np.zeros((S, 3), np.float32)
    mp_xyz = rng.uniform([-2, -2, 3], [2, 2, 8], (S, N_MP, 3)).astype(np.float32)
    mp_desc = rng.integers(0, 2 ** 32, (S, N_MP, 8), dtype=np.uint32)
    mp_normal = np.tile(np.array([0, 0, -1.0], np.float32), (S, N_MP, 1))
    mp_valid = np.ones((S, N_MP), bool)
    return imgs, R0, t0, mp_xyz, mp_desc, mp_normal, mp_valid


def _matched_problem():
    """Smooth random images; each stream's map is its own level-0..2
    features back-projected at depths 3-8 from the identity pose, and the
    start pose is ~0.01 rad and ~0.03 off."""
    rng = np.random.default_rng(1)
    box = np.ones(5) / 5
    imgs = []
    for _ in range(S):
        im = rng.uniform(0, 255, (H, W))
        im = np.apply_along_axis(np.convolve, 0, im, box, "same")
        im = np.apply_along_axis(np.convolve, 1, im, box, "same")
        imgs.append(np.clip((im - 127.5) * 3 + 127.5, 0, 255))
    imgs = np.stack(imgs).astype(np.float32)
    cfg = tfeat.OrbConfig(**CFG)
    mp_xyz = np.zeros((S, N_MP, 3), np.float32)
    mp_desc = np.zeros((S, N_MP, 8), np.uint32)
    mp_valid = np.zeros((S, N_MP), bool)
    R0 = np.zeros((S, 3, 3), np.float32)
    t0 = np.zeros((S, 3), np.float32)
    for s in range(S):
        f = tfeat.extract_orb(T(imgs[s]), cfg)
        v = N(f.valid)
        xy, desc = N(f.xy)[v], N(f.desc)[v].view(np.uint32)
        n = min(len(xy), N_MP)
        z = rng.uniform(3, 8, n)
        rays = np.stack([(xy[:n, 0] - K_ROW[2]) / K_ROW[0], (xy[:n, 1] - K_ROW[3]) / K_ROW[1],
                         np.ones(n)], -1)
        mp_xyz[s, :n] = rays * z[:, None]
        mp_desc[s, :n] = desc[:n]
        mp_valid[s, :n] = True
        R0[s] = N(tlie.so3_exp(T(rng.normal(0, 0.01, 3).astype(np.float32))))
        t0[s] = rng.normal(0, 0.03, 3)
    norm = np.maximum(np.linalg.norm(mp_xyz, axis=-1, keepdims=True), 1e-9)
    return imgs, R0, t0, mp_xyz, mp_desc, (mp_xyz / norm).astype(np.float32), mp_valid


@functools.lru_cache(maxsize=1)
def _jax_step():
    """JAX's batched frontend, built once for the module so that both
    problems run one compiled program."""
    return jax_frontend(jsb.make_mesh(S), H, W, jfeat.OrbConfig(**CFG), N_MP)


@pytest.mark.parametrize("make,min_inliers", [(_reference_problem, 0), (_matched_problem, 40)])
def test_batched_frontend_matches_reference_and_single_stream(make, min_inliers):
    imgs, R0, t0, mp_xyz, mp_desc, mp_normal, mp_valid = make()
    args = (imgs, R0, t0, mp_xyz, mp_desc, mp_normal,
            np.full((S, N_MP), 0.1, np.float32), np.full((S, N_MP), 50.0, np.float32),
            mp_valid, np.tile(K_ROW, (S, 1)))
    jR, jt, jn = _jax_step()(*[jnp.asarray(a) for a in args])
    targs = [T(a) for a in args]
    cfg = tfeat.OrbConfig(**CFG)
    R, t, n = make_batched_frontend(tsb.make_mesh(S, device="cpu"), H, W, cfg, N_MP)(*targs)
    assert R.shape == (S, 3, 3) and t.shape == (S, 3) and n.shape == (S,)
    np.testing.assert_allclose(N(R), np.asarray(jR), rtol=0, atol=1e-4)
    np.testing.assert_allclose(N(t), np.asarray(jt), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(N(n), np.asarray(jn))
    assert N(n).min() >= min_inliers
    if min_inliers:
        assert np.abs(N(t) - t0).max(axis=1).min() > 1e-3       # every stream moved
    single = make_frame_step(H, W, cfg, "cpu")
    for s in range(S):
        Rs, ts, ns = single(*[a[s] for a in targs])
        np.testing.assert_allclose(N(R[s]), N(Rs), rtol=0, atol=1e-6)
        np.testing.assert_allclose(N(t[s]), N(ts), rtol=0, atol=1e-6)
        assert int(n[s]) == int(ns)


def test_dryrun_multichip_on_logical_cpu_shards():
    out = dryrun_multichip(S, device="cpu")
    assert out == {"mesh": ["cpu"] * S, "logical": True, "inliers": out["inliers"],
                   "streams": S}
    assert out["inliers"] > 0.9 * 4 * 16 * S          # 4 keyframes x 16 points per shard
