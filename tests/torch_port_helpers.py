"""Shared helpers for the parity tests of the PyTorch port (tests/test_torch_*.py).

Every test makes its inputs with numpy from a seed and hands the same arrays
to the JAX function and to its torch counterpart, both on the CPU. Descriptors
cross the boundary as uint32 words for JAX and their int32 bit patterns
(``.view(np.int32)``) for the port.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu_torch.utils.loop_scenes import build_drifted_map  # noqa: F401

N_FEATURES = 512


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """Two intra-op threads per worker: tier-1 runs six workers on eight
    cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def T(a, dtype=None) -> torch.Tensor:
    """numpy → CPU torch tensor (uint32 words become int32 bit patterns)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(np.array(a, copy=True), dtype=dtype)


def J(a):
    """numpy → jax array."""
    return jnp.asarray(np.asarray(a))


def N(x) -> np.ndarray:
    """torch or jax array → numpy (int32 bit patterns stay int32)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_i32(x) -> np.ndarray:
    a = N(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def random_pose(rng, rot_scale=0.2, t_scale=0.3):
    """(R, t) world→camera, a moderate rotation and translation, float32."""
    from orbslam3_tpu_torch.ops import lie
    w = rng.normal(0, rot_scale, 3).astype(np.float32)
    R = lie.so3_exp(torch.as_tensor(w)).numpy()
    t = rng.normal(0, t_scale, 3).astype(np.float32)
    return R, t


@functools.lru_cache(maxsize=None)
def room_frames(n_frames: int = 8, n_features: int = N_FEATURES):
    """Rendered RoomScene(seed=1) orbit frames with depth, their JAX ORB
    features (numpy) and poses: the shared real-image input of the kernel
    parity tests."""
    from orbslam3_tpu.ops import features as jf
    from orbslam3_tpu.utils.datasets import RoomScene, orbit_trajectory
    scene = RoomScene(seed=1)
    poses = orbit_trajectory(n_frames, radius=1.0, forward=0.04)
    cfg = jf.OrbConfig(n_features=n_features)
    extract = jax.jit(lambda im: jf.extract_orb(im, cfg))
    frames = []
    for R, t in poses:
        img, depth = scene.render(R, t, return_depth=True)
        f = extract(jnp.asarray(img))
        frames.append(dict(img=img, depth=depth, R=R.astype(np.float32),
                           t=t.astype(np.float32),
                           **{k: np.asarray(getattr(f, k)) for k in f._fields}))
    return scene, frames


def build_reference_map(frames, n_kf: int = 2, stride: int = 1):
    """A JAX-package MapState built from the first ``n_kf`` rendered frames:
    one keyframe each, map points back-projected from the true depth at every
    ``stride``-th valid keypoint of the first keyframe and observed by every
    keyframe that re-finds them (nearest keypoint within 2 px); the other
    keypoints stay free for triangulation. Returns the map."""
    from orbslam3_tpu.models.map import MapConfig, MapState
    f0 = frames[0]
    cap = len(f0["valid"])
    m = MapState(MapConfig(n_features=cap, max_keyframes=64, max_map_points=8192))
    kfs = [m.add_keyframe(f["R"], f["t"], 0.05 * i, i, f["xy"], f["angle"], f["octave"],
                          f["desc"], f["valid"]) for i, f in enumerate(frames[:n_kf])]
    xy = f0["xy"]
    ij = np.clip(np.round(xy).astype(int), 0, [f0["depth"].shape[1] - 1,
                                                 f0["depth"].shape[0] - 1])
    z = f0["depth"][ij[:, 1], ij[:, 0]]
    sel = np.nonzero(f0["valid"] & (z > 0.3))[0][::stride]
    K = np.array([458.654, 457.296, 376.0, 240.0], np.float32)
    rays = np.stack([(xy[sel, 0] - K[2]) / K[0], (xy[sel, 1] - K[3]) / K[1],
                     np.ones(len(sel))], -1)
    xc = rays * z[sel, None]
    xw = ((xc - f0["t"]) @ f0["R"]).astype(np.float32)
    c0 = -f0["R"].T @ f0["t"]
    d = xw - c0
    dist = np.linalg.norm(d, axis=1)
    sf = m.scale_factors
    maxd = dist * sf[f0["octave"][sel]]
    ids = m.add_map_points(xw, f0["desc"][sel], kfs[0], d / dist[:, None],
                           maxd / sf[-1], maxd, first_kf=kfs[0])
    m.kf_feat_mp[kfs[0], sel] = ids
    for k, f in zip(kfs[1:], frames[1:n_kf]):
        xc = xw @ f["R"].T + f["t"]
        uv = np.stack([K[0] * xc[:, 0] / xc[:, 2] + K[2],
                       K[1] * xc[:, 1] / xc[:, 2] + K[3]], -1)
        dd = np.abs(uv[:, None, :] - f["xy"][None]).max(-1)
        dd[:, ~f["valid"]] = 1e9
        j = dd.argmin(1)
        ok = dd[np.arange(len(j)), j] < 2.0
        _, first = np.unique(j[ok], return_index=True)
        keep = np.nonzero(ok)[0][first]
        m.kf_feat_mp[k, j[keep]] = ids[keep]
    m.refresh_map_points(ids)
    return m
