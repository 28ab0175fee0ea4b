"""Shared helpers for the parity tests of the PyTorch port (tests/test_torch_*.py).

Every test makes its inputs with numpy from a seed and hands the same arrays
to the JAX function and to its torch counterpart, both on the CPU. Descriptors
cross the boundary as uint32 words for JAX and their int32 bit patterns
(``.view(np.int32)``) for the port.
"""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu_torch.utils.loop_scenes import build_drifted_map  # noqa: F401

N_FEATURES = 512


@contextlib.contextmanager
def jitted(module, name: str, **jit_kw):
    """``module.name`` replaced by ``jax.jit`` of itself for the duration
    (the JAX package's files are untouched). For functions that the JAX
    package calls eagerly from host code with stable shapes: the eager call
    traces and compiles on every call, the jitted one once per shape
    (``jax_host_calls`` says what each gives)."""
    orig = getattr(module, name)
    setattr(module, name, jax.jit(orig, **jit_kw))
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def shared_jax_extractors():
    """The JAX package's ``features.make_extractor`` returns a new jitted
    function per tracker, so every JAX system of a module compiles the same
    extractor again; for the duration, systems of one image size and
    configuration share one (the same program: the results are the same).
    Intrinsics only matter with a distortion to undo."""
    from orbslam3_tpu.ops import features
    orig = features.make_extractor
    cache = {}

    def make_extractor(h, w, cfg, K=None, D=None):
        key = (int(h), int(w), cfg,
               None if D is None else tuple(np.asarray(K, np.float32).ravel()),
               None if D is None else tuple(np.asarray(D, np.float32).ravel()))
        if key not in cache:
            cache[key] = orig(h, w, cfg, K=K, D=D)
        return cache[key]

    features.make_extractor = make_extractor
    try:
        yield
    finally:
        features.make_extractor = orig


def jax_host_calls():
    """The JAX package's functions that its tracker and mapper call eagerly
    from host code, jitted (``jitted``): the IMU preintegration once per
    frame (0.8 s a call on the CPU, a new trace of its scan each time),
    relocalization's PnP RANSAC and MLPnP refinement once per candidate
    (1.5-5.6 s and 1.5-1.9 s a call eager, 0.3-0.5 s and 1.0-1.2 s jitted),
    which all three give bit-identical results jitted
    (``test_torch_imu.py::test_jitted_reference_is_bit_identical``), and the
    inertial-only initialization once per IMU init attempt (14 s a solve
    eager, 6 s jitted; within 1e-6 of its eager result, the jitted form
    ``test_torch_imu.py`` holds the port against). Also one extractor per
    configuration (``shared_jax_extractors``)."""
    from orbslam3_tpu.ops import imu, imu_init, pnp
    stack = contextlib.ExitStack()
    stack.enter_context(jitted(imu, "preintegrate", static_argnums=(6, 7, 8, 9, 10)))
    stack.enter_context(jitted(pnp, "pnp_ransac",
                               static_argnames=("chi2_th", "focal", "min_inliers")))
    stack.enter_context(jitted(pnp, "mlpnp_refine", static_argnames=("iters",)))
    stack.enter_context(jitted(imu_init, "inertial_init",
                               static_argnames=("opt_scale", "iters", "prior_g", "prior_a")))
    stack.enter_context(shared_jax_extractors())
    return stack


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """Two intra-op threads per worker: tier-1 runs six workers on eight
    cores. For the module's duration the JAX package's eager host calls run
    jitted (``jax_host_calls``)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with jax_host_calls():
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


def render_all(scene, views, threads: int = 3) -> list:
    """``scene.render(R, t[, return_depth=True])`` for each ``(R, t)`` or
    ``(R, t, True)`` in ``views``, in order, on ``threads`` threads (numpy
    releases the interpreter lock in the renderer's array operations; each
    view is computed exactly as alone). The first view renders alone: it
    fills the scene's ray cache."""
    from concurrent.futures import ThreadPoolExecutor

    def one(v):
        return scene.render(v[0], v[1], return_depth=bool(v[2]) if len(v) > 2 else False)
    if not views:
        return []
    first = one(views[0])
    with ThreadPoolExecutor(threads) as ex:
        return [first] + list(ex.map(one, views[1:]))


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
    extract = jf.make_extractor(scene.h, scene.w, cfg)
    frames = []
    for (R, t), (img, depth) in zip(poses, render_all(scene, [(R, t, True) for R, t in poses])):
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


# ---------------------------------------------------------------------------
# the KB8 fisheye camera end to end (test_torch_e2e_fisheye{,_mono}.py)
# ---------------------------------------------------------------------------
KB8 = np.asarray([190.978, 190.973, 256.0, 256.0,
                  0.00348, 0.000715, -0.00205, 0.000202], np.float32)
FISHEYE_ORBIT = 24      # tests/test_e2e_fisheye.py's orbits
FISHEYE_FRAMES = 16     # of which both packages track the first 16
ERROR_COUNTS = ("mapper_errors", "lc_errors", "gba_errors", "reloc_query_errors",
                "merge_errors")


def fisheye_runs(kind: str) -> dict:
    """tests/test_e2e_fisheye.py's ``rig`` (two-camera KB8 rig, seed 8, orbit
    of radius 0.5, metric ATE) or ``mono`` (seed 6, radius 0.6, scale-aligned
    ATE) run at its settings (512x512, 512 features, dense_tracking_params(),
    cam_type=1, loop closing off) through both packages on the same rendered
    first ``FISHEYE_FRAMES`` frames. Returns {"kind", "jax": record, "torch":
    record}."""
    from conftest import dense_tracking_params
    from orbslam3_tpu.models.system import SlamSystem as JaxSlam
    from orbslam3_tpu.ops import lie as jlie
    from orbslam3_tpu.utils.datasets import RoomScene, orbit_trajectory
    from orbslam3_tpu.utils.evaluation import evaluate_trajectory
    from orbslam3_tpu_torch.models.system import SlamSystem
    from orbslam3_tpu_torch.models.tracking import TrackingParams
    from orbslam3_tpu_torch.utils.convert import config_from
    rig = kind == "rig"
    scene = RoomScene(seed=8 if rig else 6, depth=6.0, half_w=4.0, half_h=2.5,
                      h=512, w=512, fx=190.978, fy=190.973, cx=256.0, cy=256.0)
    scene.kb8_params = KB8
    poses = orbit_trajectory(FISHEYE_ORBIT, radius=0.5 if rig else 0.6,
                             forward=0.03)[:FISHEYE_FRAMES]
    R_rl = np.asarray(jlie.so3_exp(J(np.float32([0.0, 0.008, 0.0]))))
    t_rl = np.array([-0.101, 0.0, 0.0], np.float32)
    views = [(R, t) for R, t in poses]
    if rig:
        views += [(R_rl @ R, R_rl @ t + t_rl) for R, t in poses]
    imgs = render_all(scene, views)
    n = len(poses)
    frames = [(imgs[i], imgs[n + i] if rig else None) for i in range(n)]
    gt = np.array([-R.T @ t for R, t in poses])
    jparams = dense_tracking_params()
    kw = dict(n_features=512, seed=0, cam_type=1, enable_loop_closing=False)
    out = {"kind": kind}
    for name, system in (
            ("jax", JaxSlam(KB8, None, (512, 512), tracking_params=jparams, **kw)),
            ("torch", SlamSystem(KB8, None, (512, 512), device="cpu",
                                 tracking_params=config_from(jparams, TrackingParams), **kw))):
        if rig:
            system.set_fisheye_rig(KB8, R_rl, t_rl, lap_l=(0.0, 511.0), lap_r=(0.0, 511.0))
        states, n_depth = [], []
        for i, (img, img_r) in enumerate(frames):
            if rig:
                system.track_stereo_fisheye(img, img_r, ts=i / 20.0)
                n_depth.append(int((system.tracker.last_frame.depth > 0).sum()))
            else:
                system.track_monocular(img, ts=i / 20.0)
            states.append(system.state.name)
        ts, _, t_wc, lost = system.export_trajectory()
        sel = ~lost
        ate, n = evaluate_trajectory(np.arange(FISHEYE_FRAMES) / 20.0, gt, ts[sel], t_wc[sel],
                                     with_scale=not rig)
        out[name] = dict(system=system, states=states, ate=ate, n_assoc=n,
                         n_tracked=int(sel.sum()), n_depth=n_depth, stats=system.stats())
    return out


def check_fisheye_tracking(runs):
    j, t = runs["jax"], runs["torch"]
    assert t["states"][-1] == "OK", t["states"]
    assert t["n_tracked"] >= j["n_tracked"] - 2, (t["states"], j["states"])
    assert t["n_assoc"] > 0.6 * FISHEYE_FRAMES


def check_fisheye_ate(runs):
    j, t = runs["jax"], runs["torch"]
    assert t["ate"] <= max(1.5 * j["ate"], j["ate"] + 0.02), (runs["kind"], t["ate"], j["ate"])


def check_fisheye_errors_and_rig(runs):
    t = runs["torch"]
    for key in ERROR_COUNTS:
        assert t["stats"].get(key, 0) == 0, (key, t["stats"].get("last_" + key[:-1]))
    tr = t["system"].tracker
    assert tr.cam_type == 1 and t["system"].mapper.cam_type == 1
    if runs["kind"] == "rig":
        assert tr.rig is not None and t["system"].mapper.rig is tr.rig
        assert tr.bf == pytest.approx(0.101 * 190.978, rel=1e-6)
        assert min(t["n_depth"]) >= 50, t["n_depth"]


# ---------------------------------------------------------------------------
# stereo and RGB-D end to end (test_torch_e2e_stereo*.py, test_torch_e2e_kf_policy.py)
# ---------------------------------------------------------------------------
DEPTH_RIG_FRAMES = 14   # tests/test_e2e_stereo.py's orbits
DEPTH_RIG_BASELINE = 0.11


@functools.lru_cache(maxsize=None)
def depth_rig_inputs(kind: str, n_frames: int = DEPTH_RIG_FRAMES):
    """tests/test_e2e_stereo.py's fixtures: RoomScene(seed=2) with the right
    eye from scene.stereo_pose (``stereo``) or RoomScene(seed=3) with the
    renderer's depth (``rgbd``), along orbit_trajectory(n_frames, radius=0.6,
    forward=0.03) (14 frames in that file). Returns (scene, ground-truth
    centres, frames)."""
    from orbslam3_tpu.utils.datasets import RoomScene, orbit_trajectory
    scene = RoomScene(seed=2 if kind == "stereo" else 3, depth=6.0, half_w=4.0, half_h=2.5)
    poses = orbit_trajectory(n_frames, radius=0.6, forward=0.03)
    if kind == "stereo":
        views = [(R, t) for R, t in poses]
        views += [scene.stereo_pose(R, t, DEPTH_RIG_BASELINE) for R, t in poses]
        imgs = render_all(scene, views)
        frames = list(zip(imgs[:len(poses)], imgs[len(poses):]))
    else:
        frames = render_all(scene, [(R, t, True) for R, t in poses])
    return scene, np.array([-R.T @ t for R, t in poses]), frames


def depth_rig_runs(kind: str, th_depth_baselines: float = 40.0, **params) -> dict:
    """One of ``depth_rig_inputs``' walks through both packages: 512 features,
    bf = 0.11·fx, th_depth = 0.11·``th_depth_baselines``, loop closing on (the
    default), sync mapping, ``dense_tracking_params(**params)``. The state after each frame
    is read from the tracker, which does not flush a software pipeline, and
    the frames still in flight after the last one are counted before the
    export flushes them. Returns {"kind", "params", "jax": record, "torch":
    record}."""
    from conftest import dense_tracking_params
    from orbslam3_tpu.models.system import SlamSystem as JaxSlam
    from orbslam3_tpu.utils.evaluation import evaluate_trajectory
    from orbslam3_tpu_torch.models.system import SlamSystem
    from orbslam3_tpu_torch.models.tracking import TrackingParams
    from orbslam3_tpu_torch.utils.convert import config_from
    scene, gt, frames = depth_rig_inputs(kind)
    kw = dict(n_features=512, seed=0, bf=DEPTH_RIG_BASELINE * scene.fx,
              th_depth=DEPTH_RIG_BASELINE * th_depth_baselines)
    jparams = dense_tracking_params(**params)
    out = {"kind": kind, "params": params}
    for name, system in (
            ("jax", JaxSlam(scene.K, None, (scene.w, scene.h), tracking_params=jparams, **kw)),
            ("torch", SlamSystem(scene.K, None, (scene.w, scene.h),
                                 tracking_params=config_from(jparams, TrackingParams),
                                 device="cpu", **kw))):
        states = []
        for i, (a, b) in enumerate(frames):
            if kind == "stereo":
                system.track_stereo(a, b, ts=float(i) / 20.0)
            else:
                system.track_rgbd(a, b, ts=float(i) / 20.0)
            states.append(system.tracker.state.name)
        in_flight = len(system.tracker._pending)
        ts, _, t_wc, lost = system.export_trajectory()
        ate, n = evaluate_trajectory(np.arange(DEPTH_RIG_FRAMES) / 20.0, gt, ts[~lost],
                                     t_wc[~lost], with_scale=False)
        out[name] = dict(system=system, states=states, ate=ate, n_assoc=n,
                         in_flight=in_flight, paths=dict(system.tracker.path_counts),
                         stats=system.stats())
    return out


def check_depth_rig_init(runs):
    """Both packages initialize on frame 0 (stereo initialization needs one
    frame) and the port tracks every frame after the second."""
    sj, st = runs["jax"]["states"], runs["torch"]["states"]
    assert sj.index("OK") == st.index("OK") == 0, (sj, st)
    assert all(s == "OK" for s in st[2:]), st


def check_depth_rig_ate(runs):
    """Metric ATE (no scale alignment: a rig with depth is metric) no worse
    than max(1.5 x JAX, JAX + 0.02)."""
    j, t = runs["jax"], runs["torch"]
    assert t["n_assoc"] > 0.8 * DEPTH_RIG_FRAMES
    assert t["ate"] <= max(1.5 * j["ate"], j["ate"] + 0.02), (runs, t["ate"], j["ate"])


def check_depth_rig_keyframes_and_errors(runs):
    """Keyframe counts within ±2 (float32 rounding moves matches and culling
    decisions, not the accuracy class), every thread and query error count
    0, close points spawned, the loop closer at fixed scale."""
    j, t = runs["jax"]["stats"], runs["torch"]["stats"]
    assert abs(t["n_keyframes"] - j["n_keyframes"]) <= 2, (t["n_keyframes"], j["n_keyframes"])
    for key in ERROR_COUNTS:
        assert t.get(key, 0) == 0, (key, t.get("last_" + key[:-1]))
    assert t["n_map_points"] > 0
    system = runs["torch"]["system"]
    assert system.tracker.bf > 0 and system.loop_closer.fix_scale


# ---------------------------------------------------------------------------
# the inertial solvers (test_torch_imu.py, test_torch_vi_ba.py)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def imu_simulation(n_kf=10, kf_dt=0.25, hz=200, scale=0.25, g_tilt=(0.06, -0.04),
                   bg=(0.004, -0.003, 0.002), ba=(0.03, -0.02, 0.05), seed=0):
    """tests/test_imu_init.py::simulate's trajectory, IMU stream and keyframe
    preintegrations (the JAX package's), with its so3 maps evaluated over the
    whole stream in one call each instead of one call per sample. Returns
    simulate's tuple: (R_map, p_map, preints, Rwg, scale, bg, ba, v at the
    keyframes)."""
    from orbslam3_tpu.ops import imu as imu_ops
    from orbslam3_tpu.ops import lie
    Rwg = np.asarray(lie.so3_exp(jnp.asarray([g_tilt[0], g_tilt[1], 0.0], jnp.float32)))
    g_true = Rwg @ np.array([0, 0, -imu_ops.GRAVITY])
    dt = 1.0 / hz
    n_steps = int(n_kf * kf_dt * hz)
    ts = np.arange(n_steps + 1) * dt
    p = np.stack([0.8 * np.sin(1.1 * ts), 0.5 * np.sin(0.9 * ts + 1),
                  0.3 * np.sin(0.7 * ts)], -1)
    v = np.gradient(p, dt, axis=0)
    a_w = np.gradient(v, dt, axis=0)
    w = np.stack([0.2 * np.sin(0.5 * ts), 0.15 * ts * 0.1, 0.3 * np.sin(0.3 * ts)], -1)
    R_wb = np.asarray(lie.so3_exp(jnp.asarray(w, jnp.float32)))
    dRm = np.einsum("nji,njk->nik", R_wb[:-1], R_wb[1:])
    gyro = np.asarray(lie.so3_log(jnp.asarray(dRm))).astype(np.float64) / dt
    acc = np.einsum("nji,nj->ni", R_wb[:-1], (a_w[:-1] - g_true))
    gyro_m = gyro + np.asarray(bg)
    acc_m = acc + np.asarray(ba)
    per = int(kf_dt * hz)
    kf_idx = np.arange(0, n_steps + 1, per)[:n_kf]
    preints = []
    pre_fn = jax.jit(imu_ops.preintegrate, static_argnums=(6, 7, 8, 9, 10))
    for i in range(len(kf_idx) - 1):
        s0, s1 = kf_idx[i], kf_idx[i + 1]
        preints.append(pre_fn(
            jnp.asarray(acc_m[s0:s1], jnp.float32), jnp.asarray(gyro_m[s0:s1], jnp.float32),
            jnp.full(s1 - s0, dt, jnp.float32), jnp.ones(s1 - s0, bool),
            jnp.zeros(3), jnp.zeros(3), 1.7e-4, 2e-3, 1e-6, 1e-5, hz))
    p_map = (p[kf_idx] @ Rwg) / scale
    R_map = np.einsum("ij,kjl->kil", Rwg.T, R_wb[kf_idx])
    return (R_map.astype(np.float32), p_map.astype(np.float32), preints, Rwg, scale,
            np.asarray(bg), np.asarray(ba), v[kf_idx])


# ---------------------------------------------------------------------------
# stereo-inertial end to end (test_torch_e2e_stereo_inertial.py)
# ---------------------------------------------------------------------------
SI_SYNC_FRAMES = 36      # tests/test_e2e_stereo_inertial.py's run
SI_PIPE_FRAMES = 11      # then pipelined, on the IMU-initialized map


def stereo_inertial_runs() -> dict:
    """tests/test_e2e_stereo_inertial.py's fixture (RoomScene(seed=2), the
    0.6-radius forward orbit, stereo baseline 0.11 with bf = 0.11·fx, a
    200 Hz IMU stream with gravity along the world's +y, 512 features,
    dense_tracking_params(), loop closing off, sync mapping) through both
    packages: its 36 frames with the tracker's pipeline off, then
    ``SI_PIPE_FRAMES`` more with the pipeline on (TrackingParams.pipeline is
    read per frame), so that the IMU-initialized frames ride the fused
    visual-inertial step. Returns {"jax": record, "torch": record}; a
    record holds the system, the per-frame states and IMU flags, the
    IMU-init frame, the metric ATE over the first 36 frames and over all,
    and the tracker's path counts after each part."""
    import test_e2e_stereo_inertial as fx
    from conftest import dense_tracking_params
    from orbslam3_tpu.models.system import SlamSystem as JaxSlam
    from orbslam3_tpu.utils.datasets import RoomScene
    from orbslam3_tpu.utils.evaluation import evaluate_trajectory
    from orbslam3_tpu_torch.models.system import SlamSystem
    from orbslam3_tpu_torch.models.tracking import TrackingParams
    from orbslam3_tpu_torch.utils.convert import config_from
    from orbslam3_tpu.ops import lie
    n_total = SI_SYNC_FRAMES + SI_PIPE_FRAMES
    scene = RoomScene(seed=2, depth=6.0, half_w=4.0, half_h=2.5)
    with jitted(lie, "so3_log"):          # make_imu's one eager call per sample
        imu_ts, gyro, acc = fx.make_imu(n_total)
    per = fx.IMU_HZ // int(fx.FPS)
    poses = [fx.pose_at(i) for i in range(n_total)]
    imgs = render_all(scene, poses + [scene.stereo_pose(R, t, fx.BASELINE) for R, t in poses])
    frames = list(zip(imgs[:n_total], imgs[n_total:]))
    gt = np.array([-R.T @ t for R, t in poses])
    kw = dict(n_features=512, seed=0, bf=fx.BASELINE * scene.fx, th_depth=fx.BASELINE * 40,
              enable_loop_closing=False)
    jparams = dense_tracking_params()
    out = {}
    for name, system in (
            ("jax", JaxSlam(scene.K, None, (scene.w, scene.h), tracking_params=jparams, **kw)),
            ("torch", SlamSystem(scene.K, None, (scene.w, scene.h), device="cpu",
                                 tracking_params=config_from(jparams, TrackingParams), **kw))):
        system.enable_imu(freq=fx.IMU_HZ)
        rec = dict(system=system, states=[], imu=[])
        for i, (a, b) in enumerate(frames):
            if i == SI_SYNC_FRAMES:
                ts, _, t_wc, lost = system.export_trajectory()
                rec["ate_sync"], rec["n_sync"] = evaluate_trajectory(
                    np.arange(i) / fx.FPS, gt[:i], ts[~lost], t_wc[~lost], with_scale=False)
                rec["paths_sync"] = dict(system.tracker.path_counts)
                system.tracker.p.pipeline = True
            s0, s1 = (i - 1) * per, i * per
            if i == 0:
                s0 = s1 = 0
            system.track_stereo_inertial(a, b, ts=i / fx.FPS, imu_ts=imu_ts[s0:s1],
                                         imu_gyro=gyro[s0:s1], imu_acc=acc[s0:s1])
            rec["states"].append(system.tracker.state.name)
            rec["imu"].append(bool(system.tracker.imu_initialized))
        ts, _, t_wc, lost = system.export_trajectory()
        rec["ate"], rec["n_assoc"] = evaluate_trajectory(
            np.arange(n_total) / fx.FPS, gt, ts[~lost], t_wc[~lost], with_scale=False)
        rec["init_frame"] = rec["imu"].index(True) if any(rec["imu"]) else None
        rec["paths"] = dict(system.tracker.path_counts)
        rec["stats"] = system.stats()
        out[name] = rec
    return out


def jax_map_from_arrays(arrays: dict, cfg):
    """A JAX-package ``MapState`` holding copies of a map's arrays and
    counters (the reverse of ``utils.convert.map_state_from_arrays``)."""
    from orbslam3_tpu.models import map as jmap
    from orbslam3_tpu_torch.utils.convert import config_from
    if not isinstance(cfg, jmap.MapConfig):
        cfg = config_from(cfg, jmap.MapConfig)
    m = jmap.MapState(cfg, map_id=int(arrays.get("map_id", 0)))
    for name, val in arrays.items():
        if isinstance(val, np.ndarray):
            setattr(m, name, val.copy())
        elif name in ("n_kf", "n_mp", "remap_epoch", "n_compactions", "n_grows",
                      "device_version"):
            setattr(m, name, int(val))
    return m


# ---------------------------------------------------------------------------
# monocular-inertial end to end (test_torch_e2e_mono_inertial.py)
# ---------------------------------------------------------------------------
MI_FRAMES = 61          # see test_torch_e2e_mono_inertial.py for the cut
MI_HANDOFF = 52         # the JAX package's state after this many frames goes to the port
MI_INERTIAL_KEYS = ("preint_since_kf", "frame_preint", "_frame_preint_covers")
MI_TRACKER_KEYS = ("ref_kf", "last_kf_frame_id", "_last_kf_ts", "n_frames", "inlier_ema",
                   "_last_reloc_frame_id", "consecutive_lost", "frames_since_reloc", "lost_ts",
                   "n_local_inliers")


@functools.lru_cache(maxsize=None)
def mono_inertial_inputs(n_frames: int = MI_FRAMES):
    """tests/test_e2e_inertial.py's fixture: RoomScene(seed=4) at 752x480
    along its strongly excited orbit (``pose_at``), and its 200 Hz IMU
    stream (camera = body, gravity along the world's +y) twice: the JAX
    package's ``make_imu`` (the JAX package's so3_log) and the port's
    ``chip_smoke.imu_stream`` along ``chip_smoke.mono_vi_pose_at`` (numpy and
    the port's so3_log).
    Returns (scene, ground-truth centres, frames, {"jax": stream, "torch":
    stream})."""
    import chip_smoke as cs
    import test_e2e_inertial as fx
    from orbslam3_tpu.ops import lie
    from orbslam3_tpu.utils.datasets import RoomScene
    scene = RoomScene(seed=4, depth=6.0, half_w=4.0, half_h=2.5)
    poses = [fx.pose_at(i) for i in range(n_frames)]
    frames = render_all(scene, poses)
    gt = [-R.T @ t for R, t in poses]
    with jitted(lie, "so3_log"):          # make_imu's one eager call per sample
        jax_stream = fx.make_imu(n_frames)
    streams = {"jax": jax_stream,
               "torch": cs.imu_stream(cs.mono_vi_pose_at, n_frames)[:3]}
    return scene, np.array(gt), frames, streams


def _mono_inertial_system(package: str, scene, pipeline: bool, n_features: int):
    from conftest import dense_tracking_params
    jparams = dense_tracking_params(pipeline=pipeline)
    kw = dict(n_features=n_features, seed=0, enable_loop_closing=False)
    if package == "jax":
        from orbslam3_tpu.models.system import SlamSystem as JaxSlam
        system = JaxSlam(scene.K, None, (scene.w, scene.h), tracking_params=jparams, **kw)
    else:
        from orbslam3_tpu_torch.models.system import SlamSystem
        from orbslam3_tpu_torch.models.tracking import TrackingParams
        from orbslam3_tpu_torch.utils.convert import config_from
        system = SlamSystem(scene.K, None, (scene.w, scene.h), device="cpu",
                            tracking_params=config_from(jparams, TrackingParams), **kw)
    system.enable_imu(freq=200)
    return system


def _imu_module(package: str):
    if package == "jax":
        from orbslam3_tpu.ops import imu_init
    else:
        from orbslam3_tpu_torch.ops import imu_init
    return imu_init


def _snapshot(system) -> dict:
    """A JAX system's map arrays and tracker state, copied (the handoff)."""
    from orbslam3_tpu_torch.utils.convert import INERTIAL_KEYS
    m, tr = system.map, system.tracker
    lf = tr.last_frame
    return dict(
        map={k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in vars(m).items()
             if isinstance(v, (np.ndarray, int))},
        cfg=m.cfg, state=tr.state.name,
        last_frame=dict(frame_id=lf.frame_id, ts=lf.ts, tracked=lf.tracked,
                        dev={k: np.array(getattr(lf.dev, k)) for k in lf.dev._fields},
                        **{a: None if getattr(lf, a) is None else np.array(getattr(lf, a))
                           for a in ("R", "t", "feat_mp", "ur", "depth", "uvr")}),
        velocity=None if tr.velocity is None else tuple(np.array(x) for x in tr.velocity),
        attrs={a: getattr(tr, a) for a in MI_TRACKER_KEYS if hasattr(tr, a)},
        inertial={k: (np.array(v) if isinstance(v, np.ndarray) else v) for k, v in vars(tr).items()
                  if k in INERTIAL_KEYS + MI_INERTIAL_KEYS},
        imu_queue=list(tr.imu_queue), kf_preints=dict(tr.kf_preints))


def _port_frame(frame_id, ts, dev_arrays, **fields):
    from orbslam3_tpu_torch.models.frame import Frame
    from orbslam3_tpu_torch.ops.features import OrbFeatures
    dev = OrbFeatures(**{k: T(dev_arrays[k]) for k in OrbFeatures._fields})
    f = Frame(frame_id, ts, dev=dev)
    for a, v in fields.items():
        setattr(f, a, None if v is None or a == "tracked" else np.array(v, copy=True))
    f.tracked = bool(fields.get("tracked", False))
    return f


def _restore(system, snap: dict):
    """Put a ``_snapshot`` of the JAX package's system into the port's
    ``system``: the map, the tracker's state and last frame, and the
    inertial state through ``utils.convert.tracker_inertial_state_from``."""
    from types import SimpleNamespace
    from orbslam3_tpu_torch.models.tracking import TrackState
    from orbslam3_tpu_torch.utils.convert import (map_state_from_arrays,
                                                  tracker_inertial_state_from)
    m = map_state_from_arrays(snap["map"], snap["cfg"])
    system.atlas.maps = [m]
    system.atlas.current_idx = 0
    system._bind_map(m)
    tr = system.tracker
    lf = snap["last_frame"]
    tr.last_frame = _port_frame(lf["frame_id"], lf["ts"], lf["dev"], R=lf["R"], t=lf["t"],
                                feat_mp=lf["feat_mp"], ur=lf["ur"], depth=lf["depth"],
                                uvr=lf["uvr"], tracked=lf["tracked"])
    for a, v in snap["attrs"].items():
        setattr(tr, a, v)
    tr.velocity = snap["velocity"]
    tr.state = TrackState[snap["state"]]
    tracker_inertial_state_from(SimpleNamespace(**snap["inertial"], kf_preints=snap["kf_preints"],
                                                imu_queue=snap["imu_queue"]), tr)


def mono_inertial_handoff(snap: dict, scene, frames, jax_extract, n_frames: int,
                          pipeline: bool = False) -> dict:
    """The port continuing from the JAX package's state after ``MI_HANDOFF``
    frames (its map, tracker and inertial state through
    ``utils.convert``), tracking the JAX package's features of the next
    frames up to ``n_frames`` with the JAX package's IMU samples, through the
    synchronous step or (``pipeline``) the software pipeline at depth 1,
    flushed at the end. Returns the per-frame states, IMU flags and poses
    (synchronous only), the frame the init came on and its scale."""
    from orbslam3_tpu_torch.models.map import locked_current
    import chip_smoke as cs
    system = _mono_inertial_system("torch", scene, pipeline, 512)
    _restore(system, snap)
    tr = system.tracker
    _, _, _, streams = mono_inertial_inputs(n_frames)
    imu_ts, gyro, acc = streams["jax"]
    rec = dict(states=[], imu=[], poses=[])
    with cs.InitScale(_imu_module("torch"), tr) as scales:
        for i in range(MI_HANDOFF, n_frames):
            s0, s1 = (i - 1) * 10, i * 10
            feats = jax_extract(frames[i])
            f = _port_frame(i, i / 20.0, {k: np.array(getattr(feats, k))
                                          for k in feats._fields})
            tr.grab_imu(imu_ts[s0:s1], gyro[s0:s1], acc[s0:s1])
            tr.n_frames += 1
            if pipeline:
                tr._pipeline_step(f, i / 20.0)
            else:
                tr._timestamp_guard(i / 20.0)
                tr._preintegrate_step(i / 20.0)
                with locked_current(tr):
                    ok = tr._track(f)
                    tr._log_trajectory(f, tracked=ok)
                tr.last_frame = f
                rec["poses"].append(None if f.R is None else (f.R.copy(), f.t.copy()))
            rec["states"].append(tr.state.name)
            rec["imu"].append(bool(tr.imu_initialized))
        tr.flush_pending()
    rec["init_frame"] = scales.first_frame()
    rec["init_scale"] = scales.first()
    rec["stats"] = system.stats()
    return rec


def mono_inertial_run(package: str, n_frames: int = MI_FRAMES, pipeline: bool = False,
                      n_features: int = 512, snapshot_at: int | None = None) -> dict:
    """One package's run of ``mono_inertial_inputs``: ``n_features`` features,
    ``dense_tracking_params(pipeline=...)`` (depth 1), loop closing off, sync
    mapping, ``enable_imu(freq=200)``, ``track_monocular_inertial`` per frame
    with the package's own IMU stream. Returns a record: the system, the
    per-frame tracker states (read without flushing a pipeline), IMU flags
    and poses, the IMU-init frame and the first init's scale, the metric and
    the scale-aligned ATE and the frames they associate, the path counts and
    the stats; with ``snapshot_at`` also the state after that many frames
    (``_snapshot``) and the extractor."""
    from orbslam3_tpu.utils.evaluation import evaluate_trajectory
    scene, gt, frames, streams = mono_inertial_inputs(n_frames)
    imu_ts, gyro, acc = streams[package]
    system = _mono_inertial_system(package, scene, pipeline, n_features)
    tr = system.tracker
    rec = dict(system=system, states=[], imu=[], poses=[])
    import chip_smoke as cs
    with cs.InitScale(_imu_module(package), tr) as scales:
        for i in range(n_frames):
            if i == snapshot_at:
                rec["snapshot"] = _snapshot(system)
            s0, s1 = (i - 1) * 10, i * 10
            if i == 0:
                s0 = s1 = 0
            system.track_monocular_inertial(frames[i], ts=i / 20.0, imu_ts=imu_ts[s0:s1],
                                            imu_gyro=gyro[s0:s1], imu_acc=acc[s0:s1])
            rec["states"].append(tr.state.name)
            rec["imu"].append(bool(tr.imu_initialized))
            lf = tr.last_frame
            rec["poses"].append(None if lf is None or lf.R is None or lf.ts != i / 20.0
                                else (lf.R.copy(), lf.t.copy()))
        ts, _, t_wc, lost = system.export_trajectory()
    sel = ~lost
    gt_ts = np.arange(n_frames) / 20.0
    rec["ate"], rec["n_assoc"] = evaluate_trajectory(gt_ts, gt, ts[sel], t_wc[sel],
                                                     with_scale=False)
    rec["ate_s"], _ = evaluate_trajectory(gt_ts, gt, ts[sel], t_wc[sel], with_scale=True)
    rec["init_frame"] = rec["imu"].index(True) if any(rec["imu"]) else None
    rec["init_scale"] = scales.first()
    rec["init_frame_tracked"] = scales.first_frame()
    rec["paths"] = dict(tr.path_counts)
    rec["stats"] = system.stats()
    rec["extract"] = tr.extract
    return rec


# ---------------------------------------------------------------------------
# the inertial RGB-D and fisheye-rig front ends (test_torch_vi_facade.py)
# ---------------------------------------------------------------------------
IFE_PRE = 2      # frames with the IMU on and not initialized (the first has no preintegration)
IFE_VI = 3       # then frames on the seeded inertial state


def orbit_pose_at(radius: float, forward: float, yaw_rate: float = 0.003):
    """orbit_trajectory's pose as a function of a fractional frame: it starts
    at the origin with no yaw, so its world is the camera's frame at frame 0,
    the map's world of a rig with depth."""
    def pose_at(x):
        c = np.array([radius * np.sin(0.04 * x), 0.15 * np.sin(0.02 * x), forward * x])
        yaw = yaw_rate * x
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        return R_wc.T, -R_wc.T @ c
    return pose_at


def orbit_imu_stream(radius: float, forward: float, n_frames: int):
    """``chip_smoke.imu_stream`` along ``orbit_pose_at`` with gravity along
    the world's -z, as an IMU-initialized map has it. Returns (timestamps,
    gyro, acc, the world velocity at each frame)."""
    import chip_smoke as cs
    return cs.imu_stream(orbit_pose_at(radius, forward), n_frames, g_w=(0.0, 0.0, -9.81))


def inertial_front_end_runs(kind: str) -> dict:
    """The inertial RGB-D (``kind="rgbd"``: tests/test_e2e_stereo.py's RGB-D
    orbit, bf = 0.11 fx) or two-camera fisheye (``"rig"``:
    tests/test_e2e_fisheye.py's KB8 rig at 512x512) front end with
    ``enable_imu`` and an IMU stream of the orbit (``orbit_imu_stream``), 512
    features, dense_tracking_params(), sync mapping, loop closing off, both
    packages. The first IFE_PRE frames run in both packages on their own
    features; then the JAX package's inertial state is seeded as an
    initialized IMU's (the true velocity, zero biases, the staging done) and
    its map, tracker and inertial state go to the port
    (``utils.convert.tracker_inertial_state_from``), which tracks the next
    IFE_VI frames on the JAX package's features through the same front end.
    Returns {"jax": record, "torch": free-run record, "handoff": record}:
    per frame the tracker state, the frame preintegration's fields, the pose
    and the fused visual-inertial count."""
    from conftest import dense_tracking_params
    from orbslam3_tpu.models.system import SlamSystem as JaxSlam
    from orbslam3_tpu_torch.models.system import SlamSystem
    from orbslam3_tpu_torch.models.tracking import TrackingParams
    from orbslam3_tpu_torch.utils.convert import config_from
    n = IFE_PRE + IFE_VI
    if kind == "rgbd":
        scene, _, views = depth_rig_inputs("rgbd")
        K, wh, radius = scene.K, (scene.w, scene.h), 0.6
        kw = dict(bf=DEPTH_RIG_BASELINE * scene.fx, th_depth=DEPTH_RIG_BASELINE * 40)
    else:
        from orbslam3_tpu.ops import lie as jlie
        from orbslam3_tpu.utils.datasets import RoomScene, orbit_trajectory
        scene = RoomScene(seed=8, depth=6.0, half_w=4.0, half_h=2.5, h=512, w=512,
                          fx=190.978, fy=190.973, cx=256.0, cy=256.0)
        scene.kb8_params = KB8
        R_rl = np.asarray(jlie.so3_exp(J(np.float32([0.0, 0.008, 0.0]))))
        t_rl = np.array([-0.101, 0.0, 0.0], np.float32)
        poses = orbit_trajectory(n, radius=0.5, forward=0.03)
        imgs = render_all(scene, [(R, t) for R, t in poses]
                          + [(R_rl @ R, R_rl @ t + t_rl) for R, t in poses])
        views = list(zip(imgs[:n], imgs[n:]))
        K, wh, radius = KB8, (512, 512), 0.5
        kw = dict(cam_type=1)
    imu_ts, gyro, acc, vel = orbit_imu_stream(radius, 0.03, n)
    jparams = dense_tracking_params()
    kw.update(n_features=512, seed=0, enable_loop_closing=False)

    def make(pkg):
        if pkg == "jax":
            s = JaxSlam(K, None, wh, tracking_params=jparams, **kw)
        else:
            s = SlamSystem(K, None, wh, device="cpu",
                           tracking_params=config_from(jparams, TrackingParams), **kw)
        if kind == "rig":
            s.set_fisheye_rig(KB8, R_rl, t_rl, lap_l=(0.0, 511.0), lap_r=(0.0, 511.0))
        s.enable_imu(freq=200)
        return s

    def step(s, i):
        s0, s1 = max(i - 1, 0) * 10, i * 10
        s.tracker.grab_imu(imu_ts[s0:s1], gyro[s0:s1], acc[s0:s1])
        a, b = views[i]
        if kind == "rgbd":
            s.track_rgbd(a, b, ts=i / 20.0)
        else:
            s.track_stereo_fisheye(a, b, ts=i / 20.0)

    def record(s, rec):
        tr = s.tracker
        fp = tr.frame_preint
        rec["states"].append(tr.state.name)
        rec["preint"].append(None if fp is None else {
            k: N(getattr(fp, k)).copy() for k in ("dT", "dR", "dV", "dP", "C")})
        lf = tr.last_frame
        rec["poses"].append(None if lf.R is None else (lf.R.copy(), lf.t.copy()))
        rec["fused_vi"].append(tr.path_counts["fused_vi"])

    out = {}
    js = make("jax")
    feats = []
    inner = js.tracker.extract

    def capture(img):
        f = inner(img)
        feats.append({k: np.array(getattr(f, k)) for k in f._fields})
        return f
    js.tracker.extract = capture
    rec = dict(states=[], preint=[], poses=[], fused_vi=[])
    for i in range(n):
        if i == IFE_PRE:
            tr = js.tracker
            tr.imu_initialized = True
            tr.imu_init_ts = (i - 1) / 20.0
            tr.viba1_done = tr.viba2_done = True
            tr.velocity_w = vel[i - 1].copy()
            snap = _snapshot(js)
            feats.clear()
        step(js, i)
        record(js, rec)
    out["jax"] = rec
    jax_feats = list(feats)
    ts_free = make("torch")
    rec = dict(states=[], preint=[], poses=[], fused_vi=[])
    for i in range(IFE_PRE):
        step(ts_free, i)
        record(ts_free, rec)
    out["torch"] = rec
    th = make("torch")
    _restore(th, snap)
    queue = iter(jax_feats)
    from orbslam3_tpu_torch.ops.features import OrbFeatures
    th.tracker.extract = lambda img: OrbFeatures(**{k: T(v) for k, v in next(queue).items()})
    rec = dict(states=[], preint=[], poses=[], fused_vi=[])
    for i in range(IFE_PRE, n):
        step(th, i)
        record(th, rec)
    rec["stats"] = th.stats()
    out["handoff"] = rec
    out["jax_stats"] = js.stats()
    return out
