"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. card     - name and power limit, as nvidia-smi reports them;
  2. build    - compiles csrc/match_rows.cu with nvcc and csrc/mapops.cpp
                with the host compiler into orbslam3_tpu_torch/build/;
  3. kernel   - both entry points of the Hopper kernel (match_rows and
                match_rows_dual) against their plain PyTorch versions on the
                card, on seeded inputs, exact equality of idx/best/second on
                every row at 4096x1024, 1024x1024, 4096x1000 and a
                12x4096x1024 batch; at the tracking path's two shapes the
                device time per launch (a CUDA graph of 200 back-to-back
                launches of the C entry point: the host cannot be the
                limit), the wrapper's host time per call on a line of its
                own, the plain version's time and the bound;
  4. frame    - the kernel-path frame step (extract_orb -> projection_matcher
                -> pose LM at 480x752, 1024 features, 4096 map points);
  5. slice    - SlamSystem.track_monocular on 60 frames of the rendered
                RoomScene walk (sync mapping, no pipeline, no loop closing);
  6. reloc    - on the slice's system: textureless frames lose tracking (the
                map is kept), the walk resumes, and the tracker must come
                back to OK through Tracker._relocalize without a new map;
  7. headline - 300 frames of the walk with mapping_mode="async" and
                TrackingParams(pipeline=True): frames/s over the tracking
                loop, latency split by frames that made a keyframe and
                frames that did not, the mapper's drain time and queue depth;
both walks are checked for initialization, tracked fraction, scale-aligned
ATE, mapper errors and for having launched each kernel. Then one JSON line
describing the kernels, and the contract line {"ok": true, "device": {...}}
last. It never falls back to the CPU: without a CUDA device it raises before
printing any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from orbslam3_tpu_torch import native  # noqa: E402
from orbslam3_tpu_torch.models import kernels  # noqa: E402
from orbslam3_tpu_torch.models.system import SlamSystem  # noqa: E402
from orbslam3_tpu_torch.models.tracking import TrackingParams  # noqa: E402
from orbslam3_tpu_torch.ops import features, match_rows as mr, pose_opt  # noqa: E402
from orbslam3_tpu_torch.utils.datasets import RoomScene, walk_trajectory  # noqa: E402
from orbslam3_tpu_torch.utils.evaluation import evaluate_trajectory  # noqa: E402

H, W = 480, 752
N_FEATURES = 1024
N_MP = 4096
SLICE_FRAMES = 60
HEADLINE_FRAMES = 300
OPENING = 120            # the walk's opening frames: no run so far has lost a frame in them
RELOC_BLANK = 5          # textureless frames; the tracker starts a new map at 20
RELOC_RESUME = 10
# Bounds, derived from the JAX package's runs of these exact configurations on
# the CPU (scripts/reference_walks.py --package jax; the figures are in
# PERF.md). ATE bounds follow the rule of the CPU end-to-end tests:
# max(1.5 x JAX, JAX + 0.02) m.
#   slice, 60 frames sync: JAX tracks 57 of 60 frames (the first three
#     bootstrap the map), ATE 0.01069 m, 0 lost.
#   reloc: JAX is back to OK on the first resumed frame after the 5 blank
#     ones (5 failed _relocalize calls, 1 success, no new map); the port gets
#     3 frames.
#   headline, 300 frames async + pipeline: the walk is not repeatable. On the
#     card the tracker diverges within a few frames at one of a few places of
#     the walk (around frames 146-160, 218-222, 265-298) in most runs and in
#     every mapping mode, sync included: it loses one to eight frames,
#     relocalizes, and the RMS error then depends on how long it was off. On
#     the CPU each package's sync run is one deterministic sample (the JAX
#     package loses frame 284, the port none), and the JAX package's own
#     accelerator benchmarks of this walk record the same (BENCH_r03-r05.json:
#     ATE 0.6298, 0.0852, 0.4252 m with 1-2 lost frames). So the walk is held
#     to two bounds. Over its first 120 frames alone, in which no run of the
#     port has lost a frame and where the mapper thread has by then run on
#     some 60 keyframes: the JAX package with sync mapping gives 0.01048 m
#     there. Over the whole walk: the worst run the JAX package has on
#     record, 0.6298 m (its four async runs on the CPU, where its mapper
#     starves, give 0.1647-0.3403 m); that bound only says "no worse than the
#     reference's worst".
TRACKED_MIN = 0.95
SLICE_ATE_MAX = 0.0307
HEADLINE_ATE_MAX = 0.9447
HEADLINE_OPENING_ATE_MAX = 0.0305
RELOC_WITHIN = 3


def _reset_counts():
    mr.match_rows.launches = 0
    mr.match_rows_dual.launches = 0


def _read_counts() -> dict:
    return {"match_rows": mr.match_rows.launches,
            "match_rows_dual": mr.match_rows_dual.launches}


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events. The
    host enqueues inside the window, so for a short kernel this is a host
    time; a kernel's device time comes from :func:`graph_ms`."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(launch, iters: int = 200, reps: int = 7) -> float:
    """Device milliseconds per launch with the host out of the way:
    ``launch(stream_handle)`` is captured ``iters`` times, back to back, into
    one CUDA graph; the graph is replayed ``reps`` times between two events
    and the median replay is divided by ``iters``. The graph is first
    replayed for 0.2 s: an idle card runs at a fraction of its clock."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch(side.cuda_stream)                       # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        handle = torch.cuda.current_stream().cuda_stream
        for _ in range(iters):
            err = launch(handle)
            if err != 0:
                raise RuntimeError(f"kernel launch failed during capture (cudaError {err})")
    t_warm = time.perf_counter()                       # bring the SM clock up first
    while time.perf_counter() - t_warm < 0.2:
        for _ in range(20):
            graph.replay()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def host_ms(fn, iters: int = 200) -> float:
    """Host milliseconds per wrapper call (checks, allocation, ctypes call),
    device drained before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e3


def match_inputs(rng, M, N, T=None, dev="cuda"):
    """Seeded match_rows inputs with near-duplicate map points (distance
    ties), duplicate feature descriptors, rows outside every window and
    rows switched off."""
    lead = () if T is None else (T,)
    feat_desc = rng.integers(0, 2 ** 32, lead + (N, 8), dtype=np.uint32)
    feat_desc[..., 1::7, :] = feat_desc[..., 0::7, :][..., : feat_desc[..., 1::7, :].shape[-2], :]
    src = rng.integers(0, N, lead + (M,))
    mp_desc = np.take_along_axis(feat_desc, src[..., None], axis=-2).copy()
    flip = rng.integers(0, 2 ** 32, mp_desc.shape, dtype=np.uint32)
    flip &= rng.integers(0, 2 ** 32, mp_desc.shape, dtype=np.uint32)
    flip &= rng.integers(0, 2 ** 32, mp_desc.shape, dtype=np.uint32)
    mp_desc ^= flip                               # ~1/8 of the bits flipped
    mp_desc[..., ::5, :] = rng.integers(0, 2 ** 32, mp_desc[..., ::5, :].shape, dtype=np.uint32)
    feat_xy = rng.uniform([0, 0], [W, H], lead + (N, 2)).astype(np.float32)
    uv = (np.take_along_axis(feat_xy, src[..., None], axis=-2)
          + rng.normal(0, 3, lead + (M, 2))).astype(np.float32)
    uv[..., ::11, :] = -500.0                     # outside every window
    feat_oct = rng.integers(0, 8, lead + (N,)).astype(np.int32)
    lvl = np.clip(np.take_along_axis(feat_oct, src, axis=-1)
                  + rng.integers(-1, 2, lead + (M,)), 0, 7).astype(np.int32)
    rad = (8.0 * 1.2 ** lvl).astype(np.float32)
    row_ok = rng.random(lead + (M,)) < 0.8
    feat_ok = rng.random(lead + (N,)) < 0.95
    to = lambda a: torch.as_tensor(a, device=dev)
    return (to(mp_desc.view(np.int32)), to(uv), to(rad), to(lvl), to(row_ok),
            to(feat_desc.view(np.int32)), to(feat_xy), to(feat_oct), to(feat_ok))


def sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return float(out[0]) * 1e6


def match_bound_ms(args, wide: float, out_words: int):
    """The least time the card could take for one call on these inputs: the
    larger of (a) every input read once and every output written once at
    3.35 TB/s and (b) the operations these inputs need at the card's rates:
    six simple float32/int32 operations per (row, column) pair for the
    window and octave tests, at one per lane per clock (33.5e12/s: the
    published 67 TFLOP/s counts a fused multiply-add as two), plus 8 POPC per
    pair that passes the (wide) window, at 16 per SM per clock at the
    card's maximum SM clock. Returns (ms, "bytes" | "operations", survivors)."""
    mp_desc, uv, rad, lvl, row_ok, feat_desc, feat_xy, feat_oct, feat_ok = args
    r = (wide * rad)[..., :, None]
    du = torch.abs(uv[..., :, None, 0] - feat_xy[..., None, :, 0])
    dv = torch.abs(uv[..., :, None, 1] - feat_xy[..., None, :, 1])
    doct = feat_oct[..., None, :] - lvl[..., :, None]
    survivors = int(((du <= r) & (dv <= r) & (doct >= -1) & (doct <= 1)
                     & row_ok[..., :, None] & feat_ok[..., None, :]).sum())
    pairs = rad.numel() * feat_oct.shape[-1]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    t_ops = pairs * 6 / 33.5e12 + survivors * 8 / (n_sm * 16 * sm_clock_hz())
    n_bytes = sum(t.numel() * t.element_size() for t in args) + 4 * out_words
    t_bytes = n_bytes / 3.35e12
    by = "bytes" if t_bytes > t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by, survivors


KERNEL_SHAPES = ((4096, 1024, None), (1024, 1024, None), (4096, 1000, None),
                 (4096, 1024, 12))
ENTRIES = {"match_rows": dict(wide=None, planes=3),
           "match_rows_dual": dict(wide=2.0, planes=6)}


def c_launcher(lib, entry: str, args, out, wide=None):
    """``launch(stream_handle)`` for a C entry point with every pointer
    resolved once, so a timing loop does nothing but launch."""
    lead = args[0].shape[:-2]
    T = lead[0] if lead else 1
    M, N = args[0].shape[-2], args[5].shape[-2]
    ptrs = [t.data_ptr() for t in args] + [out.data_ptr()]
    fn = getattr(lib, entry + "_launch")
    tail = (T, M, N, 1, 1) if wide is None else (T, M, N, 1, 1, wide)
    return lambda stream: fn(*ptrs, *tail, stream)


def phase_kernel():
    """Both entry points against their plain versions at every shape (exact),
    and at the tracking path's two shapes their device time (CUDA graph of
    back-to-back launches of the C entry point), the wrapper's host time, the
    plain version's time and the bound. Returns {entry: record}."""
    rng = np.random.default_rng(7)
    lib = mr._load()
    wrappers = {"match_rows": (mr.match_rows, mr.match_rows_reference),
                "match_rows_dual": (mr.match_rows_dual, mr.match_rows_dual_reference)}
    rec = {name: dict(max_abs_err=0, shapes={}) for name in ENTRIES}
    for (M, N, T) in KERNEL_SHAPES:
        args = match_inputs(rng, M, N, T)
        for name, (kern, plain) in wrappers.items():
            want = plain(*args)
            got = kern(*args)
            torch.cuda.synchronize()
            if name == "match_rows":
                want, got = (want,), (got,)
            for radius, g3, w3 in zip(("r", "2r"), got, want):
                for part, a, b in zip(("idx", "best", "second"), g3, w3):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{name} M={M} N={N} T={T} at {radius}: {part} "
                                             f"differs on {int((a != b).sum())} rows")
                    rec[name]["max_abs_err"] = max(
                        rec[name]["max_abs_err"], int((a.long() - b.long()).abs().max()))
            best, second = want[-1][1], want[-1][2]
            n_empty = int((best >= mr.BIG).sum())
            n_tie = int(((second == best) & (best < mr.BIG)).sum())
            line = (f"kernel {name} M={M} N={N} T={T}: exact on all rows "
                    f"(empty rows {n_empty}, best==second ties {n_tie})")
            if T is None and N == 1024:
                wide, planes = ENTRIES[name]["wide"], ENTRIES[name]["planes"]
                out = torch.empty((planes, M), dtype=torch.int32, device="cuda")
                launch = c_launcher(lib, name, args, out, wide)
                t_p1 = cuda_ms(lambda: plain(*args), 20)
                t_k1 = graph_ms(launch)
                t_k2 = graph_ms(launch)
                t_p2 = cuda_ms(lambda: plain(*args), 20)
                t_host = host_ms(lambda: kern(*args))
                bound, by, surv = match_bound_ms(args, wide or 1.0, planes * M)
                rec[name]["shapes"][(M, N)] = dict(
                    ms=(t_k1 + t_k2) / 2, plain_ms=(t_p1 + t_p2) / 2, host_ms=t_host,
                    bound_ms=bound, bound_by=by)
                line += (f"; device {t_k1 * 1e3:.2f}/{t_k2 * 1e3:.2f} us per launch, plain "
                         f"{t_p1:.4f}/{t_p2:.4f} ms, bound {bound * 1e3:.2f} us ({by}; {surv} "
                         f"pairs in a window)\nhost {name} wrapper M={M} N={N}: "
                         f"{t_host * 1e3:.1f} us per call")
            print(line)
    return rec


def phase_frame_step():
    """The port's bench_kernel_path: one frame through extraction, the
    projection matcher and the pose LM, at the EuRoC-class budget."""
    dev = torch.device("cuda")
    cfg = features.OrbConfig(n_features=N_FEATURES)
    cap = cfg.total_capacity
    K = torch.tensor([458.654, 457.296, 376.0, 240.0], device=dev)
    wh = torch.tensor([float(W), float(H)], device=dev)
    extract = features.make_extractor(H, W, cfg, device=dev)
    proj_match = kernels.projection_matcher(0, cfg.n_levels, cfg.scale, device=dev)
    rng = np.random.default_rng(0)
    imgs = [torch.as_tensor(rng.uniform(0, 255, (H, W)).astype(np.float32), device=dev)
            for _ in range(4)]
    R0 = torch.eye(3, device=dev)
    t0 = torch.zeros(3, device=dev)
    mp_xyz = torch.as_tensor(rng.uniform([-4, -3, 5], [4, 3, 15], (N_MP, 3)).astype(np.float32),
                             device=dev)
    mp_desc = torch.as_tensor(rng.integers(0, 2 ** 32, (N_MP, 8), dtype=np.uint32).view(np.int32),
                              device=dev)
    mp_normal = torch.tensor([0.0, 0.0, -1.0], device=dev).expand(N_MP, 3).contiguous()
    mp_mind = torch.full((N_MP,), 0.5, device=dev)
    mp_maxd = torch.full((N_MP,), 50.0, device=dev)
    mp_valid = torch.ones(N_MP, dtype=torch.bool, device=dev)

    def frame_step(img):
        f = extract(img)
        idx, ok, _, _, _ = proj_match(mp_xyz, mp_desc, mp_normal, mp_mind, mp_maxd,
                                      mp_valid, R0, t0, K, f.xy, f.desc, f.octave,
                                      f.valid, wh, 8.0, 0.9, 100, 0.5)
        slot = torch.where(ok, idx.long(), cap)            # unmatched rows → dump row
        pts = torch.zeros((cap + 1, 3), device=dev).index_put_((slot,), mp_xyz)[:cap]
        valid = torch.zeros(cap + 1, dtype=torch.bool, device=dev).index_put_(
            (slot,), ok)[:cap]
        inv_s2 = 1.0 / (1.2 ** (2.0 * f.octave.to(torch.float32)))
        return pose_opt.pose_optimize(R0, t0, pts, f.xy, inv_s2, valid, K)

    for im in imgs:
        frame_step(im)
    torch.cuda.synchronize()
    n_iter = 30
    t_start = time.perf_counter()
    for i in range(n_iter):
        out = frame_step(imgs[i % len(imgs)])
    int(out.n_inliers)
    torch.cuda.synchronize()
    fps = n_iter / (time.perf_counter() - t_start)
    if not (torch.isfinite(out.R).all() and torch.isfinite(out.t).all()):
        raise AssertionError("frame step: non-finite pose")
    print(f"frame extract_orb->projection_matcher->pose LM ({H}x{W}, {N_FEATURES} features, "
          f"{N_MP} map points): {fps:.2f} frames/s")
    return fps


def render_walk(n_frames: int):
    """The rendered walk every system phase shares (the camera, not the
    system): RoomScene(seed=1, n_clutter=4) at 752x480 along
    walk_trajectory(n, period=280)."""
    scene = RoomScene(seed=1, n_clutter=4)
    poses = walk_trajectory(n_frames, period=280)
    return scene, poses, [scene.render(R, t) for (R, t) in poses]


def percentiles(lat_ms) -> str:
    if len(lat_ms) == 0:
        return "none"
    return "/".join(f"{np.percentile(lat_ms, q):.2f}" for q in (50, 90, 99))


def part_ate(gt, ts, t_wc, first: int, last: int):
    """Scale-aligned ATE over the tracked frames ``first <= frame < last``
    alone (aligned on that part), and how many frames it holds."""
    frame = np.rint(ts * 20.0).astype(int)
    sel = (frame >= first) & (frame < last)
    if sel.sum() < 3:
        return float("nan"), int(sel.sum())
    ate, n = evaluate_trajectory(np.arange(len(gt)) / 20.0, gt, ts[sel], t_wc[sel],
                                 with_scale=True)
    return float(ate), int(n)


def run_walk(scene, poses, imgs, n_frames: int, mapping_mode: str, pipeline: bool,
             system_cls=SlamSystem, params_cls=TrackingParams, **system_kw):
    """Drive a ``SlamSystem`` over the first ``n_frames`` of the walk and
    measure it (``system_cls`` and ``params_cls``: the port's classes, or
    another package's with the same surface, see scripts/reference_walks.py).
    The clock covers the tracking loop with the software pipeline flushed; the
    mapper's drain is timed after it. Returns (system, record)."""
    slam = system_cls(
        scene.K, None, (scene.w, scene.h), n_features=N_FEATURES, seed=0,
        mapping_mode=mapping_mode, enable_loop_closing=False,
        tracking_params=params_cls(kf_interval_override=5, pipeline=pipeline),
        **system_kw)
    tr = slam.tracker
    _sync()
    _reset_counts()
    made_kf, queue = [], []
    t_start = time.perf_counter()
    for i in range(n_frames):
        kf_before = tr.last_kf_frame_id
        slam.track_monocular(imgs[i], ts=float(i) / 20.0)
        made_kf.append(tr.last_kf_frame_id != kf_before)
        queue.append(len(slam.runtime.kf_queue) if slam.runtime is not None else 0)
    tr.flush_pending()                                   # drain the tracking pipeline
    _sync()
    t_track = time.perf_counter() - t_start
    drained = slam.wait_idle(timeout=120.0)
    t_drain = time.perf_counter() - t_start - t_track
    launches = _read_counts()
    lat = np.array([b - a for (a, b) in slam.frame_spans]) * 1e3
    made_kf = np.array(made_kf)
    st = slam.stats()
    gt = np.array([-R.T @ t for (R, t) in poses[:n_frames]])
    ts, _, t_wc, lost = slam.export_trajectory()
    sel = ~lost
    if not np.isfinite(t_wc[sel]).all():
        raise AssertionError("non-finite poses in the exported trajectory")
    ate, n_assoc = evaluate_trajectory(np.arange(n_frames) / 20.0, gt, ts[sel], t_wc[sel],
                                       with_scale=True)
    ate_opening, n_opening = part_ate(gt, ts[sel], t_wc[sel], 0, OPENING)
    rec = dict(
        fps=n_frames / t_track, lat_all=percentiles(lat), lat_kf=percentiles(lat[made_kf]),
        lat_other=percentiles(lat[~made_kf]), n_kf_frames=int(made_kf.sum()),
        drained=bool(drained), drain_s=t_drain, queue_max=int(max(queue)),
        queue_mean=float(np.mean(queue)), paths=dict(tr.path_counts),
        n_keyframes=st["n_keyframes"], n_map_points=st["n_map_points"],
        n_lost=int(lost.sum()), lost_frames=np.rint(ts[lost] * 20.0).astype(int).tolist(),
        tracked=float(sel.sum()) / n_frames, ate=float(ate), ate_opening=ate_opening,
        n_opening=n_opening,
        n_assoc=int(n_assoc), mapper_errors=int(st.get("mapper_errors", 0)),
        last_mapper_error=st.get("last_mapper_error"), ba_runs=st.get("ba_runs"),
        initialized=tr.state.name != "NOT_INITIALIZED", launches=launches,
        stages={k: [round(v.get("median_ms", v["mean_ms"]), 2), v.get("n", 1)]
                for k, v in sorted(st.get("stage_times", {}).items())})
    return slam, rec


def walk_line(name: str, n_frames: int, r: dict) -> str:
    return (f"{name} ({n_frames} frames): {r['fps']:.3f} frames/s over the tracking loop, "
            f"latency p50/p90/p99 ms all {r['lat_all']}, frames that made a keyframe "
            f"({r['n_kf_frames']}) {r['lat_kf']}, other frames {r['lat_other']}, "
            f"mapper drain {r['drain_s']:.2f} s (drained {r['drained']}), keyframe queue "
            f"max {r['queue_max']} mean {r['queue_mean']:.2f}, paths {json.dumps(r['paths'])}, "
            f"n_keyframes {r['n_keyframes']}, n_map_points {r['n_map_points']}, "
            f"ba_runs {r['ba_runs']}, n_lost {r['n_lost']} {r['lost_frames']}, "
            f"tracked {r['tracked']:.3f}, "
            f"ate_m {r['ate']:.4f} ({r['n_assoc']} assoc), over frames 0-{OPENING - 1} alone "
            f"{r['ate_opening']:.4f} ({r['n_opening']}), mapper_errors "
            f"{r['mapper_errors']}, launches {json.dumps(r['launches'])}, stages "
            f"[median ms, n] {json.dumps(r['stages'])}")


def check_walk(name: str, r: dict, ate_max: float, opening_ate_max: float | None = None):
    if r["mapper_errors"]:
        raise AssertionError(f"{name}: {r['mapper_errors']} mapper error(s), the last:\n"
                             f"{r['last_mapper_error']}")
    if not r["initialized"]:
        raise AssertionError(f"{name}: the system never initialized")
    if not r["drained"]:
        raise AssertionError(f"{name}: the mapper did not drain within its timeout")
    for kernel, n in r["launches"].items():
        if n <= 0:
            raise AssertionError(f"{name}: the path never launched the {kernel} kernel")
    if r["tracked"] < TRACKED_MIN:
        raise AssertionError(f"{name}: tracked fraction {r['tracked']:.3f} < {TRACKED_MIN}")
    if not r["ate"] <= ate_max:
        raise AssertionError(f"{name}: ATE {r['ate']:.4f} m > {ate_max}")
    if opening_ate_max is not None and not r["ate_opening"] <= opening_ate_max:
        raise AssertionError(f"{name}: ATE over frames 0-{OPENING - 1} {r['ate_opening']:.4f} m "
                             f"> {opening_ate_max}")


def run_reloc(slam, scene, imgs, first: int):
    """Lose tracking on a system that holds a map, then resume the walk.
    ``RELOC_BLANK`` textureless frames (fewer than the tracker's
    ``frames_to_new_map``, so the map is kept) stand in for frames ``first``
    onwards; the walk resumes behind them for ``RELOC_RESUME`` frames.
    Returns the evidence: states, calls of ``_relocalize`` and how many of
    them recovered, Atlas maps before and after."""
    tr = slam.tracker
    calls = {"n": 0, "ok": 0}
    inner = tr._relocalize

    def counted(*a, **k):
        ok = inner(*a, **k)
        calls["n"] += 1
        calls["ok"] += bool(ok)
        return ok

    tr._relocalize = counted
    n_maps = len(slam.atlas.maps)
    _reset_counts()
    blank = np.full((scene.h, scene.w), 128.0, np.float32)
    lost_states, states = [], []
    for i in range(first, first + RELOC_BLANK):
        slam.track_monocular(blank, ts=float(i) / 20.0)
        lost_states.append(slam.state.name)
    for i in range(first + RELOC_BLANK, first + RELOC_BLANK + RELOC_RESUME):
        slam.track_monocular(imgs[i], ts=float(i) / 20.0)
        states.append(slam.state.name)
    tr._relocalize = inner
    back = states.index("OK") + 1 if "OK" in states else None
    return dict(lost_states=lost_states, states=states, frames_to_ok=back,
                reloc_calls=calls["n"], reloc_ok=calls["ok"], maps_before=n_maps,
                maps_after=len(slam.atlas.maps), launches=_read_counts(),
                reloc_frames=tr.path_counts.get("reloc_frames"))


def phase_reloc(slam, scene, imgs):
    r = run_reloc(slam, scene, imgs, SLICE_FRAMES)
    print(f"reloc after the slice: {RELOC_BLANK} blank frames -> {r['lost_states']}, walk "
          f"resumed -> {r['states']}; back to OK after {r['frames_to_ok']} frame(s), "
          f"_relocalize called {r['reloc_calls']}x, recovered {r['reloc_ok']}x "
          f"(tracker counter {r['reloc_frames']}), atlas maps {r['maps_before']} -> "
          f"{r['maps_after']}, launches {json.dumps(r['launches'])}")
    if "OK" in r["lost_states"]:
        raise AssertionError("reloc: tracking survived the textureless frames")
    if r["frames_to_ok"] is None or r["frames_to_ok"] > RELOC_WITHIN:
        raise AssertionError(f"reloc: not back to OK within {RELOC_WITHIN} frames")
    if r["reloc_ok"] < 1 or r["reloc_frames"] != r["reloc_ok"]:
        raise AssertionError("reloc: the recovery did not go through _relocalize")
    if r["maps_after"] != r["maps_before"]:
        raise AssertionError("reloc: a new Atlas map was created")
    return r


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
    print(card_line())
    t0 = time.perf_counter()
    compiled = mr.build(verbose=True)
    print(f"build match_rows: {compiled:.2f} s nvcc ({time.perf_counter() - t0:.2f} s total)")
    if not native.available():
        raise AssertionError("the native map operations (csrc/mapops.cpp) did not build: "
                             f"{native.unavailable_because()}")
    print(f"build mapops: native.available() = {native.available()}")
    rec = phase_kernel()
    phase_frame_step()
    scene, poses, imgs = render_walk(HEADLINE_FRAMES)
    slam, r_slice = run_walk(scene, poses, imgs, SLICE_FRAMES, "sync", False,
                             device="cuda")
    print(walk_line("slice mono walk, sync mapping", SLICE_FRAMES, r_slice))
    check_walk("slice", r_slice, SLICE_ATE_MAX)
    r_reloc = phase_reloc(slam, scene, imgs)
    slam.shutdown(print_times=False)
    # the headline path takes the defaults: device=None is the card
    slam, r_head = run_walk(scene, poses, imgs, HEADLINE_FRAMES, "async", True)
    slam.shutdown(print_times=False)
    print(walk_line("headline mono walk, async mapping + pipeline", HEADLINE_FRAMES, r_head))
    check_walk("headline", r_head, HEADLINE_ATE_MAX, HEADLINE_OPENING_ATE_MAX)
    kernels_out = []
    for name, k in rec.items():
        at = k["shapes"][(4096, 1024)]
        small = k["shapes"][(1024, 1024)]
        kernels_out.append({
            "name": name, "route": "cuda",
            "source": "orbslam3_tpu_torch/csrc/match_rows.cu",
            "replaces": "orbslam3_tpu/ops/matching_pallas.py:146",
            "launches": r_head["launches"][name],
            "launches_slice": r_slice["launches"][name],
            "launches_reloc": r_reloc["launches"][name],
            "max_abs_err": k["max_abs_err"], "shape": "M=4096 N=1024",
            "ms": at["ms"], "host_ms": at["host_ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"], "library_ms": None,
            "at_M1024_N1024": small})
    print(json.dumps({"kernels": kernels_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
