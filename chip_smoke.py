"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. card     — name and power limit, as nvidia-smi reports them;
  2. build    — compiles csrc/match_rows.cu with nvcc into
                orbslam3_tpu_torch/build/;
  3. kernel   — the Hopper match_rows kernel against its plain PyTorch
                version on the card, on seeded inputs at the tracking path's
                shapes, exact equality of idx/best/second on every row, and
                both timed with CUDA events (plain, kernel, kernel, plain);
  4. frame    — the kernel-path frame step (extract_orb → projection_matcher
                → pose LM at 480x752, 1024 features, 4096 map points);
  5. slice    — SlamSystem.track_monocular on the rendered RoomScene walk
                (sync mapping, no loop closing), timed per frame, checked for
                initialization, tracked fraction and scale-aligned ATE, and
                for having gone through the kernel;
then one JSON line describing the kernels, and the contract line
{"ok": true, "device": {...}} last. It never falls back to the CPU: without
a CUDA device it raises before printing any result.
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

from orbslam3_tpu_torch.models import kernels  # noqa: E402
from orbslam3_tpu_torch.models.system import SlamSystem  # noqa: E402
from orbslam3_tpu_torch.models.tracking import TrackingParams, TrackState  # noqa: E402
from orbslam3_tpu_torch.ops import features, match_rows as mr, pose_opt  # noqa: E402
from orbslam3_tpu_torch.utils.datasets import RoomScene, walk_trajectory  # noqa: E402
from orbslam3_tpu_torch.utils.evaluation import evaluate_trajectory  # noqa: E402

H, W = 480, 752
N_FEATURES = 1024
N_MP = 4096
SLICE_FRAMES = 120
# Bounds of the slice, derived from the JAX package's run of this exact
# configuration on the CPU: 117 of 120 frames tracked (the first three
# bootstrap the map), scale-aligned ATE 0.01048 m, 0 lost. The port must
# track at least 95% of the frames and keep its ATE within
# max(1.5 x 0.01048, 0.01048 + 0.02) m — the bound the CPU end-to-end test
# applies to the port against the JAX run.
TRACKED_MIN = 0.95
ATE_MAX = 0.0305


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def phase_kernel():
    rng = np.random.default_rng(7)
    worst = 0
    times = {}
    for shape in ((4096, 1024, None), (1024, 1024, None), (4096, 1000, None),
                  (4096, 1024, 12)):
        M, N, T = shape
        args = match_inputs(rng, M, N, T)
        want = mr.match_rows_reference(*args, octave_lo=1, octave_hi=1)
        got = mr.match_rows(*args, octave_lo=1, octave_hi=1)
        torch.cuda.synchronize()
        for name, a, b in zip(("idx", "best", "second"), got, want):
            if not torch.equal(a, b):
                bad = int((a != b).sum())
                raise AssertionError(f"match_rows {shape}: {name} differs on {bad} rows")
            worst = max(worst, int((a.long() - b.long()).abs().max()))
        n_empty = int((want[1] >= mr.BIG).sum())
        n_tie = int(((want[2] == want[1]) & (want[1] < mr.BIG)).sum())
        if T is None and N == 1024:
            plain = lambda: mr.match_rows_reference(*args)
            kern = lambda: mr.match_rows(*args)
            for f in (plain, kern):
                f()
            t_p1 = cuda_ms(plain, 20)
            t_k1 = cuda_ms(kern, 50)
            t_k2 = cuda_ms(kern, 50)
            t_p2 = cuda_ms(plain, 20)
            times[(M, N)] = ((t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2)
            print(f"kernel match_rows M={M} N={N}: exact on all rows "
                  f"(empty rows {n_empty}, best==second ties {n_tie}); "
                  f"kernel {times[(M, N)][0]:.4f} ms, plain {times[(M, N)][1]:.4f} ms "
                  f"(runs plain {t_p1:.4f}/{t_p2:.4f}, kernel {t_k1:.4f}/{t_k2:.4f})")
        else:
            print(f"kernel match_rows M={M} N={N} T={T}: exact on all rows "
                  f"(empty rows {n_empty}, best==second ties {n_tie})")
    return worst, times


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


def phase_slice():
    scene = RoomScene(seed=1, n_clutter=4)
    poses = walk_trajectory(SLICE_FRAMES, period=280)
    imgs = [scene.render(R, t) for (R, t) in poses]      # the camera, not the system
    slam = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=N_FEATURES, seed=0,
                      mapping_mode="sync", enable_loop_closing=False,
                      tracking_params=TrackingParams(kf_interval_override=5),
                      device="cuda")
    torch.cuda.synchronize()
    mr.match_rows.launches = 0
    t_start = time.perf_counter()
    states = []
    for i in range(SLICE_FRAMES):
        slam.track_monocular(imgs[i], ts=float(i) / 20.0)
        states.append(slam.state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = mr.match_rows.launches
    lat = np.array([b - a for (a, b) in slam.frame_spans]) * 1e3
    st = slam.stats()
    gt = np.array([-R.T @ t for (R, t) in poses])
    ts, R_wc, t_wc, lost = slam.export_trajectory()
    sel = ~lost
    if not np.isfinite(t_wc[sel]).all():
        raise AssertionError("non-finite poses in the exported trajectory")
    ate, n_assoc = evaluate_trajectory(np.arange(SLICE_FRAMES) / 20.0, gt, ts[sel],
                                       t_wc[sel], with_scale=True)
    n_lost = int(lost.sum())
    tracked = float(sel.sum()) / SLICE_FRAMES
    print(f"slice mono walk ({SLICE_FRAMES} frames): {SLICE_FRAMES / wall:.3f} frames/s, "
          f"p50 {np.percentile(lat, 50):.2f} ms, p90 {np.percentile(lat, 90):.2f} ms, "
          f"paths {json.dumps(slam.tracker.path_counts)}, "
          f"n_keyframes {st['n_keyframes']}, n_map_points {st['n_map_points']}, "
          f"n_lost {n_lost}, tracked {tracked:.3f}, ate_m {ate:.4f} ({n_assoc} assoc), "
          f"match_rows launches {launches}")
    if not any(s == TrackState.OK for s in states):
        raise AssertionError("the system never initialized")
    if launches <= 0:
        raise AssertionError("the slice never launched the match_rows kernel")
    if tracked < TRACKED_MIN:
        raise AssertionError(f"tracked fraction {tracked:.3f} < {TRACKED_MIN}")
    if not ate <= ATE_MAX:
        raise AssertionError(f"ATE {ate:.4f} m > {ATE_MAX}")
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
    print(card_line())
    t0 = time.perf_counter()
    compiled = mr.build(verbose=True)
    print(f"build match_rows: {compiled:.2f} s nvcc ({time.perf_counter() - t0:.2f} s total)")
    worst, times = phase_kernel()
    phase_frame_step()
    launches = phase_slice()
    k_ms, p_ms = times[(4096, 1024)]
    print(json.dumps({"kernels": [{
        "name": "match_rows", "route": "cuda",
        "source": "orbslam3_tpu_torch/csrc/match_rows.cu",
        "replaces": "orbslam3_tpu/ops/matching_pallas.py:146",
        "launches": launches, "max_abs_err": worst,
        "ms": round(k_ms, 6), "plain_ms": round(p_ms, 6)}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
