"""The 300-frame mono walk on one GPU under each mapping mode, with and
without the tracker's software pipeline, in turns in one process.

    python3 scripts/walk_variants.py [--frames 300]
        [--runs async+pipe,async,sync+pipe,sync]

Each run is chip_smoke.py's ``run_walk`` on the same rendered frames. It tells
apart what the mapper thread, the pipeline and their combination do to frame
rate, latency, lost frames and ATE (over the whole walk and over its opening
frames alone), and repeating one name shows the run-to-run spread. Per run it
also prints where the trajectory first leaves the ground truth (per-frame
error after aligning on the opening frames) and the frames around that place.
``--deterministic`` turns PyTorch's deterministic algorithms on (no atomics
with a free summation order) and ``--plain-matcher`` puts the plain PyTorch
matcher in the place of the CUDA kernels: two ways to tell where run-to-run
differences come from. Prints one JSON object last.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from orbslam3_tpu_torch.models import kernels  # noqa: E402
from orbslam3_tpu_torch.ops import match_rows as mr  # noqa: E402
from orbslam3_tpu_torch.utils.evaluation import horn_align  # noqa: E402

VARIANTS = {"async+pipe": ("async", True), "async": ("async", False),
            "sync+pipe": ("sync", True), "sync": ("sync", False)}


def departure(slam, poses, n_frames: int, limit: float = 0.08) -> dict:
    """Per-frame position error after a similarity alignment on the opening
    frames alone; the first frame beyond ``limit`` metres and the errors from
    three frames before it to eight after (None: a lost frame)."""
    gt = np.array([-R.T @ t for (R, t) in poses[:n_frames]])
    ts, _, t_wc, lost = slam.export_trajectory()
    frame = np.rint(ts * 20.0).astype(int)
    ok = ~lost
    base = ok & (frame < cs.OPENING)
    R, t, s = horn_align(t_wc[base], gt[frame[base]], with_scale=True)
    err = np.full(n_frames, np.nan)
    err[frame[ok]] = np.linalg.norm((s * (R @ t_wc[ok].T)).T + t - gt[frame[ok]], axis=1)
    beyond = np.nonzero(err > limit)[0]
    if len(beyond) == 0:
        return {"first_beyond": None, "max_err": float(np.nanmax(err))}
    a = int(beyond[0])
    around = {i: (None if np.isnan(err[i]) else round(float(err[i]), 3))
              for i in range(max(a - 3, 0), min(a + 9, n_frames))}
    return {"first_beyond": a, "max_err": float(np.nanmax(err)), "around": around}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=cs.HEADLINE_FRAMES)
    ap.add_argument("--runs", default="async+pipe,async,sync+pipe,sync",
                    help="comma-separated sequence of " + ", ".join(VARIANTS))
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--plain-matcher", action="store_true")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the GPU")
    print(cs.card_line())
    if opt.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    if opt.plain_matcher:
        kernels.match_rows = mr.match_rows_reference
        kernels.match_rows_dual = mr.match_rows_dual_reference
    scene, poses, imgs = cs.render_walk(opt.frames)
    out = []
    for name in opt.runs.split(","):
        mode, pipe = VARIANTS[name]
        slam, rec = cs.run_walk(scene, poses, imgs, opt.frames, mode, pipe)
        rec["departure"] = departure(slam, poses, opt.frames)
        slam.shutdown(print_times=False)
        print(cs.walk_line(name, opt.frames, rec))
        print(f"{name}: leaves the ground truth at {json.dumps(rec['departure'])}", flush=True)
        if rec["mapper_errors"]:
            raise AssertionError(rec["last_mapper_error"])
        out.append({"variant": name, **{k: rec[k] for k in (
            "fps", "lat_all", "lat_kf", "lat_other", "n_kf_frames", "ate", "ate_opening",
            "n_lost", "lost_frames", "tracked", "paths", "n_keyframes", "queue_mean",
            "ba_runs", "departure", "stages")}})
    print(json.dumps({"card": cs.card_line(), "frames": opt.frames,
                      "deterministic": opt.deterministic, "plain_matcher": opt.plain_matcher,
                      "runs": out}))


if __name__ == "__main__":
    main()
