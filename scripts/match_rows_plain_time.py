"""Seconds of the match_rows plain PyTorch versions (the CPU path of
``orbslam3_tpu_torch/ops/match_rows.py``) over the calls of one port walk,
in three formulations of the same function.

    python3 scripts/match_rows_plain_time.py [--frames 58] [--threads 2] [--reps 3]

The walk is chip_smoke.py's monocular-inertial one (cell 14: RoomScene(seed=4)
at 752x480, 512 features, TrackingParams(kf_interval_override=5,
pipeline=True), loop closing on) on the CPU with sync mapping; every call of
``match_rows_reference`` and ``match_rows_dual_reference`` is recorded with
its inputs. The recorded calls then run, ``--reps`` times in turns, through:

- ``all_pairs``: the masked all-pairs Hamming matrix, the dual form as two
  single calls (the plain version of PR 10's tree);
- ``shared``: the same, with the dual form's two radii reduced from one
  Hamming matrix;
- ``windowed``: the module's plain versions (only the pairs inside each
  row's window).

Each rep checks that the three agree bit for bit. Prints one line per rep
and formulation, then one JSON object. Needs no card and no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from orbslam3_tpu_torch.ops import match_rows as mr  # noqa: E402
from orbslam3_tpu_torch.ops.matching import BIG, hamming_matrix  # noqa: E402


def _masked_top2(dist, uv, rad, lvl, row_ok, feat_xy, feat_oct, feat_ok, octave_lo=1,
                 octave_hi=1):
    du = torch.abs(uv[..., :, None, 0] - feat_xy[..., None, :, 0])
    dv = torch.abs(uv[..., :, None, 1] - feat_xy[..., None, :, 1])
    r = rad[..., :, None]
    doct = feat_oct[..., None, :] - lvl[..., :, None]
    mask = ((du <= r) & (dv <= r) & (doct >= -octave_lo) & (doct <= octave_hi)
            & row_ok[..., :, None] & feat_ok[..., None, :])
    d = torch.where(mask, dist, BIG)
    idx = torch.argmin(d, dim=-1)
    best = torch.gather(d, -1, idx[..., None])[..., 0]
    col = torch.arange(d.shape[-1], device=d.device)
    second = torch.amin(torch.where(col == idx[..., None], BIG, d), dim=-1)
    return idx.to(torch.int32), best.to(torch.int32), second.to(torch.int32)


def all_pairs(mp_desc, uv, rad, lvl, row_ok, feat_desc, *cols, octave_lo=1, octave_hi=1):
    return _masked_top2(hamming_matrix(mp_desc, feat_desc), uv, rad, lvl, row_ok, *cols,
                        octave_lo, octave_hi)


def all_pairs_dual(mp_desc, uv, rad, lvl, row_ok, feat_desc, *cols, octave_lo=1,
                   octave_hi=1, wide=2.0):
    kw = dict(octave_lo=octave_lo, octave_hi=octave_hi)
    return (all_pairs(mp_desc, uv, rad, lvl, row_ok, feat_desc, *cols, **kw),
            all_pairs(mp_desc, uv, wide * rad, lvl, row_ok, feat_desc, *cols, **kw))


def shared_dual(mp_desc, uv, rad, lvl, row_ok, feat_desc, *cols, octave_lo=1, octave_hi=1,
                wide=2.0):
    dist = hamming_matrix(mp_desc, feat_desc)
    return (_masked_top2(dist, uv, rad, lvl, row_ok, *cols, octave_lo, octave_hi),
            _masked_top2(dist, uv, wide * rad, lvl, row_ok, *cols, octave_lo, octave_hi))


FORMS = {"all_pairs": (all_pairs, all_pairs_dual),
         "shared": (all_pairs, shared_dual),
         "windowed": (mr.match_rows_reference, mr.match_rows_dual_reference)}


def record_walk(n_frames: int) -> list:
    """(kind, args, kwargs) of every plain call of the walk."""
    calls = []
    originals = {}
    for kind in ("match_rows_reference", "match_rows_dual_reference"):
        originals[kind] = orig = getattr(mr, kind)

        def rec(*a, _orig=orig, _kind=kind, **kw):
            calls.append((_kind, [x.clone() for x in a[:9]], dict(
                zip(("octave_lo", "octave_hi", "wide"), a[9:]), **kw)))
            return _orig(*a, **kw)
        setattr(mr, kind, rec)
    try:
        poses = [cs.mono_vi_pose_at(i) for i in range(n_frames)]
        imgs = cs.render_views(cs.MONO_VI_SCENE, poses)
        slam, _ = cs.run_mono_vi(imgs, n_frames, mapping_mode="sync", device="cpu")
        slam.shutdown(print_times=False)
    finally:
        for kind, orig in originals.items():
            setattr(mr, kind, orig)
    return calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=cs.MONO_VI_FRAMES)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    opt = ap.parse_args()
    torch.set_num_threads(opt.threads)
    calls = record_walk(opt.frames)
    n_dual = sum(kind == "match_rows_dual_reference" for kind, _, _ in calls)
    print(f"{len(calls)} plain calls over {opt.frames} frames ({n_dual} dual), "
          f"{opt.threads} torch threads")
    seconds = {name: [] for name in FORMS}
    for rep in range(opt.reps):
        outs = {}
        for name, (single, dual) in FORMS.items():
            t = 0.0
            outs[name] = []
            for kind, args, kw in calls:
                fn = dual if kind == "match_rows_dual_reference" else single
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                t += time.perf_counter() - t0
                outs[name].append(out)
            seconds[name].append(t)
            print(f"rep {rep} {name}: {t:.3f} s")
        for name in ("shared", "windowed"):
            for got, want in zip(outs[name], outs["all_pairs"]):
                flat_g = got if isinstance(got[0], torch.Tensor) else got[0] + got[1]
                flat_w = want if isinstance(want[0], torch.Tensor) else want[0] + want[1]
                assert all(torch.equal(g, w) for g, w in zip(flat_g, flat_w)), name
    print(json.dumps({"frames": opt.frames, "calls": len(calls), "dual_calls": n_dual,
                      "threads": opt.threads, "seconds": seconds}))


if __name__ == "__main__":
    main()
