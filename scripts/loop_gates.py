"""The loop closer's gates on identical inputs: the port against the JAX package.

    python3 scripts/loop_gates.py [--keep N] [--out FILE]

Runs the port on the CPU over the 376x240 loop walk (chip_smoke.py's loop
phase at the CPU test's width: 256 features, sync mapping) until one frame
after its first loop correction, and snapshots the map and the loop closer's
state before each ``LoopCloser.process_keyframe`` call (the last ``--keep``).
Each snapshot is then handed to a fresh loop closer of each package (the map
through ``map_state_from_arrays``' arrays, the BoW database, the pending
verification and the RANSAC generator's state through
``loop_closer_state_from``), and every gate of that call is evaluated in both:

- the keyframe's BoW row (word ids and weights);
- with no verification pending: the candidates of ``_detect_candidates``
  (shared words, covisibility-group accumulation), then for each candidate the
  verification ``_verify_candidate`` from one generator state: its result,
  the stage it failed at, the Sim3 and the guided-projection counts at radius
  8 and 3 for the accepted Sim3;
- with one pending: ``_refine_pending`` (the temporal-consistency step): its
  result, failing stage, the guided counts.

Prints one line per snapshot and gate, and a JSON summary last. Times on the
CPU say nothing about the GPU.
"""
from __future__ import annotations

import argparse
import collections
import copy
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def snapshot(lc, kf_id):
    m = lc.map
    arrays = {k: (v.copy() if hasattr(v, "copy") and not isinstance(v, (dict, list)) else v)
              for k, v in vars(m).items()
              if k in ("n_kf", "n_mp", "remap_epoch", "map_id")
              or type(v).__module__ == "numpy"}
    return dict(kf=int(kf_id), arrays=arrays, cfg=m.cfg,
                closer=dict(bow_ids=lc.bow_ids.copy(), bow_w=lc.bow_w.copy(),
                            bow_filled=lc.bow_filled.copy(), pending=copy.deepcopy(lc.pending),
                            loop_edges=list(lc.loop_edges), last_loop_kf=int(lc.last_loop_kf),
                            rng=copy.deepcopy(lc.rng.bit_generator.state)))


class _State:
    """Duck-typed loop-closer state for ``loop_closer_state_from``."""

    def __init__(self, d):
        self.bow_ids, self.bow_w, self.bow_filled = d["bow_ids"], d["bow_w"], d["bow_filled"]
        self.pending, self.loop_edges = d["pending"], d["loop_edges"]
        self.last_loop_kf = d["last_loop_kf"]

        class _R:
            pass
        self.rng = _R()
        self.rng.bit_generator = _R()
        self.rng.bit_generator.state = d["rng"]


def closers(snap, K, wh, gates):
    """(jax closer, port closer) on copies of the snapshot's state."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from orbslam3_tpu.models import map as jmap
    from orbslam3_tpu.models.loop_closing import LoopCloser as JLC
    from orbslam3_tpu_torch.models.loop_closing import LoopCloser as TLC
    from orbslam3_tpu_torch.utils.convert import (config_from, loop_closer_state_from,
                                                  map_state_from_arrays)
    tm = map_state_from_arrays(snap["arrays"], snap["cfg"])
    jm = jmap.MapState(config_from(snap["cfg"], jmap.MapConfig),
                       map_id=int(snap["arrays"].get("map_id", 0)))
    for name, val in snap["arrays"].items():
        setattr(jm, name, val.copy() if hasattr(val, "copy") else val)
    out = []
    for cls, m, kw in ((JLC, jm, {}), (TLC, tm, {"device": "cpu"})):
        lc = cls(m, K, wh, fix_scale=False, cam_type=0, **gates, **kw)
        loop_closer_state_from(_State(copy.deepcopy(snap["closer"])), lc)
        out.append(lc)
    return out


def bow_row(lc, kf):
    m = lc.map
    ids, w = lc._sparse_row(m.kf_feat_desc[kf], m.kf_feat_valid[kf])
    import numpy as np
    return np.asarray(ids), np.asarray(w)


def fail_stage(before, after):
    keys = [k for k in after if k.startswith(("lc_vfail_", "lc_refine_fail_"))
            and not k.endswith(("_log", "last_n_final")) and after[k] != before.get(k, 0)]
    return keys[0].split("_", 3)[-1] if keys else None


def gates_of(lc, snap):
    """Every gate of one process_keyframe call, evaluated on ``lc``."""
    import numpy as np
    kf = snap["kf"]
    m = lc.map
    ids, w = bow_row(lc, kf)
    lc.bow_ids[kf], lc.bow_w[kf] = ids, w
    lc.bow_filled[kf] = True
    lc._db_mark_dirty(kf)
    missing = np.nonzero(m.kf_valid[: m.n_kf] & ~lc.bow_filled[: m.n_kf])[0]
    for k in missing[:8]:
        lc.bow_ids[int(k)], lc.bow_w[int(k)] = bow_row(lc, int(k))
        lc.bow_filled[int(k)] = True
        lc._db_mark_dirty(int(k))
    rec = dict(kf=kf, frame=int(m.kf_frame_id[kf]), bow=(ids, w))
    if lc.pending is not None:
        before = dict(lc.stats)
        ok, S21 = lc._refine_pending(kf)
        rec["refine"] = dict(cand=int(lc.pending["cand"]), count=int(lc.pending["count"]),
                             ok=bool(ok), stage=fail_stage(before, lc.stats),
                             n_final=lc.stats.get("lc_refine_last_n_final"),
                             S21=None if S21 is None else (float(S21[0]), np.asarray(S21[2])))
        return rec
    cands = [int(c) for c in lc._detect_candidates(kf)]
    rec["cands"] = cands
    rec["verify"] = []
    for c in cands:
        before = dict(lc.stats)
        ok, S21 = lc._verify_candidate(kf, c)
        v = dict(cand=c, ok=bool(ok), stage=fail_stage(before, lc.stats))
        if ok:
            v["S21"] = (float(S21[0]), np.asarray(S21[2]))
            v["guided"] = [int(lc._guided_projection(kf, c, S21, radius=r)[0]) for r in (8.0, 3.0)]
        else:
            v["n_final"] = lc.stats.get("lc_vfail_last_n_final")
        rec["verify"].append(v)
        if ok:
            break
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keep", type=int, default=8, help="snapshots before the correction")
    ap.add_argument("--out", default=None, help="write the JSON summary here too")
    ap.add_argument("--threads", type=int, default=4)
    opt = ap.parse_args()
    import numpy as np
    import torch
    torch.set_num_threads(opt.threads)
    import chip_smoke as cs
    from orbslam3_tpu_torch.models.loop_closing import LoopCloser
    snaps = collections.deque(maxlen=opt.keep)
    calls = []
    inner = LoopCloser.process_keyframe

    def logged(self, kf_id, *a, **k):
        snaps.append(snapshot(self, kf_id))
        pend0 = None if self.pending is None else self.pending["count"]
        out = inner(self, kf_id, *a, **k)
        calls.append(dict(kf=int(kf_id), frame=int(self.map.kf_frame_id[kf_id])
                          if self.map.kf_valid[kf_id] else None, pending_before=pend0,
                          pending_after=None if self.pending is None else self.pending["count"],
                          corrected=bool(out)))
        snaps[-1]["result"] = calls[-1]
        return out

    LoopCloser.process_keyframe = logged
    scene, poses, imgs = cs.render_loop_walk(False, cs.LOOP_FRAMES, min(8, os.cpu_count() or 1))
    slam, rec = cs.run_loop_walk(scene, poses, imgs, 256, "sync", stop_after=1, device="cpu")
    LoopCloser.process_keyframe = inner
    slam.shutdown(print_times=False)
    print(f"port on the CPU, loop walk 376x240: first correction at frame "
          f"{rec['first_correction']}, pending before detection {rec['pending_before_detection']}")
    gs = 0.4   # SlamSystem's gate scale at 256 features
    gates = dict(n_bow_matches=int(round(20 * gs)), n_bow_inliers=int(round(15 * gs)),
                 n_sim3_inliers=int(round(20 * gs)), n_proj_matches=int(round(50 * gs)),
                 n_proj_opt_matches=int(round(80 * gs)))
    summary = []
    for snap in snaps:
        jl, tl = closers(snap, scene.K, (scene.w, scene.h), gates)
        rj, rt = gates_of(jl, snap), gates_of(tl, snap)
        same_bow = (np.array_equal(rj["bow"][0], rt["bow"][0])
                    and np.allclose(rj["bow"][1], rt["bow"][1], atol=1e-6))
        line = dict(kf=snap["kf"], frame=rj["frame"], port_call=snap["result"],
                    same_bow_row=bool(same_bow))
        if "refine" in rj:
            a, b = rj["refine"], rt["refine"]
            line.update(gate="refine_pending", cand=a["cand"], count=a["count"],
                        jax=dict(ok=a["ok"], stage=a["stage"], n_final=a["n_final"]),
                        port=dict(ok=b["ok"], stage=b["stage"], n_final=b["n_final"]),
                        same_decision=a["ok"] == b["ok"] and a["stage"] == b["stage"])
            if a["S21"] is not None and b["S21"] is not None:
                line["S21_t_diff"] = float(np.abs(a["S21"][1] - b["S21"][1]).max())
        else:
            vj = [(v["cand"], v["ok"], v["stage"]) for v in rj["verify"]]
            vt = [(v["cand"], v["ok"], v["stage"]) for v in rt["verify"]]
            line.update(gate="detect+verify", jax=dict(cands=rj["cands"], verify=vj),
                        port=dict(cands=rt["cands"], verify=vt),
                        same_decision=rj["cands"] == rt["cands"] and vj == vt)
            gj = [v.get("guided") for v in rj["verify"] if v["ok"]]
            gt = [v.get("guided") for v in rt["verify"] if v["ok"]]
            if gj or gt:
                line["guided_8_3"] = dict(jax=gj, port=gt)
        summary.append(line)
        print(json.dumps(line))
    out = dict(first_correction=rec["first_correction"], snapshots=summary,
               all_same=all(s["same_decision"] and s["same_bow_row"] for s in summary))
    if opt.out:
        with open(opt.out, "w") as f:
            json.dump(out, f)
    print(json.dumps(dict(first_correction=out["first_correction"], all_same=out["all_same"])))


if __name__ == "__main__":
    main()
