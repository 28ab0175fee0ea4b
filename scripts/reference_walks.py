"""Reference runs of chip_smoke.py's system phases, the JAX package against the port.

    python3 scripts/reference_walks.py --package jax|torch
        --phase slice|headline|loop|merge|drifted|stereo|vi|mono-vi|rgbd|fisheye|stereo-merge
        [--frames N] [--features N] [--mapping sync|async] [--pipeline 0|1] [--loop-closing 0|1]
        [--width full|test] [--device cpu|cuda] [--repeat N] [--stop-after N]
        [--record FILE] [--deterministic] [--pose-starts N] [--ba-chunk N]
    python3 scripts/reference_walks.py --compare JAX_FILE TORCH_FILE

Drives the very functions chip_smoke.py drives on the GPU (``run_walk``,
``run_reloc``, ``run_loop_walk``, ``run_merge``, ``run_drifted_loop``,
``run_fisheye``, ``run_stereo_merge``) with the
JAX package ``orbslam3_tpu`` on the CPU or with the port (on the CPU, or on
the card with ``--device cuda``), at the same full-size configuration
(752x480, 1024 features):

- ``slice``: 60 frames of the walk with sync mapping, then the
  relocalization scenario on that system (textureless frames, walk resumed);
  with ``--pose-starts 7 --frames 30`` the multi-start walk of chip_smoke.py's
  facade phase;
- ``headline``: 300 frames with ``mapping_mode="async"`` and
  ``TrackingParams(pipeline=True)``, loop closing on (the system's default);
  ``--mapping``, ``--pipeline`` and ``--loop-closing`` override each, to tell
  the threads' shares apart;
- ``loop``: the loop walk (179 frames of a 112-frame closed path, a
  3-keyframe local window, loop closing on), sync mapping unless ``--mapping
  async``, at 752x480 with 1024 features (``--width full``) or at 376x240 with
  256 features (``--width test``), ``--repeat`` times on one rendering (each
  run ending ``--stop-after`` frames after its first correction, if given),
  each followed by the relocalization scenario on that run's system. ``--record``
  writes, per frame, the tracking state, inliers and keyframes' source frames
  and, at every ``LoopCloser._detect_candidates`` call, the query keyframe,
  every older keyframe of the database with its covisibility weight to the
  query, and the candidates returned;
- ``merge``: ``run_merge``: the defaults with sync mapping on the walk's first 60
  frames, blank frames that store the map and start a new one, then the
  walk's start again, which must merge the new map back;
- ``drifted``: ``run_drifted_loop``: the drifted 752x480 map in a
  1024-feature pool through a loop closer with the scale fixed (the full-width
  loop check);
- ``stereo``: bench.py's stereo rig without the IMU on the walk's first 40
  frames (right eye at baseline 0.11, bf = 0.11·fx, th_depth = 40, loop
  closing on), sync mapping and the pipeline unless ``--mapping`` /
  ``--pipeline`` say otherwise (chip_smoke.py runs it async);
- ``vi``: bench.py::bench_vi_e2e's make_system() (the stereo rig of
  ``stereo`` with enable_imu at 200 Hz and bench.py's IMU stream) on the
  walk's first 80 frames, sync mapping unless ``--mapping`` says otherwise
  (chip_smoke.py runs it async), the pipeline on: the IMU-init frame, the
  metric ATE, the frames on the fused visual-inertial step, the keyframes;
- ``mono-vi``: chip_smoke.py's cell 14, monocular-inertial on
  tests/test_e2e_inertial.py's scene and orbit (58 frames, 512 features
  unless ``--features``, 200 Hz IMU), sync mapping unless ``--mapping`` says
  otherwise (chip_smoke.py runs it async), the pipeline on, loop closing on:
  the IMU-init frame and scale, the metric and the scale-aligned ATE, the
  frames on the fused visual-inertial step, the keyframes;
- ``rgbd``: the walk's first 20 frames with the renderer's depth, sync;
- ``fisheye``: tests/test_e2e_fisheye.py's two-camera rig and monocular KB8
  orbits (512x512, their first 16 frames) with 1500 features, loop closing on;
- ``stereo-merge``: tests/test_atlas.py's stereo merge found by the keyframe
  database's query.

``--ba-chunk N`` sets every mapper's ``ba_chunk`` (LM iterations per
chunk of a BA phase; 0 runs each phase as one call) whatever the mapping
mode, so that async mapping can run the sync schedule and back.

``--deterministic`` turns PyTorch's deterministic algorithms on for the port
(no atomics with a free summation order; an operator without a deterministic
form is named in a warning), so that a card run repeats.

``--compare`` lines two ``--record`` files up: frame by frame (state,
inliers, keyframes made), then query by query (keyframes made from the same
source frame), how many older keyframes each package's covisible group
(weight >= 15) excludes and the weights of those only one of them excludes.

chip_smoke.py's bounds come from the JAX runs: ATE at most
max(1.5 x JAX, JAX + 0.02), and the number of frames within which the state
must be back to OK. Times printed on the CPU say nothing about the GPU.
Prints one line per phase and one JSON object last.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def jax_classes() -> dict:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from orbslam3_tpu.models.system import SlamSystem
    from orbslam3_tpu.models.tracking import TrackingParams
    return dict(system_cls=SlamSystem, params_cls=TrackingParams)


def recorder(system_cls):
    """Hook ``system_cls`` so that every system made after this call logs
    its frames and its loop queries. Returns (record, restore)."""
    import numpy as np
    import torch

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    rec = {"per_frame": [], "queries": [], "init": [], "first_frame": None}
    init = system_cls.__init__

    def hooked_init(self, *a, **k):
        init(self, *a, **k)
        lc, tr = self.loop_closer, self.tracker
        detect, track = lc._detect_candidates, self.track_monocular
        match_init, two_view = tr.match_init, tr.two_view
        attempt = {}

        def logged_match_init(*a, **k):
            out = match_init(*a, **k)
            attempt["matches"] = int(host(out[2]).sum())
            return out

        def logged_two_view(*a, **k):
            out = two_view(*a, **k)
            rec["init"].append(dict(attempt, success=bool(host(out.success)),
                                    good=int(host(out.good).sum())))
            return out

        def logged_detect(kf_id, *a, **k):
            m = lc.map
            fid = m.kf_frame_id
            covis = np.asarray(m.covisibility_row(kf_id))
            filled = lc.bow_filled[: m.n_kf] & m.kf_valid[: m.n_kf]
            older = [int(j) for j in np.nonzero(filled)[0] if j < kf_id - lc.exclude_recent]
            out = detect(kf_id, *a, **k)
            rec["queries"].append(dict(
                kf=int(fid[kf_id]), n_kf=int(m.kf_valid[: m.n_kf].sum()),
                older={int(fid[j]): int(covis[j]) for j in older},
                candidates=[int(fid[c]) for c in np.asarray(out)]))
            return out

        def logged_track(img, ts):
            info = track(img, ts)
            if rec["first_frame"] is None:
                f = tr.init_frame if tr.init_frame is not None else tr.last_frame
                rec["first_frame"] = dict(
                    xy=host(f.xy).tolist(), octave=host(f.octave).tolist(),
                    desc=host(f.desc).view(np.uint32).tolist())
            m = self.map
            valid = m.kf_valid[: m.n_kf]
            rec["per_frame"].append(dict(
                state=info.get("state"), inliers=info.get("inliers"),
                kfs=[int(f) for f in m.kf_frame_id[: m.n_kf][valid]]))
            return info

        lc._detect_candidates = logged_detect
        self.track_monocular = logged_track
        tr.match_init, tr.two_view = logged_match_init, logged_two_view

    system_cls.__init__ = hooked_init

    def restore():
        system_cls.__init__ = init
    return rec, restore


def with_ba_chunk(system_cls, chunk: int):
    """A subclass of ``system_cls`` whose every mapper (each rebinding of
    the map: spawn, merge, load) runs its BA phases with ``ba_chunk =
    chunk``."""
    class Chunked(system_cls):
        def _bind_map(self, *a, **k):
            out = super()._bind_map(*a, **k)
            self.mapper.ba_chunk = chunk
            return out
    Chunked.__name__ = system_cls.__name__
    return Chunked


def compare(a: dict, b: dict) -> None:
    import numpy as np
    print(f"{a['package']} against {b['package']}")
    fa, fb = a["first_frame"], b["first_frame"]
    same_xy = np.all(np.abs(np.array(fa["xy"]) - np.array(fb["xy"])) < 1e-3, axis=1)
    same_desc = np.all(np.array(fa["desc"]) == np.array(fb["desc"]), axis=1)
    octave = np.array(fa["octave"])
    print(f"first frame: {int(same_xy.sum())} of {len(same_xy)} keypoints at the same "
          f"position; descriptors equal per octave (equal/keypoints): " + ", ".join(
              f"{o}: {int((same_desc & same_xy)[octave == o].sum())}/{int((octave == o).sum())}"
              for o in range(int(octave.max()) + 1)))
    print(f"two-view bootstrap attempts a: {a['init']}")
    print(f"two-view bootstrap attempts b: {b['init']}")
    print("frame | state a/b | inliers a/b | keyframes made at this frame a / b")
    seen_a, seen_b = set(), set()
    for i, (x, y) in enumerate(zip(a["per_frame"], b["per_frame"])):
        new_a, new_b = sorted(set(x["kfs"]) - seen_a), sorted(set(y["kfs"]) - seen_b)
        seen_a |= set(x["kfs"])
        seen_b |= set(y["kfs"])
        print(f"{i:4d} | {x['state']}/{y['state']} | {x['inliers']}/{y['inliers']} | "
              f"{new_a} / {new_b}")
    qa = {q["kf"]: q for q in a["queries"]}
    qb = {q["kf"]: q for q in b["queries"]}
    print(f"queried by {a['package']} only: {sorted(set(qa) - set(qb))}")
    print(f"queried by {b['package']} only: {sorted(set(qb) - set(qa))}")
    print("query frame | older kfs a/b | excluded a/b (weight >= 15) | not excluded "
          "(frame:weight a/b) | candidates a / b")
    for kf in sorted(set(qa) & set(qb)):
        ox = {int(k): v for k, v in qa[kf]["older"].items()}
        oy = {int(k): v for k, v in qb[kf]["older"].items()}
        ex = {k for k, v in ox.items() if v >= 15}
        ey = {k for k, v in oy.items() if v >= 15}
        free = sorted((set(ox) - ex) | (set(oy) - ey))
        free_s = " ".join(f"{k}:{ox.get(k, '-')}/{oy.get(k, '-')}" for k in free)
        print(f"{kf:4d} | {len(ox)}/{len(oy)} | {len(ex)}/{len(ey)} | {free_s or '-'} | "
              f"{qa[kf]['candidates']} / {qb[kf]['candidates']}")


def sensor_phase(cs, opt, kw, mapping, pipeline, lc, name, where) -> dict:
    """The stereo, RGB-D, fisheye and stereo-merge phases on one package;
    prints one line per run and returns their records."""
    workers = min(8, os.cpu_count() or 1)
    if opt.phase in ("stereo", "rgbd"):
        n = opt.frames or (cs.STEREO_FRAMES if opt.phase == "stereo" else cs.RGBD_FRAMES)
        walk_kw = dict(seed=1, n_clutter=4)
        scene = cs.RoomScene(**walk_kw)
        poses = cs.walk_trajectory(n, period=280)
        depth = opt.phase == "rgbd"
        jobs = [("walk", walk_kw, p, depth) for p in poses]
        if not depth:
            jobs += [("walk", walk_kw, scene.stereo_pose(R, t, cs.STEREO_BASELINE), False)
                     for (R, t) in poses]
        views = cs.render_jobs(jobs, workers)
        if depth:
            imgs, extra = [v[0] for v in views], dict(depths=[v[1] for v in views],
                                                      th_depth=cs.STEREO_BASELINE * 40)
        else:
            imgs, extra = views[:n], dict(right=views[n:], th_depth=cs.STEREO_TH_DEPTH)
        slam, rec = cs.run_walk(scene, poses, imgs, n, mapping, pipeline,
                                enable_loop_closing=lc, bf=cs.STEREO_BASELINE * scene.fx,
                                **extra, **kw)
        slam.shutdown(print_times=False)
        print(cs.walk_line(name, n, rec))
        return {"walk": rec}
    # the fisheye and merge views, without the walk's (any scene serves
    # stereo_pose, a function of the pose alone)
    jobs = cs.sensor_jobs(cs.RoomScene(**cs.stereo_merge_scene()[0]), None, [])
    if opt.phase == "fisheye":
        views = cs.render_jobs([j for j in jobs if j[0].startswith("fisheye")], workers)
        it = iter(views)
        out = {}
        for kind, _, poses in cs.fisheye_scenes():
            if kind == "fisheye_rig":
                pairs = [(next(it), next(it)) for _ in poses]
                imgs, imgs_r = [a for a, _ in pairs], [b for _, b in pairs]
            else:
                imgs, imgs_r = [next(it) for _ in poses], None
            slam, rec = cs.run_fisheye(kind, imgs, imgs_r, enable_loop_closing=lc, **kw)
            slam.shutdown(print_times=False)
            print(f"{opt.package} on {where}, {kind}: {json.dumps(rec)}")
            out[kind] = rec
        return out
    views = cs.render_jobs([j for j in jobs if j[0] == "stereo_merge"], workers)
    merge_views = list(zip(views[0::2], views[1::2]))
    slam, rec = cs.run_stereo_merge(merge_views, **kw)
    slam.shutdown(print_times=False)
    print(f"{opt.package} on {where}, stereo merge: {json.dumps(rec)}")
    return {"stereo_merge": rec}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"))
    ap.add_argument("--phase", choices=("slice", "headline", "loop", "merge", "drifted",
                                        "stereo", "vi", "mono-vi", "rgbd", "fisheye",
                                        "stereo-merge"))
    ap.add_argument("--frames", type=int, default=0, help="0: the phase's own length")
    ap.add_argument("--features", type=int, default=0,
                    help="mono-vi: the features per frame (0: the phase's own)")
    ap.add_argument("--mapping", choices=("sync", "async"), default=None)
    ap.add_argument("--pipeline", type=int, choices=(0, 1), default=None)
    ap.add_argument("--loop-closing", type=int, choices=(0, 1), default=None,
                    help="default: off for slice, on for headline and loop")
    ap.add_argument("--width", choices=("full", "test"), default="full",
                    help="loop phase: 752x480 and 1024 features, or 376x240 and 256")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu",
                    help="the port's device (the JAX package runs on the CPU)")
    ap.add_argument("--repeat", type=int, default=1, help="loop phase: runs")
    ap.add_argument("--stop-after", type=int, default=None,
                    help="loop phase: end each run this many frames after its first "
                         "correction")
    ap.add_argument("--record", help="loop phase: write frames and loop queries here")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"), help="two --record files")
    ap.add_argument("--pose-starts", type=int, default=1,
                    help="slice and headline: TrackingParams.pose_starts (the multi-start "
                         "pose solve above 1)")
    ap.add_argument("--threads", type=int, default=4, help="torch CPU threads")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True) for the port")
    ap.add_argument("--ba-chunk", type=int, default=None,
                    help="set every mapper's ba_chunk to this (default: the system's)")
    opt = ap.parse_args()
    if opt.compare:
        with open(opt.compare[0]) as fa, open(opt.compare[1]) as fb:
            compare(json.load(fa), json.load(fb))
        return
    if not (opt.package and opt.phase):
        ap.error("--package and --phase are required unless --compare is given")
    if opt.record and opt.repeat > 1:
        ap.error("--record takes one run")
    import torch
    torch.set_num_threads(opt.threads)
    if opt.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        # warn_only: an operator without a deterministic form warns (and is
        # named in the output) instead of stopping the run
        torch.use_deterministic_algorithms(True, warn_only=True)
    import chip_smoke as cs
    kw = jax_classes() if opt.package == "jax" else {"device": opt.device}
    if opt.ba_chunk is not None:
        kw["system_cls"] = with_ba_chunk(kw.get("system_cls") or cs.SlamSystem, opt.ba_chunk)
    where = "the CPU" if opt.package == "jax" or opt.device == "cpu" else "the card"
    if where == "the card":
        print(cs.card_line())
    mapping = opt.mapping or ("async" if opt.phase == "headline" else "sync")
    pipeline = bool(opt.phase in ("headline", "stereo", "mono-vi") if opt.pipeline is None
                    else opt.pipeline)
    lc = bool(opt.phase != "slice" if opt.loop_closing is None else opt.loop_closing)
    params_kw = {"pose_starts": opt.pose_starts} if opt.pose_starts != 1 else None
    out = {"package": opt.package, "phase": opt.phase, "device": opt.device,
           "mapping": mapping, "pipeline": pipeline, "loop_closing": lc,
           "pose_starts": opt.pose_starts, "ba_chunk": opt.ba_chunk}
    name = (f"{opt.package} on {where}, {opt.phase} ({mapping}, pipeline {pipeline}, "
            f"loop closing {lc})")
    if opt.phase == "drifted":
        if opt.package == "jax":
            from orbslam3_tpu.models import map as jmap
            from orbslam3_tpu.models.local_mapping import LocalMapper
            from orbslam3_tpu.models.loop_closing import LoopCloser
            from orbslam3_tpu.ops.features import OrbConfig
            rec = cs.run_drifted_loop(LoopCloser, LocalMapper, jmap, OrbConfig)
        else:
            rec = cs.run_drifted_loop(device=opt.device)
        print(f"{opt.package} on {where}, drifted: {json.dumps(rec)}")
        print(json.dumps(dict(out, drifted=rec)))
        return
    if opt.phase == "vi":
        n = opt.frames or cs.VI_FRAMES
        walk_kw = dict(seed=1, n_clutter=4)
        scene = cs.RoomScene(**walk_kw)
        poses = cs.walk_trajectory(n, period=280)
        jobs = [("walk", walk_kw, p, False) for p in poses]
        jobs += [("walk", walk_kw, scene.stereo_pose(R, t, cs.STEREO_BASELINE), False)
                 for (R, t) in poses]
        views = cs.render_jobs(jobs, min(8, os.cpu_count() or 1))
        slam, rec = cs.run_vi(scene, views[:n], views[n:], n, mapping, **kw)
        slam.shutdown(print_times=False)
        print(f"{name}: {json.dumps(rec)}")
        print(json.dumps(dict(out, vi=rec)))
        return
    if opt.phase == "mono-vi":
        n = opt.frames or cs.MONO_VI_FRAMES
        jobs = [("mono_vi", cs.MONO_VI_SCENE, cs.mono_vi_pose_at(i), False) for i in range(n)]
        views = cs.render_jobs(jobs, min(8, os.cpu_count() or 1))
        if opt.package == "jax":
            from orbslam3_tpu.ops import imu_init as imu_init_module
        else:
            from orbslam3_tpu_torch.ops import imu_init as imu_init_module
        slam, rec = cs.run_mono_vi(views, n, mapping, opt.features or cs.MONO_VI_FEATURES,
                                   imu_init_module=imu_init_module,
                                   enable_loop_closing=lc, **kw)
        slam.shutdown(print_times=False)
        print(f"{name}, {rec['n_features']} features: init frame {rec['imu_init_frame']}, "
              f"scale {rec['init_scale']}, metric ATE {rec['ate']}, scale-aligned ATE "
              f"{rec['ate_s']}, fused frames {rec['paths'].get('fused_vi')}, keyframes "
              f"{rec['n_keyframes']}: {json.dumps(rec)}")
        print(json.dumps(dict(out, mono_vi=rec)))
        return
    if opt.phase in ("stereo", "rgbd", "fisheye", "stereo-merge"):
        out.update(sensor_phase(cs, opt, kw, mapping, pipeline, lc, name, where))
        print(json.dumps(out))
        return
    if opt.phase == "slice":
        n = opt.frames or cs.SLICE_FRAMES
        scene, poses, imgs = cs.render_walk(n + cs.RELOC_BLANK + cs.RELOC_RESUME)
        slam, rec = cs.run_walk(scene, poses, imgs, n, mapping, pipeline,
                                 enable_loop_closing=lc, params_kw=params_kw, **kw)
        print(cs.walk_line(name, n, rec))
        reloc = cs.run_reloc(slam, scene, imgs, n)
        print(f"{opt.package} on {where}, reloc: {json.dumps(reloc)}")
        out.update(walk=rec, reloc=reloc)
    elif opt.phase == "headline":
        n = opt.frames or cs.HEADLINE_FRAMES
        scene, poses, imgs = cs.render_walk(n)
        slam, rec = cs.run_walk(scene, poses, imgs, n, mapping, pipeline,
                                 enable_loop_closing=lc, params_kw=params_kw, **kw)
        print(cs.walk_line(name, n, rec))
        out.update(walk=rec)
    elif opt.phase == "merge":
        scene, poses, imgs = cs.render_walk(cs.SLICE_FRAMES)
        slam, rec = cs.run_merge(scene, imgs, **kw)
        print(f"{opt.package} on {where}, merge: {json.dumps(rec)}")
        out.update(merge=rec)
    else:
        full = opt.width == "full"
        n = opt.frames or cs.LOOP_FRAMES
        scene, poses, imgs = cs.render_loop_walk(full, n + cs.RELOC_BLANK + cs.RELOC_RESUME,
                                                 min(8, os.cpu_count() or 1))
        if opt.record:
            system_cls = kw.get("system_cls") or cs.SlamSystem
            log, restore = recorder(system_cls)
        runs, relocs = [], []
        for rep in range(opt.repeat):
            slam, rec = cs.run_loop_walk(scene, poses, imgs, 1024 if full else 256, mapping,
                                         n_frames=n, stop_after=opt.stop_after, **kw)
            print(f"{name}, {opt.width} width, run {rep}: {json.dumps(rec)}")
            runs.append(rec)
            if opt.record:
                restore()
                with open(opt.record, "w") as f:
                    json.dump(dict(package=opt.package, width=opt.width, walk=rec, **log), f)
            reloc = cs.run_reloc(slam, scene, imgs, rec["frames"])
            print(f"{opt.package} on {where}, run {rep}, reloc: {json.dumps(reloc)}")
            relocs.append(reloc)
            if rep + 1 < opt.repeat:
                slam.shutdown(print_times=False)
        out.update(walk=runs, reloc=relocs, width=opt.width)
    slam.shutdown(print_times=False)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
