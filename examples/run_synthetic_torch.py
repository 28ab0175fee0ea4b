#!/usr/bin/env python
"""Self-contained demo on the PyTorch port: track a synthetic room sequence
(no dataset needed), save the TUM trajectory, report ATE against ground
truth, render the map.

  python examples/run_synthetic_torch.py --mode stereo --frames 24 --render map.png
  python examples/run_synthetic_torch.py --device cpu --frames 8
"""
import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from orbslam3_tpu_torch.models.system import SlamSystem  # noqa: E402
from orbslam3_tpu_torch.utils.datasets import RoomScene, orbit_trajectory  # noqa: E402
from orbslam3_tpu_torch.utils.evaluation import evaluate_trajectory  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="stereo", choices=["mono", "stereo", "rgbd"])
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--out", default="trajectory_tum.txt")
    ap.add_argument("--render", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    scene = RoomScene(seed=2, depth=6.0, half_w=4.0, half_h=2.5)
    poses = orbit_trajectory(args.frames, radius=0.6, forward=0.03)
    B = 0.11
    bf = B * scene.fx if args.mode != "mono" else 0.0
    slam = SlamSystem(scene.K, None, (scene.w, scene.h), n_features=512,
                      bf=bf, th_depth=B * 40, device=args.device)
    gt = []
    for i, (R, t) in enumerate(poses):
        if args.mode == "stereo":
            Rr, tr = scene.stereo_pose(R, t, B)
            info = slam.track_stereo(scene.render(R, t), scene.render(Rr, tr), i / 20.0)
        elif args.mode == "rgbd":
            img, depth = scene.render(R, t, return_depth=True)
            info = slam.track_rgbd(img, depth, i / 20.0)
        else:
            info = slam.track_monocular(scene.render(R, t), i / 20.0)
        gt.append(-R.T @ t)
        print(i, info, flush=True)

    slam.save_trajectory_tum(args.out)
    ts, _, t_wc, lost = slam.export_trajectory()
    ate, n = evaluate_trajectory(np.arange(args.frames) / 20.0, np.array(gt),
                                 ts[~lost], t_wc[~lost], with_scale=args.mode == "mono")
    print(f"RMS ATE: {ate:.4f} over {n} frames | stats: {slam.stats()}")
    if args.render:
        from orbslam3_tpu_torch.models.viewer import render_map
        render_map(slam.map, args.render, trajectory=t_wc)
        print("map rendered to", args.render)
    slam.shutdown(print_times=False)
    return slam


if __name__ == "__main__":
    main()
