#!/usr/bin/env python
"""TUM RGB-D dataset driver on the PyTorch port (the reference's
Examples/RGB-D/rgbd_tum.cc).

Usage:
  python examples/run_tum_rgbd_torch.py SETTINGS.yaml SEQ_DIR \
      [--out traj.txt] [--gt groundtruth.txt] [--max-frames N] [--device cuda|cpu]

SEQ_DIR is a TUM RGB-D sequence dir (rgb.txt, depth.txt, rgb/, depth/).
RGB and depth images are paired by nearest timestamp. Depth images are
uint16, divided by the settings file's DepthMapFactor (5000 for TUM).
"""
import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from orbslam3_tpu_torch.utils.config import load_config, system_from_config  # noqa: E402
from orbslam3_tpu_torch.utils.datasets import load_tum_rgbd  # noqa: E402
from orbslam3_tpu_torch.utils.evaluation import evaluate_trajectory  # noqa: E402
from orbslam3_tpu_torch.utils.imageio import imread  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("seq_dir")
    ap.add_argument("--out", default="trajectory_tum.txt")
    ap.add_argument("--gt", default=None, help="TUM groundtruth.txt (ts tx ty tz qx qy qz qw)")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(args.settings)
    slam = system_from_config(args.settings, device=args.device)
    stamps, rgb_paths, depth_paths = load_tum_rgbd(args.seq_dir)
    n = len(stamps) if not args.max_frames else min(args.max_frames, len(stamps))
    t_start = time.perf_counter()
    for i in range(n):
        img = imread(rgb_paths[i], "gray").astype(np.float32)
        depth = imread(depth_paths[i], "unchanged").astype(np.float32)
        depth /= cfg.depth_map_factor
        info = slam.track_rgbd(img, depth, stamps[i])
        if i % 50 == 0:
            print(f"[{i}/{n}] {info} ({(i + 1) / (time.perf_counter() - t_start):.1f} fps)",
                  flush=True)

    slam.save_trajectory_tum(args.out)
    print("stats:", slam.stats())
    if args.gt:
        gt = np.loadtxt(args.gt, comments="#")
        ts, _, est_t, _ = slam.export_trajectory()
        ate, n_assoc = evaluate_trajectory(gt[:, 0], gt[:, 1:4], ts, est_t, with_scale=False)
        print(f"RMS ATE: {ate:.4f} m over {n_assoc} associations")
    slam.shutdown(print_times=False)
    return slam


if __name__ == "__main__":
    main()
