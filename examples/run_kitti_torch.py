#!/usr/bin/env python
"""KITTI odometry dataset driver on the PyTorch port (the reference's
Examples/Monocular/mono_kitti.cc and Examples/Stereo/stereo_kitti.cc).

Usage:
  python examples/run_kitti_torch.py SETTINGS.yaml SEQ_DIR --mode mono|stereo \
      [--out traj_kitti.txt] [--gt poses.txt] [--max-frames N] [--device cuda|cpu]

SEQ_DIR is a KITTI odometry sequence dir (times.txt, image_0/, image_1/).
KITTI images are rectified already; the trajectory is saved in KITTI format
(12 numbers per row).
"""
import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from orbslam3_tpu_torch.utils.config import system_from_config  # noqa: E402
from orbslam3_tpu_torch.utils.datasets import load_kitti_sequence  # noqa: E402
from orbslam3_tpu_torch.utils.evaluation import evaluate_trajectory  # noqa: E402
from orbslam3_tpu_torch.utils.imageio import imread  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("seq_dir")
    ap.add_argument("--mode", default="mono", choices=["mono", "stereo"])
    ap.add_argument("--out", default="trajectory_kitti.txt")
    ap.add_argument("--gt", default=None, help="KITTI poses file (12 numbers/row ground truth)")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    slam = system_from_config(args.settings, device=args.device)
    stamps, left, right = load_kitti_sequence(args.seq_dir)
    n = len(stamps) if not args.max_frames else min(args.max_frames, len(stamps))
    t_start = time.perf_counter()
    for i in range(n):
        img = imread(left[i], "gray").astype(np.float32)
        if args.mode == "stereo":
            img_r = imread(right[i], "gray").astype(np.float32)
            info = slam.track_stereo(img, img_r, stamps[i])
        else:
            info = slam.track_monocular(img, stamps[i])
        if i % 50 == 0:
            print(f"[{i}/{n}] {info} ({(i + 1) / (time.perf_counter() - t_start):.1f} fps)",
                  flush=True)

    slam.save_trajectory_kitti(args.out)
    print("stats:", slam.stats())
    if args.gt:
        gt = np.loadtxt(args.gt)          # (N,12) row-major [R|t]
        gt_t = gt[:, [3, 7, 11]]
        ts, _, est_t, _ = slam.export_trajectory()
        ate, n_assoc = evaluate_trajectory(stamps[: len(gt_t)], gt_t, ts, est_t,
                                           with_scale=args.mode == "mono")
        print(f"RMS ATE: {ate:.4f} m over {n_assoc} associations")
    slam.shutdown(print_times=False)
    return slam


if __name__ == "__main__":
    main()
