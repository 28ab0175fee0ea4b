#!/usr/bin/env python
"""EuRoC dataset driver on the PyTorch port (the reference's Examples/
mains, e.g. Examples/Monocular-Inertial/mono_inertial_euroc.cc).

Usage:
  python examples/run_euroc_torch.py SETTINGS.yaml SEQ_DIR [SEQ_DIR ...] \
      --mode mono|stereo|mono_vi|stereo_vi [--out traj.txt] [--gt groundtruth.csv] \
      [--max-frames N] [--render map.png] [--device cuda|cpu]

SEQ_DIR is the EuRoC sequence root containing mav0/. Stereo pairs are
rectified with the settings file's LEFT./RIGHT. blocks on the device.
"""
import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from orbslam3_tpu_torch.utils.config import load_config, rectify, system_from_config  # noqa: E402
from orbslam3_tpu_torch.utils.datasets import load_euroc_images, load_euroc_imu  # noqa: E402
from orbslam3_tpu_torch.utils.evaluation import evaluate_trajectory  # noqa: E402
from orbslam3_tpu_torch.utils.imageio import imread  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("seq_dirs", nargs="+",
                    help="one or more sequence roots; several = a multi-session Atlas run")
    ap.add_argument("--mode", default="mono",
                    choices=["mono", "stereo", "mono_vi", "stereo_vi"])
    ap.add_argument("--out", default="trajectory_tum.txt")
    ap.add_argument("--gt", default=None)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--render", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    slam = system_from_config(args.settings, device=args.device)
    # EuRoC stereo pairs are unrectified: rectify with the LEFT./RIGHT. blocks
    rect = None
    if args.mode.startswith("stereo"):
        rect = load_config(args.settings).stereo_rectify_maps()
    t_start = time.perf_counter()
    n_done = 0
    for si, seq_dir in enumerate(args.seq_dirs):
        stamps, paths = load_euroc_images(seq_dir, "cam0")
        if args.mode.startswith("stereo"):
            stamps_r, paths_r = load_euroc_images(seq_dir, "cam1")
        if args.mode.endswith("_vi"):
            imu_ts, gyro, acc = load_euroc_imu(seq_dir)
            cursor = 0
        if si > 0:
            print(f"-- session {si + 1}/{len(args.seq_dirs)}: {seq_dir} "
                  "(timestamp-gap handling spawns/merges Atlas sub-maps)")
        n = len(stamps) if not args.max_frames else min(args.max_frames, len(stamps))
        for i in range(n):
            img = imread(paths[i], "gray").astype(np.float32)
            ts = stamps[i]
            if args.mode.endswith("_vi"):
                end = np.searchsorted(imu_ts, ts, side="right")
                slam.tracker.grab_imu(imu_ts[cursor:end], gyro[cursor:end], acc[cursor:end])
                cursor = end
            if args.mode.startswith("stereo"):
                img_r = imread(paths_r[i], "gray").astype(np.float32)
                if rect is not None:
                    img = rectify(img, rect[0], slam.device).cpu().numpy()
                    img_r = rectify(img_r, rect[1], slam.device).cpu().numpy()
                info = slam.track_stereo(img, img_r, ts)
            else:
                info = slam.track_monocular(img, ts)
            n_done += 1
            if i % 50 == 0:
                print(f"[{i}/{n}] {info} ({n_done / (time.perf_counter() - t_start):.1f} fps)",
                      flush=True)

    slam.save_trajectory_tum(args.out)
    print("stats:", slam.stats())
    if args.render:
        from orbslam3_tpu_torch.models.viewer import render_map
        _, _, t_wc, _ = slam.export_trajectory()
        render_map(slam.map, args.render, trajectory=t_wc)
    if args.gt:
        gt = np.loadtxt(args.gt, delimiter=",", comments="#")
        ts, _, est_t, _ = slam.export_trajectory()
        ate, n_assoc = evaluate_trajectory(gt[:, 0] * 1e-9, gt[:, 1:4], ts, est_t,
                                           with_scale=args.mode == "mono")
        print(f"RMS ATE: {ate:.4f} m over {n_assoc} associations")
    slam.shutdown(print_times=False)
    return slam


if __name__ == "__main__":
    main()
