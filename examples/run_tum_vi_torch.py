#!/usr/bin/env python
"""TUM-VI dataset driver on the PyTorch port (the reference's Examples/ TUM-VI mains, e.g.
Examples/Monocular-Inertial/mono_inertial_tum_vi.cc and
Examples/Stereo-Inertial/stereo_inertial_tum_vi_512.cc).

Usage:
  python examples/run_tum_vi_torch.py SETTINGS.yaml SEQ_DIR [SEQ_DIR ...] \
      --mode mono|stereo|mono_vi|stereo_vi [--out traj.txt] [--max-frames N] \
      [--device cuda|cpu]

SEQ_DIR is a TUM-VI sequence root in EuRoC/ASL format (the distribution the
dataset ships as): mav0/cam0/data/*.png 512x512 fisheye, mav0/imu0/data.csv,
ground truth at mav0/mocap0/data.csv. Cameras are Kannala-Brandt-8; stereo
uses the heterogeneous two-camera fisheye rig (Camera2.* + Tlr YAML blocks,
reference src/Frame.cc:1340 two-camera constructor) — no rectification.
Multiple SEQ_DIRs run as one multi-session Atlas process (reference
tum_vi_examples.sh multi-session rows / ChangeDataset).
"""
import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from orbslam3_tpu_torch.utils.config import system_from_config  # noqa: E402
from orbslam3_tpu_torch.utils.datasets import load_euroc_images, load_euroc_imu  # noqa: E402
from orbslam3_tpu_torch.utils.evaluation import evaluate_trajectory  # noqa: E402
from orbslam3_tpu_torch.utils.imageio import imread  # noqa: E402


def load_tum_vi_mocap(seq_dir):
    """mav0/mocap0/data.csv: ts[ns], px, py, pz, qw, qx, qy, qz."""
    gt = np.loadtxt(f"{seq_dir}/mav0/mocap0/data.csv", delimiter=",",
                    comments="#")
    return gt[:, 0] * 1e-9, gt[:, 1:4]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("seq_dirs", nargs="+",
                    help="one or more TUM-VI sequence roots (EuRoC format); "
                    "several = a multi-session Atlas run")
    ap.add_argument("--mode", default="mono_vi",
                    choices=["mono", "stereo", "mono_vi", "stereo_vi"])
    ap.add_argument("--out", default="f_dataset_tum_vi.txt")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--render", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    slam = system_from_config(args.settings, device=args.device)
    stereo = args.mode.startswith("stereo")
    fisheye_rig = stereo and slam.tracker.rig is not None
    if stereo and not fisheye_rig and getattr(slam.tracker, "cam_type", 0) == 1:
        # TUM-VI cameras are 512x512 Kannala-Brandt fisheyes: pinhole-stereo
        # row matching on raw fisheye images is geometrically wrong (the
        # reference builds the two-camera KB8 rig from Camera2.*+Tlr,
        # src/Tracking.cc two-camera branch) — refuse rather than emit garbage
        raise SystemExit(
            "stereo mode requested but the settings YAML has no two-camera "
            "rig (Camera2.* + Tlr): refusing to run pinhole stereo on raw "
            "fisheye images. Add the rig to the YAML or use --mode mono/mono_vi.")
    t_start = time.perf_counter()
    n_done = 0
    gt_ts, gt_xyz = [], []
    for si, seq_dir in enumerate(args.seq_dirs):
        stamps, paths = load_euroc_images(seq_dir, "cam0")
        if stereo:
            _, paths_r = load_euroc_images(seq_dir, "cam1")
        if args.mode.endswith("_vi"):
            imu_ts, gyro, acc = load_euroc_imu(seq_dir)
            cursor = 0
        try:
            ts_g, xyz_g = load_tum_vi_mocap(seq_dir)
            gt_ts.append(ts_g)
            gt_xyz.append(xyz_g)
        except OSError:
            pass
        if si > 0:
            print(f"-- session {si + 1}/{len(args.seq_dirs)}: {seq_dir}")
        n = len(stamps) if not args.max_frames else min(args.max_frames,
                                                        len(stamps))
        for i in range(n):
            img = imread(paths[i], "gray").astype(np.float32)
            ts = stamps[i]
            if args.mode.endswith("_vi"):
                end = np.searchsorted(imu_ts, ts, side="right")
                slam.tracker.grab_imu(imu_ts[cursor:end], gyro[cursor:end],
                                      acc[cursor:end])
                cursor = end
            if stereo:
                img_r = imread(paths_r[i], "gray").astype(np.float32)
                if fisheye_rig:
                    info = slam.track_stereo_fisheye(img, img_r, ts)
                else:
                    info = slam.track_stereo(img, img_r, ts)
            else:
                info = slam.track_monocular(img, ts)
            n_done += 1
            if i % 50 == 0:
                print(f"[{i}/{n}] {info} "
                      f"({n_done / (time.perf_counter() - t_start):.1f} fps)",
                      flush=True)

    slam.save_trajectory_euroc(args.out)
    print("stats:", slam.stats())
    if args.render:
        from orbslam3_tpu_torch.models.viewer import render_map
        _, _, t_wc, _ = slam.export_trajectory()
        render_map(slam.map, args.render, trajectory=t_wc)
    if gt_ts:
        ate, n_assoc = evaluate_trajectory(
            np.concatenate(gt_ts), np.concatenate(gt_xyz),
            *(lambda e: (e[0], e[2]))(slam.export_trajectory()),
            with_scale=args.mode == "mono")
        print(f"RMS ATE: {ate:.4f} m over {n_assoc} associations")
    slam.shutdown(print_times=False)
    return slam


if __name__ == "__main__":
    main()
