#!/usr/bin/env python
"""ATE evaluation CLI of the PyTorch port: scripts/evaluate_ate.py with the
port's ``utils.evaluation`` (Horn alignment, optional scale for monocular,
RMS ATE; the reference's evaluation/evaluate_ate_scale.py:49-60 and
associate.py timestamp pairing). It needs no JAX.

Usage:
  python scripts/evaluate_ate_torch.py GROUND_TRUTH EST_TRAJECTORY \
      [--scale] [--max-dt 0.02] [--gt-format tum|euroc] [--verbose]

GROUND_TRUTH: TUM format (ts tx ty tz ...) or EuRoC csv (ns,px,py,pz,...).
EST_TRAJECTORY: TUM format (``SlamSystem.save_trajectory_tum``'s output).
Prints the RMS ATE in meters (and the recovered scale with --scale),
matching the reference's --verbose2 output fields.
"""
import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from orbslam3_tpu_torch.utils.evaluation import associate, horn_align  # noqa: E402


def load_traj(path, fmt):
    if fmt == "euroc":
        arr = np.loadtxt(path, delimiter=",", comments="#")
        return arr[:, 0] * 1e-9, arr[:, 1:4]
    arr = np.loadtxt(path, comments="#")
    return arr[:, 0], arr[:, 1:4]


def main(argv=None):
    """Parse ``argv`` (default the command line), print the result and return
    (RMS ATE, scale)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("gt_file")
    ap.add_argument("est_file")
    ap.add_argument("--scale", action="store_true",
                    help="align with scale (monocular)")
    ap.add_argument("--max-dt", type=float, default=0.02)
    ap.add_argument("--gt-format", default=None, choices=["tum", "euroc"])
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    fmt = args.gt_format
    if fmt is None:
        with open(args.gt_file) as f:
            first = f.readline()
        fmt = "euroc" if "," in first else "tum"
    gt_ts, gt_t = load_traj(args.gt_file, fmt)
    est_ts, est_t = load_traj(args.est_file, "tum")

    ia, ib = associate(gt_ts, est_ts, max_dt=args.max_dt)
    if len(ia) < 2:
        print("error: fewer than 2 associated pairs", file=sys.stderr)
        sys.exit(1)
    R, t, s = horn_align(est_t[ib], gt_t[ia], with_scale=args.scale)
    aligned = s * est_t[ib] @ R.T + t
    err = np.linalg.norm(aligned - gt_t[ia], axis=1)
    rmse = float(np.sqrt(np.mean(err ** 2)))
    if args.verbose:
        print(f"compared_pose_pairs {len(ia)} pairs")
        print(f"absolute_translational_error.rmse {rmse:.6f} m")
        print(f"absolute_translational_error.mean {err.mean():.6f} m")
        print(f"absolute_translational_error.median {np.median(err):.6f} m")
        print(f"absolute_translational_error.std {err.std():.6f} m")
        print(f"absolute_translational_error.min {err.min():.6f} m")
        print(f"absolute_translational_error.max {err.max():.6f} m")
        print(f"scale {s:.6f}")
    else:
        print(f"{rmse:.6f},{s:.6f}")
    return rmse, float(s)


if __name__ == "__main__":
    main()
