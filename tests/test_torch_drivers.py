"""The port's example drivers (``examples/run_*_torch.py``) on the CPU, on
tiny dataset layouts written into ``tmp_path``: a rendered RoomScene orbit
(the synthetic demo's scene and rig) as EuRoC (stereo, rectified on the
device with identity LEFT./RIGHT. blocks; also read by the TUM-VI driver),
KITTI (stereo) and TUM RGB-D (colour PNG + 16-bit depth at DepthMapFactor
5000), the images written by the port's PNG writer; and the synthetic demo
with its map rendering. Each driver runs in-process with ``--device cpu``,
tracks from its first frame (stereo and RGB-D initialize at once) and writes
its trajectory in its format, one line per frame. The ROS driver without a
ROS installation says so and exits 2. Also tests/test_dataset_loaders.py's
two cases on the port's loaders."""
import os
import sys

import numpy as np
import pytest

from orbslam3_tpu_torch.utils import imageio
from orbslam3_tpu_torch.utils.datasets import (RoomScene, load_kitti_sequence, load_tum_rgbd,
                                               orbit_trajectory)
from torch_port_helpers import torch_threads  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "examples"))

N = 3
B = 0.11


@pytest.fixture(scope="module")
def rendered():
    # the synthetic demo's room at half its resolution (and focal length)
    scene = RoomScene(seed=2, depth=6.0, half_w=4.0, half_h=2.5, w=376, h=240,
                      fx=229.327, fy=228.648, cx=188.0, cy=120.0)
    out = []
    for R, t in orbit_trajectory(N, radius=0.6, forward=0.03):
        Rr, tr = scene.stereo_pose(R, t, B)
        img, depth = scene.render(R, t, return_depth=True)
        out.append((np.clip(img, 0, 255).astype(np.uint8),
                    np.clip(scene.render(Rr, tr), 0, 255).astype(np.uint8), depth))
    return scene, out


def _settings(path, scene, rect=False):
    fx, fy, cx, cy = (float(v) for v in scene.K)
    text = (f"%YAML:1.0\nCamera.type: \"PinHole\"\nCamera.fx: {fx}\nCamera.fy: {fy}\n"
            f"Camera.cx: {cx}\nCamera.cy: {cy}\nCamera.k1: 0.0\nCamera.k2: 0.0\n"
            f"Camera.p1: 0.0\nCamera.p2: 0.0\nCamera.width: {scene.w}\n"
            f"Camera.height: {scene.h}\nCamera.fps: 20.0\nCamera.RGB: 1\n"
            f"Camera.bf: {B * fx}\nThDepth: 40.0\nDepthMapFactor: 5000.0\n"
            "ORBextractor.nFeatures: 512\nORBextractor.scaleFactor: 1.2\n"
            "ORBextractor.nLevels: 8\nORBextractor.iniThFAST: 20\nORBextractor.minThFAST: 7\n")
    if rect:
        for side, tx in (("LEFT", 0.0), ("RIGHT", -B * fx)):
            mats = {"K": (3, 3, [fx, 0, cx, 0, fy, cy, 0, 0, 1]), "D": (1, 5, [0.0] * 5),
                    "R": (3, 3, [1, 0, 0, 0, 1, 0, 0, 0, 1]),
                    "P": (3, 4, [fx, 0, cx, tx, 0, fy, cy, 0, 0, 0, 1, 0])}
            text += f"{side}.width: {scene.w}\n{side}.height: {scene.h}\n"
            for name, (r, c, data) in mats.items():
                text += (f"{side}.{name}: !!opencv-matrix\n   rows: {r}\n   cols: {c}\n"
                         f"   dt: d\n   data: [{', '.join(str(float(v)) for v in data)}]\n")
    path.write_text(text)
    return str(path)


def _lines(path, n_fields):
    rows = [line.split() for line in open(path).read().splitlines()]
    assert len(rows) == N and all(len(r) == n_fields for r in rows), rows[:2]
    return np.array(rows, float)


def _euroc_layout(seq, frames):
    for cam in ("cam0", "cam1"):
        (seq / "mav0" / cam / "data").mkdir(parents=True)
        with open(seq / "mav0" / cam / "data.csv", "w") as f:
            f.write("#timestamp [ns],filename\n")
            for i, fr in enumerate(frames):
                ts = 1403636579763555584 + i * 50_000_000
                imageio.imwrite(str(seq / "mav0" / cam / "data" / f"{ts}.png"),
                                fr[0 if cam == "cam0" else 1])
                f.write(f"{ts},{ts}.png\n")
    return str(seq)


def test_euroc_stereo(tmp_path, rendered):
    import run_euroc_torch
    scene, frames = rendered
    seq = _euroc_layout(tmp_path / "MH_01", frames)
    out = str(tmp_path / "traj.txt")
    slam = run_euroc_torch.main([_settings(tmp_path / "s.yaml", scene, rect=True), seq,
                                 "--mode", "stereo", "--out", out, "--device", "cpu"])
    rows = _lines(out, 8)
    assert np.all(np.diff(rows[:, 0]) > 0) and slam.stats()["n_keyframes"] >= 1
    assert slam.tracker.state.name == "OK"


def test_tum_vi_stereo_on_a_euroc_layout(tmp_path, rendered):
    """TUM-VI ships in the EuRoC layout; a pinhole rig runs its stereo branch
    and the trajectory comes out in EuRoC format (ns timestamps)."""
    import run_tum_vi_torch
    scene, frames = rendered
    seq = _euroc_layout(tmp_path / "room1", frames)
    out = str(tmp_path / "traj.txt")
    slam = run_tum_vi_torch.main([_settings(tmp_path / "s.yaml", scene), seq, "--mode", "stereo",
                                  "--out", out, "--device", "cpu"])
    rows = _lines(out, 8)
    assert abs(rows[0, 0] - 1403636579763555584) < 1e3      # float64 seconds, printed in ns
    assert slam.tracker.state.name == "OK"


def test_synthetic_demo(tmp_path):
    import run_synthetic_torch
    out, png = str(tmp_path / "traj.txt"), str(tmp_path / "map.png")
    slam = run_synthetic_torch.main(["--mode", "rgbd", "--frames", str(N), "--out", out,
                                     "--render", png, "--device", "cpu"])
    _lines(out, 8)
    assert imageio.imread(png).shape == (880, 1100, 3)
    assert slam.tracker.state.name == "OK"


def test_kitti_stereo(tmp_path, rendered):
    import run_kitti_torch
    scene, frames = rendered
    seq = tmp_path / "00"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir()
    (seq / "times.txt").write_text("".join(f"{0.1 * i:.6e}\n" for i in range(N)))
    for i, fr in enumerate(frames):
        imageio.imwrite(str(seq / "image_0" / f"{i:06d}.png"), fr[0])
        imageio.imwrite(str(seq / "image_1" / f"{i:06d}.png"), fr[1])
    out = str(tmp_path / "traj_kitti.txt")
    slam = run_kitti_torch.main([_settings(tmp_path / "s.yaml", scene), str(seq),
                                 "--mode", "stereo", "--out", out, "--device", "cpu"])
    rows = _lines(out, 12).reshape(N, 3, 4)
    np.testing.assert_allclose(rows[0, :, :3], np.eye(3), atol=1e-6)   # the first frame
    assert slam.tracker.state.name == "OK"


def test_tum_rgbd(tmp_path, rendered):
    import run_tum_rgbd_torch
    scene, frames = rendered
    seq = tmp_path / "fr1"
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir()
    rgb_list, depth_list = ["# color images\n"], ["# depth maps\n"]
    for i, (img, _, depth) in enumerate(frames):
        ts = 1305031102.175304 + 0.05 * i
        imageio.imwrite(str(seq / "rgb" / f"{ts:.6f}.png"), np.repeat(img[..., None], 3, -1))
        imageio.imwrite(str(seq / "depth" / f"{ts + 0.004:.6f}.png"),
                        np.clip(depth * 5000.0, 0, 65535).astype(np.uint16))
        rgb_list.append(f"{ts:.6f} rgb/{ts:.6f}.png\n")
        depth_list.append(f"{ts + 0.004:.6f} depth/{ts + 0.004:.6f}.png\n")
    (seq / "rgb.txt").write_text("".join(rgb_list))
    (seq / "depth.txt").write_text("".join(depth_list))
    out = str(tmp_path / "traj.txt")
    slam = run_tum_rgbd_torch.main([_settings(tmp_path / "s.yaml", scene), str(seq),
                                    "--out", out, "--device", "cpu"])
    rows = _lines(out, 8)
    np.testing.assert_allclose(np.linalg.norm(rows[:, 4:], axis=1), 1.0, atol=1e-5)
    assert slam.tracker.state.name == "OK"


def test_ros_driver_without_ros(tmp_path, rendered, capsys):
    import run_ros_torch
    assert run_ros_torch.main([_settings(tmp_path / "s.yaml", rendered[0]),
                               "--device", "cpu"]) == 2
    assert "needs a ROS1 environment" in capsys.readouterr().err


def test_kitti_layout(tmp_path):
    seq = tmp_path / "00"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir()
    (seq / "times.txt").write_text("0.0\n0.1\n0.2\n")
    ts, left, right = load_kitti_sequence(str(seq))
    assert len(ts) == 3 and ts[2] == 0.2
    assert left[1].endswith("image_0/000001.png")
    assert right[2].endswith("image_1/000002.png")


def test_tum_rgbd_association(tmp_path):
    seq = tmp_path / "fr1"
    seq.mkdir()
    (seq / "rgb.txt").write_text(
        "# comment\n1.00 rgb/1.00.png\n1.05 rgb/1.05.png\n1.50 rgb/1.50.png\n")
    (seq / "depth.txt").write_text(
        "1.01 depth/1.01.png\n1.06 depth/1.06.png\n2.00 depth/2.00.png\n")
    ts, rgb, depth = load_tum_rgbd(str(seq), max_dt=0.02)
    assert len(ts) == 2
    assert rgb[0].endswith("rgb/1.00.png") and depth[0].endswith("depth/1.01.png")
    assert rgb[1].endswith("rgb/1.05.png") and depth[1].endswith("depth/1.06.png")
