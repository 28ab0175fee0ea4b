"""Settings loader: the reference's OpenCV-YAML settings files.

Port of ``orbslam3_tpu/utils/config.py`` without OpenCV: ``read_settings``
reads the ``%YAML:1.0`` subset of the reference's per-sensor settings files
(``key: value`` scalars and ``!!opencv-matrix`` blocks with ``rows``,
``cols``, ``dt`` and ``data``) into what ``cv2.FileStorage`` would give:
ints and reals as numbers, quoted or bare words as strings, matrices as
numpy arrays of their ``dt``. ``load_config`` then reads the same keys as
the JAX package, with the same validation (a missing camera key fails
cleanly). ``SlamConfig.stereo_rectify_maps`` is the map computation of
``cv2.initUndistortRectifyMap`` (radial-tangential distortion, R, P) in
numpy, and ``rectify`` the bilinear ``cv2.remap`` of the EuRoC stereo
driver, on the device.

As in the JAX package, ``system_from_config`` passes only ``n_features`` of
the ORBextractor keys on to the system.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np
import torch

_DT = {"u": np.uint8, "c": np.int8, "w": np.uint16, "s": np.int16, "i": np.int32,
       "f": np.float32, "d": np.float64}
_INT = re.compile(r"^[-+]?\d+$")
_REAL = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if ch in "\"'":
            quote = None if quote == ch else (quote or ch)
        elif ch == "#" and quote is None:
            return line[:i]
    return line


def _scalar(text: str):
    """A YAML scalar as cv2.FileStorage types it: int, float or str."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    if _INT.match(text):
        return int(text)
    if _REAL.match(text):
        return float(text)
    return text


def _matrix(block: dict) -> np.ndarray:
    dt = _DT[str(block.get("dt", "d"))[0]]
    data = np.asarray(block.get("data", []), np.float64)
    return data.astype(dt).reshape(int(block["rows"]), int(block["cols"]))


def read_settings(path: str) -> dict:
    """The top-level nodes of a settings file: {key: int | float | str |
    np.ndarray | dict}."""
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines or not lines[0].startswith("%YAML"):
        raise IOError(f"{path}: not an OpenCV YAML settings file (no %YAML header)")
    out: dict = {}
    key, block, pending = None, None, ""

    def close():
        if key is not None and block is not None:
            out[key] = _matrix(block) if block.pop("__matrix__", False) else block

    for raw in lines[1:]:
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() == "---":
            continue
        if pending:                      # a flow sequence spanning lines
            pending += " " + line.strip()
            if "]" in line:
                sub, val = pending.split(":", 1)
                block[sub.strip()] = _seq(val)
                pending = ""
            continue
        indented = line[0] in " \t"
        k, _, val = line.strip().partition(":")
        k, val = k.strip(), val.strip()
        if indented and block is not None:
            if val.startswith("[") and "]" not in val:
                pending = f"{k}: {val}"
            else:
                block[k] = _seq(val) if val.startswith("[") else _scalar(val)
            continue
        close()
        key, block = k, None
        if val.startswith("!!opencv-matrix"):
            block = {"__matrix__": True}
        elif val == "":
            block = {}
        else:
            out[k] = _seq(val) if val.startswith("[") else _scalar(val)
    close()
    return out


def _seq(text: str) -> list:
    body = text.strip().lstrip("[").rstrip("]")
    return [_scalar(v) for v in body.split(",") if v.strip()]


@dataclass
class SlamConfig:
    camera_type: str = "PinHole"        # "PinHole" | "KannalaBrandt8"
    K: np.ndarray = None                # (4,) fx fy cx cy
    D: np.ndarray = None                # (5,) k1 k2 p1 p2 k3 (pinhole) / (4,) KB8 k0..k3
    width: int = 752
    height: int = 480
    fps: float = 20.0
    rgb: bool = True
    bf: float = 0.0
    th_depth: float = 0.0
    depth_map_factor: float = 1.0
    # ORB
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # IMU
    has_imu: bool = False
    imu_freq: float = 200.0
    imu_noise_gyro: float = 1.7e-4
    imu_noise_acc: float = 2e-3
    imu_gyro_walk: float = 1.9e-5
    imu_acc_walk: float = 3e-3
    Tbc: np.ndarray = None              # (4,4) body←camera
    th_far_points: float = 0.0
    # example-level stereo rectification: LEFT./RIGHT. K, D, R, P
    rect_left: dict = None              # {K,D,R,P,width,height} raw matrices
    rect_right: dict = None
    # two-camera fisheye rig (Camera2.* + Tlr + lapping areas)
    K2: np.ndarray = None               # (8,) fx fy cx cy k1..k4 (KB8)
    Tlr: np.ndarray = None              # (4,4)
    lapping1: tuple = None
    lapping2: tuple = None
    missing: list = field(default_factory=list)

    def stereo_rectify_maps(self):
        """Undistort + rectify pixel maps from the LEFT./RIGHT. blocks, as
        ``cv2.initUndistortRectifyMap(K, D, R, P[:3, :3], size, CV_32FC1)``
        computes them. Returns ((map1x, map1y), (map2x, map2y)), float32
        (height, width) each, or None without rectification blocks."""
        if not (self.rect_left and self.rect_right):
            return None
        return tuple(undistort_rectify_map(r["K"], r["D"], r["R"], r["P"][:3, :3],
                                           (int(r["width"]), int(r["height"])))
                     for r in (self.rect_left, self.rect_right))


def undistort_rectify_map(K, D, R, P, size):
    """For each pixel (u, v) of the rectified image, the pixel of the raw
    image it samples: the ray (P·R)⁻¹ (u, v, 1) through the radial-tangential
    model (k1 k2 p1 p2 [k3]) and K. Returns (map_x, map_y) float32 of shape
    (height, width)."""
    K = np.asarray(K, np.float64).reshape(3, 3)
    d = np.zeros(5)
    dd = np.asarray(D, np.float64).reshape(-1)[:5]
    d[: len(dd)] = dd
    k1, k2, p1, p2, k3 = d
    iR = np.linalg.inv(np.asarray(P, np.float64).reshape(3, 3)
                       @ np.asarray(R, np.float64).reshape(3, 3))
    w, h = size
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    X = iR[0, 0] * u + iR[0, 1] * v + iR[0, 2]
    Y = iR[1, 0] * u + iR[1, 1] * v + iR[1, 2]
    W = iR[2, 0] * u + iR[2, 1] * v + iR[2, 2]
    x, y = X / W, Y / W
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    xy2 = 2 * x * y
    mx = K[0, 0] * (x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)) + K[0, 2]
    my = K[1, 1] * (y * kr + p1 * (r2 + 2 * y2) + p2 * xy2) + K[1, 2]
    return mx.astype(np.float32), my.astype(np.float32)


def rectify(img, maps, device=None) -> torch.Tensor:
    """Bilinear resampling of ``img`` at ``maps = (map_x, map_y)``, as
    ``cv2.remap(img, map_x, map_y, INTER_LINEAR)`` does for a float image,
    outside pixels read as 0. Returns a float32 (height, width) tensor on
    ``device`` (None: the card)."""
    from .. import resolve_device
    dev = resolve_device(device)
    src = torch.as_tensor(np.asarray(img, np.float32), device=dev)
    H, W = src.shape
    mx = torch.as_tensor(np.asarray(maps[0], np.float32), device=dev)
    my = torch.as_tensor(np.asarray(maps[1], np.float32), device=dev)
    fx, fy = torch.floor(mx), torch.floor(my)
    ax, ay = mx - fx, my - fy
    x0, y0 = fx.to(torch.int64), fy.to(torch.int64)
    out = torch.zeros_like(mx)
    for dy, wy in ((0, 1.0 - ay), (1, ay)):
        for dx, wx in ((0, 1.0 - ax), (1, ax)):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            v = src[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
            out = out + torch.where(inside, v, 0.0) * (wx * wy)
    return out


def load_config(path: str) -> SlamConfig:
    try:
        fs = read_settings(path)
    except OSError as e:
        raise IOError(f"cannot open settings file {path}") from e
    cfg = SlamConfig()

    def get(key, default=None, required=False):
        if key not in fs:
            if required:
                cfg.missing.append(key)
            return default
        val = fs[key]
        if isinstance(val, str):
            return val
        if isinstance(val, (int, float)):
            return float(val)
        return val

    cam_type = get("Camera.type", "PinHole")
    cfg.camera_type = cam_type
    fx = get("Camera.fx", required=True)
    fy = get("Camera.fy", required=True)
    cx = get("Camera.cx", required=True)
    cy = get("Camera.cy", required=True)
    if cfg.missing:
        raise ValueError(f"missing required camera keys: {cfg.missing}")
    cfg.K = np.asarray([fx, fy, cx, cy], np.float32)
    if cam_type == "KannalaBrandt8":
        cfg.D = np.asarray([get(f"Camera.k{i+1}", 0.0) for i in range(4)], np.float32)
    else:
        cfg.D = np.asarray([get("Camera.k1", 0.0), get("Camera.k2", 0.0),
                            get("Camera.p1", 0.0), get("Camera.p2", 0.0),
                            get("Camera.k3", 0.0)], np.float32)
    cfg.width = int(get("Camera.width", cfg.width))
    cfg.height = int(get("Camera.height", cfg.height))
    cfg.fps = float(get("Camera.fps", cfg.fps))
    cfg.rgb = bool(int(get("Camera.RGB", 1)))
    cfg.bf = float(get("Camera.bf", 0.0))
    th = get("ThDepth", 0.0)
    if th and cfg.bf:
        cfg.th_depth = float(th) * cfg.bf / cfg.K[0]
    cfg.depth_map_factor = float(get("DepthMapFactor", 1.0))

    cfg.n_features = int(get("ORBextractor.nFeatures", cfg.n_features))
    cfg.scale_factor = float(get("ORBextractor.scaleFactor", cfg.scale_factor))
    cfg.n_levels = int(get("ORBextractor.nLevels", cfg.n_levels))
    cfg.ini_th_fast = int(get("ORBextractor.iniThFAST", cfg.ini_th_fast))
    cfg.min_th_fast = int(get("ORBextractor.minThFAST", cfg.min_th_fast))

    cfg.th_far_points = float(get("thFarPoints", 0.0))

    # second (right) camera of a two-camera fisheye rig
    fx2 = get("Camera2.fx")
    if fx2 is not None and cam_type == "KannalaBrandt8":
        cfg.K2 = np.asarray(
            [fx2, get("Camera2.fy", 0.0), get("Camera2.cx", 0.0), get("Camera2.cy", 0.0)]
            + [get(f"Camera2.k{i+1}", 0.0) for i in range(4)], np.float32)
        tlr = get("Tlr")
        if tlr is not None and hasattr(tlr, "shape"):
            cfg.Tlr = np.asarray(tlr, np.float32).reshape(-1, 4)
        cfg.lapping1 = (float(get("Camera.lappingBegin", 0.0)),
                        float(get("Camera.lappingEnd", 1e9)))
        cfg.lapping2 = (float(get("Camera2.lappingBegin", 0.0)),
                        float(get("Camera2.lappingEnd", 1e9)))

    def rect_block(prefix):
        K = get(f"{prefix}.K")
        D = get(f"{prefix}.D")
        R = get(f"{prefix}.R")
        P = get(f"{prefix}.P")
        w = get(f"{prefix}.width")
        h = get(f"{prefix}.height")
        if any(v is None for v in (K, D, R, P, w, h)):
            return None
        return {"K": np.asarray(K, np.float64), "D": np.asarray(D, np.float64),
                "R": np.asarray(R, np.float64), "P": np.asarray(P, np.float64),
                "width": int(w), "height": int(h)}

    cfg.rect_left = rect_block("LEFT")
    cfg.rect_right = rect_block("RIGHT")

    tbc = get("Tbc")
    if tbc is not None and hasattr(tbc, "shape"):
        cfg.Tbc = np.asarray(tbc, np.float32).reshape(4, 4)
        cfg.has_imu = True
    freq = get("IMU.Frequency")
    if freq is not None:
        cfg.has_imu = True
        cfg.imu_freq = float(freq)
        cfg.imu_noise_gyro = float(get("IMU.NoiseGyro", cfg.imu_noise_gyro))
        cfg.imu_noise_acc = float(get("IMU.NoiseAcc", cfg.imu_noise_acc))
        cfg.imu_gyro_walk = float(get("IMU.GyroWalk", cfg.imu_gyro_walk))
        cfg.imu_acc_walk = float(get("IMU.AccWalk", cfg.imu_acc_walk))
    return cfg


def system_from_config(path: str, **kwargs):
    """A SlamSystem from a reference-style settings file (the reference
    System constructor's path); ``kwargs`` go to ``SlamSystem`` (``device``
    among them: None is the card)."""
    from ..models.system import SlamSystem
    cfg = load_config(path)
    cam_type = 1 if cfg.camera_type == "KannalaBrandt8" else 0
    K = cfg.K if cam_type == 0 else np.concatenate([cfg.K, cfg.D])
    system = SlamSystem(K, cfg.D if cam_type == 0 else None, (cfg.width, cfg.height),
                        n_features=cfg.n_features, bf=cfg.bf, th_depth=cfg.th_depth,
                        cam_type=cam_type, **kwargs)
    if cfg.K2 is not None and cfg.Tlr is not None:
        # two-camera fisheye rig
        R_rl = cfg.Tlr[:3, :3].T
        t_rl = -R_rl @ cfg.Tlr[:3, 3]
        system.set_fisheye_rig(cfg.K2, R_rl, t_rl, lap_l=cfg.lapping1, lap_r=cfg.lapping2)
    if cfg.has_imu:
        system.enable_imu(freq=cfg.imu_freq,
                          noise=(cfg.imu_noise_gyro, cfg.imu_noise_acc,
                                 cfg.imu_gyro_walk, cfg.imu_acc_walk))
    return system
