"""Dataset loaders and synthetic sequence generation.

The reference is driven by EuRoC / TUM / KITTI datasets (reference
Examples/*); none are present in this environment, so the test pyramid is
built on synthetic sequences with exact ground truth: a textured random
point cloud rendered into a moving pinhole camera. This gives golden values
for every stage (known 3D points, known poses, known associations) — the
unit-level oracle the reference never had (its only oracle is dataset ATE,
reference evaluation/evaluate_ate_scale.py).

Also provides a real EuRoC loader (directory layout cam0/data.csv + data/,
reference Examples/Monocular/mono_euroc.cc LoadImages) for when data exists.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class SyntheticScene:
    """Random textured 3D point cloud + IMU-free trajectory generator."""

    n_points: int = 600
    seed: int = 0
    extent: float = 8.0      # lateral world extent
    depth_min: float = 4.0
    depth_max: float = 14.0
    patch: int = 15          # sprite texture size (odd)
    h: int = 480
    w: int = 752
    fx: float = 458.654
    fy: float = 457.296
    cx: float = 376.0
    cy: float = 240.0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.points = np.stack(
            [
                rng.uniform(-self.extent, self.extent, self.n_points),
                rng.uniform(-self.extent * 0.6, self.extent * 0.6, self.n_points),
                rng.uniform(self.depth_min, self.depth_max, self.n_points),
            ],
            axis=-1,
        )
        # high-contrast random sprite per point, radially masked so each sprite
        # has one dominant corner region with a distinctive BRIEF signature
        self.textures = rng.uniform(60.0, 255.0, size=(self.n_points, self.patch, self.patch))
        self.textures *= rng.random(size=(self.n_points, self.patch, self.patch)) > 0.45
        r = self.patch // 2
        dyx = np.arange(-r, r + 1)
        rad2 = dyx[:, None] ** 2 + dyx[None, :] ** 2
        self.textures *= (rad2 <= r * r).astype(float)
        # mild smoothing so bilinear resampling across perspective scales is
        # stable (no aliased corner popping)
        from scipy.ndimage import gaussian_filter as _gf
        self.textures = np.stack([_gf(t, 0.6) for t in self.textures])
        # Background: a textured 3D plane at z=bg_depth rendered with true
        # parallax. A flat background makes all off-sprite BRIEF bits constant
        # (sibling-corner descriptor confusion real imagery doesn't have), and
        # a static screen-space texture would vote for zero camera motion; a
        # world-anchored plane gives informative descriptors AND correct
        # geometry. Kept smooth (corner-free) so FAST fires on sprites.
        from scipy.ndimage import gaussian_filter
        self.bg_depth = 25.0
        ext = self.bg_depth * 1.1 + 5.0
        self.bg_spacing = ext * 2 / 1023
        noise = rng.uniform(0.0, 1.0, size=(1024, 1024))
        smooth = gaussian_filter(noise, sigma=8.0)
        smooth = (smooth - smooth.min()) / max(float(np.ptp(smooth)), 1e-9)
        self.bg_tex = 15.0 + 45.0 * smooth
        self.bg_ext = ext

    @property
    def K(self) -> np.ndarray:
        return np.array([self.fx, self.fy, self.cx, self.cy], dtype=np.float32)

    def _render_background(self, R_cw: np.ndarray, t_cw: np.ndarray) -> np.ndarray:
        """Ray-cast the textured background plane z=bg_depth (bilinear sampling)."""
        uu, vv = np.meshgrid(np.arange(self.w), np.arange(self.h))
        rays_c = np.stack([(uu - self.cx) / self.fx, (vv - self.cy) / self.fy,
                           np.ones_like(uu, float)], axis=-1)
        R_wc = R_cw.T
        c = -R_wc @ t_cw
        rays_w = rays_c @ R_wc.T
        lam = (self.bg_depth - c[2]) / np.maximum(rays_w[..., 2], 1e-6)
        pw = c + lam[..., None] * rays_w
        gx = (pw[..., 0] + self.bg_ext) / self.bg_spacing
        gy = (pw[..., 1] + self.bg_ext) / self.bg_spacing
        gx = np.clip(gx, 0, self.bg_tex.shape[1] - 1.001)
        gy = np.clip(gy, 0, self.bg_tex.shape[0] - 1.001)
        x0 = gx.astype(int); y0 = gy.astype(int)
        fx_ = gx - x0; fy_ = gy - y0
        t00 = self.bg_tex[y0, x0]
        t01 = self.bg_tex[y0, x0 + 1]
        t10 = self.bg_tex[y0 + 1, x0]
        t11 = self.bg_tex[y0 + 1, x0 + 1]
        return (t00 * (1 - fx_) * (1 - fy_) + t01 * fx_ * (1 - fy_)
                + t10 * (1 - fx_) * fy_ + t11 * fx_ * fy_)

    # world half-size of a sprite (true planar patches → perspective-correct
    # scaling; a fixed-pixel sprite would make detected corners correspond to
    # 3D points that slide with depth — a bias no BA can remove)
    sprite_half_world: float = 0.22

    def render(self, R_cw: np.ndarray, t_cw: np.ndarray) -> np.ndarray:
        """Render the scene from world→camera pose (R,t). Returns (H,W) float32 image.

        Sprites are fronto-parallel planar patches of fixed WORLD size, sampled
        bilinearly at the true subpixel projection (no integer quantization),
        composited far-to-near (painter's algorithm for true occlusion).
        """
        pc = self.points @ R_cw.T + t_cw
        z = pc[:, 2]
        vis = z > 0.5
        u = self.fx * pc[:, 0] / np.where(vis, z, 1.0) + self.cx
        v = self.fy * pc[:, 1] / np.where(vis, z, 1.0) + self.cy
        img = self._render_background(R_cw, t_cw)
        r_tex = self.patch // 2
        order = np.argsort(-z)
        for i in order:
            if not vis[i]:
                continue
            r_px = self.fx * self.sprite_half_world / z[i]
            if r_px < 1.5:
                continue
            x_lo = int(np.floor(u[i] - r_px))
            x_hi = int(np.ceil(u[i] + r_px)) + 1
            y_lo = int(np.floor(v[i] - r_px))
            y_hi = int(np.ceil(v[i] + r_px)) + 1
            if x_hi <= 0 or y_hi <= 0 or x_lo >= self.w or y_lo >= self.h:
                continue
            x_lo2, x_hi2 = max(x_lo, 0), min(x_hi, self.w)
            y_lo2, y_hi2 = max(y_lo, 0), min(y_hi, self.h)
            xs = np.arange(x_lo2, x_hi2)
            ys = np.arange(y_lo2, y_hi2)
            # texture coords: subpixel-aligned, perspective-scaled
            txc = (xs - u[i]) / r_px * r_tex + r_tex
            tyc = (ys - v[i]) / r_px * r_tex + r_tex
            TX, TY = np.meshgrid(txc, tyc)
            inside = (TX >= 0) & (TX <= 2 * r_tex - 1.001) & (TY >= 0) & (TY <= 2 * r_tex - 1.001)
            TXc = np.clip(TX, 0, 2 * r_tex - 1.001)
            TYc = np.clip(TY, 0, 2 * r_tex - 1.001)
            x0 = TXc.astype(int); y0 = TYc.astype(int)
            fx_ = TXc - x0; fy_ = TYc - y0
            tex = self.textures[i]
            val = (tex[y0, x0] * (1 - fx_) * (1 - fy_) + tex[y0, x0 + 1] * fx_ * (1 - fy_)
                   + tex[y0 + 1, x0] * (1 - fx_) * fy_ + tex[y0 + 1, x0 + 1] * fx_ * fy_)
            on = inside & (val > 30.0)
            region = img[y_lo2:y_hi2, x_lo2:x_hi2]
            region[on] = val[on]
        return img.astype(np.float32)

    def project(self, R_cw: np.ndarray, t_cw: np.ndarray):
        """Ground-truth projections: (u, v, z, visible_mask)."""
        pc = self.points @ R_cw.T + t_cw
        z = pc[:, 2]
        vis = z > 0.1
        u = self.fx * pc[:, 0] / np.where(vis, z, 1.0) + self.cx
        v = self.fy * pc[:, 1] / np.where(vis, z, 1.0) + self.cy
        r = self.fx * self.sprite_half_world / np.where(vis, z, 1.0)
        inb = vis & (u >= r) & (u < self.w - r) & (v >= r) & (v < self.h - r)
        return u, v, z, inb


@dataclass
class RoomScene:
    """A textured box room rendered by ray casting — fully 3D, projectively
    exact at every pixel, FAST corners at all scales. The fixture of choice for
    end-to-end SLAM tests (sprite scenes keep per-landmark ground truth for
    feature/matching tests; this one exercises realistic dense imagery).

    Box interior: back wall z=depth, floor y=+half_h, ceiling y=-half_h,
    side walls x=±half_w. Camera starts near the origin looking +z.
    """

    seed: int = 0
    depth: float = 12.0
    half_w: float = 8.0
    half_h: float = 4.0
    tex_n: int = 2048
    h: int = 480
    w: int = 752
    fx: float = 458.654
    fy: float = 457.296
    cx: float = 376.0
    cy: float = 240.0
    # interior clutter: floating textured panels at diverse depths. A bare box
    # room seen frontally is a near-planar scene — monocular pose then has a
    # lateral-translation+yaw direction whose only curvature comes from image-
    # edge points, and any estimator (the reference's g2o PoseOptimization
    # included) scale-drifts once the chi2 gate censors those. Real indoor
    # imagery has foreground structure; n_clutter adds it.
    n_clutter: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # "Mondrian" texture: sparse random rectangles of varied size/intensity.
        # Locally distinctive neighborhoods (uniform binary noise is self-similar
        # at every scale → ~50% descriptor mismatch rates, an unrealistic
        # association stress real imagery doesn't exhibit) and corner-rich.
        def make_tex():
            t = np.full((self.tex_n, self.tex_n), 40.0)
            n_rect = 2600
            xs = rng.integers(0, self.tex_n, n_rect)
            ys = rng.integers(0, self.tex_n, n_rect)
            ws = rng.integers(6, 90, n_rect)
            hs = rng.integers(6, 90, n_rect)
            vals = rng.uniform(25.0, 235.0, n_rect)
            for x, y, w_, h_, v in zip(xs, ys, ws, hs, vals):
                t[y:y + h_, x:x + w_] = v
            return t
        # one shared texture atlas per wall keeps memory modest
        self.textures = [make_tex() for _ in range(5)]
        # plane definitions: (point, normal, u-axis, v-axis, tex)
        d, hw, hh = self.depth, self.half_w, self.half_h
        self.planes = [
            (np.array([0.0, 0.0, d]), np.array([0.0, 0.0, -1.0]),
             np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.0])),   # back wall
            (np.array([0.0, hh, 0.0]), np.array([0.0, -1.0, 0.0]),
             np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0])),   # floor
            (np.array([0.0, -hh, 0.0]), np.array([0.0, 1.0, 0.0]),
             np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0])),   # ceiling
            (np.array([hw, 0.0, 0.0]), np.array([-1.0, 0.0, 0.0]),
             np.array([0.0, 0.0, 1.0]), np.array([0.0, 1.0, 0.0])),   # right wall
            (np.array([-hw, 0.0, 0.0]), np.array([1.0, 0.0, 0.0]),
             np.array([0.0, 0.0, 1.0]), np.array([0.0, 1.0, 0.0])),   # left wall
        ]
        # finite-extent clutter panels: (u0,u1,v0,v1) bounds in panel coords
        self.plane_bounds = [None] * len(self.planes)
        for i in range(self.n_clutter):
            ctr = np.array([rng.uniform(-0.65 * hw, 0.65 * hw),
                            rng.uniform(-0.65 * hh, 0.65 * hh),
                            rng.uniform(0.3 * d, 0.85 * d)])
            # face roughly toward -z with a random tilt
            n = np.array([rng.uniform(-0.35, 0.35), rng.uniform(-0.35, 0.35), -1.0])
            n /= np.linalg.norm(n)
            ua = np.cross(n, [0.0, 1.0, 0.0])
            ua /= np.linalg.norm(ua)
            va = np.cross(n, ua)
            half_u = rng.uniform(0.35, 0.9)
            half_v = rng.uniform(0.25, 0.7)
            self.planes.append((ctr, n, ua, va))
            self.plane_bounds.append((-half_u, half_u, -half_v, half_v))
        self.tex_scale = 48.0  # texels per world unit

    @property
    def K(self) -> np.ndarray:
        return np.array([self.fx, self.fy, self.cx, self.cy], dtype=np.float32)

    # optional fisheye: set to an 8-vector (fx fy cx cy k0..k3) to render
    # through the Kannala-Brandt model instead of the pinhole
    kb8_params: np.ndarray | None = None

    def stereo_pose(self, R_cw: np.ndarray, t_cw: np.ndarray, baseline: float):
        """World→right-camera pose for a rectified rig: x_r = x_l − [b,0,0]."""
        t_r = t_cw - np.array([baseline, 0.0, 0.0])
        return R_cw, t_r

    def _pixel_rays(self):
        cached = getattr(self, "_rays_cache", None)
        if cached is not None:
            return cached
        uu, vv = np.meshgrid(np.arange(self.w), np.arange(self.h))
        if self.kb8_params is not None:
            import torch
            from ..ops import camera as cam_ops
            uvs = np.stack([uu.reshape(-1), vv.reshape(-1)], -1).astype(np.float32)
            rays = cam_ops.kb8_unproject(
                torch.as_tensor(np.asarray(self.kb8_params, np.float32)),
                torch.from_numpy(uvs)).numpy()
            self._rays_cache = rays.reshape(self.h, self.w, 3).astype(float)
        else:
            self._rays_cache = np.stack(
                [(uu - self.cx) / self.fx, (vv - self.cy) / self.fy,
                 np.ones_like(uu, float)], axis=-1)
        return self._rays_cache

    def render(self, R_cw: np.ndarray, t_cw: np.ndarray,
               return_depth: bool = False):
        rays_c = self._pixel_rays()
        R_wc = R_cw.T
        c = -R_wc @ t_cw
        rays_w = rays_c @ R_wc.T
        best_t = np.full((self.h, self.w), np.inf)
        img = np.full((self.h, self.w), 20.0)
        for pi, (p0, n, ua, va) in enumerate(self.planes):
            denom = rays_w @ n
            tt = ((p0 - c) @ n) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            hitp = c + tt[..., None] * rays_w
            ok = (tt > 0.2) & (tt < best_t)
            bounds = self.plane_bounds[pi]
            if bounds is None:
                # clip to box extents
                ok &= (np.abs(hitp[..., 0]) <= self.half_w + 1e-6)
                ok &= (np.abs(hitp[..., 1]) <= self.half_h + 1e-6)
                ok &= (hitp[..., 2] >= -1.0) & (hitp[..., 2] <= self.depth + 1e-6)
            else:
                u0, u1, v0, v1 = bounds
                su = (hitp - p0) @ ua
                sv = (hitp - p0) @ va
                ok &= (su >= u0) & (su <= u1) & (sv >= v0) & (sv <= v1)
            tex = self.textures[pi % len(self.textures)]
            gu = (hitp @ ua) * self.tex_scale % (self.tex_n - 1)
            gv = (hitp @ va) * self.tex_scale % (self.tex_n - 1)
            # np.mod(x, y) can return exactly y for |x| >> y (floor-division
            # rounding); near-parallel rays produce such huge hit coords
            x0 = np.clip(gu.astype(int), 0, self.tex_n - 2)
            y0 = np.clip(gv.astype(int), 0, self.tex_n - 2)
            fx_ = gu - x0; fy_ = gv - y0
            val = (tex[y0, x0] * (1 - fx_) * (1 - fy_) + tex[y0, x0 + 1] * fx_ * (1 - fy_)
                   + tex[y0 + 1, x0] * (1 - fx_) * fy_ + tex[y0 + 1, x0 + 1] * fx_ * fy_)
            img = np.where(ok, val, img)
            best_t = np.where(ok, tt, best_t)
        if return_depth:
            # z-depth = ray parameter * ray z-component in camera frame (=1 by
            # construction of rays_c) → depth = tt * rays_c_z = tt
            depth = np.where(np.isfinite(best_t), best_t, 0.0).astype(np.float32)
            return img.astype(np.float32), depth
        return img.astype(np.float32)


def orbit_trajectory(n_frames: int, radius: float = 0.8, forward: float = 0.02,
                     yaw_rate: float = 0.003):
    """A gently translating + yawing camera path. Returns lists of (R_cw, t_cw)
    (world→camera) and the inverse camera-center trajectory for ATE checks."""
    poses = []
    for i in range(n_frames):
        # camera center in world
        c = np.array([radius * np.sin(0.04 * i), 0.15 * np.sin(0.02 * i), forward * i])
        yaw = yaw_rate * i
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        R_cw = R_wc.T
        t_cw = -R_cw @ c
        poses.append((R_cw, t_cw))
    return poses


def load_euroc_images(seq_dir: str, cam: str = "cam0"):
    """EuRoC mav0 layout loader → (timestamps (s), image paths). Mirrors the
    reference's LoadImages (Examples/Monocular/mono_euroc.cc:73-107)."""
    csv = os.path.join(seq_dir, "mav0", cam, "data.csv")
    stamps, paths = [], []
    with open(csv) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            ts, name = line.strip().split(",")[:2]
            stamps.append(float(ts) * 1e-9)
            paths.append(os.path.join(seq_dir, "mav0", cam, "data", name))
    return np.array(stamps), paths


def load_euroc_imu(seq_dir: str):
    """EuRoC IMU csv → (timestamps (s), gyro (N,3), acc (N,3))."""
    csv = os.path.join(seq_dir, "mav0", "imu0", "data.csv")
    rows = []
    with open(csv) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            rows.append([float(x) for x in line.strip().split(",")])
    arr = np.array(rows)
    return arr[:, 0] * 1e-9, arr[:, 1:4], arr[:, 4:7]


def load_kitti_sequence(seq_dir: str):
    """KITTI odometry sequence loader → (timestamps (s), left paths, right
    paths). Mirrors the reference's LoadImages
    (Examples/Stereo/stereo_kitti.cc LoadImages: times.txt + image_0/ +
    image_1/, %06d.png)."""
    with open(os.path.join(seq_dir, "times.txt")) as f:
        stamps = np.array([float(x) for x in f.read().split()])
    left = [os.path.join(seq_dir, "image_0", f"{i:06d}.png")
            for i in range(len(stamps))]
    right = [os.path.join(seq_dir, "image_1", f"{i:06d}.png")
             for i in range(len(stamps))]
    return stamps, left, right


def load_tum_rgbd(seq_dir: str, max_dt: float = 0.02):
    """TUM RGB-D sequence loader → (timestamps (s), rgb paths, depth paths),
    associated by nearest timestamp within max_dt. Mirrors the reference's
    associate.py + LoadImages (Examples/RGB-D/rgbd_tum.cc; the reference
    expects a pre-associated file, we associate inline like
    evaluation/associate.py)."""
    def read_list(name):
        ts, paths = [], []
        with open(os.path.join(seq_dir, name)) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                t, p = line.strip().split()[:2]
                ts.append(float(t))
                paths.append(os.path.join(seq_dir, p))
        return np.array(ts), paths

    rgb_ts, rgb_p = read_list("rgb.txt")
    d_ts, d_p = read_list("depth.txt")
    j = np.searchsorted(d_ts, rgb_ts)
    out_ts, out_rgb, out_d = [], [], []
    for i, t in enumerate(rgb_ts):
        cand = [c for c in (j[i] - 1, j[i]) if 0 <= c < len(d_ts)]
        if not cand:
            continue
        c = min(cand, key=lambda c: abs(d_ts[c] - t))
        if abs(d_ts[c] - t) <= max_dt:
            out_ts.append(t)
            out_rgb.append(rgb_p[i])
            out_d.append(d_p[c])
    return np.array(out_ts), out_rgb, out_d


def walk_trajectory(n_frames: int, period: int = 160, radius: float = 2.2,
                    height: float = 0.5, depth: float = 1.1,
                    yaw_amp: float = 0.25):
    """An in-room loop walk (EuRoC-room-like): the camera circles the scene
    and revisits its own path every ``period`` frames, without the net escape
    of ``orbit_trajectory``'s forward drift (which degenerates into a
    permanent zoom-out — every new view is coarser-scale than the map, so
    reference-rule keyframe culling and insertion oscillate). Returns
    (R_cw, t_cw) pairs."""
    poses = []
    for i in range(n_frames):
        ph = 2 * np.pi * (i % period) / period
        c = np.array([radius * np.sin(ph), height * np.sin(2 * ph),
                      2.0 + depth * np.cos(ph)])
        yaw = yaw_amp * np.sin(ph + 0.7)
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        R_cw = R_wc.T
        poses.append((R_cw, -R_cw @ c))
    return poses
