"""Camera models: Pinhole (+ radial-tangential distortion) and Kannala-Brandt-8.

Port of ``orbslam3_tpu/ops/camera.py``. Parameter layouts are the reference's:
pinhole ``(fx, fy, cx, cy)``, radtan ``(k1, k2, p1, p2, k3)``, KB8
``(fx, fy, cx, cy, k0, k1, k2, k3)``. Projection maps camera-frame points
``(...,3)`` to pixels ``(...,2)``; unprojection maps pixels to unit-z rays.
"""
from __future__ import annotations

import math

import torch

PINHOLE = 0
KB8 = 1


def pinhole_project(K: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points (...,3) → pixels (...,2). No distortion:
    keypoints are undistorted once at extraction."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    inv_z = 1.0 / xc[..., 2]
    u = fx * xc[..., 0] * inv_z + cx
    v = fy * xc[..., 1] * inv_z + cy
    return torch.stack([u, v], dim=-1)


def pinhole_unproject(K: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (...,2) → unit-z rays (...,3)."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def pinhole_project_jac(K: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """Jacobian d(u,v)/d(xc): (...,2,3)."""
    fx, fy = K[0], K[1]
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(x)
    row0 = torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1)
    row1 = torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def radtan_distort(D: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """Apply radial-tangential distortion to normalized coords (...,2)."""
    k1, k2, p1, p2, k3 = D[0], D[1], D[2], D[3], D[4]
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xy2 = 2.0 * x * y
    xd = x * radial + p1 * xy2 + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p2 * xy2 + p1 * (r2 + 2.0 * y * y)
    return torch.stack([xd, yd], dim=-1)


def radtan_undistort(D: torch.Tensor, xd: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Invert radtan distortion via the compensated fixed-point iteration
    x ← (xd − tangential(x)) / radial(x) (cv::undistortPoints semantics)."""
    k1, k2, p1, p2, k3 = D[0], D[1], D[2], D[3], D[4]
    x0, y0 = xd[..., 0], xd[..., 1]
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        inv_radial = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) * inv_radial
        y = (y0 - dy) * inv_radial
    return torch.stack([x, y], dim=-1)


def pinhole_undistort_pixels(K: torch.Tensor, D: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Distorted pixels → undistorted pixels under the same K."""
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    xn = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)
    xu = radtan_undistort(D, xn)
    return torch.stack([xu[..., 0] * fx + cx, xu[..., 1] * fy + cy], dim=-1)


def kb8_project(P: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """KB8 projection: r(θ) = θ + k0 θ³ + k1 θ⁵ + k2 θ⁷ + k3 θ⁹."""
    fx, fy, cx, cy = P[0], P[1], P[2], P[3]
    k0, k1, k2, k3 = P[4], P[5], P[6], P[7]
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    r = torch.sqrt(x * x + y * y + 1e-18)
    theta = torch.atan2(r, z)
    t2 = theta * theta
    d = theta * (1.0 + t2 * (k0 + t2 * (k1 + t2 * (k2 + t2 * k3))))
    scale = d / r
    return torch.stack([fx * x * scale + cx, fy * y * scale + cy], dim=-1)


def kb8_unproject(P: torch.Tensor, uv: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """KB8 unprojection to unit-z rays via Newton on r(θ)=d."""
    fx, fy, cx, cy = P[0], P[1], P[2], P[3]
    k0, k1, k2, k3 = P[4], P[5], P[6], P[7]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    d = torch.sqrt(mx * mx + my * my + 1e-18)
    d_clip = torch.clamp(d, max=math.pi / 2.0 + 0.6)   # keep Newton in basin
    theta = d_clip
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k0 + t2 * (k1 + t2 * (k2 + t2 * k3)))) - d_clip
        fp = 1.0 + t2 * (3 * k0 + t2 * (5 * k1 + t2 * (7 * k2 + t2 * 9 * k3)))
        theta = theta - f / torch.where(torch.abs(fp) < 1e-8, torch.ones_like(fp), fp)
    scale = torch.tan(theta) / d
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def kb8_project_jac(P: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """Analytic Jacobian d(u,v)/d(xc): (...,2,3)."""
    fx, fy = P[0], P[1]
    k0, k1, k2, k3 = P[4], P[5], P[6], P[7]
    x, y, z = xc[..., 0], xc[..., 1], xc[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(r2 + 1e-18)
    R2 = r2 + z * z
    theta = torch.atan2(r, z)
    t2 = theta * theta
    f = theta * (1.0 + t2 * (k0 + t2 * (k1 + t2 * (k2 + t2 * k3))))
    fp = 1.0 + t2 * (3 * k0 + t2 * (5 * k1 + t2 * (7 * k2 + t2 * 9 * k3)))
    dt_dx = z * x / (R2 * r)
    dt_dy = z * y / (R2 * r)
    dt_dz = -r / R2
    inv_r = 1.0 / r
    inv_r3 = inv_r / r2
    du_dx = fx * (fp * dt_dx * x * inv_r + f * (y * y) * inv_r3)
    du_dy = fx * (fp * dt_dy * x * inv_r - f * x * y * inv_r3)
    du_dz = fx * fp * dt_dz * x * inv_r
    dv_dx = fy * (fp * dt_dx * y * inv_r - f * x * y * inv_r3)
    dv_dy = fy * (fp * dt_dy * y * inv_r + f * (x * x) * inv_r3)
    dv_dz = fy * fp * dt_dz * y * inv_r
    row0 = torch.stack([du_dx, du_dy, du_dz], dim=-1)
    row1 = torch.stack([dv_dx, dv_dy, dv_dz], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def project(cam_type: int, params: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """Static dispatch on the camera-type tag."""
    if cam_type == PINHOLE:
        return pinhole_project(params, xc)
    return kb8_project(params, xc)


def unproject(cam_type: int, params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    if cam_type == PINHOLE:
        return pinhole_unproject(params, uv)
    return kb8_unproject(params, uv)


def project_jac(cam_type: int, params: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    if cam_type == PINHOLE:
        return pinhole_project_jac(params, xc)
    return kb8_project_jac(params, xc)
