"""Lie-group operations: SO(3), SE(3), Sim(3) on torch tensors.

Port of ``orbslam3_tpu/ops/lie.py``. Same conventions: rotations ``(...,3,3)``,
tangent vectors ``(...,3)``, SE(3) as ``(R, t)`` world→camera pairs, Sim(3)
with a leading scale ``s``. Small-angle Taylor branches are ``torch.where``
selections, so every function is batched and free of host syncs.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _eye_like(x: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (...,3) vector: hat(w) @ v == cross(w, v)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (...,3,3) skew matrix → (...,3) vector."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta2: torch.Tensor):
    """Branchless (A, B, C) = (sinθ/θ, (1-cosθ)/θ², (θ-sinθ)/θ³) with Taylor fallback."""
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    return a, b, c


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) → SO(3) (Rodrigues), batched."""
    theta2 = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    return _eye_like(w, W.shape) + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map SO(3) → so(3), batched; stable up to theta slightly below pi
    (same clipped-arccos and near-pi axis recovery as the reference)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)
    w_skew = vee(R - R.transpose(-1, -2)) * 0.5
    sin_t = torch.sin(theta)
    small = theta < 1e-4
    scale = torch.where(small, 1.0 + theta * theta / 6.0,
                        theta / torch.where(small, torch.ones_like(sin_t), sin_t))
    w = scale[..., None] * w_skew
    near_pi = theta > 3.1
    Rp = (R + _eye_like(R, R.shape)) * 0.5
    diag = torch.stack([Rp[..., 0, 0], Rp[..., 1, 1], Rp[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp(diag, min=0.0) + 1e-12)
    k = torch.argmax(diag, dim=-1)
    row = torch.take_along_dim(Rp, k[..., None, None].expand(
        k.shape + (1, 3)), dim=-2)[..., 0, :]
    axis = axis * torch.where(torch.signbit(row), -1.0, 1.0).to(R.dtype)
    dot = torch.sum(axis * w_skew, dim=-1)
    axis = axis * torch.where(dot < 0, -1.0, 1.0).to(R.dtype)[..., None]
    w_pi = axis * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w)


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian Jr(w) of SO(3): Exp(w + dw) ≈ Exp(w) Exp(Jr dw)."""
    theta2 = torch.sum(w * w, dim=-1)
    _, b, c = _sinc_coeffs(theta2)
    W = hat(w)
    return _eye_like(w, W.shape) - b[..., None, None] * W + c[..., None, None] * (W @ W)


def so3_right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3)."""
    theta2 = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_coeffs(theta2)
    small = theta2 < 1e-8
    d = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 / torch.where(small, torch.ones_like(theta2), theta2))
        * (1.0 - a / (2.0 * b)))
    W = hat(w)
    return _eye_like(w, W.shape) + 0.5 * W + d[..., None, None] * (W @ W)


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation onto SO(3) via SVD."""
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    fix = torch.cat([torch.ones(R.shape[:-2] + (2,), dtype=R.dtype, device=R.device),
                     det[..., None]], dim=-1)
    return (u * fix[..., None, :]) @ vt


# ---------------------------------------------------------------------------
# quaternions (x, y, z, w) — trajectory export
# ---------------------------------------------------------------------------

def quat_from_mat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → unit quaternion (x,y,z,w), batched, branchless."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw_ = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) * 0.5
    q0 = torch.stack([(m21 - m12), (m02 - m20), (m10 - m01)], dim=-1) / (4.0 * qw_)[..., None]
    q0 = torch.cat([q0, qw_[..., None]], dim=-1)
    qx_ = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) * 0.5
    q1 = torch.stack([qx_, (m01 + m10) / (4 * qx_), (m02 + m20) / (4 * qx_),
                      (m21 - m12) / (4 * qx_)], dim=-1)
    qy_ = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) * 0.5
    q2 = torch.stack([(m01 + m10) / (4 * qy_), qy_, (m12 + m21) / (4 * qy_),
                      (m02 - m20) / (4 * qy_)], dim=-1)
    qz_ = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) * 0.5
    q3 = torch.stack([(m02 + m20) / (4 * qz_), (m12 + m21) / (4 * qz_), qz_,
                      (m10 - m01) / (4 * qz_)], dim=-1)
    cand = torch.stack([q0, q1, q2, q3], dim=-2)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    q = torch.take_along_dim(cand, idx[..., None, None].expand(idx.shape + (1, 4)),
                             dim=-2)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def mat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (x,y,z,w) → rotation matrix, batched."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = 2.0 / torch.where(n > 0, n, torch.ones_like(n))
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
    ], dim=-2)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (...,i,j)·(...,j) → (...,i)."""
    return (M @ v[..., None])[..., 0]


def se3_exp(xi: torch.Tensor):
    """Exp map se(3) → SE(3). xi = (...,6) with rotation part first [w | v] → (R, t)."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    theta2 = torch.sum(w * w, dim=-1)
    _, b, c = _sinc_coeffs(theta2)
    W = hat(w)
    V = _eye_like(xi, W.shape) + b[..., None, None] * W + c[..., None, None] * (W @ W)
    return R, _mv(V, v)


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Log map SE(3) → se(3), returns (...,6) = [w | v]."""
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_coeffs(theta2)
    W = hat(w)
    small = theta2 < 1e-8
    coef = torch.where(
        small, torch.full_like(theta2, 1.0 / 12.0),
        (1.0 / torch.where(small, torch.ones_like(theta2), theta2))
        * (1.0 - a / (2.0 * b)))
    Vinv = _eye_like(R, W.shape) - 0.5 * W + coef[..., None, None] * (W @ W)
    return torch.cat([w, _mv(Vinv, t)], dim=-1)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra,ta) ∘ (Rb,tb): x → Ra(Rb x + tb) + ta."""
    return Ra @ Rb, _mv(Ra, tb) + ta


def se3_inverse(R, t):
    Rinv = R.transpose(-1, -2)
    return Rinv, -_mv(Rinv, t)


def se3_apply(R, t, x):
    """Apply (R,t) to points x (...,3); R may be unbatched (3,3)."""
    if R.dim() == 2:
        return x @ R.T + t
    return _mv(R, x) + t


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------

def sim3_apply(s, R, t, x):
    return s[..., None] * _mv(R, x) + t


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    """x → sa Ra (sb Rb x + tb) + ta."""
    return sa * sb, Ra @ Rb, sa[..., None] * _mv(Ra, tb) + ta


def sim3_inverse(s, R, t):
    si = 1.0 / s
    Ri = R.transpose(-1, -2)
    return si, Ri, -si[..., None] * _mv(Ri, t)


def _sim3_V_coeffs(s, sigma, theta2):
    """(X, A, B) of V = X·I + A·W + B·W² (Strasdat's closed form, g2o sim3.h)."""
    theta = torch.sqrt(theta2 + _EPS)
    sig2 = sigma * sigma
    small_sig = torch.abs(sigma) < 1e-5
    small_th = theta2 < 1e-8
    one = torch.ones_like(sigma)
    X = torch.where(small_sig, 1.0 + sigma / 2.0 + sig2 / 6.0,
                    (s - 1.0) / torch.where(small_sig, one, sigma))
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    denom = torch.where(small_sig & small_th, one, sig2 + theta2)
    a_gen = (s * sin_t * sigma + (1.0 - s * cos_t) * theta) / (
        torch.where(small_th, one, theta) * denom)
    b_gen = (X - ((s * cos_t - 1.0) * sigma + s * sin_t * theta) / denom) / \
        torch.where(small_th, one, theta2)
    _, b0, c0 = _sinc_coeffs(theta2)
    A = torch.where(small_sig, b0, a_gen)
    B = torch.where(small_sig, c0, b_gen)
    A = torch.where(small_th, torch.where(
        small_sig, 0.5 * one,
        ((sigma - 1.0) * s + 1.0) / torch.where(small_sig, one, sig2)), A)
    B = torch.where(small_th, one / 6.0, B)
    return X, A, B


def sim3_exp(xi: torch.Tensor):
    """Exp map sim(3) → Sim(3). xi = (...,7) = [w | v | sigma] → (s, R, t)."""
    w, v, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    R = so3_exp(w)
    theta2 = torch.sum(w * w, dim=-1)
    W = hat(w)
    X, A, B = _sim3_V_coeffs(s, sigma, theta2)
    V = (X[..., None, None] * _eye_like(xi, W.shape) + A[..., None, None] * W
         + B[..., None, None] * (W @ W))
    return s, R, _mv(V, v)


def sim3_log(s, R, t) -> torch.Tensor:
    """Log map Sim(3) → sim(3) via solving V x = t (3x3 solve, batched)."""
    sigma = torch.log(s)
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1)
    W = hat(w)
    X, A, B = _sim3_V_coeffs(s, sigma, theta2)
    V = (X[..., None, None] * _eye_like(R, W.shape) + A[..., None, None] * W
         + B[..., None, None] * (W @ W))
    v = torch.linalg.solve(V, t[..., None])[..., 0]
    return torch.cat([w, v, sigma[..., None]], dim=-1)
