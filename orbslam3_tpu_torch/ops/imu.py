"""IMU preintegration on SO(3)/R3 with bias Jacobians and noise propagation.

Port of ``orbslam3_tpu/ops/imu.py`` (reference ``IMU::Preintegrated``,
src/ImuTypes.cc:341-430). Per measurement, in the reference's order: position
and velocity with the old rotation, the A/B noise-propagation blocks, the
position/velocity bias Jacobians, then the rotation update and the
covariance. ``corrected_delta`` is the first-order bias correction,
``predict_state`` the reference's PredictStateIMU and ``inertial_residual``
the 9-dim preintegration error. GRAVITY = 9.81.

``preintegrate`` walks the measurement buffer step by step; a slot whose
``valid`` flag is off leaves the state as it was (the reference package's
masked scan step), so a buffer holding only its valid samples gives the same
state as the padded one.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie

GRAVITY = 9.81


class PreintState(NamedTuple):
    dR: torch.Tensor      # (3,3)
    dV: torch.Tensor      # (3,)
    dP: torch.Tensor      # (3,)
    JRg: torch.Tensor     # (3,3) d dR / d gyro-bias
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    C: torch.Tensor       # (15,15) covariance [dR dV dP | bg ba]
    dT: torch.Tensor      # () total time
    bias_g: torch.Tensor  # (3,) bias used at integration time
    bias_a: torch.Tensor


def gravity_vec(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, -GRAVITY], dtype=dtype, device=device)


def init_state(bias_g=None, bias_a=None, dtype=torch.float32, device=None) -> PreintState:
    z3 = torch.zeros(3, dtype=dtype, device=device)
    z33 = torch.zeros((3, 3), dtype=dtype, device=device)
    return PreintState(
        dR=torch.eye(3, dtype=dtype, device=device), dV=z3, dP=z3,
        JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
        C=torch.zeros((15, 15), dtype=dtype, device=device),
        dT=torch.zeros((), dtype=dtype, device=device),
        bias_g=z3 if bias_g is None else bias_g,
        bias_a=z3 if bias_a is None else bias_a)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def integrate_measurement(s: PreintState, acc, gyro, dt, nga: torch.Tensor,
                          nga_walk: torch.Tensor) -> PreintState:
    """One reference-order update. nga: (6,6) measurement noise (gyro², acc²)·freq;
    nga_walk: (6,6) random-walk covariance."""
    a = acc - s.bias_a
    w = gyro - s.bias_g
    dRa = _mv(s.dR, a)
    # position/velocity first with the old dR (reference order)
    dP = s.dP + s.dV * dt + 0.5 * dRa * dt * dt
    dV = s.dV + dRa * dt

    Wacc = lie.hat(a)
    dtype, dev = s.dR.dtype, s.dR.device
    eye = torch.eye(3, dtype=dtype, device=dev)
    z33 = torch.zeros((3, 3), dtype=dtype, device=dev)
    dRW = s.dR @ Wacc
    # bias Jacobians for P/V (reference :385-389)
    JPa = s.JPa + s.JVa * dt - 0.5 * s.dR * dt * dt
    JPg = s.JPg + s.JVg * dt - 0.5 * dRW @ s.JRg * dt * dt
    JVa = s.JVa - s.dR * dt
    JVg = s.JVg - dRW @ s.JRg * dt

    # rotation update (reference :395-403)
    wdt = w * dt
    dRi = lie.so3_exp(wdt)
    Jr = lie.so3_right_jacobian(wdt)
    dR = lie.normalize_rotation(s.dR @ dRi)
    JRg = dRi.T @ s.JRg - Jr * dt

    # A (9x9), B (9x6) noise propagation (reference :361-379)
    A = torch.cat([
        torch.cat([dRi.T, z33, z33], dim=1),
        torch.cat([-dRW * dt, eye, z33], dim=1),
        torch.cat([-0.5 * dRW * dt * dt, eye * dt, eye], dim=1)], dim=0)
    B = torch.cat([
        torch.cat([Jr * dt, z33], dim=1),
        torch.cat([z33, s.dR * dt], dim=1),
        torch.cat([z33, 0.5 * s.dR * dt * dt], dim=1)], dim=0)

    # covariance (reference :407-409)
    C9 = A @ s.C[0:9, 0:9] @ A.T + B @ nga @ B.T
    C = torch.cat([
        torch.cat([C9, s.C[0:9, 9:15]], dim=1),
        torch.cat([s.C[9:15, 0:9], s.C[9:15, 9:15] + nga_walk], dim=1)], dim=0)
    return PreintState(dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa,
                       JPg=JPg, JPa=JPa, C=C, dT=s.dT + dt,
                       bias_g=s.bias_g, bias_a=s.bias_a)


def preintegrate(acc: torch.Tensor, gyro: torch.Tensor, dts: torch.Tensor,
                 valid: torch.Tensor, bias_g, bias_a,
                 noise_gyro: float, noise_acc: float,
                 walk_gyro: float, walk_acc: float, freq: float) -> PreintState:
    """Preintegrate a measurement buffer (N,3),(N,3),(N,),(N,).

    Invalid slots are skipped branchlessly; ``valid=None`` means every slot
    is valid. Noise densities are continuous-time (reference YAML
    IMU.NoiseGyro etc.), scaled by sqrt(freq) like the reference
    (Calib::Set)."""
    dtype, dev = acc.dtype, acc.device
    sf = torch.sqrt(torch.tensor(freq, dtype=dtype))
    ng = (noise_gyro * sf) ** 2
    na = (noise_acc * sf) ** 2
    nga = torch.diag(torch.stack([ng, ng, ng, na, na, na])).to(dev)
    walk_diag = torch.tensor([walk_gyro ** 2] * 3 + [walk_acc ** 2] * 3, dtype=dtype,
                             device=dev)
    s = init_state(bias_g, bias_a, dtype, dev)
    for i in range(acc.shape[0]):
        dt = dts[i]
        s2 = integrate_measurement(s, acc[i], gyro[i], dt, nga, torch.diag(walk_diag * dt))
        if valid is None:
            s = s2
        else:
            s = PreintState(*(torch.where(valid[i], new, old) for new, old in zip(s2, s)))
    return s


def compose(a: PreintState, b: PreintState) -> PreintState:
    """Compose consecutive preintegrations (a then b) into one block (the
    reference's MergePrevious when keyframes are culled). The 9x9 delta
    covariance is propagated through the composition's linearization; the
    bias random-walk blocks add."""
    dtype, dev = a.dR.dtype, a.dR.device
    dR = a.dR @ b.dR
    dV = a.dV + _mv(a.dR, b.dV)
    dP = a.dP + a.dV * b.dT + _mv(a.dR, b.dP)
    JRg = b.dR.T @ a.JRg + b.JRg
    JVg = a.JVg + a.dR @ b.JVg
    JVa = a.JVa + a.dR @ b.JVa
    JPg = a.JPg + a.JVg * b.dT + a.dR @ b.JPg
    JPa = a.JPa + a.JVa * b.dT + a.dR @ b.JPa
    eye = torch.eye(3, dtype=dtype, device=dev)
    z33 = torch.zeros((3, 3), dtype=dtype, device=dev)
    A = torch.cat([
        torch.cat([b.dR.T, z33, z33], dim=1),
        torch.cat([-a.dR @ lie.hat(b.dV), eye, z33], dim=1),
        torch.cat([-a.dR @ lie.hat(b.dP), eye * b.dT, eye], dim=1)], dim=0)
    # the new segment's V/P deltas enter rotated by dR_a; δθ_b enters directly
    Ba = torch.block_diag(eye, a.dR, a.dR)
    C9 = A @ a.C[0:9, 0:9] @ A.T + Ba @ b.C[0:9, 0:9] @ Ba.T
    z96 = torch.zeros((9, 6), dtype=dtype, device=dev)
    C = torch.cat([torch.cat([C9, z96], dim=1),
                   torch.cat([z96.T, a.C[9:15, 9:15] + b.C[9:15, 9:15]], dim=1)], dim=0)
    return PreintState(dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa,
                       JPg=JPg, JPa=JPa, C=C, dT=a.dT + b.dT,
                       bias_g=a.bias_g, bias_a=a.bias_a)


def corrected_delta(s: PreintState, bias_g, bias_a):
    """First-order bias-corrected (dR, dV, dP) (reference GetDeltaRotation/
    Velocity/Position(Bias))."""
    dbg = bias_g - s.bias_g
    dba = bias_a - s.bias_a
    dR = s.dR @ lie.so3_exp(_mv(s.JRg, dbg))
    dV = s.dV + _mv(s.JVg, dbg) + _mv(s.JVa, dba)
    dP = s.dP + _mv(s.JPg, dbg) + _mv(s.JPa, dba)
    return dR, dV, dP


def predict_state(R_wb, t_wb, v_w, s: PreintState, bias_g, bias_a):
    """IMU state propagation over the preintegrated interval (reference
    Tracking::PredictStateIMU):
        R2 = R1·ΔR, v2 = v1 + g·t + R1·ΔV, p2 = p1 + v1·t + ½g·t² + R1·ΔP."""
    dR, dV, dP = corrected_delta(s, bias_g, bias_a)
    g = gravity_vec(R_wb.dtype, R_wb.device)
    t = s.dT
    R2 = lie.normalize_rotation(R_wb @ dR)
    v2 = v_w + g * t + _mv(R_wb, dV)
    p2 = t_wb + v_w * t + 0.5 * g * t * t + _mv(R_wb, dP)
    return R2, p2, v2


def inertial_residual(R1, p1, v1, R2, p2, v2, bg, ba, s: PreintState):
    """9-dim preintegration residual [er, ev, ep] (reference EdgeInertial);
    poses are body-in-world (R_wb, p_wb)."""
    dR, dV, dP = corrected_delta(s, bg, ba)
    g = gravity_vec(R1.dtype, R1.device)
    t = s.dT
    er = lie.so3_log(dR.T @ (R1.T @ R2))
    ev = _mv(R1.T, v2 - v1 - g * t) - dV
    ep = _mv(R1.T, p2 - p1 - v1 * t - 0.5 * g * t * t) - dP
    return torch.cat([er, ev, ep])
