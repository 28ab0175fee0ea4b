"""Pose-graph (essential-graph) optimization over Sim(3).

Port of ``orbslam3_tpu/ops/posegraph.py`` (the reference's
``OptimizeEssentialGraph``: keyframes as Sim3 vertices, edges = loop links +
spanning tree + high-covisibility links, then translation divided by scale):

- Nodes: (K,) Sim3 world→kf as (s, R, t) with validity and fixed masks.
- Edges: (E,) pairs with a measured relative Sim3; residual
  r_e = log(S_meas⁻¹ ∘ S_i ∘ S_j⁻¹) ∈ R⁷.
- Per-edge Jacobians by forward-mode automatic differentiation of that
  residual with respect to the two nodes' local updates, as the reference's
  ``vmap(jacfwd)`` does: the Sim3 log's Jacobian has no short closed form,
  and the derivative of the same residual code keeps the two packages' steps
  equal to rounding. The residual runs batched over the edges, on dual
  tensors (``torch.autograd.forward_ad``) that carry the seven tangent
  directions as a leading batch of 7: one forward pass per node side and
  iteration. (A per-edge ``vmap(jacfwd)`` would differentiate 0-dim tensors,
  where this PyTorch's forward-mode division by a Python float returns
  float64 tangents, and ``vmap`` of ``jvp`` costs 6x the time.)
- The normal equations are assembled densely, (7K, 7K), and solved with
  ``torch.linalg.solve`` once per Gauss-Newton iteration.
"""
from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

from . import lie


def _edge_residual(xi_i, xi_j, s_i, R_i, t_i, s_j, R_j, t_j, m_s, m_R, m_t):
    """Residual of one edge at local updates (xi_i, xi_j) ∈ R7 applied on the
    RIGHT of each node (S ← S ∘ Exp(xi)): nodes are world→kf, so a right
    increment acts in the world frame, and the dof mask's rotation
    components are world axes (4DoF yaw = the gravity axis)."""
    ds_i, dR_i, dt_i = lie.sim3_exp(xi_i)
    ds_j, dR_j, dt_j = lie.sim3_exp(xi_j)
    si, Ri, ti = lie.sim3_compose(s_i, R_i, t_i, ds_i, dR_i, dt_i)
    sj, Rj, tj = lie.sim3_compose(s_j, R_j, t_j, ds_j, dR_j, dt_j)
    sji, Rji, tji = lie.sim3_inverse(sj, Rj, tj)
    s_ij, R_ij, t_ij = lie.sim3_compose(si, Ri, ti, sji, Rji, tji)
    ms_i, mR_i, mt_i = lie.sim3_inverse(m_s, m_R, m_t)
    es, eR, et = lie.sim3_compose(ms_i, mR_i, mt_i, s_ij, R_ij, t_ij)
    return lie.sim3_log(es, eR, et)


def _edge_jacobians(args):
    """Residuals (E,7) at zero updates and their Jacobians (E,7,7) with
    respect to xi_i and xi_j, every edge and every tangent direction at once:
    the zero update is a dual tensor of shape (7,E,7) whose k-th slice has
    tangent e_k, and the edge arguments broadcast over that leading 7."""
    E = args[0].shape[0]
    dtype, dev = args[2].dtype, args[2].device
    zero = torch.zeros((7, E, 7), dtype=dtype, device=dev)
    basis = torch.eye(7, dtype=dtype, device=dev)[:, None, :].expand(7, E, 7)
    r = _edge_residual(zero[0], zero[0], *args)
    with fwAD.dual_level():
        x = fwAD.make_dual(zero, basis)
        d_i = fwAD.unpack_dual(_edge_residual(x, zero, *args)).tangent
        d_j = fwAD.unpack_dual(_edge_residual(zero, x, *args)).tangent
    return r, d_i.permute(1, 2, 0), d_j.permute(1, 2, 0)     # (E, 7 out, 7 in)


def optimize_pose_graph(s, R, t, node_valid, fixed, edge_i, edge_j, edge_s, edge_R,
                        edge_t, edge_valid, edge_weight, iters: int = 20,
                        lam: float = 1e-6, dof_mask=None):
    """Gauss-Newton over the pose graph. Shapes: nodes (K,...), edges (E,...).

    ``dof_mask``: optional (7,) bool over the sim3 tangent [w(3)|v(3)|sigma]
    selecting the free update directions: all True is the Sim(3) essential
    graph, scale masked the fixed-scale (stereo / RGB-D) variant,
    [0,0,yaw | v | 0] the 4DoF graph of a gravity-aligned inertial map.
    Masked directions never move. Returns (s, R, t, costs (iters,))."""
    K = s.shape[0]
    dtype, dev = t.dtype, t.device
    ei, ej = edge_i.long(), edge_j.long()
    ar7 = torch.arange(7, device=dev)
    rows_i = (ei[:, None] * 7 + ar7)                      # (E,7) flat indices
    rows_j = (ej[:, None] * 7 + ar7)
    w = edge_valid.to(dtype) * edge_weight
    free = torch.repeat_interleave(node_valid & ~fixed, 7)
    if dof_mask is not None:
        free = free & torch.as_tensor(dof_mask, dtype=torch.bool, device=dev).repeat(K)
    upd = node_valid & ~fixed
    costs = []
    for _ in range(iters):
        r, Ji, Jj = _edge_jacobians((s[ei], R[ei], t[ei], s[ej], R[ej], t[ej],
                                     edge_s, edge_R, edge_t))
        Hii = torch.einsum("eai,e,eaj->eij", Ji, w, Ji)
        Hjj = torch.einsum("eai,e,eaj->eij", Jj, w, Jj)
        Hij = torch.einsum("eai,e,eaj->eij", Ji, w, Jj)
        H = torch.zeros((K * 7, K * 7), dtype=dtype, device=dev)
        for ra, rb, blk in ((rows_i, rows_i, Hii), (rows_j, rows_j, Hjj),
                            (rows_i, rows_j, Hij), (rows_j, rows_i, Hij.transpose(-1, -2))):
            H.index_put_((ra[:, :, None], rb[:, None, :]), blk, accumulate=True)
        b = torch.zeros(K * 7, dtype=dtype, device=dev)
        b.index_add_(0, rows_i.reshape(-1), -torch.einsum("eai,e,ea->ei", Ji, w, r).reshape(-1))
        b.index_add_(0, rows_j.reshape(-1), -torch.einsum("eai,e,ea->ei", Jj, w, r).reshape(-1))
        Hm = torch.where(free[:, None] & free[None, :], H, 0.0)
        Hm = Hm + torch.diag(torch.where(free, lam, 1.0).to(dtype))
        bv = torch.where(free, b, 0.0)
        dx = torch.linalg.solve(Hm, bv).reshape(K, 7)
        ds, dR, dt = lie.sim3_exp(dx)
        sn, Rn, tn = lie.sim3_compose(s, R, t, ds, dR, dt)
        s = torch.where(upd, sn, s)
        R = torch.where(upd[:, None, None], Rn, R)
        t = torch.where(upd[:, None], tn, t)
        costs.append(torch.sum(r * r * w[:, None]))
    return s, R, t, torch.stack(costs) if costs else torch.zeros(0, dtype=dtype, device=dev)
