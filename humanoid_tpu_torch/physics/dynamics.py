"""Floating-base rigid-body dynamics: bias forces and the CRBA mass matrix.
Port of the reference package's physics/dynamics.py on env-batched tensors.

Generalized coordinates:
  q = (base_pos (3), base_quat wxyz (4), qj (nj,))
  u = [omega_base_world (3), v_base_world (3), qdot (nj,)]
Spatial quantities live in a world-aligned Plücker frame at the base origin.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kinematics import RobotTensors, fk
from .spatial import quat_rotate, quat_to_mat, skew


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def compute_kinematics_bias(rt: RobotTensors, base_pos, base_quat, qj, u,
                            mass: Optional[torch.Tensor] = None,
                            com: Optional[torch.Tensor] = None,
                            inertia: Optional[torch.Tensor] = None):
    """FK, joint screws, spatial inertias, the velocity/bias recursion.
    mass (N, nb), com (N, nb, 3) and inertia (N, nb, 3, 3) are per-env
    overrides of the model's (the body domain randomization).

    Returns (body_pos (N,nb,3), body_quat (N,nb,4), S (N,nv,6),
    I_sp (N,nb,6,6), v_sp (N,nb,6), C (N,nv))."""
    N = base_pos.shape[0]
    nj, nb = rt.nj, rt.nb
    dev, dt = base_pos.device, base_pos.dtype
    body_pos, body_quat = fk(rt, base_pos, base_quat, qj)
    A = body_pos[:, 0]

    w = quat_rotate(body_quat[:, 1:], rt.joint_axis)                # (N,nj,3)
    anchors = body_pos[:, 1:] - A[:, None]
    S_j = torch.cat([w, _cross(anchors, w)], dim=-1)                 # (N,nj,6)
    eye6 = torch.eye(6, device=dev, dtype=dt).expand(N, 6, 6)
    S = torch.cat([eye6, S_j], dim=1)                                # (N,nv,6)

    if mass is None:
        mass = rt.mass.expand(N, nb)
    if com is None:
        com = rt.com.expand(N, nb, 3)
    if inertia is None:
        inertia = rt.inertia.expand(N, nb, 3, 3)
    R = quat_to_mat(body_quat)
    com_w = body_pos + torch.einsum("nbij,nbj->nbi", R, com)
    I_w = torch.einsum("nbij,nbjk,nblk->nbil", R, inertia, R)
    rx = skew(com_w - A[:, None])
    m3 = mass[..., None, None]
    eye3 = torch.eye(3, device=dev, dtype=dt)
    top = torch.cat([I_w + m3 * rx @ rx.transpose(-1, -2), m3 * rx], dim=-1)
    bot = torch.cat([m3 * rx.transpose(-1, -2), m3 * eye3.expand_as(rx)], dim=-1)
    I_sp = torch.cat([top, bot], dim=-2)                             # (N,nb,6,6)

    g = rt.model.gravity
    v = [u[:, 0:6]]
    a0 = torch.zeros(N, 6, device=dev, dtype=dt)
    a0[:, 5] = -g                                                    # gravity trick
    a = [a0]
    for k in range(nj):
        p = rt.parent[k + 1]
        vJ = S_j[:, k] * u[:, 6 + k: 7 + k]
        vb = v[p] + vJ
        v.append(vb)
        aw = _cross(vb[:, 0:3], vJ[:, 0:3])
        al = _cross(vb[:, 3:6], vJ[:, 0:3]) + _cross(vb[:, 0:3], vJ[:, 3:6])
        a.append(a[p] + torch.cat([aw, al], dim=-1))
    v_sp = torch.stack(v, dim=1)
    a_sp = torch.stack(a, dim=1)

    Iv = torch.einsum("nbij,nbj->nbi", I_sp, v_sp)
    Ia = torch.einsum("nbij,nbj->nbi", I_sp, a_sp)
    n_, f_ = Iv[..., 0:3], Iv[..., 3:6]
    wv, vl = v_sp[..., 0:3], v_sp[..., 3:6]
    f_b = Ia + torch.cat([_cross(wv, n_) + _cross(vl, f_), _cross(wv, f_)], dim=-1)

    gs = list(f_b.unbind(1))
    for b in range(nb - 1, 0, -1):
        p = rt.parent[b]
        gs[p] = gs[p] + gs[b]
    C_j = torch.sum(S_j * torch.stack(gs[1:], dim=1), dim=-1)
    C = torch.cat([gs[0], C_j + rt.damping * u[:, 6:]], dim=-1)
    return body_pos, body_quat, S, I_sp, v_sp, C


def assemble_mass_matrix(rt: RobotTensors, S, I_sp):
    """CRBA: composite inertias by reverse accumulation, M = D∘(S F^T)
    symmetrized, plus reflected armature. Returns (N, nv, nv)."""
    IC = list(I_sp.unbind(1))
    for b in range(rt.nb - 1, 0, -1):
        p = rt.parent[b]
        IC[p] = IC[p] + IC[b]
    IC_dof = torch.stack([IC[0]] * 6 + IC[1:], dim=1)               # (N,nv,6,6)
    F = torch.einsum("nvij,nvj->nvi", IC_dof, S)
    U = (S @ F.transpose(-1, -2)) * rt.dof_mask
    M = U + U.transpose(-1, -2) - torch.diag_embed(torch.diagonal(U, dim1=-2, dim2=-1))
    arm = torch.cat([torch.zeros(6, device=S.device, dtype=S.dtype), rt.armature])
    return M + torch.diag(arm)
