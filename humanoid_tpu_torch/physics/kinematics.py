"""Batched forward kinematics, body velocities, Jacobians and spatial
inertias: port of the reference package's physics/kinematics.py.

Every function takes env-batched tensors (N, ...) and loops in Python over
the robot's static topology. Spatial quantities live in a world-aligned
Plücker frame whose origin is the base position ("A = p0").
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .model import RobotModel
from .spatial import mat_to_quat, quat_from_axis_angle, quat_mul, quat_rotate, quat_to_mat, skew


@dataclasses.dataclass(frozen=True)
class RobotTensors:
    """The parts of a RobotModel that the torch physics reads, as float32
    tensors on one device, plus the static topology as Python ints."""
    model: RobotModel
    device: torch.device
    parent: tuple
    joint_rot_quat: torch.Tensor   # (nj, 4)
    joint_axis: torch.Tensor       # (nj, 3)
    joint_pos: torch.Tensor        # (nj, 3)
    mass: torch.Tensor             # (nb,)
    com: torch.Tensor              # (nb, 3)
    inertia: torch.Tensor          # (nb, 3, 3)
    armature: torch.Tensor         # (nj,)
    damping: torch.Tensor          # (nj,)
    ancestors: torch.Tensor        # (nb, nj) 1 where joint j is on the path to body b
    dof_mask: torch.Tensor         # (nv, nv) CRBA upper-triangle coupling mask

    @staticmethod
    def from_model(model: RobotModel, device) -> "RobotTensors":
        device = torch.device(device)

        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

        nv, nj = model.nv, model.nj
        anc = model.ancestor_matrix()
        D = np.zeros((nv, nv))
        D[:6, :] = 1.0
        D[:6, :6] = np.triu(np.ones((6, 6)))
        for a in range(nj):
            for b in range(nj):
                if anc[b + 1, a]:
                    D[6 + a, 6 + b] = 1.0
        jr = mat_to_quat(torch.as_tensor(np.asarray(model.joint_rot), dtype=torch.float32))
        return RobotTensors(
            model=model, device=device,
            parent=tuple(int(p) for p in model.parent),
            joint_rot_quat=jr.to(device),
            joint_axis=t(model.joint_axis), joint_pos=t(model.joint_pos),
            mass=t(model.mass), com=t(model.com), inertia=t(model.inertia),
            armature=t(model.dof_armature), damping=t(model.dof_damping),
            ancestors=t(anc), dof_mask=t(D),
        )

    @property
    def nj(self) -> int:
        return self.model.nj

    @property
    def nb(self) -> int:
        return self.model.nb

    @property
    def nv(self) -> int:
        return self.model.nv


def fk(rt: RobotTensors, base_pos, base_quat, qj):
    """World positions (N, nb, 3) and orientations (N, nb, 4) of all body
    frames."""
    pos = [base_pos]
    quat = [base_quat]
    for k in range(rt.nj):
        p = rt.parent[k + 1]
        q_fixed = quat_mul(quat[p], rt.joint_rot_quat[k].expand_as(quat[p]))
        q_joint = quat_from_axis_angle(rt.joint_axis[k], qj[:, k])
        quat.append(quat_mul(q_fixed, q_joint))
        pos.append(pos[p] + quat_rotate(quat[p], rt.joint_pos[k]))
    return torch.stack(pos, dim=1), torch.stack(quat, dim=1)


def joint_axes(rt: RobotTensors, body_quat):
    """World joint axes (N, nj, 3): joint k rotates body k+1."""
    return quat_rotate(body_quat[:, 1:], rt.joint_axis)


def body_velocities(rt: RobotTensors, body_pos, body_quat, u):
    """Spatial velocity [omega; v_A] of every body (N, nb, 6) and the world
    joint axes (N, nj, 3). u: (N, nv) = [omega_base, v_base, qdot]."""
    A = body_pos[:, 0]
    w = joint_axes(rt, body_quat)
    v_sp = [u[:, 0:6]]
    for k in range(rt.nj):
        p = rt.parent[k + 1]
        anchor = body_pos[:, k + 1] - A
        S = torch.cat([w[:, k], torch.linalg.cross(anchor, w[:, k], dim=-1)], dim=-1)
        v_sp.append(v_sp[p] + S * u[:, 6 + k: 7 + k])
    return torch.stack(v_sp, dim=1), w


def jacobians(rt: RobotTensors, body_pos, body_quat):
    """Geometric Jacobians (N, nb, 6, nv) in the Plücker-at-base frame."""
    N = body_pos.shape[0]
    A = body_pos[:, 0]
    w = joint_axes(rt, body_quat)                                   # (N, nj, 3)
    anchors = body_pos[:, 1:] - A[:, None]
    Jj = torch.cat([w, torch.linalg.cross(anchors, w, dim=-1)], dim=-1)  # (N, nj, 6)
    J_joint = rt.ancestors[None, :, :, None] * Jj[:, None]          # (N, nb, nj, 6)
    base = torch.eye(6, device=body_pos.device, dtype=body_pos.dtype).expand(N, rt.nb, 6, 6)
    return torch.cat([base, J_joint.transpose(-1, -2)], dim=-1)


def spatial_inertias(rt: RobotTensors, body_pos, body_quat, mass=None):
    """Per-body 6x6 spatial inertias (N, nb, 6, 6) about the base point and
    the world COMs (N, nb, 3). mass: optional (N, nb) per-env masses."""
    if mass is None:
        mass = rt.mass.expand(body_pos.shape[0], rt.nb)
    A = body_pos[:, 0]
    R = quat_to_mat(body_quat)                                      # (N, nb, 3, 3)
    com_w = body_pos + torch.einsum("nbij,bj->nbi", R, rt.com)
    I_w = torch.einsum("nbij,bjk,nblk->nbil", R, rt.inertia, R)
    rx = skew(com_w - A[:, None])
    m3 = mass[..., None, None]
    eye = torch.eye(3, device=body_pos.device, dtype=body_pos.dtype)
    top = torch.cat([I_w + m3 * rx @ rx.transpose(-1, -2), m3 * rx], dim=-1)
    bot = torch.cat([m3 * rx.transpose(-1, -2), m3 * eye.expand_as(rx)], dim=-1)
    return torch.cat([top, bot], dim=-2), com_w
