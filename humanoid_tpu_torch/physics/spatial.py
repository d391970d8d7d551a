"""Quaternion and spatial (6D) algebra on batched tensors.

Port of the reference package's physics/spatial.py. Conventions:
  * Quaternions are (w, x, y, z), unit norm, rotating body-frame vectors
    into the world frame: v_world = R(q) @ v_body.
  * Spatial vectors are [angular(3); linear(3)] (Featherstone).
Every function works on trailing axes and broadcasts over leading ones.
"""
from __future__ import annotations

import math

import torch


def quat_mul(a, b):
    """Hamilton product a ⊗ b."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_normalize(q, eps=1e-12):
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=eps)


def quat_rotate(q, v):
    """Rotate v by q (body -> world when q is a body pose)."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)


def quat_rotate_inverse(q, v):
    """Rotate v by the inverse of q (world -> body)."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v - qw * t + torch.linalg.cross(qv, t, dim=-1)


def quat_apply_yaw(q, v):
    """Rotate v by the yaw part of q only (x and y of the wxyz quaternion
    zeroed, then renormalized)."""
    q_yaw = torch.cat([q[..., 0:1], torch.zeros_like(q[..., 1:3]), q[..., 3:4]], dim=-1)
    return quat_rotate(quat_normalize(q_yaw), v)


def quat_from_axis_angle(axis, angle):
    """Unit quaternion for a rotation of `angle` about unit `axis`."""
    half = 0.5 * angle
    s = torch.sin(half)
    return torch.cat([torch.cos(half)[..., None], axis * s[..., None]], dim=-1)


def quat_to_mat(q):
    """3x3 rotation matrix of q (acts on column vectors)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_exp(omega_dt):
    """Quaternion exponential of a rotation vector, safe near zero."""
    angle = torch.linalg.vector_norm(omega_dt, dim=-1, keepdim=True)
    half = 0.5 * angle
    small = angle < 1e-8
    k = torch.where(small, torch.full_like(angle, 0.5),
                    torch.sin(half) / torch.where(small, torch.ones_like(angle), angle))
    return torch.cat([torch.cos(half), omega_dt * k], dim=-1)


def quat_integrate(q, omega_world, dt):
    """q(t+dt) = exp(0.5 * omega_world * dt) ⊗ q."""
    return quat_normalize(quat_mul(quat_exp(omega_world * dt), q))


def wrap_to_pi(a):
    """Wrap angles to (-pi, pi]."""
    return a - 2.0 * math.pi * torch.floor((a + math.pi) / (2.0 * math.pi))


def quat_to_euler_xyz(q):
    """Roll/pitch/yaw (extrinsic x-y-z), wrapped to (-pi, pi]."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return wrap_to_pi(torch.stack([roll, pitch, yaw], dim=-1))


def mat_to_quat(m):
    """Rotation matrix -> quaternion (w, x, y, z), branch-free."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    zero = torch.zeros_like(tr)
    qw = torch.sqrt(torch.maximum(1 + tr, zero)) / 2
    qx = torch.sqrt(torch.maximum(1 + m00 - m11 - m22, zero)) / 2
    qy = torch.sqrt(torch.maximum(1 - m00 + m11 - m22, zero)) / 2
    qz = torch.sqrt(torch.maximum(1 - m00 - m11 + m22, zero)) / 2
    qx = torch.where(m[..., 2, 1] - m[..., 1, 2] < 0, -qx, qx)
    qy = torch.where(m[..., 0, 2] - m[..., 2, 0] < 0, -qy, qy)
    qz = torch.where(m[..., 1, 0] - m[..., 0, 1] < 0, -qz, qz)
    return quat_normalize(torch.stack([qw, qx, qy, qz], dim=-1))


def skew(v):
    """3x3 cross-product matrices of v (..., 3)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))
