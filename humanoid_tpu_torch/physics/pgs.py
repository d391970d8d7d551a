"""Constraint-based foot contact: batched block projected Gauss-Seidel.
Port of the reference package's physics/pgs.py.

Velocity time-stepping:
    u+ = u_free + M^-1 Jc^T lam,          u_free = u + h M^-1 (tau - C)
    per contact k:  0 <= lam_n  _|_  v_n+ + b_n + gamma*lam_n >= 0
                    ||lam_t|| <= mu * lam_n   (Coulomb cone, exact stick)
with Baumgarte bias b_n = -(erp/h) max(-phi - slop, 0) and the
constraint-force-mixing regularizer gamma = cfm_ratio * A_nn. Solved by
block PGS: scalar normal update, 2x2 tangential solve, cone projection.

The contact prep (frames, Jacobian rows, Delassus operator) can be built
once per control step from the entry configuration and reused by every
substep (`freeze_prep`, see PGSPrep); penetrations, bias and velocities are
always fresh. The sweep starts from zero impulses, or from `lam0` (the
warm start: the previous substep's impulses, `PGSParams.warm_start`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .contact import Terrain, plane_normal
from .kinematics import RobotTensors
from .spatial import quat_rotate, skew


class PGSParams(NamedTuple):
    iterations: int = 8
    erp: float = 0.024
    cfm_ratio: float = 0.01
    slop: float = 0.0
    # carry the impulses from substep to substep within a control step: the
    # fused kernel's option (and its plain version's); the engine path of the
    # env starts every substep cold, as the reference's XLA path does
    warm_start: bool = False


class PGSPrep(NamedTuple):
    """Configuration-dependent solve structures."""
    Rk: torch.Tensor        # (N, K, 3, 3) contact frames [n; t1; t2]
    Jc: torch.Tensor        # (N, 3K, nv) contact-frame Jacobian rows
    W: torch.Tensor         # (N, 3K, nv) rows of (M^-1 Jc^T)^T
    A: torch.Tensor         # (N, 3K, 3K) Delassus operator Jc M^-1 Jc^T


def contact_frames(n):
    """Orthonormal tangent basis per contact normal n (..., 3)."""
    ex = torch.tensor([1.0, 0.0, 0.0], device=n.device, dtype=n.dtype)
    ey = torch.tensor([0.0, 1.0, 0.0], device=n.device, dtype=n.dtype)
    use_x = torch.abs(n[..., 0:1]) < 0.9
    a = torch.where(use_x, ex, ey)
    t1 = torch.linalg.cross(n, a.expand_as(n), dim=-1)
    t1 = t1 / torch.linalg.vector_norm(t1, dim=-1, keepdim=True)
    t2 = torch.linalg.cross(n, t1, dim=-1)
    return t1, t2


def foot_contact_set(rt: RobotTensors, body_pos, body_quat, v_sp, terrain: Terrain,
                     planes: Optional[torch.Tensor] = None):
    """Foot-point kinematics, Jacobians and terrain geometry.

    The ground is `terrain`, sampled at the points (the flat plane or a
    heightfield: the gap along the normal, the normal from the local
    gradient), or, when given, `planes` (N, 3P): a plane [c0, gx, gy] per
    contact point in contact_points() order (sole corners, then the
    termination spheres), height c0 + gx x + gy y, held for a control step
    (the kernel's semantics).

    Returns (pts (N,K,3), vels (N,K,3), phi (N,K), n (N,K,3), J (N,K,3,nv))
    with K = 4 corners x n_feet and J mapping u to world point velocity."""
    A = body_pos[:, 0]
    pt_body, pt_off = rt.model.contact_points()
    pts, vels = [], []
    for b, off in zip(pt_body, pt_off):
        b = int(b)
        off_t = torch.as_tensor(off, dtype=body_pos.dtype, device=body_pos.device)
        p = body_pos[:, b] + quat_rotate(body_quat[:, b], off_t)
        v = v_sp[:, b, 3:6] + torch.linalg.cross(v_sp[:, b, 0:3], p - A, dim=-1)
        pts.append(p)
        vels.append(v)
    pts = torch.stack(pts, dim=1)
    vels = torch.stack(vels, dim=1)
    K = pts.shape[1]
    if planes is not None:
        c0, gx, gy = planes.reshape(pts.shape[0], -1, 3)[:, :K].unbind(-1)
        n, inv_l = plane_normal(gx, gy)
        phi = (pts[..., 2] - (c0 + gx * pts[..., 0] + gy * pts[..., 1])) * inv_l
    elif terrain.flat:
        n = torch.zeros_like(pts)
        n[..., 2] = 1.0
        phi = pts[..., 2]
    else:
        heights, gx, gy = terrain.sample_with_grad(pts[..., 0:2])
        n, inv_l = plane_normal(gx, gy)
        phi = (pts[..., 2] - heights) * inv_l

    r = pts - A[:, None]                                        # (N,K,3)
    w_j = quat_rotate(body_quat[:, 1:], rt.joint_axis)          # (N,nj,3)
    anchor = body_pos[:, 1:] - A[:, None]
    lin_j = torch.linalg.cross(anchor, w_j, dim=-1)
    mask = rt.ancestors[torch.as_tensor(pt_body, dtype=torch.long, device=pts.device)]
    w_b, r_b = torch.broadcast_tensors(w_j[:, None], r[:, :, None, :])
    Jj = mask[None, :, :, None] * (lin_j[:, None] + torch.linalg.cross(w_b, r_b, dim=-1))
    J_base_w = -skew(r)
    eye3 = torch.eye(3, device=pts.device, dtype=pts.dtype).expand_as(J_base_w)
    J = torch.cat([J_base_w, eye3, Jj.transpose(-1, -2)], dim=-1)  # (N,K,3,nv)
    return pts, vels, phi, n, J


def pgs_prepare(L, n, J) -> PGSPrep:
    """Frames, contact-frame rows and the Delassus operator from the
    Cholesky factor L (N, nv, nv) of M."""
    N, K = n.shape[:2]
    nv = J.shape[-1]
    t1, t2 = contact_frames(n)
    Rk = torch.stack([n, t1, t2], dim=2)                        # (N,K,3,3)
    Jc = torch.einsum("nkab,nkbv->nkav", Rk, J).reshape(N, 3 * K, nv)
    W = torch.cholesky_solve(Jc.transpose(-1, -2), L).transpose(-1, -2)
    A = Jc @ W.transpose(-1, -2)
    return PGSPrep(Rk=Rk, Jc=Jc, W=W, A=A)


def pgs_solve(u_free, prep: PGSPrep, phi, mu, dt: float, params: PGSParams, lam0=None):
    """Block-PGS impulse solve, the reference kernel's _pgs_contact sweep.
    It starts from zero impulses, or from lam0 (N, 3K) (the warm start),
    which enters every row velocity v = v_free + A lam as the sweep's own
    impulses do; after the first sweep a point out of contact holds zero.
    Returns (u_plus (N,nv), world contact forces (N,K,3) = impulses / dt,
    the final impulses lam (N,3K) in the contact frames)."""
    N, K = phi.shape
    Amat = prep.A
    v_free = torch.einsum("nkv,nv->nk", prep.Jc, u_free)
    active = phi < 0.0
    b_n = -(params.erp / dt) * torch.clamp(-phi - params.slop, min=0.0)
    zero = torch.zeros((), dtype=u_free.dtype, device=u_free.device)
    if lam0 is None:
        lam = torch.zeros(N, 3 * K, dtype=u_free.dtype, device=u_free.device)
    else:
        lam = lam0.clone()
    for _ in range(params.iterations):
        for k in range(K):
            i0 = 3 * k
            vk = v_free[:, i0:i0 + 3] + torch.einsum("nij,nj->ni", Amat[:, i0:i0 + 3, :], lam)
            Ann = Amat[:, i0, i0]
            gam = params.cfm_ratio * Ann
            ln = lam[:, i0]
            ln_new = torch.clamp(ln - (vk[:, 0] + b_n[:, k] + gam * ln) / (Ann + gam), min=0.0)
            ln_new = torch.where(active[:, k], ln_new, zero)
            vt = vk[:, 1:3] + Amat[:, i0 + 1:i0 + 3, i0] * (ln_new - ln)[:, None]
            a11 = Amat[:, i0 + 1, i0 + 1] + gam
            a22 = Amat[:, i0 + 2, i0 + 2] + gam
            a12 = Amat[:, i0 + 1, i0 + 2]
            det = a11 * a22 - a12 * a12
            rhs1 = vt[:, 0] + gam * lam[:, i0 + 1]
            rhs2 = vt[:, 1] + gam * lam[:, i0 + 2]
            lt1 = lam[:, i0 + 1] - (a22 * rhs1 - a12 * rhs2) / det
            lt2 = lam[:, i0 + 2] - (a11 * rhs2 - a12 * rhs1) / det
            tnorm = torch.sqrt(lt1 * lt1 + lt2 * lt2 + 1e-12)
            scale = torch.clamp(mu * ln_new / tnorm, max=1.0)
            ok = active[:, k]
            lam[:, i0] = ln_new
            lam[:, i0 + 1] = torch.where(ok, lt1 * scale, zero)
            lam[:, i0 + 2] = torch.where(ok, lt2 * scale, zero)
    u_plus = u_free + torch.einsum("nkv,nk->nv", prep.W, lam)
    forces = torch.einsum("nkab,nka->nkb", prep.Rk, lam.reshape(N, K, 3)) / dt
    return u_plus, forces, lam
