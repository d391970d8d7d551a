"""The physics engine on the PGS contact path, batched over envs: port of
the reference package's physics/engine.py (`substep_batch_pgs`,
`control_step_pgs`) in plain PyTorch.

This is the plain version of the CUDA control-step kernel
(ops/physics_kernel.py): the CPU runs it, and the card runs it only to
hold the kernel against it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .contact import ContactParams, Terrain, _point_forces
from .dynamics import assemble_mass_matrix, compute_kinematics_bias
from .kinematics import RobotTensors
from .pgs import PGSParams, PGSPrep, foot_contact_set, pgs_prepare, pgs_solve
from .spatial import quat_integrate, quat_rotate


class PhysState(NamedTuple):
    """Dynamic state, batched (N, ...)."""
    base_pos: torch.Tensor   # (N, 3)
    base_quat: torch.Tensor  # (N, 4) wxyz
    qj: torch.Tensor         # (N, nj)
    u: torch.Tensor          # (N, nv) [omega_world, v_world, qdot]


class PhysDiag(NamedTuple):
    """The last substep's diagnostics."""
    body_pos: torch.Tensor      # (N, nb, 3)
    body_quat: torch.Tensor     # (N, nb, 4)
    body_omega: torch.Tensor    # (N, nb, 3) world angular velocities
    foot_forces: torch.Tensor   # (N, n_feet, 3) net contact force per foot
    term_force: torch.Tensor    # (N, nt) normal force on termination proxies
    tau: torch.Tensor           # (N, nj) applied joint torques


class EnvPhysParams(NamedTuple):
    masses: torch.Tensor     # (N, nb)
    friction: torch.Tensor   # (N,)


def mass_matrix_factor(rt: RobotTensors, params: EnvPhysParams, state: PhysState):
    """Cholesky factor (N, nv, nv) of the CRBA mass matrix at `state`."""
    _, _, S, I_sp, _, _ = compute_kinematics_bias(
        rt, state.base_pos, state.base_quat, state.qj, state.u, mass=params.masses)
    return torch.linalg.cholesky(assemble_mass_matrix(rt, S, I_sp))


def _sphere_forces(rt, body_pos, body_quat, v_sp, terrain, mu, contact_params):
    """Penalty forces on the termination proxy spheres. Returns their
    generalized force (N, nv) and normal forces (N, nt)."""
    m = rt.model
    N = body_pos.shape[0]
    nt = len(m.term_sphere_body)
    dev, dt = body_pos.device, body_pos.dtype
    A0 = body_pos[:, 0]
    sph_tau = torch.zeros(N, rt.nv, device=dev, dtype=dt)
    term_fn = torch.zeros(N, nt, device=dev, dtype=dt)
    w_j = quat_rotate(body_quat[:, 1:], rt.joint_axis)
    lin_j = torch.linalg.cross(body_pos[:, 1:] - A0[:, None], w_j, dim=-1)
    for i in range(nt):
        b = int(m.term_sphere_body[i])
        off = torch.as_tensor(m.term_sphere_offset[i], device=dev, dtype=dt)
        low = body_pos[:, b] + quat_rotate(body_quat[:, b], off)
        low = low - torch.tensor([0.0, 0.0, 1.0], device=dev, dtype=dt) * float(m.term_sphere_radius[i])
        v = v_sp[:, b, 3:6] + torch.linalg.cross(v_sp[:, b, 0:3], low - A0, dim=-1)
        f, fn = _point_forces(low, v, terrain.sample(low[..., 0:2]), mu, contact_params)
        term_fn[:, i] = fn
        n_mom = torch.linalg.cross(low - A0, f, dim=-1)
        contrib = (torch.einsum("ni,nji->nj", n_mom, w_j)
                   + torch.einsum("ni,nji->nj", f, lin_j)) * rt.ancestors[b]
        sph_tau = sph_tau + torch.cat([n_mom, f, contrib], dim=1)
    return sph_tau, term_fn


def substep_batch_pgs(
    rt: RobotTensors,
    params: EnvPhysParams,
    terrain: Terrain,
    contact_params: ContactParams,
    pgs_params: PGSParams,
    state: PhysState,
    tau_j: torch.Tensor,
    dt: float,
    L: Optional[torch.Tensor] = None,
    prep: Optional[PGSPrep] = None,
) -> Tuple[PhysState, PhysDiag]:
    """One velocity-stepping substep with the block-PGS foot contact.
    L: frozen mass-matrix factor, else CRBA + factor here. prep: frozen
    contact prep, else built here from this substep's configuration."""
    N = tau_j.shape[0]
    body_pos, body_quat, S, I_sp, v_sp, C = compute_kinematics_bias(
        rt, state.base_pos, state.base_quat, state.qj, state.u, mass=params.masses)
    if L is None:
        L = torch.linalg.cholesky(assemble_mass_matrix(rt, S, I_sp))

    sph_tau, term_fn = _sphere_forces(
        rt, body_pos, body_quat, v_sp, terrain, params.friction, contact_params)
    zeros6 = torch.zeros(N, 6, device=tau_j.device, dtype=tau_j.dtype)
    tau_gen = torch.cat([zeros6, tau_j], dim=1) + sph_tau
    udot_free = torch.cholesky_solve((tau_gen - C)[..., None], L)[..., 0]
    u_free = state.u + dt * udot_free

    pts, vels, phi, n, J = foot_contact_set(rt, body_pos, body_quat, v_sp, terrain)
    if prep is None:
        prep = pgs_prepare(L, n, J)
    u_plus, point_forces = pgs_solve(u_free, prep, phi, params.friction, dt, pgs_params)

    # spatial -> conventional correction on the linear part
    omega = state.u[:, 0:3]
    v = state.u[:, 3:6]
    corr = torch.cat([zeros6[:, :3], dt * torch.linalg.cross(omega, v, dim=-1),
                      torch.zeros_like(state.u[:, 6:])], dim=1)
    u_new = u_plus + corr
    new_state = PhysState(
        base_pos=state.base_pos + dt * u_new[:, 3:6],
        base_quat=quat_integrate(state.base_quat, u_new[:, 0:3], dt),
        qj=state.qj + dt * u_new[:, 6:],
        u=u_new,
    )
    n_feet = len(rt.model.foot_bodies)
    diag = PhysDiag(
        body_pos=body_pos,
        body_quat=body_quat,
        body_omega=v_sp[:, :, 0:3],
        foot_forces=point_forces.reshape(N, n_feet, -1, 3).sum(dim=2),
        term_force=term_fn,
        tau=tau_j,
    )
    return new_state, diag


def frozen_prep(rt: RobotTensors, params: EnvPhysParams, state: PhysState, L, terrain):
    """Contact prep from the configuration of `state` (freeze_prep)."""
    body_pos, body_quat, _, _, v_sp, _ = compute_kinematics_bias(
        rt, state.base_pos, state.base_quat, state.qj, state.u, mass=params.masses)
    _, _, _, n, J = foot_contact_set(rt, body_pos, body_quat, v_sp, terrain)
    return pgs_prepare(L, n, J)


def control_step_pgs(
    rt: RobotTensors,
    params: EnvPhysParams,
    terrain: Terrain,
    contact_params: ContactParams,
    pgs_params: PGSParams,
    state: PhysState,
    torque_fn: Callable[[PhysState], torch.Tensor],
    decimation: int,
    dt: float,
    freeze_mass_matrix: bool = True,
    freeze_prep: bool = False,
) -> Tuple[PhysState, PhysDiag]:
    """`decimation` PGS substeps with the PD torque recomputed each one.
    freeze_mass_matrix factors M once, from the entry configuration;
    freeze_prep (only with a frozen factor) also builds the contact prep
    once from it."""
    L = prep = None
    if freeze_mass_matrix:
        L = mass_matrix_factor(rt, params, state)
        if freeze_prep:
            prep = frozen_prep(rt, params, state, L, terrain)
    diag = None
    for _ in range(decimation):
        state, diag = substep_batch_pgs(
            rt, params, terrain, contact_params, pgs_params, state,
            torque_fn(state), dt, L=L, prep=prep)
    return state, diag
