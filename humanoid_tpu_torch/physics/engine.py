"""The physics engine, batched over envs: port of the reference package's
physics/engine.py on its two contact models, block-PGS
(`substep_batch_pgs`, `control_step_pgs`) and penalty (`substep_batch`,
`control_step_batch`).

It is the plain version of the CUDA control-step kernel
(ops/physics_kernel.py), and the env's physics when the config turns the
kernel off (`sim.use_pallas_substep=False`, the reference's XLA path).
Its Cholesky factor, apply and solve are the `chol` argument's: the env
hands in its ops/linalg.py `CholeskyKernels` (the CUDA kernels of
csrc/linalg.cu on the card, their plain versions on the CPU); the default,
`linalg.PLAIN`, is the plain versions on any device, so that the control
step's plain version shares no kernel with what it is held against.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..ops.linalg import PLAIN
from .contact import ContactParams, Terrain, _point_forces, contact_forces
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
    masses: torch.Tensor                   # (N, nb)
    friction: torch.Tensor                 # (N,)
    com: Optional[torch.Tensor] = None     # (N, nb, 3) body-frame COMs; None = the model's
    inertia: Optional[torch.Tensor] = None  # (N, nb, 3, 3) body-frame inertias


def mass_matrix_factor(rt: RobotTensors, params: EnvPhysParams, state: PhysState, chol=PLAIN):
    """Cholesky factor (N, nv, nv) of the CRBA mass matrix at `state`."""
    _, _, S, I_sp, _, _ = _kinematics_bias(rt, params, state)
    return chol.factor_spd_batch(assemble_mass_matrix(rt, S, I_sp).contiguous())


def _kinematics_bias(rt: RobotTensors, params: EnvPhysParams, state: PhysState):
    return compute_kinematics_bias(rt, state.base_pos, state.base_quat, state.qj, state.u,
                                   mass=params.masses, com=params.com, inertia=params.inertia)


def _sphere_forces(rt, body_pos, body_quat, v_sp, terrain, mu, contact_params, planes=None):
    """Penalty forces on the termination proxy spheres. Returns their
    generalized force (N, nv) and normal forces (N, nt). Against `terrain`
    the force is vertical at the sampled height (the reference's PGS path);
    against `planes` (N, 3P) it acts along each sphere's plane normal (the
    kernel's)."""
    m = rt.model
    N = body_pos.shape[0]
    nt = len(m.term_sphere_body)
    n_fpts = len(m.contact_points()[0])
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
        if planes is None:
            f, fn = _point_forces(low, v, terrain.sample(low[..., 0:2]), mu, contact_params)
        else:
            c0, gx, gy = planes[:, 3 * (n_fpts + i):3 * (n_fpts + i) + 3].unbind(-1)
            f, fn = _point_forces(low, v, c0 + gx * low[:, 0] + gy * low[:, 1], mu,
                                  contact_params, grads=(gx, gy))
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
    planes: Optional[torch.Tensor] = None,
    chol=PLAIN,
    lam0: Optional[torch.Tensor] = None,
) -> Tuple[PhysState, PhysDiag, torch.Tensor]:
    """One velocity-stepping substep with the block-PGS foot contact.
    L: frozen mass-matrix factor, else CRBA + factor here. prep: frozen
    contact prep, else built here from this substep's configuration.
    planes: per-point ground planes (N, 3P) in place of `terrain`. chol:
    the Cholesky routines (ops/linalg.py). lam0: the impulses (N, 3K) the
    sweep starts from (None: zeros). Returns (state, diag, the final
    impulses)."""
    N = tau_j.shape[0]
    body_pos, body_quat, S, I_sp, v_sp, C = _kinematics_bias(rt, params, state)
    if L is None:
        L = chol.factor_spd_batch(assemble_mass_matrix(rt, S, I_sp).contiguous())

    sph_tau, term_fn = _sphere_forces(
        rt, body_pos, body_quat, v_sp, terrain, params.friction, contact_params, planes)
    zeros6 = torch.zeros(N, 6, device=tau_j.device, dtype=tau_j.dtype)
    tau_gen = torch.cat([zeros6, tau_j], dim=1) + sph_tau
    udot_free = chol.apply_spd_batch(L, (tau_gen - C).contiguous())
    u_free = state.u + dt * udot_free

    pts, vels, phi, n, J = foot_contact_set(rt, body_pos, body_quat, v_sp, terrain, planes)
    if prep is None:
        prep = pgs_prepare(L, n, J)
    u_plus, point_forces, lam = pgs_solve(u_free, prep, phi, params.friction, dt, pgs_params,
                                          lam0)

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
    return new_state, diag, lam


def frozen_prep(rt: RobotTensors, params: EnvPhysParams, state: PhysState, L, terrain,
                planes=None):
    """Contact prep from the configuration of `state` (freeze_prep)."""
    body_pos, body_quat, _, _, v_sp, _ = _kinematics_bias(rt, params, state)
    _, _, _, n, J = foot_contact_set(rt, body_pos, body_quat, v_sp, terrain, planes)
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
    planes: Optional[torch.Tensor] = None,
    chol=PLAIN,
    warm: bool = False,
) -> Tuple[PhysState, PhysDiag]:
    """`decimation` PGS substeps with the PD torque recomputed each one.
    freeze_mass_matrix factors M once, from the entry configuration;
    freeze_prep (only with a frozen factor) also builds the contact prep
    once from it. The ground is `terrain`, sampled every substep (the
    reference's semantics), or `planes` (N, 3P), one plane per contact
    point held for the whole control step (the kernel's). chol: the
    Cholesky routines (ops/linalg.py). warm: each substep's sweep starts
    from the previous substep's impulses, zeros at the control step's
    entry (the reference kernel's pgs_warm_start); otherwise every sweep
    starts cold."""
    L = prep = lam = None
    if freeze_mass_matrix:
        L = mass_matrix_factor(rt, params, state, chol)
        if freeze_prep:
            prep = frozen_prep(rt, params, state, L, terrain, planes)
    diag = None
    for _ in range(decimation):
        state, diag, lam_out = substep_batch_pgs(
            rt, params, terrain, contact_params, pgs_params, state,
            torque_fn(state), dt, L=L, prep=prep, planes=planes, chol=chol, lam0=lam)
        if warm:
            lam = lam_out
    return state, diag


def substep_batch(
    rt: RobotTensors,
    params: EnvPhysParams,
    terrain: Terrain,
    contact_params: ContactParams,
    state: PhysState,
    tau_j: torch.Tensor,
    dt: float,
    L: Optional[torch.Tensor] = None,
    planes: Optional[torch.Tensor] = None,
    chol=PLAIN,
) -> Tuple[PhysState, PhysDiag]:
    """One semi-implicit Euler substep with penalty contact on every sole
    corner and termination sphere. L: frozen mass-matrix factor (the
    reference's cached substep: two sweeps), else CRBA and the full solve
    here. planes: per-point ground planes (N, 3P) in place of `terrain`.
    chol: the Cholesky routines (ops/linalg.py)."""
    N = tau_j.shape[0]
    body_pos, body_quat, S, I_sp, v_sp, C = _kinematics_bias(rt, params, state)
    ci = contact_forces(rt, body_pos, body_quat, v_sp, terrain, params.friction, contact_params,
                        planes)
    zeros6 = torch.zeros(N, 6, device=tau_j.device, dtype=tau_j.dtype)
    rhs = (torch.cat([zeros6, tau_j], dim=1) + ci.tau_gen - C).contiguous()
    if L is None:
        udot = chol.solve_spd_batch(assemble_mass_matrix(rt, S, I_sp).contiguous(), rhs)
    else:
        udot = chol.apply_spd_batch(L, rhs)
    # spatial -> conventional acceleration of the base origin point
    lin = udot[:, 3:6] + torch.linalg.cross(state.u[:, 0:3], state.u[:, 3:6], dim=-1)
    u_new = state.u + dt * torch.cat([udot[:, 0:3], lin, udot[:, 6:]], dim=1)
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
        foot_forces=ci.point_forces.reshape(N, n_feet, -1, 3).sum(dim=2),
        term_force=ci.term_force,
        tau=tau_j,
    )
    return new_state, diag


def control_step_batch(
    rt: RobotTensors,
    params: EnvPhysParams,
    terrain: Terrain,
    contact_params: ContactParams,
    state: PhysState,
    torque_fn: Callable[[PhysState], torch.Tensor],
    decimation: int,
    dt: float,
    freeze_mass_matrix: bool = False,
    planes: Optional[torch.Tensor] = None,
    chol=PLAIN,
) -> Tuple[PhysState, PhysDiag]:
    """`decimation` penalty substeps with the PD torque recomputed each one.
    freeze_mass_matrix factors M once, from the entry configuration, and
    every substep reuses the factor; otherwise each substep solves with its
    own. The ground is `terrain`, sampled every substep, or `planes`
    (N, 3P), held for the control step (the kernel's). chol: the Cholesky
    routines (ops/linalg.py)."""
    L = mass_matrix_factor(rt, params, state, chol) if freeze_mass_matrix else None
    diag = None
    for _ in range(decimation):
        state, diag = substep_batch(rt, params, terrain, contact_params, state,
                                    torque_fn(state), dt, L=L, planes=planes, chol=chol)
    return state, diag
