"""The XBot-L reward bank, batched over envs: port of the reference
package's env/rewards.py. Each term is a pure function of a RewardContext;
terms with zero scale are pruned when the table is built.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class RewardContext(NamedTuple):
    """Everything the reward bank reads. Tensors lead with the env axis."""
    dof_pos: torch.Tensor            # (N, nj)
    dof_vel: torch.Tensor            # (N, nj)
    last_dof_vel: torch.Tensor       # (N, nj)
    actions: torch.Tensor            # (N, nj)
    last_actions: torch.Tensor       # (N, nj)
    last_last_actions: torch.Tensor  # (N, nj)
    torques: torch.Tensor            # (N, nj)
    ref_dof_pos: torch.Tensor        # (N, nj)
    default_dof_pos: torch.Tensor    # (nj,)
    base_pos: torch.Tensor           # (N, 3)
    base_lin_vel: torch.Tensor       # (N, 3) body frame
    base_ang_vel: torch.Tensor       # (N, 3) body frame
    base_euler: torch.Tensor         # (N, 3)
    projected_gravity: torch.Tensor  # (N, 3)
    root_vel: torch.Tensor           # (N, 6) [lin, ang] world
    last_root_vel: torch.Tensor      # (N, 6)
    commands: torch.Tensor           # (N, 4)
    foot_pos: torch.Tensor           # (N, 2, 3)
    knee_pos: torch.Tensor           # (N, 2, 3)
    foot_ang_vel: torch.Tensor       # (N, 2, 3)
    foot_forces: torch.Tensor        # (N, 2, 3)
    term_force: torch.Tensor         # (N, nt)
    contact: torch.Tensor            # (N, 2) bool, fz > 5 N
    stance_mask: torch.Tensor        # (N, 2) gait-phase stance mask
    feet_air_time: torch.Tensor      # (N, 2) after += dt
    first_contact: torch.Tensor      # (N, 2) bool
    feet_height: torch.Tensor        # (N, 2) after integration
    dt: float
    cfg: object                      # config.structs.RewardsCfg


def gait_updates(contact, stance_mask, last_contacts, feet_air_time, foot_pos_z,
                 last_feet_z, feet_height, dt):
    """The stateful part of feet_air_time / feet_clearance as explicit
    transitions. Returns (ctx fields, new state fields)."""
    contact_filt = contact | stance_mask.bool() | last_contacts
    first_contact = (feet_air_time > 0.0) & contact_filt
    air_time = feet_air_time + dt
    new_feet_air_time = air_time * (~contact_filt)
    feet_z = foot_pos_z - 0.05
    fh = feet_height + (feet_z - last_feet_z)
    new_feet_height = fh * (~contact)
    return (air_time, first_contact, fh), (new_feet_air_time, contact, feet_z, new_feet_height)


def _norm(x, dim):
    return torch.linalg.vector_norm(x, dim=dim)


def joint_pos(c):
    n = _norm(c.dof_pos - c.ref_dof_pos, 1)
    return torch.exp(-2.0 * n) - 0.2 * torch.clamp(n, 0.0, 0.5)


def feet_distance(c):
    fd = _norm(c.foot_pos[:, 0, 0:2] - c.foot_pos[:, 1, 0:2], 1)
    d_min = torch.clamp(fd - c.cfg.min_dist, -0.5, 0.0)
    d_max = torch.clamp(fd - c.cfg.max_dist, 0.0, 0.5)
    return (torch.exp(-torch.abs(d_min) * 100) + torch.exp(-torch.abs(d_max) * 100)) / 2.0


def knee_distance(c):
    kd = _norm(c.knee_pos[:, 0, 0:2] - c.knee_pos[:, 1, 0:2], 1)
    d_min = torch.clamp(kd - c.cfg.min_dist, -0.5, 0.0)
    d_max = torch.clamp(kd - c.cfg.max_dist / 2, 0.0, 0.5)
    return (torch.exp(-torch.abs(d_min) * 100) + torch.exp(-torch.abs(d_max) * 100)) / 2.0


def foot_slip(c):
    # the upstream term reads the feet's angular velocity xy (kept for parity)
    speed = _norm(c.foot_ang_vel[:, :, 0:2], 2)
    return torch.sum(torch.sqrt(speed) * c.contact, dim=1)


def feet_air_time(c):
    return torch.sum(torch.clamp(c.feet_air_time, 0.0, 0.5) * c.first_contact, dim=1)


def feet_contact_number(c):
    match = c.contact == c.stance_mask.bool()
    return torch.mean(torch.where(match, 1.0, -0.3), dim=1)


def orientation(c):
    quat_mismatch = torch.exp(-torch.sum(torch.abs(c.base_euler[:, 0:2]), dim=1) * 10)
    orient = torch.exp(-_norm(c.projected_gravity[:, 0:2], 1) * 20)
    return (quat_mismatch + orient) / 2.0


def feet_contact_forces(c):
    f = _norm(c.foot_forces, -1)
    return torch.sum(torch.clamp(f - c.cfg.max_contact_force, 0.0, 400.0), dim=1)


def default_joint_pos(c):
    joint_diff = c.dof_pos - c.default_dof_pos
    yaw_roll = _norm(joint_diff[:, 0:2], 1) + _norm(joint_diff[:, 6:8], 1)
    yaw_roll = torch.clamp(yaw_roll - 0.1, 0.0, 50.0)
    return torch.exp(-yaw_roll * 100) - 0.01 * _norm(joint_diff, 1)


def base_height(c):
    stance = c.stance_mask
    measured = torch.sum(c.foot_pos[:, :, 2] * stance, dim=1) / torch.clamp(
        torch.sum(stance, dim=1), min=1e-6)
    h = c.base_pos[:, 2] - (measured - 0.05)
    return torch.exp(-torch.abs(h - c.cfg.base_height_target) * 100)


def base_acc(c):
    return torch.exp(-_norm(c.last_root_vel - c.root_vel, 1) * 3)


def vel_mismatch_exp(c):
    lin = torch.exp(-torch.square(c.base_lin_vel[:, 2]) * 10)
    ang = torch.exp(-_norm(c.base_ang_vel[:, 0:2], 1) * 5.0)
    return (lin + ang) / 2.0


def track_vel_hard(c):
    lin_err = _norm(c.commands[:, 0:2] - c.base_lin_vel[:, 0:2], 1)
    ang_err = torch.abs(c.commands[:, 2] - c.base_ang_vel[:, 2])
    return (torch.exp(-lin_err * 10) + torch.exp(-ang_err * 10)) / 2.0 - 0.2 * (lin_err + ang_err)


def tracking_lin_vel(c):
    err = torch.sum(torch.square(c.commands[:, 0:2] - c.base_lin_vel[:, 0:2]), dim=1)
    return torch.exp(-err * c.cfg.tracking_sigma)


def tracking_ang_vel(c):
    err = torch.square(c.commands[:, 2] - c.base_ang_vel[:, 2])
    return torch.exp(-err * c.cfg.tracking_sigma)


def feet_clearance(c):
    swing = 1.0 - c.stance_mask
    near = torch.abs(c.feet_height - c.cfg.target_feet_height) < 0.01
    return torch.sum(near * swing, dim=1)


def low_speed(c):
    if c.cfg.low_speed_directional:
        cmd_xy = c.commands[:, 0:2]
        cmd = _norm(cmd_xy, 1)
        dirv = cmd_xy / torch.clamp(cmd, min=1e-6)[:, None]
        signed = torch.sum(c.base_lin_vel[:, 0:2] * dirv, dim=1)
        speed = torch.abs(signed)
        mismatch = signed < 0.0
    else:
        speed = torch.abs(c.base_lin_vel[:, 0])
        cmd = torch.abs(c.commands[:, 0])
        mismatch = torch.sign(c.base_lin_vel[:, 0]) != torch.sign(c.commands[:, 0])
    active = cmd > 0.1
    too_low = speed < c.cfg.low_speed_lo * cmd
    too_high = speed > c.cfg.low_speed_hi * cmd
    desired = ~(too_low | too_high)
    r = torch.zeros_like(speed)
    r = torch.where(too_low, -1.0, r)
    r = torch.where(too_high, c.cfg.low_speed_overspeed_r, r)
    r = torch.where(desired, 1.2, r)
    r = torch.where(mismatch, -2.0, r)
    return r * active


def torques(c):
    return torch.sum(torch.square(c.torques), dim=1)


def dof_vel(c):
    return torch.sum(torch.square(c.dof_vel), dim=1)


def dof_acc(c):
    return torch.sum(torch.square((c.last_dof_vel - c.dof_vel) / c.dt), dim=1)


def collision(c):
    return torch.sum(1.0 * (c.term_force > 0.1), dim=1)


def action_smoothness(c):
    t1 = torch.sum(torch.square(c.last_actions - c.actions), dim=1)
    t2 = torch.sum(torch.square(c.actions + c.last_last_actions - 2 * c.last_actions), dim=1)
    t3 = 0.05 * torch.sum(torch.abs(c.actions), dim=1)
    return t1 + t2 + t3


REWARD_FNS = {
    "joint_pos": joint_pos,
    "feet_distance": feet_distance,
    "knee_distance": knee_distance,
    "foot_slip": foot_slip,
    "feet_air_time": feet_air_time,
    "feet_contact_number": feet_contact_number,
    "orientation": orientation,
    "feet_contact_forces": feet_contact_forces,
    "default_joint_pos": default_joint_pos,
    "base_height": base_height,
    "base_acc": base_acc,
    "vel_mismatch_exp": vel_mismatch_exp,
    "track_vel_hard": track_vel_hard,
    "tracking_lin_vel": tracking_lin_vel,
    "tracking_ang_vel": tracking_ang_vel,
    "feet_clearance": feet_clearance,
    "low_speed": low_speed,
    "torques": torques,
    "dof_vel": dof_vel,
    "dof_acc": dof_acc,
    "collision": collision,
    "action_smoothness": action_smoothness,
}


def build_reward_table(rewards_cfg, dt: float):
    """(names, fns, scales * dt) for the nonzero-scale terms."""
    names, fns, scales = [], [], []
    for name, scale in rewards_cfg.scales.active():
        if name not in REWARD_FNS:
            continue
        names.append(name)
        fns.append(REWARD_FNS[name])
        scales.append(scale * dt)
    return tuple(names), tuple(fns), tuple(scales)
