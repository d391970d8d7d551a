"""XBot-L walking task on batched torch tensors: port of the reference
package's env/xbotl.py with both contact models (block-PGS and penalty), on
flat ground or a heightfield, with the reference's domain randomizations
(friction, masses, COM and inertia, motor strength, offset and gains,
action lag), the terrain curriculum, the height scan, and its command
features: the stand/walk switch with its gait schedule (`sw_switch`), the
command curriculum and the on-axis command practice (`axis_frac`).

One `step` over an explicit EnvState, batched over envs, with the masked
auto-reset inside it. Randomness comes from an explicit torch.Generator on
the env's device. The physics takes one of the reference's two paths, by
`cfg.sim.use_pallas_substep`:

- on (the default): the fused control step, ControlStepKernel, with PGS or
  penalty contact. On a heightfield the ground of a control step is one
  plane per contact point, sampled at its entry position by TerrainSampler
  (the reference's kernel semantics), and `pgs_freeze_prep` and
  `pgs_warm_start` are honoured.
- off: the reference's XLA engine path, physics/engine.py's
  control_step_pgs or control_step_batch, whose factor and solves are the
  CUDA kernels of ops/linalg.py (the env's `cholesky`). The heightfield is
  sampled at every substep, the PGS contact prep is built every substep and
  every sweep starts cold (the reference ignores `pgs_freeze_prep` and
  `pgs_warm_start` there, and warns), and the torque is the reference's own
  function of the substep's state.

The reference also takes its XLA path when num_envs is not a multiple of
128 or the backend is not a TPU: both are limits of the TPU's tiles, which
the CUDA kernel does not have, so the port dispatches on the flag alone.
Each kernel runs on the card for state on the card and as its plain
PyTorch version for state on the CPU; the height scan always comes from
TerrainSampler (equal to the reference's gather).

Step pipeline (ordering of the reference): action delay-mix + noise + clip
-> action lag -> decimated PD/physics -> episode counters -> base
quantities -> [resample commands, heading, push] -> termination -> rewards
-> terrain curriculum + masked reset -> gain redraw -> observations and
height scan -> history and last_* updates -> obs clip.
"""
from __future__ import annotations

import logging
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..assets import load_robot
from ..config.structs import XBotLCfg
from ..ops.linalg import CholeskyKernels
from ..ops.physics_kernel import ControlStepKernel, pack_body, pack_state, unpack_state
from ..ops.terrain_sampler import TerrainSampler
from ..physics.contact import ContactParams, Terrain
from ..physics.engine import EnvPhysParams, PhysState, control_step_batch, control_step_pgs
from ..physics.kinematics import RobotTensors, fk
from ..physics.pgs import PGSParams
from ..physics.spatial import (quat_apply_yaw, quat_rotate, quat_rotate_inverse,
                               quat_to_euler_xyz, wrap_to_pi)
from .rewards import RewardContext, build_reward_table, gait_updates


class EnvState(NamedTuple):
    phys: PhysState                  # batched (N, ...)
    masses: torch.Tensor             # (N, nb) randomized body masses
    friction: torch.Tensor           # (N,)
    episode_length: torch.Tensor     # (N,) int32
    common_step: torch.Tensor        # () int64 global counter
    commands: torch.Tensor           # (N, 4) [vx, vy, wyaw, heading]
    actions: torch.Tensor            # (N, nj)
    last_actions: torch.Tensor       # (N, nj)
    last_last_actions: torch.Tensor  # (N, nj)
    last_dof_vel: torch.Tensor       # (N, nj)
    last_root_vel: torch.Tensor      # (N, 6) [lin, ang] world
    feet_air_time: torch.Tensor      # (N, 2)
    last_contacts: torch.Tensor      # (N, 2) bool
    last_feet_z: torch.Tensor        # (N, 2)
    feet_height: torch.Tensor        # (N, 2)
    push_force: torch.Tensor         # (N, 2)
    push_torque: torch.Tensor        # (N, 3)
    obs_hist: torch.Tensor           # (N, frame_stack, K)
    critic_hist: torch.Tensor        # (N, c_frame_stack, K')
    episode_sums: torch.Tensor       # (N, n_rew)
    env_origins: torch.Tensor        # (N, 3) spawn origin (terrain cell or plane grid)
    terrain_levels: torch.Tensor     # (N,) int32 curriculum row (zeros on the plane)
    terrain_types: torch.Tensor      # (N,) int32 curriculum column
    course_gain: torch.Tensor        # () reward curriculum gain
    # None when the feature is off
    body_com: Optional[torch.Tensor] = None         # (N, nb, 3) body-frame COMs
    body_inertia: Optional[torch.Tensor] = None     # (N, nb, 3, 3)
    motor_strengths: Optional[torch.Tensor] = None  # (N, nj)
    motor_offsets: Optional[torch.Tensor] = None    # (N, nj)
    kp_factors: Optional[torch.Tensor] = None       # (N, nj)
    kd_factors: Optional[torch.Tensor] = None       # (N, nj)
    lag_buffer: Optional[torch.Tensor] = None       # (N, L+1, nj) scaled actions, newest last
    # the stand/walk switch and its gait schedule (sw_switch)
    time_to_stand_still: Optional[torch.Tensor] = None  # (N,) steps of stand command at low speed
    phase_length_buf: Optional[torch.Tensor] = None     # (N,) int32 gait phase counter
    gait_start: Optional[torch.Tensor] = None           # (N,) phase offset, 0 or 0.5 cycles
    gait_time: Optional[torch.Tensor] = None            # (N, n_gaits) int32 switch steps
    cmd_x_range: Optional[torch.Tensor] = None          # (2,) lin_vel_x under the command curriculum
    terrain_planes: Optional[torch.Tensor] = None   # (N, 3P) next step's contact planes


class StepOutput(NamedTuple):
    obs: torch.Tensor                # (N, frame_stack * K)
    privileged_obs: torch.Tensor     # (N, c_frame_stack * K')
    rew: torch.Tensor                # (N,)
    reset: torch.Tensor              # (N,) bool
    time_outs: torch.Tensor          # (N,) bool
    ep_rew_sums: torch.Tensor        # (n_rew,) summed over envs that reset
    ep_count: torch.Tensor           # () episodes finished
    ep_len_sum: torch.Tensor         # () their summed lengths
    ep_term_count: torch.Tensor      # () episodes ended by failure
    rew_terms_mean: torch.Tensor     # (n_rew,) this-step mean per term


def _stretch(v, lo: float, hi: float):
    """|v| mapped from [0, range] into [0.2, range] on its side of zero, so
    that an on-axis command is never below the stand threshold."""
    side = torch.where(v >= 0, torch.full_like(v, hi), torch.full_like(v, -lo))
    m = 0.2 + v.abs() / torch.clamp(side, min=1e-6) * torch.clamp(side - 0.2, min=0.0)
    return torch.sign(v) * m


def axis_project(vx, vy, on_axis, sagittal, ranges):
    """The on-axis command practice (CommandsCfg.axis_frac): where on_axis,
    keep vx alone (sagittal) or vy alone, stretched into [0.2, range] of the
    static ranges; elsewhere the box sample."""
    vx = torch.where(on_axis & ~sagittal, 0.0,
                     torch.where(on_axis, _stretch(vx, *ranges.lin_vel_x), vx))
    vy = torch.where(on_axis & sagittal, 0.0,
                     torch.where(on_axis, _stretch(vy, *ranges.lin_vel_y), vy))
    return vx, vy


def lag_push(lag_buffer, actions_scaled, idx):
    """The action-lag ring: push the newest scaled actions (N, nj) into
    lag_buffer (N, L+1, nj), newest last, and take element idx (a (1,)
    index tensor) of the new ring. Returns (new ring, (N, nj))."""
    ring = torch.cat([lag_buffer[:, 1:], actions_scaled[:, None]], dim=1)
    return ring, ring.index_select(1, idx)[:, 0]


class XBotLEnv:
    """Static task object: the compiled model, config-derived constant
    tensors on one device, the reward table, the control-step kernel and,
    on a heightfield, the terrain and its sampler.

    terrain: the heightfield Terrain on `device` (the flat plane when None);
    terrain_world: the generated world (env/terrain.py::TerrainWorld) that
    gives the curriculum's origins and the sampler's raster; joint_order:
    the robot's dof order (assets.resolve_robot), else the URDF's document
    order."""

    def __init__(self, cfg: XBotLCfg, urdf_path: str, device="cuda",
                 terrain: Optional[Terrain] = None, terrain_world=None, joint_order=None):
        if cfg.sim.contact_model not in ("penalty", "pgs"):
            raise ValueError(f"unknown contact_model {cfg.sim.contact_model!r} (penalty | pgs)")
        if cfg.terrain.mesh_type not in ("plane", "heightfield", "trimesh"):
            raise ValueError(f"unknown terrain mesh_type {cfg.terrain.mesh_type!r}")
        if (cfg.terrain.mesh_type != "plane") != (terrain_world is not None):
            raise ValueError(f"mesh_type {cfg.terrain.mesh_type!r} needs a terrain world "
                             "exactly when it is not 'plane' (utils/registry.py builds it)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = load_robot(urdf_path, cfg.asset, cfg.sim.armature, joint_order)
        m = self.model
        self.nj = m.nj
        self.dt = cfg.dt
        dev = self.device

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        self.default_dof_pos = t(cfg.init_state.default_joint_angles)
        self.action_scale = t(cfg.control.action_scale)
        kp = np.asarray(cfg.control.stiffness, dtype=np.float32)
        kd = np.asarray(cfg.control.damping, dtype=np.float32)
        torque_limits = (m.dof_effort * cfg.safety.torque_limit).astype(np.float32)
        s = cfg.sim
        self.contact_params = ContactParams(kn=s.contact_kn, cn=s.contact_cn,
                                            v_reg=s.contact_v_reg)
        self.pgs_params = (PGSParams(iterations=s.pgs_iterations, erp=s.pgs_erp,
                                     cfm_ratio=s.pgs_cfm, slop=s.pgs_slop,
                                     warm_start=s.pgs_warm_start)
                           if s.contact_model == "pgs" else None)
        # the fused control step; off, the engine path (it then counts no
        # launch) with the Cholesky kernels (they count none on the kernel path)
        self.use_kernel = s.use_pallas_substep
        if not self.use_kernel and self.pgs_params is not None and (s.pgs_freeze_prep
                                                                    or s.pgs_warm_start):
            logging.getLogger(__name__).warning(
                "fused control-step kernel off (sim.use_pallas_substep=False): the engine "
                "path runs. NOTE: pgs_freeze_prep/pgs_warm_start are kernel-only and are "
                "ignored on this path (per-substep prep, cold start).")
        self.physics = ControlStepKernel(m, kp, kd, torque_limits, self.contact_params,
                                         self.pgs_params, s.dt)
        self.cholesky = CholeskyKernels()
        obs_scales = cfg.normalization.obs_scales
        self.commands_scale = t([obs_scales.lin_vel, obs_scales.lin_vel, obs_scales.ang_vel])
        self.reward_names, self.reward_fns, reward_scales = build_reward_table(cfg.rewards, self.dt)
        self.reward_scales = t(reward_scales)
        self.n_rew = len(self.reward_names)
        self.noise_vec = self._build_noise_vec()

        N = cfg.env.num_envs
        cols = int(np.floor(np.sqrt(N)))
        rows = int(np.ceil(N / cols))
        xx, yy = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
        origins = np.zeros((N, 3))
        origins[:, 0] = cfg.terrain.env_spacing * xx.flatten()[:N]
        origins[:, 1] = cfg.terrain.env_spacing * yy.flatten()[:N]
        self.env_origins = t(origins)          # the plane's grid

        # terrain: the curriculum's cell origins and the sampler
        self.terrain = terrain if terrain is not None else Terrain.plane()
        self.terrain_world = terrain_world
        self.custom_origins = terrain_world is not None
        self.sampler = None
        # the kernel's ground on a heightfield: per-point planes carried in the state
        self.kernel_planes = self.use_kernel and self.custom_origins
        if self.custom_origins:
            self.terrain_origins = t(terrain_world.env_origins)      # (rows, cols, 3)
            self.max_terrain_level = terrain_world.num_rows
            self.sampler = TerrainSampler(terrain_world.height, cfg.terrain.vertical_scale,
                                          terrain_world.horizontal_scale, terrain_world.border,
                                          device=dev)
        self.height_points = None
        if cfg.terrain.measure_heights:
            gx, gy = np.meshgrid(np.asarray(cfg.terrain.measured_points_x),
                                 np.asarray(cfg.terrain.measured_points_y), indexing="ij")
            self.height_points = t(np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], -1))
        # contact points with a plane (sole corners, then termination
        # spheres): bodies and offsets, and their xy in the default stance
        # with the base at the origin (where a just-reset env's planes are
        # sampled: its feet spawn in the air)
        pt_body, pt_off = m.contact_points()
        self._plane_bodies = [int(b) for b in pt_body] + [int(b) for b in m.term_sphere_body]
        self._plane_offsets = t(np.concatenate([np.asarray(pt_off).reshape(-1, 3),
                                                np.asarray(m.term_sphere_offset).reshape(-1, 3)]))
        self._rt = RobotTensors.from_model(m, dev)
        bp0, bq0 = fk(self._rt, torch.zeros(1, 3, device=dev),
                      t([[1.0, 0.0, 0.0, 0.0]]), self.default_dof_pos[None])
        self._default_contact_xy = self._contact_xy(bp0, bq0)[0]      # (P, 2)

        # domain randomization of gains, bodies and the action lag
        dr = cfg.domain_rand
        self.dof_rand_on = (dr.randomize_motor_strength or dr.randomize_motor_offset
                            or dr.randomize_kp_factor or dr.randomize_kd_factor)
        self.body_rand_on = dr.randomize_base_com or dr.randomize_inertia
        self.dof_rand_interval = int(np.ceil(dr.dof_rand_interval_s / self.dt))
        self.kp, self.kd, self.torque_limits = t(kp), t(kd), t(torque_limits)
        self.sw_switch = cfg.commands.sw_switch
        self.resample_steps = int(cfg.commands.resampling_time / self.dt)
        self.push_interval = int(np.ceil(cfg.domain_rand.push_interval_s / self.dt))
        self.max_episode_length = cfg.max_episode_length
        self.smooth_idx = (self.reward_names.index("action_smoothness")
                           if "action_smoothness" in self.reward_names else None)
        self.track_idx = (self.reward_names.index("tracking_lin_vel")
                          if "tracking_lin_vel" in self.reward_names else None)
        # static gait-reference masks (leg pitch/knee/ankle per side)
        s1 = cfg.rewards.target_joint_pos_scale
        vl = np.zeros(self.nj, dtype=np.float32)
        vl[list(cfg.rewards.ref_leg_idx_left)] = [s1, 2 * s1, s1]
        vr = np.zeros(self.nj, dtype=np.float32)
        vr[list(cfg.rewards.ref_leg_idx_right)] = [s1, 2 * s1, s1]
        self._ref_l, self._ref_r = t(vl), t(vr)
        # constants of the step, made once: a host-to-device copy inside the
        # step would wait for the card's queue
        self._init_pos = t(cfg.init_state.pos)
        self._identity_quat = t([1.0, 0.0, 0.0, 0.0])
        self._down = t([0.0, 0.0, -1.0])
        self._forward = t([1.0, 0.0, 0.0])

    # ------------------------------------------------------------------
    # static helpers

    def _build_noise_vec(self):
        cfg = self.cfg
        ns = cfg.noise.noise_scales
        os_ = cfg.normalization.obs_scales
        nj = self.nj
        v = np.zeros(cfg.env.num_single_obs, dtype=np.float32)
        v[5:5 + nj] = ns.dof_pos * os_.dof_pos
        v[5 + nj:5 + 2 * nj] = ns.dof_vel * os_.dof_vel
        v[5 + 3 * nj:8 + 3 * nj] = ns.ang_vel * os_.ang_vel
        v[8 + 3 * nj:11 + 3 * nj] = ns.quat * os_.quat
        return torch.as_tensor(v, device=self.device)

    def _phase(self, counter, gait_start=None):
        """Gait phase in cycles: the episode length, or under sw_switch the
        phase counter (frozen while standing) plus its half-cycle offset."""
        phase = counter.float() * self.dt / self.cfg.rewards.cycle_time
        return phase if gait_start is None else phase + gait_start

    def _gait_masks(self, counter, gait_start=None):
        """(stance_mask (N,2), sin_pos (N,))."""
        sin_pos = torch.sin(2 * math.pi * self._phase(counter, gait_start))
        left = sin_pos >= 0
        stance = torch.stack([left, ~left], dim=-1).float()
        double = (torch.abs(sin_pos) < 0.1)[:, None]
        return torch.where(double, 1.0, stance), sin_pos

    def _ref_dof_pos(self, counter, gait_start=None):
        _, sin_pos = self._gait_masks(counter, gait_start)
        ref = (torch.clamp(sin_pos, max=0.0)[:, None] * self._ref_l
               + torch.clamp(sin_pos, min=0.0)[:, None] * self._ref_r)
        double = (torch.abs(sin_pos) < 0.1)[:, None]
        return torch.where(double, 0.0, ref)

    def _uniform(self, gen, shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=self.device)

    def _sample_commands(self, gen, n, cmd_x_range=None):
        """(n, 4) fresh commands; cmd_x_range (2,), under the command
        curriculum, replaces the static lin_vel_x bounds."""
        cfg = self.cfg.commands
        r = cfg.ranges
        if cmd_x_range is None:
            vx = self._uniform(gen, (n,), *r.lin_vel_x)
        else:
            u = torch.rand((n,), generator=gen, device=self.device)
            vx = cmd_x_range[0] + u * (cmd_x_range[1] - cmd_x_range[0])
        vy = self._uniform(gen, (n,), *r.lin_vel_y)
        if cfg.heading_command:
            heading = self._uniform(gen, (n,), *r.heading)
            wyaw = torch.zeros(n, device=self.device)
        else:
            heading = torch.zeros(n, device=self.device)
            wyaw = self._uniform(gen, (n,), *r.ang_vel_yaw)
        if cfg.axis_frac > 0.0:
            on_axis = torch.rand((n,), generator=gen, device=self.device) < cfg.axis_frac
            sagittal = torch.rand((n,), generator=gen, device=self.device) < 0.5
            vx, vy = axis_project(vx, vy, on_axis, sagittal, r)
        cmds = torch.stack([vx, vy, wyaw, heading], dim=-1)
        keep = (torch.linalg.vector_norm(cmds[:, 0:2], dim=1) > 0.2).float()
        return torch.cat([cmds[:, 0:2] * keep[:, None], cmds[:, 2:]], dim=1)

    def _sample_gait_command(self, gen, n, gait, cmd_x_range=None):
        """The gait schedule's command rules: stand -> zeros,
        walk_omnidirectional -> the full ranges, walk_sagittal -> vy = 0,
        walk_lateral -> vx = 0."""
        if gait == "stand":
            return torch.zeros(n, 4, device=self.device)
        cmds = self._sample_commands(gen, n, cmd_x_range)
        if gait == "walk_sagittal":
            cmds[:, 1] = 0.0
        elif gait == "walk_lateral":
            cmds[:, 0] = 0.0
        elif gait != "walk_omnidirectional":
            raise ValueError(f"unknown gait {gait!r}")
        return cmds

    def _generate_gait_time(self, gen, n):
        """(n, n_gaits) int32 switch steps, stratified: gait i switches in at
        a random step of the i-th of n_gaits equal parts of the episode."""
        n_g = len(self.cfg.commands.gait)
        seg = self.max_episode_length // n_g
        u = torch.randint(1, max(seg, 2), (n, n_g), generator=gen, device=self.device)
        return (u + seg * torch.arange(n_g, device=self.device)).to(torch.int32)

    def _reset_phys(self, gen, n, env_origins):
        """Fresh state at the origins, with the xy jitter within 1 m of a
        terrain cell's centre."""
        rand = self.cfg.init_state.reset_dof_rand
        qj = self.default_dof_pos + self._uniform(gen, (n, self.nj), -rand, rand)
        base_pos = self._init_pos + env_origins
        if self.custom_origins:
            jitter = self._uniform(gen, (n, 2), -1.0, 1.0)
            base_pos = torch.cat([base_pos[:, 0:2] + jitter, base_pos[:, 2:3]], dim=1)
        quat = self._identity_quat.expand(n, 4).contiguous()
        return PhysState(base_pos=base_pos, base_quat=quat, qj=qj,
                         u=torch.zeros(n, 6 + self.nj, device=self.device))

    def _sample_dof_rand(self, gen, n):
        """(motor_strengths, motor_offsets, kp_factors, kd_factors), each
        (n, nj): strength is one factor per env, the others per dof."""
        dr = self.cfg.domain_rand
        nj = self.nj

        def u(shape, rng, enabled, fill):
            if not enabled:
                return torch.full((n, nj), fill, device=self.device)
            return self._uniform(gen, shape, *rng).expand(n, nj)

        ms = u((n, 1), dr.motor_strength_range, dr.randomize_motor_strength, 1.0)
        mo = u((n, nj), dr.motor_offset_range, dr.randomize_motor_offset, 0.0)
        kpf = u((n, nj), dr.kp_factor_range, dr.randomize_kp_factor, 1.0)
        kdf = u((n, nj), dr.kd_factor_range, dr.randomize_kd_factor, 1.0)
        return ms.contiguous(), mo, kpf, kdf

    def _sample_body_rand(self, gen, n, masses):
        """One link-mass factor per env on the non-base bodies, a base COM
        offset, and 6 inertia factors per body applied symmetrically.
        Returns (masses, com (n, nb, 3), inertia (n, nb, 3, 3))."""
        dr = self.cfg.domain_rand
        m = self.model
        dev = self.device
        if dr.randomize_link_mass:
            f = self._uniform(gen, (n, 1), *dr.link_mass_range)
            masses = torch.cat([masses[:, 0:1], masses[:, 1:] * f], dim=1)
        com = torch.as_tensor(np.asarray(m.com), dtype=torch.float32, device=dev).repeat(n, 1, 1)
        if dr.randomize_base_com:
            off = torch.stack([self._uniform(gen, (n,), *dr.added_com_range_x),
                               self._uniform(gen, (n,), *dr.added_com_range_y),
                               self._uniform(gen, (n,), *dr.added_com_range_z)], dim=-1)
            com[:, 0] += off
        inertia = torch.as_tensor(np.asarray(m.inertia), dtype=torch.float32,
                                  device=dev).repeat(n, 1, 1, 1)
        if dr.randomize_inertia:
            f6 = self._uniform(gen, (n, m.nb, 6), *dr.inertia_range)
            fac = f6[..., (0, 1, 2, 1, 3, 4, 2, 4, 5)].reshape(n, m.nb, 3, 3)
            inertia = inertia * fac
        return masses, com, inertia

    def _contact_xy(self, body_pos, body_quat):
        """World xy (N, P, 2) of the contact points with a plane: sole
        corners, then termination sphere centres."""
        b = self._plane_bodies
        p = body_pos[:, b] + quat_rotate(body_quat[:, b], self._plane_offsets)
        return p[..., 0:2]

    def contact_planes(self, phys: PhysState):
        """(N, 3P) contact planes at the contact points of `phys` (one
        sampler call): the first step's planes."""
        body_pos, body_quat = fk(self._rt, phys.base_pos, phys.base_quat, phys.qj)
        return self._sample_terrain(phys, self._contact_xy(body_pos, body_quat))[1]

    def _scan_xy(self, phys: PhysState):
        """World xy (N, Ps, 2) of the height scan: the grid yaw-rotated
        about the base."""
        return (quat_apply_yaw(phys.base_quat[:, None, :], self.height_points[None])
                + phys.base_pos[:, None, :])[..., 0:2]

    def _sample_terrain(self, phys: PhysState, con_xy):
        """One sampler call at the envs' current positions: the height scan
        (N, Ps) under the yaw-rotated scan grid (None without a scan) and
        the contact planes (N, 3P) [c0, gx, gy] at con_xy (N, P, 2)."""
        N = phys.base_pos.shape[0]
        if self.height_points is not None:
            scan_xy = self._scan_xy(phys)
        else:
            scan_xy = phys.base_pos.new_zeros(N, 0, 2)
        scan_h, corners = self.sampler(scan_xy.contiguous(), con_xy.contiguous())
        h, gx, gy = self.terrain.interp_from_corners(*corners)
        c0 = h - gx * con_xy[..., 0] - gy * con_xy[..., 1]
        planes = torch.stack([c0, gx, gy], dim=-1).reshape(N, -1)
        return (scan_h if self.height_points is not None else None), planes

    def _curriculum(self, gen, state, phys, episode_sums, episode_length, commands, term,
                    time_out, reset_buf):
        """The terrain game curriculum for the envs that reset: new levels
        and their cell origins. Returns (terrain_levels, env_origins)."""
        tc = self.cfg.terrain
        levels = state.terrain_levels
        if tc.curriculum_mode == "tracking":
            # promote a clean timeout with good mean tracking under a walk
            # command, demote a fall with probability demote_prob
            q = episode_sums[:, self.track_idx] / (
                torch.clamp(episode_length, min=1).float() * self.reward_scales[self.track_idx])
            moving = torch.linalg.vector_norm(commands[:, 0:2], dim=1) > 0.1
            move_up = time_out & moving & (q >= tc.promote_quality)
            move_down = (term & ~time_out) & (
                torch.rand(levels.shape, generator=gen, device=self.device) < tc.demote_prob)
        else:
            dist = torch.linalg.vector_norm(phys.base_pos[:, 0:2] - state.env_origins[:, 0:2], dim=1)
            move_up = dist > self.terrain_world.terrain_length / 2
            required = (torch.linalg.vector_norm(commands[:, 0:2], dim=1)
                        * self.cfg.env.episode_length_s * 0.5)
            move_down = (dist < required) & ~move_up
        new = levels + move_up.int() - move_down.int()
        rand_lvl = torch.randint(0, self.max_terrain_level, levels.shape, generator=gen,
                                 device=self.device, dtype=levels.dtype)
        new = torch.where(new >= self.max_terrain_level, rand_lvl, torch.clamp(new, min=0))
        if tc.random_level_frac > 0.0:
            # exploration floor: a uniform random row for a fraction of resets
            explore = torch.rand(levels.shape, generator=gen,
                                 device=self.device) < tc.random_level_frac
            new = torch.where(explore, rand_lvl, new)
        levels = torch.where(reset_buf, new, levels)
        cells = self.terrain_origins.reshape(-1, 3)
        origins = cells[(levels * self.terrain_world.num_cols + state.terrain_types).long()]
        return levels, torch.where(reset_buf[:, None], origins, state.env_origins)

    def _kernel_step(self, state: EnvState, targets):
        """The control step through ControlStepKernel, with the per-env gains
        and bodies and the contact planes as its optional inputs."""
        gains = body = None
        if self.dof_rand_on:
            # motor offsets fold into the setpoint: kp (q* - q + off) = kp ((q* + off) - q)
            targets = targets + state.motor_offsets
            gains = torch.cat([self.kp * state.kp_factors, self.kd * state.kd_factors,
                               state.motor_strengths], dim=1)
        if self.body_rand_on:
            body = pack_body(state.body_com, state.body_inertia)
        cfg = self.cfg
        pack, diag = self.physics(
            pack_state(state.phys), state.masses, state.friction, targets.contiguous(),
            cfg.control.decimation, freeze=cfg.sim.freeze_mass_matrix,
            freeze_prep=cfg.sim.pgs_freeze_prep, gains=gains, body=body,
            planes=state.terrain_planes,
        )
        return unpack_state(pack, self.nj), diag

    def _engine_step(self, state: EnvState, targets):
        """The control step on the reference's XLA path: the engine, with the
        reference env's torque function of each substep's state."""
        lim = self.torque_limits
        if self.dof_rand_on:
            kp_eff = self.kp * state.kp_factors
            kd_eff = self.kd * state.kd_factors

            def torque_fn(s):
                tau = (kp_eff * (targets - s.qj + state.motor_offsets)
                       - kd_eff * s.u[:, 6:]) * state.motor_strengths
                return torch.clamp(tau, -lim, lim)
        else:
            def torque_fn(s):
                return torch.clamp(self.kp * (targets - s.qj) - self.kd * s.u[:, 6:], -lim, lim)

        params = EnvPhysParams(masses=state.masses, friction=state.friction,
                               com=state.body_com, inertia=state.body_inertia)
        s = self.cfg.sim
        args = (self._rt, params, self.terrain, self.contact_params)
        rest = (state.phys, torque_fn, self.cfg.control.decimation, s.dt)
        if self.pgs_params is not None:
            return control_step_pgs(*args, self.pgs_params, *rest,
                                    freeze_mass_matrix=s.freeze_mass_matrix, chol=self.cholesky)
        return control_step_batch(*args, *rest, freeze_mass_matrix=s.freeze_mass_matrix,
                                  chol=self.cholesky)

    # ------------------------------------------------------------------
    # lifecycle

    def initial_state(self, gen: torch.Generator) -> EnvState:
        """All envs in the post-reset configuration; step(zeros) once to get
        the first observation."""
        cfg = self.cfg
        N = cfg.env.num_envs
        dev = self.device
        dr = cfg.domain_rand
        if dr.randomize_friction:
            buckets = self._uniform(gen, (256,), *dr.friction_range)
            friction = buckets[torch.randint(0, 256, (N,), generator=gen, device=dev)]
        else:
            friction = torch.ones(N, device=dev)
        masses = torch.as_tensor(self.model.mass, dtype=torch.float32, device=dev).repeat(N, 1)
        if dr.randomize_base_mass:
            masses[:, 0] += self._uniform(gen, (N,), *dr.added_mass_range)
        commands = self._sample_commands(gen, N)
        nK, nKp = cfg.env.num_single_obs, cfg.env.single_num_privileged_obs

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, device=dev, dtype=dtype)

        if self.custom_origins:
            max_init = (cfg.terrain.max_init_terrain_level if cfg.terrain.curriculum
                        else self.max_terrain_level - 1)
            terrain_levels = torch.randint(0, max_init + 1, (N,), generator=gen, device=dev,
                                           dtype=torch.int32)
            terrain_types = (torch.arange(N, device=dev) * self.terrain_world.num_cols
                             // N).to(torch.int32)
            env_origins = self.terrain_origins[terrain_levels.long(), terrain_types.long()]
        else:
            terrain_levels = z(N, dtype=torch.int32)
            terrain_types = z(N, dtype=torch.int32)
            env_origins = self.env_origins
        extra = {}
        if self.body_rand_on or dr.randomize_link_mass:
            masses, com, inertia = self._sample_body_rand(gen, N, masses)
            if self.body_rand_on:
                extra.update(body_com=com, body_inertia=inertia)
        if self.dof_rand_on:
            ms, mo, kpf, kdf = self._sample_dof_rand(gen, N)
            extra.update(motor_strengths=ms, motor_offsets=mo, kp_factors=kpf, kd_factors=kdf)
        if dr.randomize_lag_timesteps:
            extra["lag_buffer"] = z(N, dr.lag_timesteps + 1, self.nj)
        if self.sw_switch:
            extra.update(
                time_to_stand_still=z(N), phase_length_buf=z(N, dtype=torch.int32),
                gait_start=torch.randint(0, 2, (N,), generator=gen, device=dev).float() * 0.5,
                gait_time=self._generate_gait_time(gen, N))
        if cfg.commands.curriculum:
            extra["cmd_x_range"] = torch.tensor(cfg.commands.ranges.lin_vel_x,
                                                dtype=torch.float32, device=dev)
        phys = self._reset_phys(gen, N, env_origins)
        if self.kernel_planes:
            extra["terrain_planes"] = self.contact_planes(phys)

        return EnvState(
            phys=phys, masses=masses, friction=friction,
            episode_length=z(N, dtype=torch.int32), common_step=z(dtype=torch.int64),
            commands=commands, actions=z(N, self.nj), last_actions=z(N, self.nj),
            last_last_actions=z(N, self.nj), last_dof_vel=z(N, self.nj),
            last_root_vel=z(N, 6), feet_air_time=z(N, 2),
            last_contacts=z(N, 2, dtype=torch.bool), last_feet_z=z(N, 2),
            feet_height=z(N, 2), push_force=z(N, 2), push_torque=z(N, 3),
            obs_hist=z(N, cfg.env.frame_stack, nK), critic_hist=z(N, cfg.env.c_frame_stack, nKp),
            episode_sums=z(N, self.n_rew), env_origins=env_origins,
            terrain_levels=terrain_levels, terrain_types=terrain_types,
            course_gain=torch.ones((), device=dev), **extra,
        )

    # ------------------------------------------------------------------

    @torch.no_grad()
    def step(self, state: EnvState, actions: torch.Tensor,
             gen: torch.Generator) -> Tuple[EnvState, StepOutput]:
        cfg = self.cfg
        N = cfg.env.num_envs
        dev = self.device
        dr = cfg.domain_rand

        # ---- 1. action processing ----
        if cfg.env.use_ref_actions:
            actions = actions + 2.0 * self._ref_dof_pos(state.episode_length)
        if dr.action_delay:
            delay = torch.rand((N, 1), generator=gen, device=dev)
            actions = (1 - delay) * actions + delay * state.actions
        if dr.dynamic_randomization > 0:
            actions = actions + dr.dynamic_randomization * torch.randn(
                actions.shape, generator=gen, device=dev) * actions
        clip_a = cfg.normalization.clip_actions
        actions = torch.clamp(actions, -clip_a, clip_a)

        # ---- 2. action lag, decimated PD + physics ----
        actions_scaled = actions * self.action_scale
        lag_buffer = state.lag_buffer
        if dr.randomize_lag_timesteps:
            # the PD target is a random element of the lag ring, one index
            # for all envs in a control step
            idx = torch.randint(0, dr.lag_timesteps + 1, (1,), generator=gen, device=dev)
            lag_buffer, lagged = lag_push(lag_buffer, actions_scaled, idx)
            targets = lagged + self.default_dof_pos
        else:
            targets = actions_scaled + self.default_dof_pos
        if self.use_kernel:
            phys, diag = self._kernel_step(state, targets)
        else:
            phys, diag = self._engine_step(state, targets)

        # ---- 3. counters + base quantities ----
        episode_length = state.episode_length + 1
        common_step = state.common_step + 1
        base_quat = phys.base_quat
        base_lin_vel = quat_rotate_inverse(base_quat, phys.u[:, 3:6])
        base_ang_vel = quat_rotate_inverse(base_quat, phys.u[:, 0:3])
        projected_gravity = quat_rotate_inverse(base_quat, self._down.expand(N, 3))
        base_euler = quat_to_euler_xyz(base_quat)

        # ---- resample commands / heading / push ----
        contact = diag.foot_forces[:, :, 2] > 5.0
        commands = state.commands
        ttss, plb = state.time_to_stand_still, state.phase_length_buf
        if self.sw_switch:
            # the stand/walk switch: the stand timer counts steps of a stand
            # command at low speed and restarts under a walk command (the
            # deploy-side form the reference adopts, not the base class's,
            # which makes standing absorbing once the phase freezes); each
            # gait of the schedule switches its command in at its step
            ccfg = cfg.commands
            stand_cmd = torch.linalg.vector_norm(commands[:, 0:3], dim=1) <= ccfg.stand_com_threshold
            low_speed = (torch.linalg.vector_norm(base_lin_vel[:, 0:2], dim=1) < 0.3).float()
            ttss = torch.where(stand_cmd, (ttss + 1.0) * low_speed, 0.0)
            double = (contact.float().sum(dim=1) == 2).float()
            for i, gait in enumerate(ccfg.gait):
                switch = episode_length == state.gait_time[:, i]
                fresh = self._sample_gait_command(gen, N, gait, state.cmd_x_range)
                commands = torch.where(switch[:, None], fresh, commands)
                # a zero command with both feet down and low speed stands at once
                still = (torch.linalg.vector_norm(commands[:, 0:3], dim=1) == 0.0).float()
                ttss = torch.where(switch, ccfg.static_delay * double * still * low_speed, ttss)
            # the phase counter freezes (restarts) while standing
            plb = torch.where(ttss > ccfg.static_delay, 0, plb + 1)
        else:
            resample = (episode_length % self.resample_steps) == 0
            commands = torch.where(resample[:, None],
                                   self._sample_commands(gen, N, state.cmd_x_range), commands)
        if cfg.commands.heading_command:
            fwd = quat_rotate(base_quat, self._forward.expand(N, 3))
            heading = torch.atan2(fwd[:, 1], fwd[:, 0])
            yaw_cmd = torch.clamp(0.5 * wrap_to_pi(commands[:, 3] - heading), -1.0, 1.0)
            commands = torch.cat([commands[:, 0:2], yaw_cmd[:, None], commands[:, 3:4]], dim=1)

        push_force, push_torque = state.push_force, state.push_torque
        if dr.push_robots:
            push_now = (common_step % self.push_interval) == 0
            new_pf = self._uniform(gen, (N, 2), -dr.max_push_vel_xy, dr.max_push_vel_xy)
            new_pt = self._uniform(gen, (N, 3), -dr.max_push_ang_vel, dr.max_push_ang_vel)
            push_force = torch.where(push_now, new_pf, push_force)
            push_torque = torch.where(push_now, new_pt, push_torque)
            # the push sets root velocities after the obs quantities were taken
            u = phys.u.clone()
            u[:, 3:5] = torch.where(push_now, new_pf, u[:, 3:5])
            u[:, 0:3] = torch.where(push_now, new_pt, u[:, 0:3])
            phys = phys._replace(u=u)

        # ---- 4. termination, with the non-finite / absurd-state guard ----
        term = torch.any(diag.term_force > cfg.asset.termination_force, dim=1)
        finite = (torch.isfinite(phys.base_pos).all(1) & torch.isfinite(phys.base_quat).all(1)
                  & torch.isfinite(phys.qj).all(1) & torch.isfinite(phys.u).all(1))
        bad = ~finite | (torch.amax(torch.abs(phys.u), dim=1) > 1e4) \
            | (torch.amax(torch.abs(phys.qj), dim=1) > 1e3)
        term = term | bad
        time_out = episode_length > self.max_episode_length
        reset_buf = term | time_out

        # ---- 5. rewards (pre-reset state) ----
        m = self.model
        foot_pos = diag.body_pos[:, list(m.foot_bodies)]
        # the phase counter after the switch drives the stance target; the
        # reference pose is the previous step's (the reference's one-step lag)
        gs = state.gait_start
        stance_mask, _ = self._gait_masks(plb if self.sw_switch else episode_length, gs)
        (air_time, first_contact, fh), (new_air, new_last_contacts, new_last_feet_z,
                                        new_feet_height) = gait_updates(
            contact, stance_mask, state.last_contacts, state.feet_air_time,
            foot_pos[:, :, 2], state.last_feet_z, state.feet_height, self.dt)
        root_vel = torch.cat([phys.u[:, 3:6], phys.u[:, 0:3]], dim=1)
        ctx = RewardContext(
            dof_pos=phys.qj, dof_vel=phys.u[:, 6:], last_dof_vel=state.last_dof_vel,
            actions=actions, last_actions=state.last_actions,
            last_last_actions=state.last_last_actions, torques=diag.tau,
            ref_dof_pos=self._ref_dof_pos(
                state.phase_length_buf if self.sw_switch else state.episode_length, gs),
            default_dof_pos=self.default_dof_pos, base_pos=phys.base_pos,
            base_lin_vel=base_lin_vel, base_ang_vel=base_ang_vel, base_euler=base_euler,
            projected_gravity=projected_gravity, root_vel=root_vel,
            last_root_vel=state.last_root_vel, commands=commands, foot_pos=foot_pos,
            knee_pos=diag.body_pos[:, list(m.knee_bodies)],
            foot_ang_vel=diag.body_omega[:, list(m.foot_bodies)],
            foot_forces=diag.foot_forces, term_force=diag.term_force, contact=contact,
            stance_mask=stance_mask, feet_air_time=air_time, first_contact=first_contact,
            feet_height=fh, dt=self.dt, cfg=cfg.rewards,
        )
        rew_terms = torch.stack([fn(ctx) for fn in self.reward_fns], dim=1) * self.reward_scales
        if self.smooth_idx is not None and cfg.rewards.course_ratio != 1.0:
            gain = torch.ones(self.n_rew, device=dev)
            gain[self.smooth_idx] = state.course_gain
            rew_terms = rew_terms * gain
        # blown-up envs: zero the whole row so no NaN reaches the batch
        rew_terms = torch.where(bad[:, None], 0.0, rew_terms)
        rew = torch.sum(rew_terms, dim=1)
        if cfg.rewards.only_positive_rewards:
            rew = torch.clamp(rew, min=0.0)
        episode_sums = state.episode_sums + rew_terms

        # ---- 6. terrain curriculum and masked auto-reset ----
        r = reset_buf[:, None]
        env_origins, terrain_levels = state.env_origins, state.terrain_levels
        if self.custom_origins and cfg.terrain.curriculum:
            terrain_levels, env_origins = self._curriculum(
                gen, state, phys, episode_sums, episode_length, commands, term, time_out,
                reset_buf)
        fresh = self._reset_phys(gen, N, env_origins)
        phys = PhysState(*(torch.where(r, f, p) for f, p in zip(fresh, phys)))
        commands = torch.where(r, self._sample_commands(gen, N), commands)
        actions = torch.where(r, 0.0, actions)
        new_air = torch.where(r, 0.0, new_air)
        new_last_contacts = new_last_contacts & ~r
        new_last_feet_z = torch.where(r, 0.0, new_last_feet_z)
        new_feet_height = torch.where(r, 0.0, new_feet_height)
        episode_length_out = torch.where(reset_buf, 0, episode_length).to(torch.int32)
        if dr.randomize_lag_timesteps:
            lag_buffer = torch.where(reset_buf[:, None, None], 0.0, lag_buffer)
        gait_time = state.gait_time
        if self.sw_switch:
            ttss = torch.where(reset_buf, 0.0, ttss)
            plb = torch.where(reset_buf, 0, plb)
            gs = torch.where(reset_buf, torch.randint(0, 2, (N,), generator=gen,
                                                      device=dev).float() * 0.5, gs)
            gait_time = torch.where(reset_buf[:, None], self._generate_gait_time(gen, N),
                                    gait_time)
        dof_rand = {}
        if self.dof_rand_on:
            # redrawn at reset and on the dof_rand_interval grid
            redraw = (((episode_length % self.dof_rand_interval) == 0) | reset_buf)[:, None]
            names = ("motor_strengths", "motor_offsets", "kp_factors", "kd_factors")
            for name, new in zip(names, self._sample_dof_rand(gen, N)):
                dof_rand[name] = torch.where(redraw, new, getattr(state, name))

        rmask = reset_buf.float()
        ep_rew_sums = torch.sum(episode_sums * rmask[:, None], dim=0)
        ep_count = torch.sum(rmask)
        ep_len_sum = torch.sum(episode_length * reset_buf)
        cmd_x_range = state.cmd_x_range
        if cfg.commands.curriculum and self.track_idx is not None:
            # every max_episode_length common steps, widen lin_vel_x by 0.5
            # m/s each way if the episodes finishing now tracked velocity
            # above 80% of the possible reward
            T = self.max_episode_length
            track = self.reward_scales[self.track_idx]
            mean_track = torch.sum(episode_sums[:, self.track_idx] * rmask) / torch.clamp(
                ep_count, min=1.0)
            widen = ((common_step % T) == 0) & (mean_track / T > 0.8 * track) & (ep_count > 0)
            mc = cfg.commands.max_curriculum
            wider = torch.stack([torch.clamp(cmd_x_range[0] - 0.5, -mc, 0.0),
                                 torch.clamp(cmd_x_range[1] + 0.5, 0.0, mc)])
            cmd_x_range = torch.where(widen, wider, cmd_x_range)
        episode_sums = torch.where(r, 0.0, episode_sums)

        # ---- 7. observations ----
        base_lin_vel_o = torch.where(r, 0.0, base_lin_vel)
        base_ang_vel_o = torch.where(r, 0.0, base_ang_vel)
        base_euler_o = torch.where(r, 0.0, base_euler)
        counter_out = plb if self.sw_switch else episode_length_out
        stance_mask_o, _ = self._gait_masks(counter_out, gs)
        phase = self._phase(counter_out, gs)
        sincos = torch.stack([torch.sin(2 * math.pi * phase), torch.cos(2 * math.pi * phase)], dim=1)
        command_input = torch.cat([sincos, commands[:, 0:3] * self.commands_scale], dim=1)
        os_ = cfg.normalization.obs_scales
        q = (phys.qj - self.default_dof_pos) * os_.dof_pos
        dq = phys.u[:, 6:] * os_.dof_vel
        diff = phys.qj - self._ref_dof_pos(counter_out, gs)
        single_priv = torch.cat([
            command_input, q, dq, actions, diff,
            base_lin_vel_o * os_.lin_vel, base_ang_vel_o * os_.ang_vel, base_euler_o * os_.quat,
            push_force, push_torque, state.friction[:, None], state.masses[:, 0:1] / 30.0,
            stance_mask_o, contact.float(),
        ], dim=1)
        terrain_planes = state.terrain_planes
        mh = None
        if self.kernel_planes:
            # one sampler call at the exit (post-reset) positions: the height
            # scan, and the next step's contact planes under the points the
            # kernel's last substep reported; just-reset envs use the
            # default-stance offsets at their fresh base
            con_xy = self._contact_xy(diag.body_pos, diag.body_quat)
            fresh_xy = phys.base_pos[:, None, 0:2] + self._default_contact_xy
            con_xy = torch.where(r[:, :, None], fresh_xy, con_xy)
            mh, terrain_planes = self._sample_terrain(phys, con_xy)
        elif self.sampler is not None and self.height_points is not None:
            # the engine samples the heightfield itself: the height scan only
            mh, _ = self._sample_terrain(phys, phys.base_pos.new_zeros(N, 0, 2))
        elif self.height_points is not None:
            mh = self.terrain.sample_min3(self._scan_xy(phys))   # the plane's heights
        if mh is not None:
            heights = torch.clamp(phys.base_pos[:, 2:3] - 0.5 - mh, -1.0, 1.0)
            single_priv = torch.cat([single_priv, heights * os_.height_measurements], dim=1)
        single_obs = torch.cat([
            command_input, q, dq, actions, base_ang_vel_o * os_.ang_vel, base_euler_o * os_.quat,
        ], dim=1)
        if cfg.noise.add_noise:
            single_obs = single_obs + torch.randn(
                single_obs.shape, generator=gen, device=dev) * self.noise_vec * cfg.noise.noise_level

        zero3 = reset_buf[:, None, None]
        obs_hist = torch.cat([torch.where(zero3, 0.0, state.obs_hist)[:, 1:],
                              single_obs[:, None]], dim=1)
        critic_hist = torch.cat([torch.where(zero3, 0.0, state.critic_hist)[:, 1:],
                                 single_priv[:, None]], dim=1)
        clip_obs = cfg.normalization.clip_observations
        obs = torch.clamp(obs_hist.reshape(N, -1), -clip_obs, clip_obs)
        priv_obs = torch.clamp(critic_hist.reshape(N, -1), -clip_obs, clip_obs)

        # ---- 8. last_* updates ----
        new_state = EnvState(
            phys=phys, masses=state.masses, friction=state.friction,
            episode_length=episode_length_out, common_step=common_step, commands=commands,
            actions=actions, last_actions=torch.where(r, 0.0, actions),
            last_last_actions=torch.where(r, 0.0, state.last_actions),
            last_dof_vel=torch.where(r, 0.0, phys.u[:, 6:]),
            last_root_vel=torch.cat([phys.u[:, 3:6], phys.u[:, 0:3]], dim=1),
            feet_air_time=new_air, last_contacts=new_last_contacts,
            last_feet_z=new_last_feet_z, feet_height=new_feet_height,
            push_force=push_force, push_torque=push_torque, obs_hist=obs_hist,
            critic_hist=critic_hist, episode_sums=episode_sums, env_origins=env_origins,
            terrain_levels=terrain_levels, terrain_types=state.terrain_types,
            course_gain=state.course_gain, body_com=state.body_com,
            body_inertia=state.body_inertia, lag_buffer=lag_buffer,
            time_to_stand_still=ttss, phase_length_buf=plb, gait_start=gs, gait_time=gait_time,
            cmd_x_range=cmd_x_range, terrain_planes=terrain_planes, **dof_rand,
        )
        out = StepOutput(
            obs=obs, privileged_obs=priv_obs, rew=rew, reset=reset_buf, time_outs=time_out,
            ep_rew_sums=ep_rew_sums, ep_count=ep_count, ep_len_sum=ep_len_sum,
            ep_term_count=torch.sum((term & ~time_out).float()),
            rew_terms_mean=torch.mean(rew_terms, dim=0),
        )
        return new_state, out
