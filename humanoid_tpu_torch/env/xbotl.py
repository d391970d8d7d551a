"""XBot-L walking task on batched torch tensors: port of the reference
package's env/xbotl.py on the flat-ground PGS path without gain or body
randomization (the shipping `humanoid_ppo` task).

One `step` over an explicit EnvState, batched over envs, with the masked
auto-reset inside it. The physics goes through ControlStepKernel: the CUDA
kernel for state on the card, its plain PyTorch version for state on the
CPU. Randomness comes from an explicit torch.Generator on the env's device.

Step pipeline (ordering of the reference): action delay-mix + noise + clip
-> decimated PD/physics -> episode counters -> base quantities ->
[resample commands, heading, push] -> termination -> rewards -> masked
reset -> observations -> history and last_* updates -> obs clip.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..assets import load_robot
from ..config.structs import XBotLCfg
from ..ops.physics_kernel import ControlStepKernel, pack_state, unpack_state
from ..physics.contact import ContactParams
from ..physics.engine import PhysState
from ..physics.pgs import PGSParams
from ..physics.spatial import quat_rotate, quat_rotate_inverse, quat_to_euler_xyz, wrap_to_pi
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
    course_gain: torch.Tensor        # () reward curriculum gain


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


def _unported(cfg: XBotLCfg):
    """Config features of the reference env that this slice does not port."""
    dr, c = cfg.domain_rand, cfg.commands
    checks = {
        "terrain.mesh_type != 'plane'": cfg.terrain.mesh_type != "plane",
        "terrain.measure_heights": cfg.terrain.measure_heights,
        "sim.contact_model != 'pgs'": cfg.sim.contact_model != "pgs",
        "sim.pgs_warm_start": cfg.sim.pgs_warm_start,
        "gain randomization": (dr.randomize_motor_strength or dr.randomize_motor_offset
                               or dr.randomize_kp_factor or dr.randomize_kd_factor),
        "body randomization": (dr.randomize_base_com or dr.randomize_inertia
                               or dr.randomize_link_mass),
        "domain_rand.randomize_lag_timesteps": dr.randomize_lag_timesteps,
        "commands.sw_switch": c.sw_switch,
        "commands.curriculum": c.curriculum,
        "commands.axis_frac": c.axis_frac > 0.0,
    }
    return [name for name, on in checks.items() if on]


class XBotLEnv:
    """Static task object: the compiled model, config-derived constant
    tensors on one device, the reward table and the control-step kernel."""

    def __init__(self, cfg: XBotLCfg, urdf_path: str, device="cuda"):
        missing = _unported(cfg)
        if missing:
            raise NotImplementedError(f"not ported yet: {', '.join(missing)}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = load_robot(urdf_path, cfg.asset, cfg.sim.armature)
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
        self.physics = ControlStepKernel(
            m, kp, kd, torque_limits,
            ContactParams(kn=s.contact_kn, cn=s.contact_cn, v_reg=s.contact_v_reg),
            PGSParams(iterations=s.pgs_iterations, erp=s.pgs_erp, cfm_ratio=s.pgs_cfm,
                      slop=s.pgs_slop),
            s.dt,
        )
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
        self.env_origins = t(origins)
        self.resample_steps = int(cfg.commands.resampling_time / self.dt)
        self.push_interval = int(np.ceil(cfg.domain_rand.push_interval_s / self.dt))
        self.max_episode_length = cfg.max_episode_length
        self.smooth_idx = (self.reward_names.index("action_smoothness")
                           if "action_smoothness" in self.reward_names else None)
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

    def _phase(self, episode_length):
        return episode_length.float() * self.dt / self.cfg.rewards.cycle_time

    def _gait_masks(self, episode_length):
        """(stance_mask (N,2), sin_pos (N,))."""
        sin_pos = torch.sin(2 * math.pi * self._phase(episode_length))
        left = sin_pos >= 0
        stance = torch.stack([left, ~left], dim=-1).float()
        double = (torch.abs(sin_pos) < 0.1)[:, None]
        return torch.where(double, 1.0, stance), sin_pos

    def _ref_dof_pos(self, episode_length):
        _, sin_pos = self._gait_masks(episode_length)
        ref = (torch.clamp(sin_pos, max=0.0)[:, None] * self._ref_l
               + torch.clamp(sin_pos, min=0.0)[:, None] * self._ref_r)
        double = (torch.abs(sin_pos) < 0.1)[:, None]
        return torch.where(double, 0.0, ref)

    def _uniform(self, gen, shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=self.device)

    def _sample_commands(self, gen, n):
        cfg = self.cfg.commands
        r = cfg.ranges
        vx = self._uniform(gen, (n,), *r.lin_vel_x)
        vy = self._uniform(gen, (n,), *r.lin_vel_y)
        if cfg.heading_command:
            heading = self._uniform(gen, (n,), *r.heading)
            wyaw = torch.zeros(n, device=self.device)
        else:
            heading = torch.zeros(n, device=self.device)
            wyaw = self._uniform(gen, (n,), *r.ang_vel_yaw)
        cmds = torch.stack([vx, vy, wyaw, heading], dim=-1)
        keep = (torch.linalg.vector_norm(cmds[:, 0:2], dim=1) > 0.2).float()
        return torch.cat([cmds[:, 0:2] * keep[:, None], cmds[:, 2:]], dim=1)

    def _reset_phys(self, gen, n):
        rand = self.cfg.init_state.reset_dof_rand
        qj = self.default_dof_pos + self._uniform(gen, (n, self.nj), -rand, rand)
        base_pos = self._init_pos + self.env_origins[:n]
        quat = self._identity_quat.expand(n, 4).contiguous()
        return PhysState(base_pos=base_pos, base_quat=quat, qj=qj,
                         u=torch.zeros(n, 6 + self.nj, device=self.device))

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

        return EnvState(
            phys=self._reset_phys(gen, N), masses=masses, friction=friction,
            episode_length=z(N, dtype=torch.int32), common_step=z(dtype=torch.int64),
            commands=commands, actions=z(N, self.nj), last_actions=z(N, self.nj),
            last_last_actions=z(N, self.nj), last_dof_vel=z(N, self.nj),
            last_root_vel=z(N, 6), feet_air_time=z(N, 2),
            last_contacts=z(N, 2, dtype=torch.bool), last_feet_z=z(N, 2),
            feet_height=z(N, 2), push_force=z(N, 2), push_torque=z(N, 3),
            obs_hist=z(N, cfg.env.frame_stack, nK), critic_hist=z(N, cfg.env.c_frame_stack, nKp),
            episode_sums=z(N, self.n_rew), course_gain=torch.ones((), device=dev),
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

        # ---- 2. decimated PD + physics ----
        targets = (actions * self.action_scale + self.default_dof_pos).contiguous()
        pack, diag = self.physics(
            pack_state(state.phys), state.masses, state.friction, targets,
            cfg.control.decimation, freeze=cfg.sim.freeze_mass_matrix,
            freeze_prep=cfg.sim.pgs_freeze_prep,
        )
        phys = unpack_state(pack, self.nj)

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
        resample = (episode_length % self.resample_steps) == 0
        commands = torch.where(resample[:, None], self._sample_commands(gen, N), state.commands)
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
        stance_mask, _ = self._gait_masks(episode_length)
        (air_time, first_contact, fh), (new_air, new_last_contacts, new_last_feet_z,
                                        new_feet_height) = gait_updates(
            contact, stance_mask, state.last_contacts, state.feet_air_time,
            foot_pos[:, :, 2], state.last_feet_z, state.feet_height, self.dt)
        root_vel = torch.cat([phys.u[:, 3:6], phys.u[:, 0:3]], dim=1)
        ctx = RewardContext(
            dof_pos=phys.qj, dof_vel=phys.u[:, 6:], last_dof_vel=state.last_dof_vel,
            actions=actions, last_actions=state.last_actions,
            last_last_actions=state.last_last_actions, torques=diag.tau,
            ref_dof_pos=self._ref_dof_pos(state.episode_length),
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

        # ---- 6. masked auto-reset ----
        r = reset_buf[:, None]
        fresh = self._reset_phys(gen, N)
        phys = PhysState(*(torch.where(r, f, p) for f, p in zip(fresh, phys)))
        commands = torch.where(r, self._sample_commands(gen, N), commands)
        actions = torch.where(r, 0.0, actions)
        new_air = torch.where(r, 0.0, new_air)
        new_last_contacts = new_last_contacts & ~r
        new_last_feet_z = torch.where(r, 0.0, new_last_feet_z)
        new_feet_height = torch.where(r, 0.0, new_feet_height)
        episode_length_out = torch.where(reset_buf, 0, episode_length).to(torch.int32)

        rmask = reset_buf.float()
        ep_rew_sums = torch.sum(episode_sums * rmask[:, None], dim=0)
        ep_count = torch.sum(rmask)
        ep_len_sum = torch.sum(episode_length * reset_buf)
        episode_sums = torch.where(r, 0.0, episode_sums)

        # ---- 7. observations ----
        base_lin_vel_o = torch.where(r, 0.0, base_lin_vel)
        base_ang_vel_o = torch.where(r, 0.0, base_ang_vel)
        base_euler_o = torch.where(r, 0.0, base_euler)
        stance_mask_o, _ = self._gait_masks(episode_length_out)
        phase = self._phase(episode_length_out)
        sincos = torch.stack([torch.sin(2 * math.pi * phase), torch.cos(2 * math.pi * phase)], dim=1)
        command_input = torch.cat([sincos, commands[:, 0:3] * self.commands_scale], dim=1)
        os_ = cfg.normalization.obs_scales
        q = (phys.qj - self.default_dof_pos) * os_.dof_pos
        dq = phys.u[:, 6:] * os_.dof_vel
        diff = phys.qj - self._ref_dof_pos(episode_length_out)
        single_priv = torch.cat([
            command_input, q, dq, actions, diff,
            base_lin_vel_o * os_.lin_vel, base_ang_vel_o * os_.ang_vel, base_euler_o * os_.quat,
            push_force, push_torque, state.friction[:, None], state.masses[:, 0:1] / 30.0,
            stance_mask_o, contact.float(),
        ], dim=1)
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
            critic_hist=critic_hist, episode_sums=episode_sums, course_gain=state.course_gain,
        )
        out = StepOutput(
            obs=obs, privileged_obs=priv_obs, rew=rew, reset=reset_buf, time_outs=time_out,
            ep_rew_sums=ep_rew_sums, ep_count=ep_count, ep_len_sum=ep_len_sum,
            ep_term_count=torch.sum((term & ~time_out).float()),
            rew_terms_mean=torch.mean(rew_terms, dim=0),
        )
        return new_state, out
