"""Config dataclasses of the port, copied from the reference package's
config/structs.py so that the port imports nothing of it: frozen, hashable
dataclasses whose fields are scalars, strings or tuples. Defaults are the
reference's; only the 18-dof `d11_cfg` factory is left out (the 18-dof
task is not ported yet).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


def _t(*xs) -> Tuple[float, ...]:
    return tuple(float(x) for x in xs)


@dataclass(frozen=True)
class EnvCfg:
    """humanoid_config.py:42-64 (canonical 12-dof values)."""
    num_envs: int = 4096
    num_actions: int = 12
    frame_stack: int = 15
    c_frame_stack: int = 3
    num_single_obs: int = 47
    single_num_privileged_obs: int = 73
    episode_length_s: float = 24.0
    use_ref_actions: bool = False
    send_timeouts: bool = True

    @property
    def num_observations(self) -> int:
        return self.frame_stack * self.num_single_obs

    @property
    def num_privileged_obs(self) -> int:
        return self.c_frame_stack * self.single_num_privileged_obs


@dataclass(frozen=True)
class SafetyCfg:
    """humanoid_config.py:70-77."""
    pos_limit: float = 1.0
    vel_limit: float = 1.0
    torque_limit: float = 0.85


@dataclass(frozen=True)
class InitStateCfg:
    """humanoid_config.py:190-218 (12-dof: upstream zero defaults)."""
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.95)
    default_joint_angles: Tuple[float, ...] = _t(*([0.0] * 12))
    reset_dof_rand: float = 0.1   # U(-0.1, 0.1) added at reset


@dataclass(frozen=True)
class ControlCfg:
    """humanoid_config.py:221-271; 12-dof gains from the reference's own
    XBot sim2sim block (scripts/sim2sim.py:307-309): kp [200,200,350,350,
    15,15] per leg, kd 10."""
    stiffness: Tuple[float, ...] = _t(200, 200, 350, 350, 15, 15,
                                      200, 200, 350, 350, 15, 15)
    damping: Tuple[float, ...] = _t(*([10.0] * 12))
    action_scale: object = 0.25
    decimation: int = 10


@dataclass(frozen=True)
class SimCfg:
    """humanoid_config.py:273-315 + contact model constants (ours)."""
    dt: float = 0.001
    gravity: float = -9.81
    armature: float = 0.01
    contact_kn: float = 2.0e4
    contact_cn: float = 80.0
    contact_v_reg: float = 0.05
    freeze_mass_matrix: bool = True
    use_pallas_substep: bool = True   # kept for config parity; unused
    contact_model: str = "penalty"
    pgs_iterations: int = 8
    pgs_erp: float = 0.024
    pgs_cfm: float = 0.01
    pgs_slop: float = 0.0
    pgs_freeze_prep: bool = False
    pgs_warm_start: bool = False


@dataclass(frozen=True)
class DomainRandCfg:
    """humanoid_config.py:317-339."""
    randomize_friction: bool = True
    friction_range: Tuple[float, float] = (0.1, 2.0)
    randomize_base_mass: bool = True
    added_mass_range: Tuple[float, float] = (-5.0, 5.0)
    push_robots: bool = True
    push_interval_s: float = 4.0
    max_push_vel_xy: float = 0.2
    max_push_ang_vel: float = 0.4
    dynamic_randomization: float = 0.02
    action_delay: bool = True     # the per-step random delay mixing (step)
    randomize_link_mass: bool = False
    link_mass_range: Tuple[float, float] = (0.9, 1.1)
    randomize_base_com: bool = False
    added_com_range_x: Tuple[float, float] = (-0.07, 0.03)
    added_com_range_y: Tuple[float, float] = (-0.03, 0.03)
    added_com_range_z: Tuple[float, float] = (-0.03, 0.03)
    randomize_inertia: bool = False
    inertia_range: Tuple[float, float] = (0.8, 1.2)
    randomize_motor_strength: bool = False
    motor_strength_range: Tuple[float, float] = (0.8, 1.2)
    randomize_motor_offset: bool = False
    motor_offset_range: Tuple[float, float] = (-0.035, 0.035)
    randomize_kp_factor: bool = False
    kp_factor_range: Tuple[float, float] = (0.8, 1.2)
    randomize_kd_factor: bool = False
    kd_factor_range: Tuple[float, float] = (0.8, 1.2)
    randomize_lag_timesteps: bool = False
    lag_timesteps: int = 6
    dof_rand_interval_s: float = 4.0


@dataclass(frozen=True)
class CommandRangesCfg:
    lin_vel_x: Tuple[float, float] = (-0.3, 0.6)
    lin_vel_y: Tuple[float, float] = (-0.3, 0.3)
    ang_vel_yaw: Tuple[float, float] = (-0.3, 0.3)
    heading: Tuple[float, float] = (-3.14, 3.14)


@dataclass(frozen=True)
class CommandsCfg:
    """humanoid_config.py:341-370."""
    curriculum: bool = False
    max_curriculum: float = 1.0
    num_commands: int = 4
    resampling_time: float = 8.0
    heading_command: bool = True
    ranges: CommandRangesCfg = CommandRangesCfg()
    sw_switch: bool = False
    stand_com_threshold: float = 0.05
    axis_frac: float = 0.0
    static_delay: int = 5          # steps of zero-command before phase freeze
    gait: Tuple[str, ...] = ("walk_omnidirectional",)


@dataclass(frozen=True)
class RewardScalesCfg:
    """humanoid_config.py:395-425 — zero scale prunes the term."""
    joint_pos: float = 1.6
    feet_clearance: float = 1.0
    feet_contact_number: float = 1.2
    feet_air_time: float = 1.0
    foot_slip: float = -0.05
    feet_distance: float = 0.2
    knee_distance: float = 0.2
    feet_contact_forces: float = -0.01
    tracking_lin_vel: float = 1.2
    tracking_ang_vel: float = 1.1
    vel_mismatch_exp: float = 0.5
    low_speed: float = 0.2
    track_vel_hard: float = 0.5
    default_joint_pos: float = 0.5
    orientation: float = 1.0
    base_height: float = 0.2
    base_acc: float = 0.2
    action_smoothness: float = -0.002
    torques: float = -1e-5
    dof_vel: float = -5e-4
    dof_acc: float = -1e-7
    collision: float = -1.0
    termination: float = -0.0
    feet_stumble: float = -0.0
    action_rate: float = -0.0
    stand_still: float = -0.0

    def active(self) -> Tuple[Tuple[str, float], ...]:
        return tuple(
            (f.name, getattr(self, f.name))
            for f in dataclasses.fields(self)
            if getattr(self, f.name) != 0.0
        )


@dataclass(frozen=True)
class RewardsCfg:
    """humanoid_config.py:372-430 (12-dof canonical values)."""
    base_height_target: float = 0.89
    min_dist: float = 0.2
    max_dist: float = 0.5
    target_joint_pos_scale: float = 0.17
    target_feet_height: float = 0.06
    cycle_time: float = 0.64
    ref_leg_idx_left: Tuple[int, int, int] = (2, 3, 4)
    ref_leg_idx_right: Tuple[int, int, int] = (8, 9, 10)
    only_positive_rewards: bool = True
    tracking_sigma: float = 5.0
    max_contact_force: float = 700.0
    low_speed_lo: float = 0.5
    low_speed_hi: float = 1.2
    low_speed_directional: bool = False
    low_speed_overspeed_r: float = 0.0
    course_ratio: float = 1.0
    scales: RewardScalesCfg = RewardScalesCfg()


@dataclass(frozen=True)
class ObsScalesCfg:
    lin_vel: float = 2.0
    ang_vel: float = 1.0
    dof_pos: float = 1.0
    dof_vel: float = 0.05
    quat: float = 1.0
    height_measurements: float = 5.0


@dataclass(frozen=True)
class NormalizationCfg:
    """humanoid_config.py:432-459."""
    obs_scales: ObsScalesCfg = ObsScalesCfg()
    clip_observations: float = 18.0
    clip_actions: float = 18.0


@dataclass(frozen=True)
class NoiseScalesCfg:
    dof_pos: float = 0.05
    dof_vel: float = 0.5
    ang_vel: float = 0.1
    lin_vel: float = 0.05
    quat: float = 0.03
    height_measurements: float = 0.1
    gravity: float = 0.05


@dataclass(frozen=True)
class NoiseCfg:
    """humanoid_config.py:155-182."""
    add_noise: bool = True
    noise_level: float = 0.6
    noise_scales: NoiseScalesCfg = NoiseScalesCfg()


@dataclass(frozen=True)
class TerrainCfg:
    """legged_robot_config.py terrain + HumanoidTerrain (terrain.py:189-231).

    mesh_type "trimesh" = heightfield sampling with the reference's
    slope-threshold vertical-face semantics (terrain_utils.
    convert_heightfield_to_trimesh, terrain.py:69-73): cell edges steeper
    than `slope_treshold` become near-vertical walls and contact forces act
    along the local surface normal, so stair risers block feet instead of
    behaving as 45-degree ramps. "heightfield" = raw bilinear sampling
    (isaacgym's heightfield mode has no vertical-face correction either).
    """
    mesh_type: str = "plane"        # plane | heightfield | trimesh
    generator_set: str = "humanoid"
    selected_type: str = ""
    horizontal_scale: float = 0.1
    vertical_scale: float = 0.005
    border_size: float = 25.0
    curriculum: bool = True
    static_friction: float = 0.6
    dynamic_friction: float = 0.6
    restitution: float = 0.0
    measure_heights: bool = False
    measured_points_x: Tuple[float, ...] = _t(*[i * 0.1 - 0.8 for i in range(17)])
    measured_points_y: Tuple[float, ...] = _t(*[i * 0.1 - 0.5 for i in range(11)])
    terrain_length: float = 8.0
    terrain_width: float = 8.0
    num_rows: int = 10              # difficulty levels
    num_cols: int = 20              # terrain types
    max_init_terrain_level: int = 5
    random_level_frac: float = 0.0
    curriculum_mode: str = "displacement"
    promote_quality: float = 0.55
    demote_prob: float = 0.5
    terrain_proportions: Tuple[float, ...] = _t(0.2, 0.2, 0.4, 0.1, 0.1, 0, 0)
    uneven_amplitude: float = 0.2
    slope_treshold: float = 0.75
    env_spacing: float = 3.0        # plane grid spacing


@dataclass(frozen=True)
class AssetCfg:
    """humanoid_config.py:79-119."""
    urdf: str = ""                  # explicit path override; else `robot`
    robot: str = "xbot12"           # named variant (assets.resolve_robot)
    foot_name: str = "ankle_roll"
    knee_name: str = "knee"
    terminate_after_contacts_on: Tuple[str, ...] = ("base_link",)
    penalize_contacts_on: Tuple[str, ...] = ("base_link",)
    termination_force: float = 1.0


@dataclass(frozen=True)
class XBotLCfg:
    """The full task config (reference XBotLCfg, humanoid_config.py:37-459),
    canonical 12-dof XBot-L values."""
    env: EnvCfg = EnvCfg()
    safety: SafetyCfg = SafetyCfg()
    asset: AssetCfg = AssetCfg()
    terrain: TerrainCfg = TerrainCfg()
    init_state: InitStateCfg = InitStateCfg()
    control: ControlCfg = ControlCfg()
    sim: SimCfg = SimCfg()
    domain_rand: DomainRandCfg = DomainRandCfg()
    commands: CommandsCfg = CommandsCfg()
    rewards: RewardsCfg = RewardsCfg()
    normalization: NormalizationCfg = NormalizationCfg()
    noise: NoiseCfg = NoiseCfg()
    seed: int = 5

    @property
    def dt(self) -> float:
        """Policy dt = decimation * sim dt (humanoid_env.py:164)."""
        return self.control.decimation * self.sim.dt

    @property
    def max_episode_length(self) -> int:
        return int(self.env.episode_length_s / self.dt)

    def replace(self, **kw) -> "XBotLCfg":
        return dataclasses.replace(self, **kw)



@dataclass(frozen=True)
class PolicyCfg:
    init_noise_std: float = 1.0
    actor_hidden_dims: Tuple[int, ...] = (512, 256, 128)
    critic_hidden_dims: Tuple[int, ...] = (768, 256, 128)
    vel_est_hidden_dims: Tuple[int, ...] = (128, 128)
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class AlgorithmCfg:
    value_loss_coef: float = 1.0
    use_clipped_value_loss: bool = True
    clip_param: float = 0.2
    entropy_coef: float = 0.001
    learning_rate: float = 1e-5
    schedule: str = "adaptive"          # adaptive | fixed
    num_learning_epochs: int = 2
    gamma: float = 0.994
    lam: float = 0.9
    num_mini_batches: int = 4
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0
    min_lr: float = 1e-5
    max_lr: float = 1e-2
    sym_loss: bool = False
    sym_coef: float = 1.0
    base_lin_vel_coef: float = 1.0
    shuffle_granule: int = 8


@dataclass(frozen=True)
class RunnerCfg:
    num_steps_per_env: int = 60
    max_iterations: int = 3001
    save_interval: int = 100
    experiment_name: str = "XBot_ppo"
    run_name: str = ""
    resume: bool = False
    log_interval: int = 1
    iters_per_dispatch: int = 50
    save_env_state: bool = False


@dataclass(frozen=True)
class XBotLCfgPPO:
    seed: int = 5
    policy: PolicyCfg = PolicyCfg()
    algorithm: AlgorithmCfg = AlgorithmCfg()
    runner: RunnerCfg = RunnerCfg()

    def replace(self, **kw) -> "XBotLCfgPPO":
        return dataclasses.replace(self, **kw)
