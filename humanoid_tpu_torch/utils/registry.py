"""Task registry of the port: name -> (env cfg, train cfg), with the
reference registry's configs.

  humanoid_ppo          flat ground, block-PGS contact (6 cold sweeps),
                        frozen mass-matrix factor and contact prep
  humanoid_ppo_penalty  the contact-model A/B: humanoid_ppo's task on the
                        penalty (spring-damper) contact, XBotLCfg()'s
                        defaults
  humanoid_ppo_terrain  the same physics on the heightfield curriculum
                        (humanoid generator set) with the 187-point height
                        scan in the critic frame, the extended domain
                        randomization and the tracking curriculum
  humanoid_ppo_trimesh  as humanoid_ppo_terrain on the base generator set,
                        with the vertical-face (trimesh) sampling
  humanoid_ppo_pgs      an alias of humanoid_ppo
  humanoid_ppo_robust   humanoid_ppo with the extended domain
                        randomization, the stand/walk switch with a
                        walk-stand-walk gait schedule, the command
                        curriculum and the action-smoothness reward
                        curriculum
  humanoid_ppo_transfer humanoid_ppo with the extended domain
                        randomization and tracking-biased rewards
  humanoid_ppo_omni     humanoid_ppo_transfer with wider command ranges
  humanoid_ppo_envelope humanoid_ppo_omni's recipe with on-axis command
                        practice (axis_frac), a wider vx range, the
                        terrain tasks' rewards and the mirror-symmetry loss
  humanoid_ppo_8k       humanoid_ppo at 8192 envs
  humanoid_ppo_sym      humanoid_ppo with the mirror-symmetry loss
  d11_ppo               the 18-dof robot (XBot-L with its six arm dofs
                        re-enabled, arms first; config.structs.d11_cfg) on
                        humanoid_ppo's physics
  d11_ppo_pgs           an alias of d11_ppo
  d12_ppo               d11_ppo with the extended domain randomization, the
                        stand/walk switch with a walk-stand-walk gait
                        schedule and the command curriculum

The robot of a task is its `asset.robot` stand-in (assets.resolve_robot),
written into the package's build directory; `--urdf PATH` replaces it, on
an 18-dof task with the six arm joints of that file flipped to revolute
(assets.make_xbot18_urdf).

Warm-started PGS (`sim.pgs_warm_start`) ships in no task, as in the
reference; a config with it set runs the kernel's warm instance.
"""
from __future__ import annotations

import dataclasses
import os
from datetime import datetime
from typing import Dict, Optional, Tuple, Union

from ..assets import XBOT18_JOINT_ORDER, make_xbot18_urdf, resolve_robot
from ..config.structs import (AlgorithmCfg, AssetCfg, CommandRangesCfg, CommandsCfg,
                              DomainRandCfg, EnvCfg, RewardScalesCfg, RewardsCfg, SimCfg,
                              TerrainCfg, XBotLCfg, XBotLCfgPPO, d11_cfg)

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
# runs go to <LOG_ROOT>/<experiment_name>/<%b%d_%H-%M-%S>_<run_name>/
LOG_ROOT = os.environ.get(
    "HUMANOID_TPU_LOGS",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                 "logs"))

_PGS = SimCfg(contact_model="pgs", pgs_freeze_prep=True, pgs_iterations=6)
# the extended domain randomization and the tracking-biased rewards
_EXTENDED_DR = DomainRandCfg(
    randomize_link_mass=True, randomize_base_com=True, randomize_inertia=True,
    randomize_motor_strength=True, randomize_motor_offset=True, randomize_kp_factor=True,
    randomize_kd_factor=True, randomize_lag_timesteps=True,
)
_TRACKING_REWARDS = RewardsCfg(
    low_speed_lo=0.7, tracking_sigma=12.0, low_speed_directional=True,
    scales=RewardScalesCfg(tracking_lin_vel=2.4, low_speed=0.4),
)

_REGISTRY: Dict[str, Tuple[XBotLCfg, XBotLCfgPPO]] = {
    "humanoid_ppo": (XBotLCfg(sim=_PGS), XBotLCfgPPO()),
    "humanoid_ppo_penalty": (XBotLCfg(), XBotLCfgPPO()),
    "humanoid_ppo_terrain": (
        XBotLCfg(
            env=EnvCfg(single_num_privileged_obs=73 + 187),
            terrain=TerrainCfg(
                mesh_type="heightfield", measure_heights=True,
                terrain_proportions=(0.05, 0.15, 0.15, 0.1, 0.1, 0.1, 0.1, 0.25),
                curriculum_mode="tracking", random_level_frac=0.1,
            ),
            sim=_PGS, domain_rand=_EXTENDED_DR, rewards=_TRACKING_REWARDS,
        ),
        XBotLCfgPPO(),
    ),
    "humanoid_ppo_trimesh": (
        XBotLCfg(
            env=EnvCfg(single_num_privileged_obs=73 + 187),
            terrain=TerrainCfg(
                mesh_type="trimesh", measure_heights=True, generator_set="base",
                terrain_proportions=(0.15, 0.15, 0.15, 0.15, 0.15, 0.1, 0.1),
                curriculum_mode="tracking", random_level_frac=0.1,
            ),
            sim=_PGS, domain_rand=_EXTENDED_DR, rewards=_TRACKING_REWARDS,
        ),
        XBotLCfgPPO(),
    ),
    "humanoid_ppo_pgs": (XBotLCfg(sim=_PGS), XBotLCfgPPO()),
    "humanoid_ppo_robust": (
        XBotLCfg(
            sim=_PGS, domain_rand=_EXTENDED_DR,
            commands=CommandsCfg(curriculum=True, sw_switch=True,
                                 gait=("walk_omnidirectional", "stand", "walk_omnidirectional")),
            rewards=RewardsCfg(course_ratio=1.001),
        ),
        XBotLCfgPPO(),
    ),
    "humanoid_ppo_transfer": (
        XBotLCfg(sim=_PGS, domain_rand=_EXTENDED_DR,
                 rewards=RewardsCfg(low_speed_lo=0.7,
                                    scales=RewardScalesCfg(tracking_lin_vel=2.4))),
        XBotLCfgPPO(),
    ),
    "humanoid_ppo_omni": (
        XBotLCfg(sim=_PGS, domain_rand=_EXTENDED_DR,
                 commands=CommandsCfg(ranges=CommandRangesCfg(lin_vel_x=(-0.5, 0.6),
                                                              lin_vel_y=(-0.4, 0.4))),
                 rewards=RewardsCfg(low_speed_lo=0.7,
                                    scales=RewardScalesCfg(tracking_lin_vel=2.4))),
        XBotLCfgPPO(),
    ),
    "humanoid_ppo_envelope": (
        XBotLCfg(sim=_PGS, domain_rand=_EXTENDED_DR,
                 commands=CommandsCfg(axis_frac=0.25,
                                      ranges=CommandRangesCfg(lin_vel_x=(-0.5, 0.8),
                                                              lin_vel_y=(-0.4, 0.4))),
                 rewards=_TRACKING_REWARDS),
        XBotLCfgPPO(algorithm=AlgorithmCfg(sym_loss=True, sym_coef=1.0)),
    ),
    "humanoid_ppo_8k": (XBotLCfg(env=EnvCfg(num_envs=8192), sim=_PGS), XBotLCfgPPO()),
    "humanoid_ppo_sym": (XBotLCfg(sim=_PGS),
                         XBotLCfgPPO(algorithm=AlgorithmCfg(sym_loss=True, sym_coef=1.0))),
    "d11_ppo": (d11_cfg().replace(sim=_PGS), XBotLCfgPPO()),
    "d11_ppo_pgs": (d11_cfg().replace(sim=_PGS), XBotLCfgPPO()),
    "d12_ppo": (
        d11_cfg().replace(
            sim=_PGS, domain_rand=_EXTENDED_DR,
            commands=CommandsCfg(curriculum=True, sw_switch=True,
                                 gait=("walk_omnidirectional", "stand", "walk_omnidirectional")),
        ),
        XBotLCfgPPO(),
    ),
}


def list_tasks():
    return sorted(_REGISTRY)


def get_cfgs(name: str) -> Tuple[XBotLCfg, XBotLCfgPPO]:
    if name not in _REGISTRY:
        raise KeyError(f"unknown task {name!r}; ported tasks: {list_tasks()}")
    return _REGISTRY[name]


def update_cfg_from_args(env_cfg: XBotLCfg, train_cfg: XBotLCfgPPO, args):
    """The reference's CLI override whitelist: num_envs, seed,
    max_iterations, experiment_name, run_name, resume, the terrain's mesh
    type and the contact model."""
    def runner(**kw):
        return train_cfg.replace(runner=dataclasses.replace(train_cfg.runner, **kw))

    if getattr(args, "num_envs", None):
        env_cfg = env_cfg.replace(env=dataclasses.replace(env_cfg.env, num_envs=args.num_envs))
    if getattr(args, "seed", None) is not None:
        env_cfg = env_cfg.replace(seed=args.seed)
        train_cfg = train_cfg.replace(seed=args.seed)
    if getattr(args, "max_iterations", None):
        train_cfg = runner(max_iterations=args.max_iterations)
    if getattr(args, "experiment_name", None):
        train_cfg = runner(experiment_name=args.experiment_name)
    if getattr(args, "run_name", None):
        train_cfg = runner(run_name=args.run_name)
    if getattr(args, "resume", False):
        train_cfg = runner(resume=True)
    if getattr(args, "terrain", None):
        env_cfg = env_cfg.replace(terrain=dataclasses.replace(env_cfg.terrain,
                                                              mesh_type=args.terrain))
    if getattr(args, "contact", None):
        env_cfg = env_cfg.replace(sim=dataclasses.replace(env_cfg.sim, contact_model=args.contact))
    return env_cfg, train_cfg


def default_urdf(asset_cfg: Optional[AssetCfg] = None) -> str:
    """The robot of `asset_cfg` (default: the 12-dof XBot-topology
    stand-in), its stand-in written into the package's build dir."""
    return resolve_robot(asset_cfg or AssetCfg(), BUILD_DIR)[0]


def robot(env_cfg: XBotLCfg, urdf: Optional[str] = None):
    """(URDF path, joint order) of a config's robot: `urdf` (the CLI's
    --urdf) in document order, on an 18-dof task with its six arm joints
    flipped to revolute and the 18-dof order; else the config's own
    (resolve_robot)."""
    if urdf is None:
        return resolve_robot(env_cfg.asset, BUILD_DIR)
    if env_cfg.asset.robot == "xbot18":
        return make_xbot18_urdf(urdf, BUILD_DIR), XBOT18_JOINT_ORDER
    return urdf, None


def build_env(env_cfg: XBotLCfg, urdf: str, device="cuda", joint_order=None, shard=None):
    """The env of a config on the robot `urdf` (in `joint_order`, else in
    document order), on this rank's `shard` of the envs when given: on a
    heightfield or trimesh task, the world from the C++ synthesizer
    (native/terrain_native.py, seeded by the config, as the reference
    builds it), with trimesh's vertical faces at slope_treshold x
    horizontal_scale of rise per cell."""
    from ..env.xbotl import XBotLEnv
    from ..native.terrain_native import build_terrain_native
    from ..physics.contact import Terrain

    tc = env_cfg.terrain
    if tc.mesh_type not in ("heightfield", "trimesh"):
        return XBotLEnv(env_cfg, urdf, device=device, joint_order=joint_order, shard=shard)
    world = build_terrain_native(tc, seed=env_cfg.seed)
    wall_thresh = tc.slope_treshold * tc.horizontal_scale if tc.mesh_type == "trimesh" else 0.0
    terrain = Terrain.heightfield(world.height, world.horizontal_scale, world.border,
                                  wall_thresh=wall_thresh, device=device)
    return XBotLEnv(env_cfg, urdf, device=device, terrain=terrain, terrain_world=world,
                    joint_order=joint_order, shard=shard)


def make_env(name: str, args=None, device="cuda", urdf: Optional[str] = None,
             env_cfg: Optional[XBotLCfg] = None, sharded: bool = False):
    """(env, env cfg, train cfg) of a task; env_cfg, when given, replaces
    the task's env config (then the CLI overrides apply to it); `urdf`
    replaces its robot (see `robot`). `sharded` splits the env axis over
    the ranks of the process group (parallel/mesh.py): the env then holds
    this rank's share, and the returned env cfg keeps the global count."""
    task_env_cfg, train_cfg = get_cfgs(name)
    env_cfg = env_cfg or task_env_cfg
    if args is not None:
        env_cfg, train_cfg = update_cfg_from_args(env_cfg, train_cfg, args)
    shard = None
    if sharded:
        from ..parallel.dist import process_count, process_index
        from ..parallel.mesh import make_shard

        shard = make_shard(env_cfg.env.num_envs, process_index(), process_count(),
                           train_cfg.algorithm.shuffle_granule)
    path, joint_order = robot(env_cfg, urdf)
    return build_env(env_cfg, path, device, joint_order, shard), env_cfg, train_cfg


def run_dir(train_cfg: XBotLCfgPPO, log_root: Optional[str] = None) -> str:
    """<log_root or LOG_ROOT>/<experiment_name>/<%b%d_%H-%M-%S>_<run_name>,
    the reference's run directory (created when the run first writes); in a
    data-parallel run, rank 0's on every rank."""
    from ..parallel.dist import sync_run_name

    leaf = sync_run_name(datetime.now().strftime("%b%d_%H-%M-%S") + "_"
                         + train_cfg.runner.run_name)
    return os.path.join(log_root or LOG_ROOT, train_cfg.runner.experiment_name, leaf)


def make_alg_runner(env, train_cfg: XBotLCfgPPO, log_root: Union[str, bool, None] = None,
                    log_dir: Optional[str] = None):
    """The runner of `env`, saving into `log_dir`, or else into a new run
    directory under `log_root` (default LOG_ROOT); `log_root=False` gives a
    runner that writes nothing."""
    from ..algo.runner import OnPolicyRunner

    if log_dir is None and log_root is not False:
        log_dir = run_dir(train_cfg, log_root)
    return OnPolicyRunner(env, train_cfg, log_dir=log_dir)
