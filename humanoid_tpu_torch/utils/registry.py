"""Task registry of the port: name -> (env cfg, train cfg).

Only `humanoid_ppo` is registered: the shipping flat-ground task with
block-PGS contact (6 cold sweeps), the frozen mass-matrix factor and the
frozen contact prep, as the reference registry defines it."""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

from ..assets import write_xbot_topology_urdf
from ..config.structs import SimCfg, XBotLCfg, XBotLCfgPPO

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")

_REGISTRY: Dict[str, Tuple[XBotLCfg, XBotLCfgPPO]] = {
    "humanoid_ppo": (
        XBotLCfg(sim=SimCfg(contact_model="pgs", pgs_freeze_prep=True, pgs_iterations=6)),
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
    """The CLI override whitelist: num_envs, seed, max_iterations."""
    if getattr(args, "num_envs", None):
        env_cfg = env_cfg.replace(env=dataclasses.replace(env_cfg.env, num_envs=args.num_envs))
    if getattr(args, "seed", None) is not None:
        env_cfg = env_cfg.replace(seed=args.seed)
        train_cfg = train_cfg.replace(seed=args.seed)
    if getattr(args, "max_iterations", None):
        train_cfg = train_cfg.replace(runner=dataclasses.replace(
            train_cfg.runner, max_iterations=args.max_iterations))
    return env_cfg, train_cfg


def default_urdf() -> str:
    """The XBot-topology stand-in, written into the package's build dir."""
    return write_xbot_topology_urdf(BUILD_DIR)


def make_env(name: str, args=None, device="cuda", urdf: Optional[str] = None):
    from ..env.xbotl import XBotLEnv

    env_cfg, train_cfg = get_cfgs(name)
    if args is not None:
        env_cfg, train_cfg = update_cfg_from_args(env_cfg, train_cfg, args)
    env = XBotLEnv(env_cfg, urdf or default_urdf(), device=device)
    return env, env_cfg, train_cfg


def make_alg_runner(env, train_cfg: XBotLCfgPPO):
    from ..algo.runner import OnPolicyRunner

    return OnPolicyRunner(env, train_cfg)
