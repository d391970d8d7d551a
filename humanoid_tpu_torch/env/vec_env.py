"""Stateful VecEnv facade over the env's step: the port of the reference
package's env/vec_env.py.

The upstream trainer defines the env<->algo contract as an abstract class
(algo/vec_env.py:39-63): attributes num_envs / num_obs / num_privileged_obs
/ num_actions / max_episode_length plus `step(actions) -> (obs, priv_obs,
rew, reset, extras)`, `reset()` and `get_observations()`. The port's
trainer calls `XBotLEnv.step` on an explicit state; code written for that
stateful contract gets it here: the adapter owns the EnvState and the
torch.Generator and keeps the upstream auto-reset and `extras` (the
per-term episode means over the episodes that just finished and the
timeout flags).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .xbotl import EnvState, XBotLEnv


class VecEnvAdapter:
    def __init__(self, env: XBotLEnv, seed: int = 0):
        self.env = env
        cfg = env.cfg
        self.num_envs = cfg.env.num_envs
        self.num_obs = cfg.env.num_observations
        self.num_privileged_obs = cfg.env.num_privileged_obs
        self.num_actions = cfg.env.num_actions
        self.max_episode_length = env.max_episode_length
        self.extras: Dict = {}
        self._gen = torch.Generator(device=env.device)
        self._gen.manual_seed(seed)
        self._state: Optional[EnvState] = None
        self.obs_buf = None
        self.privileged_obs_buf = None
        self.rew_buf = None
        self.reset_buf = None

    @property
    def episode_length_buf(self):
        return self._state.episode_length

    def reset(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """A fresh state and one zero-action step, as the upstream
        BaseTask.reset (base_task.py:144-149)."""
        self._state = self.env.initial_state(self._gen)
        obs, priv, *_ = self.step(torch.zeros(self.num_envs, self.num_actions,
                                              device=self.env.device))
        return obs, priv

    def step(self, actions):
        if self._state is None:
            self._state = self.env.initial_state(self._gen)
        actions = torch.as_tensor(actions, dtype=torch.float32, device=self.env.device)
        self._state, out = self.env.step(self._state, actions, self._gen)
        self.obs_buf = out.obs
        self.privileged_obs_buf = out.privileged_obs
        self.rew_buf = out.rew
        self.reset_buf = out.reset
        # per-term episode means over just-finished episodes + timeout split
        # (humanoid_env.py:1141-1152)
        n = torch.clamp(out.ep_count, min=1.0)
        self.extras = {
            "episode": {
                f"rew_{name}": out.ep_rew_sums[i] / n
                for i, name in enumerate(self.env.reward_names)
            },
            "time_outs": out.time_outs,
        }
        return out.obs, out.privileged_obs, out.rew, out.reset, self.extras

    def get_observations(self):
        return self.obs_buf

    def get_privileged_observations(self):
        return self.privileged_obs_buf
