"""On-policy training runner: rollout, GAE and the PPO update per
iteration. Port of the reference package's algo/runner.py (`init_carry`,
`_train_iteration`, `learn`).

The rollout runs the actor only; one batched critic pass over the stored
trajectory then gives the values for GAE and the timeout bootstrap.
Advantages are normalized over the whole batch, and `course_gain` is
updated on the device. Checkpoints are not ported yet.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import torch

from ..config.structs import XBotLCfgPPO
from ..env.xbotl import EnvState, XBotLEnv
from .gae import compute_gae
from .networks import MIN_STD, ActorCritic, log_prob
from .ppo import Adam, Batch, UpdateMetrics, ppo_update, tile_permutation


class IterationCarry(NamedTuple):
    env_state: EnvState
    obs: torch.Tensor
    critic_obs: torch.Tensor


class IterationMetrics(NamedTuple):
    update: UpdateMetrics
    mean_step_reward: torch.Tensor
    ep_rew_sums: torch.Tensor      # (n_rew,) summed over finished episodes
    ep_count: torch.Tensor
    ep_len_sum: torch.Tensor
    ep_term_count: torch.Tensor
    mean_action_std: torch.Tensor
    rew_terms_mean: torch.Tensor   # (n_rew,)
    rollout_s: float               # host seconds, synchronized
    update_s: float
    kernel_launches: int           # control-step kernel launches this iteration


class OnPolicyRunner:
    def __init__(self, env: XBotLEnv, train_cfg: XBotLCfgPPO):
        self.env = env
        self.cfg = train_cfg
        self.device = env.device
        ecfg = env.cfg.env
        pcfg = train_cfg.policy
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(train_cfg.seed)
        init_gen = torch.Generator()
        init_gen.manual_seed(train_cfg.seed)
        self.net = ActorCritic(
            ecfg.num_observations, ecfg.num_privileged_obs, ecfg.num_actions,
            pcfg.actor_hidden_dims, pcfg.critic_hidden_dims, pcfg.vel_est_hidden_dims,
            pcfg.init_noise_std, pcfg.compute_dtype,
        )
        self.net.reset_parameters(init_gen, pcfg.init_noise_std)
        self.net.to(self.device)
        acfg = train_cfg.algorithm
        self.opt = Adam(list(self.net.parameters()), acfg.max_grad_norm, acfg.learning_rate)
        lo = 5 + 4 * ecfg.num_actions   # base_lin_vel slice of the oldest critic frame
        self.vel_slice = (lo, lo + 3)
        self.iteration = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def init_carry(self, init_at_random_ep_len: bool = True) -> IterationCarry:
        """Env reset plus the first zero-action step."""
        env = self.env
        state = env.initial_state(self.gen)
        if init_at_random_ep_len:
            state = state._replace(episode_length=torch.randint(
                0, env.max_episode_length, state.episode_length.shape,
                generator=self.gen, device=self.device, dtype=torch.int32))
        N, nj = env.cfg.env.num_envs, env.cfg.env.num_actions
        state, out = env.step(state, torch.zeros(N, nj, device=self.device), self.gen)
        return IterationCarry(env_state=state, obs=out.obs, critic_obs=out.privileged_obs)

    def train_iteration(self, carry: IterationCarry):
        env, net = self.env, self.net
        acfg = self.cfg.algorithm
        T = self.cfg.runner.num_steps_per_env
        N = env.cfg.env.num_envs
        dev = self.device
        t0 = time.perf_counter()
        launches0 = env.physics.launches

        es = carry.env_state
        ratio = env.cfg.rewards.course_ratio
        if ratio != 1.0:
            es = es._replace(course_gain=torch.clamp(es.course_gain * ratio, max=20.0))

        store_dt = net.compute_dtype
        with torch.no_grad():
            std = torch.clamp(net.std, min=MIN_STD)
            obs_buf = torch.empty((T, N, carry.obs.shape[1]), device=dev, dtype=store_dt)
            cobs_buf = torch.empty((T, N, carry.critic_obs.shape[1]), device=dev, dtype=store_dt)
            act_buf = torch.empty((T, N, env.nj), device=dev)
            mean_buf = torch.empty_like(act_buf)
            logp_buf = torch.empty((T, N), device=dev)
            rew_buf = torch.empty_like(logp_buf)
            done_buf = torch.empty_like(logp_buf)
            tout_buf = torch.empty_like(logp_buf)
            n_rew = env.n_rew
            ep_rew = torch.zeros(n_rew, device=dev)
            ep_stats = torch.zeros(3, device=dev)    # count, length sum, failures
            rew_terms = torch.zeros(n_rew, device=dev)
            obs, cobs = carry.obs, carry.critic_obs
            for t in range(T):
                mean = net.act_mean(obs)
                action = mean + std * torch.randn(mean.shape, generator=self.gen, device=dev)
                obs_buf[t] = obs
                cobs_buf[t] = cobs
                act_buf[t] = action
                mean_buf[t] = mean
                logp_buf[t] = log_prob(mean, std, action)
                es, out = env.step(es, action, self.gen)
                rew_buf[t] = out.rew
                done_buf[t] = out.reset.float()
                tout_buf[t] = out.time_outs.float()
                ep_rew += out.ep_rew_sums
                ep_stats += torch.stack([out.ep_count, out.ep_len_sum.float(), out.ep_term_count])
                rew_terms += out.rew_terms_mean
                obs, cobs = out.obs, out.privileged_obs
            self._sync()
            t1 = time.perf_counter()

            values = net.value(cobs_buf.reshape(T * N, -1)).reshape(T, N)
            last_values = net.value(cobs.to(store_dt))
            rewards = rew_buf + acfg.gamma * values * tout_buf \
                if env.cfg.env.send_timeouts else rew_buf
            advantages, returns = compute_gae(rewards, values, done_buf, last_values,
                                              acfg.gamma, acfg.lam)
            norm_adv = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
            batch = Batch(
                obs=obs_buf.reshape(T * N, -1), critic_obs=cobs_buf.reshape(T * N, -1),
                actions=act_buf.reshape(T * N, -1), old_logp=logp_buf.reshape(-1),
                old_mu=mean_buf.reshape(T * N, -1),
                old_sigma=std.expand(T * N, -1), target_values=values.reshape(-1),
                advantages=norm_adv.reshape(-1), returns=returns.reshape(-1),
            )
            perm = tile_permutation(T * N, acfg, self.gen, dev)
        update = ppo_update(net, acfg, self.opt, batch, perm, self.vel_slice)
        self._sync()
        t2 = time.perf_counter()
        self.iteration += 1
        metrics = IterationMetrics(
            update=update, mean_step_reward=rew_buf.mean(), ep_rew_sums=ep_rew,
            ep_count=ep_stats[0], ep_len_sum=ep_stats[1], ep_term_count=ep_stats[2],
            mean_action_std=torch.clamp(net.std.detach(), min=MIN_STD).mean(),
            rew_terms_mean=rew_terms / T, rollout_s=t1 - t0, update_s=t2 - t1,
            kernel_launches=env.physics.launches - launches0,
        )
        return IterationCarry(env_state=es, obs=obs, critic_obs=cobs), metrics

    def learn(self, num_iterations: int,
              log_fn: Optional[Callable] = None) -> IterationCarry:
        """Train for `num_iterations` from a fresh env at random episode
        lengths; log_fn(it, metrics, env_steps_per_s) is called after each."""
        carry = self.init_carry(init_at_random_ep_len=True)
        steps = self.cfg.runner.num_steps_per_env * self.env.cfg.env.num_envs
        for _ in range(num_iterations):
            carry, metrics = self.train_iteration(carry)
            if log_fn is not None:
                log_fn(self.iteration, metrics, steps / (metrics.rollout_s + metrics.update_s))
        return carry
