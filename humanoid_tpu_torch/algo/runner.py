"""On-policy training runner: rollout, GAE and the PPO update per
iteration. Port of the reference package's algo/runner.py (`init_carry`,
`_train_iteration`, `learn`).

The rollout runs the actor only; one batched critic pass over the stored
trajectory then gives the values for GAE and the timeout bootstrap.
Advantages are normalized over the whole batch, and `course_gain` is
updated on the device.

Checkpoints (reference `save`, `save_state`, `load_state`, `load`):
`model_<it>.pt` holds the network, Adam's moments keyed by parameter name,
its step count and learning rate, and the iteration; `state_<it>.pt` adds
the iteration carry field by field and the generator's state, so that a run
resumed from it repeats the unbroken run.

On a sharded env (parallel/mesh.py) each of W ranks runs this runner on its
share of the envs: the action noise, the random episode lengths and the
minibatch permutation are drawn at the global size, the advantages are
normalized over every rank's, and the iteration's metrics are summed over
the ranks, so that every rank logs the global values and takes the update
that one process with every env takes. Rank 0 alone saves; the exact
state is not saved over several ranks (no rank holds the whole carry), as
in the reference.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..config.structs import XBotLCfgPPO
from ..env.xbotl import EnvState, XBotLEnv
from ..parallel.mesh import all_reduce_sum, draw, global_mean_std, single
from ..physics.engine import PhysState
from .gae import compute_gae
from .networks import MIN_STD, ActorCritic, log_prob
from .ppo import Adam, Batch, UpdateMetrics, ppo_update, tile_permutation

TERRAIN_LEVEL_BINS = 10


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
    sampler_launches: int          # heightfield sampler launches this iteration
    factor_launches: int           # Cholesky factor kernel launches (engine path)
    apply_launches: int            # Cholesky apply kernel launches (engine path)
    solve_launches: int            # Cholesky solve kernel launches (engine path)
    terrain_level_mean: torch.Tensor   # mean curriculum row at the iteration's end (0 on plane)
    terrain_level_hist: torch.Tensor   # (10,) share of envs on each row


def _as_dict(x):
    """A NamedTuple (nested ones too) as a dict by field name, for a
    payload that `torch.load(weights_only=True)` reads back."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: _as_dict(getattr(x, f)) for f in x._fields}
    return x


class OnPolicyRunner:
    def __init__(self, env: XBotLEnv, train_cfg: XBotLCfgPPO, log_dir: Optional[str] = None):
        self.env = env
        self.cfg = train_cfg
        self.log_dir = log_dir
        self.device = env.device
        self.shard = env.shard
        self.n_global = env.n_global
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
        # the mirror matrices of the symmetry loss, built only when it is on
        self.obs_perm = self.act_perm = None
        if acfg.sym_loss:
            from .symmetry import xbot_perm_matrices

            obs_perm, act_perm = xbot_perm_matrices(ecfg.frame_stack, ecfg.num_actions)
            self.obs_perm = torch.as_tensor(obs_perm, device=self.device)
            self.act_perm = torch.as_tensor(act_perm, device=self.device)
        self.iteration = 0
        # the checkpoint hook: on_checkpoint(runner, checkpoint path, iteration),
        # called by `save` on rank 0 (deploy/eval_gate.py's CheckpointEvalGate)
        self.on_checkpoint = None

    def _sampler_launches(self) -> int:
        return self.env.sampler.launches if self.env.sampler is not None else 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def init_carry(self, init_at_random_ep_len: bool = True) -> IterationCarry:
        """Env reset plus the first zero-action step."""
        env = self.env
        state = env.initial_state(self.gen)
        if init_at_random_ep_len:
            state = state._replace(episode_length=draw(
                self.shard, torch.randint, 0, env.max_episode_length,
                size=state.episode_length.shape, generator=self.gen, device=self.device,
                dtype=torch.int32))
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
        sampler0 = self._sampler_launches()
        chol0 = dict(env.cholesky.launches)

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
            with torch.profiler.record_function("rollout"):   # a span for device_trace
                for t in range(T):
                    mean = net.act_mean(obs)
                    action = mean + std * draw(self.shard, torch.randn, size=mean.shape,
                                               generator=self.gen, device=dev)
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
                    ep_stats += torch.stack([out.ep_count, out.ep_len_sum.float(),
                                             out.ep_term_count])
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
            adv_mean, adv_std = global_mean_std(advantages, self.shard)
            norm_adv = (advantages - adv_mean) / (adv_std + 1e-8)
            batch = Batch(
                obs=obs_buf.reshape(T * N, -1), critic_obs=cobs_buf.reshape(T * N, -1),
                actions=act_buf.reshape(T * N, -1), old_logp=logp_buf.reshape(-1),
                old_mu=mean_buf.reshape(T * N, -1),
                old_sigma=std.expand(T * N, -1), target_values=values.reshape(-1),
                advantages=norm_adv.reshape(-1), returns=returns.reshape(-1),
            )
            perm = tile_permutation(T * self.n_global, acfg, self.gen, dev)
        update = ppo_update(net, acfg, self.opt, batch, perm, self.vel_slice, self.obs_perm,
                            self.act_perm, self.shard)
        self._sync()
        t2 = time.perf_counter()
        self.iteration += 1
        levels = es.terrain_levels
        hist = (levels[:, None] == torch.arange(TERRAIN_LEVEL_BINS, device=dev,
                                                dtype=levels.dtype)).float()
        if single(self.shard):
            step_reward, rew_terms_mean = rew_buf.mean(), rew_terms / T
            level_mean, level_hist = levels.float().mean(), hist.mean(0)
        else:
            # the global values, in one collective: sums over every rank's envs
            n_rew = ep_rew.shape[0]
            total = all_reduce_sum(torch.cat([
                ep_rew, ep_stats, rew_terms * N, hist.sum(0),
                torch.stack([rew_buf.sum(), levels.float().sum()])]), self.shard)
            ep_rew, ep_stats, rew_terms, hist_sum, rest = torch.split(
                total, [n_rew, 3, n_rew, TERRAIN_LEVEL_BINS, 2])
            Ng = self.n_global
            step_reward, level_mean = rest[0] / (T * Ng), rest[1] / Ng
            level_hist, rew_terms_mean = hist_sum / Ng, rew_terms / (Ng * T)
        metrics = IterationMetrics(
            update=update, mean_step_reward=step_reward, ep_rew_sums=ep_rew,
            ep_count=ep_stats[0], ep_len_sum=ep_stats[1], ep_term_count=ep_stats[2],
            mean_action_std=torch.clamp(net.std.detach(), min=MIN_STD).mean(),
            rew_terms_mean=rew_terms_mean, rollout_s=t1 - t0, update_s=t2 - t1,
            kernel_launches=env.physics.launches - launches0,
            sampler_launches=self._sampler_launches() - sampler0,
            **{f"{k}_launches": env.cholesky.launches[f"chol_{k}"] - chol0[f"chol_{k}"]
               for k in ("factor", "apply", "solve")},
            terrain_level_mean=level_mean, terrain_level_hist=level_hist,
        )
        return IterationCarry(env_state=es, obs=obs, critic_obs=cobs), metrics

    def learn(self, num_iterations: int, init_at_random_ep_len: bool = True,
              log_fn: Optional[Callable] = None,
              carry: Optional[IterationCarry] = None) -> IterationCarry:
        """Train for `num_iterations`, from `carry` or else from a fresh env;
        log_fn(it, metrics, env_steps_per_s) is called after each (the env
        steps of every rank). With a log_dir, saves every `save_interval`
        iterations and at the end (and the exact state beside each save when
        `runner.save_env_state`)."""
        if carry is None:
            carry = self.init_carry(init_at_random_ep_len)
        steps = self.cfg.runner.num_steps_per_env * self.n_global
        every = self.cfg.runner.save_interval
        saved_at = None
        for _ in range(num_iterations):
            carry, metrics = self.train_iteration(carry)
            if log_fn is not None:
                log_fn(self.iteration, metrics, steps / (metrics.rollout_s + metrics.update_s))
            if self.log_dir and every and self.iteration % every == 0:
                self._save_all(carry)
                saved_at = self.iteration
        if self.log_dir and saved_at != self.iteration:
            self._save_all(carry)
        return carry

    def _save_all(self, carry: IterationCarry):
        if self.shard is not None and self.shard.rank != 0:
            return                      # rank 0 alone writes the run's checkpoints
        self.save()
        if self.cfg.runner.save_env_state:
            self.save_state(carry)

    # ------------------------------------------------------------------
    # checkpoints

    def _payload(self) -> Dict:
        names = [n for n, _ in self.net.named_parameters()]
        opt = self.opt
        return {
            "model": self.net.state_dict(),
            "optimizer": {"mu": dict(zip(names, opt.mu)), "nu": dict(zip(names, opt.nu)),
                          "count": opt.count, "lr": opt.lr},
            "iteration": self.iteration,
        }

    def _restore(self, payload: Dict, load_optimizer: bool = True):
        self.net.load_state_dict(payload["model"])
        if load_optimizer:
            o = payload["optimizer"]
            names = [n for n, _ in self.net.named_parameters()]
            for key, buffers in (("mu", self.opt.mu), ("nu", self.opt.nu)):
                if sorted(o[key]) != sorted(names):
                    raise KeyError(f"Adam {key} is keyed by {sorted(o[key])}, the network's "
                                   f"parameters are {sorted(names)}")
                with torch.no_grad():
                    for name, buf in zip(names, buffers):
                        buf.copy_(o[key][name])
            self.opt.count = int(o["count"])
            self.opt.lr = o["lr"].to(self.device)
        self.iteration = int(payload["iteration"])

    def save(self, path: Optional[str] = None) -> str:
        """The model, Adam and the iteration, to `path` (default
        <log_dir>/model_<it>) + ".pt"; then, on rank 0, the checkpoint hook
        `on_checkpoint` where one is set."""
        from ..utils.checkpoint import save_checkpoint

        path = save_checkpoint(path or os.path.join(self.log_dir, f"model_{self.iteration}"),
                               self._payload())
        if self.on_checkpoint is not None and (self.shard is None or self.shard.rank == 0):
            self.on_checkpoint(self, path, self.iteration)
        return path

    def load(self, path: str, load_optimizer: bool = True) -> None:
        from ..utils.checkpoint import load_checkpoint

        self._restore(load_checkpoint(path, self.device), load_optimizer)

    def save_state(self, carry: IterationCarry, path: Optional[str] = None) -> str:
        """Exact state: everything `save` writes, the iteration carry field by
        field (EnvState and PhysState as dicts, None fields kept) and the
        generator's state, to `path` (default <log_dir>/state_<it>) + ".pt"."""
        from ..utils.checkpoint import save_checkpoint

        path = path or os.path.join(self.log_dir, f"state_{self.iteration}")
        if not single(self.shard):
            logging.getLogger(__name__).warning(
                "save_env_state skipped: exact-state checkpoints are single-rank only (the "
                "env axis is split over %d ranks)", self.shard.world)
            return path
        return save_checkpoint(path, {**self._payload(), "carry": _as_dict(carry),
                                      "generator": self.gen.get_state()})

    def load_state(self, path: str) -> IterationCarry:
        """Restore an exact-state checkpoint: the runner's model, Adam,
        iteration and generator, and the carry to continue from."""
        from ..utils.checkpoint import load_checkpoint

        payload = load_checkpoint(path, self.device)
        self._restore(payload)
        self.gen.set_state(payload["generator"].cpu())
        c = payload["carry"]
        es = dict(c["env_state"])
        es["phys"] = PhysState(**es["phys"])
        return IterationCarry(env_state=EnvState(**es), obs=c["obs"], critic_obs=c["critic_obs"])

    def inference_policy(self) -> Callable:
        """The deterministic actor: obs -> act_mean(obs)."""
        net = self.net

        @torch.no_grad()
        def policy(obs):
            return net.act_mean(obs)

        return policy
